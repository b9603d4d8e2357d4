"""Transformer layers: the port of paddle_tpu/nn/layer/transformer.py.

``MultiHeadAttention`` projects with JAX-layout ``Linear``s to (batch, seq,
heads, head_dim) and attends through the port's
``F.scaled_dot_product_attention``: on the card, an unmasked, dropout-free
attention of 128 or more query rows runs the flash-attention kernels
(forward, and dq and dk/dv in the backward); a mask, dropout or a short
query takes the math path, whose dropout draws from the device's default
generator. ``Cache`` (keys and values so far, concatenated a step at a
time) and ``StaticCache`` (the projected memory) serve incremental
decoding; ``need_weights=True`` returns ``None`` weights, as in JAX.

``TransformerEncoder``/``TransformerDecoder`` keep the given layer and build
the others afresh from its ``_config``, as the JAX package does: each layer
has its own initial weights (none is a copy of the prototype).
``Transformer.generate_square_subsequent_mask`` is a float32 mask of 0 on
and below the diagonal and -inf above it, on the current device.
"""
from __future__ import annotations

import collections

import torch

from ...ops.manipulation import concat, reshape
from .. import functional as F
from .common import Dropout, Linear
from .container import LayerList
from .layers import Layer
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer", "TransformerEncoder",
           "TransformerDecoderLayer", "TransformerDecoder", "Transformer"]


class MultiHeadAttention(Layer):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None, vdim=None,
                 need_weights=False, weight_attr=None, bias_attr=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(kdim or embed_dim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(vdim or embed_dim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _shape(self, x):
        return reshape(x, [x.shape[0], x.shape[1], self.num_heads, self.head_dim])

    def gen_cache(self, key, value=None, type=Cache):  # noqa: A002
        if type == MultiHeadAttention.StaticCache:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value if value is not None else key))
            return self.StaticCache(k, v)
        empty = torch.zeros(key.shape[0], 0, self.num_heads, self.head_dim,
                            dtype=torch.float32, device=key.device)
        return self.Cache(empty, empty)

    def forward(self, query, key=None, value=None, attn_mask=None, cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._shape(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = concat([cache.k, k], axis=1)
                v = concat([cache.v, v], axis=1)
                cache = self.Cache(k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout if self.training else 0.0,
            training=self.training)
        out = self.out_proj(reshape(out, [out.shape[0], out.shape[1], self.embed_dim]))
        if isinstance(cache, self.Cache):
            return (out, cache) if not self.need_weights else (out, None, cache)
        if self.need_weights:
            return out, None
        return out


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1, activation="relu",
                 attn_dropout=None, act_dropout=None, normalize_before=False,
                 weight_attr=None, bias_attr=None, layer_norm_eps=1e-5):
        super().__init__()
        self._config = (d_model, nhead, dim_feedforward, dropout, activation, attn_dropout,
                        act_dropout, normalize_before, weight_attr, bias_attr, layer_norm_eps)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout if attn_dropout is not None else dropout,
            weight_attr=weight_attr, bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr, bias_attr)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr, bias_attr)
        self.norm1 = LayerNorm(d_model, layer_norm_eps)
        self.norm2 = LayerNorm(d_model, layer_norm_eps)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout if act_dropout is not None else dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.act_dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [encoder_layer]
            + [type(encoder_layer)(*encoder_layer._config) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, src_mask)
            else:
                output, c = layer(output, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1, activation="relu",
                 attn_dropout=None, act_dropout=None, normalize_before=False,
                 weight_attr=None, bias_attr=None, layer_norm_eps=1e-5):
        super().__init__()
        self._config = (d_model, nhead, dim_feedforward, dropout, activation, attn_dropout,
                        act_dropout, normalize_before, weight_attr, bias_attr, layer_norm_eps)
        self.normalize_before = normalize_before
        ad = attn_dropout if attn_dropout is not None else dropout
        self.self_attn = MultiHeadAttention(d_model, nhead, ad, weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.cross_attn = MultiHeadAttention(d_model, nhead, ad, weight_attr=weight_attr,
                                             bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr, bias_attr)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr, bias_attr)
        self.norm1 = LayerNorm(d_model, layer_norm_eps)
        self.norm2 = LayerNorm(d_model, layer_norm_eps)
        self.norm3 = LayerNorm(d_model, layer_norm_eps)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout if act_dropout is not None else dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None, cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
            new_inc = None
        else:
            tgt, new_inc = self.self_attn(tgt, tgt, tgt, tgt_mask, cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask, cache[1])
            if isinstance(tgt, tuple):
                tgt = tgt[0]
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.act_dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (new_inc, cache[1]))

    def gen_cache(self, memory):
        inc = self.self_attn.gen_cache(memory)
        sta = self.cross_attn.gen_cache(memory, memory, type=MultiHeadAttention.StaticCache)
        return inc, sta


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [decoder_layer]
            + [type(decoder_layer)(*decoder_layer._config) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None, cache=None):
        output = tgt
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, memory, tgt_mask, memory_mask)
            else:
                output, c = layer(output, memory, tgt_mask, memory_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        return [layer.gen_cache(memory) for layer in self.layers]


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6, num_decoder_layers=6,
                 dim_feedforward=2048, dropout=0.1, activation="relu", attn_dropout=None,
                 act_dropout=None, normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        self.d_model = d_model
        self.nhead = nhead
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(d_model, nhead, dim_feedforward, dropout,
                                                activation, attn_dropout, act_dropout,
                                                normalize_before, weight_attr, bias_attr)
            norm = LayerNorm(d_model) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers, norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(d_model, nhead, dim_feedforward, dropout,
                                                activation, attn_dropout, act_dropout,
                                                normalize_before, weight_attr, bias_attr)
            norm = LayerNorm(d_model) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers, norm)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None, memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length):
        from ... import resolve_device

        keep = torch.ones(length, length, dtype=torch.bool, device=resolve_device(None)).tril()
        return torch.zeros(length, length, device=keep.device).masked_fill(~keep, float("-inf"))

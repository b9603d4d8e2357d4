"""Fused transformer layer classes: the port of
``paddle_tpu/incubate/nn/layer_fused.py``.

Reference analog: python/paddle/incubate/nn/layer/fused_transformer.py
(FusedLinear :52, FusedMultiHeadAttention :213, FusedFeedForward :480,
FusedTransformerEncoderLayer :666, FusedMultiTransformer :900 — each backed by
a monolithic CUDA kernel).

These classes carry the reference's packed parameter layout (one qkv weight
[3, H, D, E], the pre/post-LN switch) and compose the incubate functionals,
as the JAX classes do, with the same parameter names and ``state_dict``
order, so a JAX layer's ``state_dict`` loads into the port's. The attention
is the port's ``scaled_dot_product_attention``: with no mask and no attention
dropout (eval, or ``attn_dropout_rate=0``), a CUDA query of 128 or more rows
runs the flash kernels. ``FusedMultiTransformer`` is pre-LN only; its cached
generation goes through ``fused_multi_transformer``'s cache contract.
"""
from __future__ import annotations

from ...nn import functional as F
from ...nn.initializer import Constant, XavierUniform
from ...nn.layer.layers import Layer
from . import functional as IF

__all__ = ["FusedLinear", "FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer", "FusedMultiTransformer"]


class FusedLinear(Layer):
    """fused_transformer.py:52 — Linear through fused_matmul_bias."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, transpose_weight=False, name=None):
        super().__init__()
        self._transpose = transpose_weight
        shape = [out_features, in_features] if transpose_weight \
            else [in_features, out_features]
        self.weight = self.create_parameter(
            shape, attr=weight_attr, default_initializer=XavierUniform())
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_features], attr=bias_attr, default_initializer=Constant(0.0),
            is_bias=True)

    def forward(self, x):
        return IF.fused_matmul_bias(x, self.weight, self.bias,
                                    transpose_y=self._transpose)


class FusedMultiHeadAttention(Layer):
    """fused_transformer.py:213 — packed-QKV self-attention with the
    residual-add + layernorm folded in (pre- or post-LN)."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, transpose_qkv_wb=False, name=None):
        super().__init__()
        if need_weights:
            raise NotImplementedError("need_weights=True is not supported "
                                      "(matches the reference)")
        if transpose_qkv_wb:
            raise NotImplementedError(
                "transpose_qkv_wb=True ([hidden, 3*hidden] qkv layout) is not "
                "implemented; the packed [3, H, D, E] layout is")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self._epsilon = epsilon
        # packed (3, H, D/H, E) layout like the reference kernel's qkv weight
        self.qkv_weight = self.create_parameter(
            [3, num_heads, self.head_dim, embed_dim], attr=qkv_weight_attr,
            default_initializer=XavierUniform())
        self.qkv_bias = None if qkv_bias_attr is False else \
            self.create_parameter([3, num_heads, self.head_dim],
                                  attr=qkv_bias_attr,
                                  default_initializer=Constant(0.0),
                                  is_bias=True)
        self.linear_weight = self.create_parameter(
            [embed_dim, embed_dim], attr=linear_weight_attr,
            default_initializer=XavierUniform())
        self.linear_bias = self.create_parameter(
            [embed_dim], attr=linear_bias_attr,
            default_initializer=Constant(0.0), is_bias=True)
        self.pre_ln_scale = self.create_parameter(
            [embed_dim], attr=pre_ln_scale_attr,
            default_initializer=Constant(1.0))
        self.pre_ln_bias = self.create_parameter(
            [embed_dim], attr=pre_ln_bias_attr,
            default_initializer=Constant(0.0), is_bias=True)
        self.ln_scale = self.create_parameter(
            [embed_dim], attr=ln_scale_attr,
            default_initializer=Constant(1.0))
        self.ln_bias = self.create_parameter(
            [embed_dim], attr=ln_bias_attr,
            default_initializer=Constant(0.0), is_bias=True)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        from ...ops import manipulation as m

        residual = query
        x = query
        if self.normalize_before:
            x = F.layer_norm(x, [self.embed_dim], self.pre_ln_scale,
                             self.pre_ln_bias, self._epsilon)
        E = self.embed_dim
        w = m.reshape(self.qkv_weight, [3 * E, E])
        qkv = IF.fused_matmul_bias(
            x, w, None if self.qkv_bias is None
            else m.reshape(self.qkv_bias, [3 * E]), transpose_y=True)
        # 0 = copy dim
        qkv = m.reshape(qkv, [0, 0, 3, self.num_heads, self.head_dim])
        q, k, v = (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.attn_dropout_rate, is_causal=False,
            training=self.training)
        out = m.reshape(out, [0, 0, E])
        out = IF.fused_matmul_bias(out, self.linear_weight, self.linear_bias)
        if self.dropout_rate:
            out = F.dropout(out, p=self.dropout_rate, training=self.training)
        out = residual + out
        if not self.normalize_before:
            out = F.layer_norm(out, [self.embed_dim], self.ln_scale,
                               self.ln_bias, self._epsilon)
        return out


class FusedFeedForward(Layer):
    """fused_transformer.py:480 — linear/act/dropout/linear with the residual
    add + layernorm folded in."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-05, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None, ln2_bias_attr=None,
                 nranks=1, ring_id=-1, name=None):
        super().__init__()
        self.d_model = d_model
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = dropout_rate if act_dropout_rate is None \
            else act_dropout_rate
        self.activation = activation
        self._epsilon = epsilon
        self.linear1 = FusedLinear(d_model, dim_feedforward,
                                   weight_attr=linear1_weight_attr,
                                   bias_attr=linear1_bias_attr)
        self.linear2 = FusedLinear(dim_feedforward, d_model,
                                   weight_attr=linear2_weight_attr,
                                   bias_attr=linear2_bias_attr)
        self.ln1_scale = self.create_parameter(
            [d_model], attr=ln1_scale_attr, default_initializer=Constant(1.0))
        self.ln1_bias = self.create_parameter(
            [d_model], attr=ln1_bias_attr, default_initializer=Constant(0.0),
            is_bias=True)
        self.ln2_scale = self.create_parameter(
            [d_model], attr=ln2_scale_attr, default_initializer=Constant(1.0))
        self.ln2_bias = self.create_parameter(
            [d_model], attr=ln2_bias_attr, default_initializer=Constant(0.0),
            is_bias=True)

    def forward(self, x):
        residual = x
        if self.normalize_before:
            x = F.layer_norm(x, [self.d_model], self.ln1_scale, self.ln1_bias,
                             self._epsilon)
        act = getattr(F, self.activation)
        h = act(self.linear1(x))
        if self.act_dropout_rate:
            h = F.dropout(h, p=self.act_dropout_rate, training=self.training)
        h = self.linear2(h)
        if self.dropout_rate:
            h = F.dropout(h, p=self.dropout_rate, training=self.training)
        out = residual + h
        if not self.normalize_before:
            out = F.layer_norm(out, [self.d_model], self.ln2_scale,
                               self.ln2_bias, self._epsilon)
        return out


class FusedTransformerEncoderLayer(Layer):
    """fused_transformer.py:666 — FusedMultiHeadAttention + FusedFeedForward."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout_rate = dropout_rate if attn_dropout_rate is None \
            else attn_dropout_rate
        # the reference's _convert_param_attr_to_list(attr, 2) contract:
        # a 2-list routes [0] to attention, [1] to the FFN; a single attr
        # applies to both
        def _pair(attr):
            if isinstance(attr, (list, tuple)):
                if len(attr) != 2:
                    raise ValueError(
                        "weight_attr/bias_attr lists must have 2 entries "
                        "(attention, ffn)")
                return attr[0], attr[1]
            return attr, attr

        w_attn, w_ffn = _pair(weight_attr)
        b_attn, b_ffn = _pair(bias_attr)
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=attn_dropout_rate,
            normalize_before=normalize_before,
            qkv_weight_attr=w_attn, qkv_bias_attr=b_attn,
            linear_weight_attr=w_attn, linear_bias_attr=b_attn)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before,
            linear1_weight_attr=w_ffn, linear1_bias_attr=b_ffn,
            linear2_weight_attr=w_ffn, linear2_bias_attr=b_ffn)

    def forward(self, src, src_mask=None, cache=None):
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))


class FusedMultiTransformer(Layer):
    """fused_transformer.py:900 — N pre-LN decoder blocks in one module (the
    reference's inference mega-kernel). Without ``caches`` the N
    ``FusedTransformerEncoderLayer``s run eagerly, one flash-attention
    forward launch a layer through sdpa with no mask and no dropout; with
    ``caches`` the stack goes through the functional
    ``fused_multi_transformer``, whose cached attention is plain torch math
    and which returns new caches."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu", normalize_before=True,
                 num_layers=1, nranks=1, ring_id=-1, name=None, **kwargs):
        super().__init__()
        if not normalize_before:
            raise NotImplementedError(
                "FusedMultiTransformer is pre-LN only (matches the reference)")
        from ...nn.layer.container import LayerList

        self.layers = LayerList([
            FusedTransformerEncoderLayer(
                embed_dim, num_heads, dim_feedforward,
                dropout_rate=dropout_rate, activation=activation,
                normalize_before=True)
            for _ in range(num_layers)])

    def forward(self, src, attn_mask=None, caches=None, time_step=None,
                **kwargs):
        if time_step is not None and caches is None:
            raise ValueError(
                "FusedMultiTransformer: time_step needs caches (the "
                "preallocated [2, B, H, max_len, D] per-layer cache list)")
        if caches is not None:
            # cached generation rides the functional's cache_kvs/time_step
            # contract (preallocated [2, B, H, max_len, D] per layer);
            # returns (out, updated_caches) like the reference layer
            lyrs = list(self.layers)
            biases = [l.fused_attn.qkv_bias for l in lyrs]
            if any(b is None for b in biases) \
                    and any(b is not None for b in biases):
                raise ValueError(
                    "FusedMultiTransformer cached forward: mixed per-layer "
                    "qkv biases (some None, some parameters) cannot be "
                    "represented by the functional's list-or-None contract")
            out, caches = IF.fused_multi_transformer(
                src,
                ln_scales=[l.fused_attn.pre_ln_scale for l in lyrs],
                ln_biases=[l.fused_attn.pre_ln_bias for l in lyrs],
                qkv_weights=[l.fused_attn.qkv_weight for l in lyrs],
                qkv_biases=(biases if all(b is not None for b in biases)
                            else None),
                linear_weights=[l.fused_attn.linear_weight for l in lyrs],
                linear_biases=[l.fused_attn.linear_bias for l in lyrs],
                ffn_ln_scales=[l.ffn.ln1_scale for l in lyrs],
                ffn_ln_biases=[l.ffn.ln1_bias for l in lyrs],
                ffn1_weights=[l.ffn.linear1.weight for l in lyrs],
                ffn1_biases=[l.ffn.linear1.bias for l in lyrs],
                ffn2_weights=[l.ffn.linear2.weight for l in lyrs],
                ffn2_biases=[l.ffn.linear2.bias for l in lyrs],
                pre_layer_norm=True, cache_kvs=caches, time_step=time_step,
                attn_mask=attn_mask, dropout_rate=0.0, training=False,
                activation=lyrs[0].ffn.activation)
            return out, caches
        out = src
        for lyr in self.layers:
            out = lyr(out, src_mask=attn_mask)
        return out


class FusedDropoutAdd(Layer):
    """incubate/nn/layer/fused_dropout_add.py: dropout(x) + y in one op."""

    def __init__(self, p=0.5, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.mode = mode

    def forward(self, x, y):
        return IF.fused_dropout_add(x, y, p=self.p, training=self.training,
                                    mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}, mode={self.mode}"


class FusedBiasDropoutResidualLayerNorm(Layer):
    """incubate/nn/layer/fused_dropout_nd.py FusedBiasDropoutResidualLayerNorm:
    ln(residual + dropout(x + bias))."""

    def __init__(self, embed_dim, dropout_rate=0.5, weight_attr=None,
                 bias_attr=None, epsilon=1e-5, name=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.dropout_rate = dropout_rate
        self._epsilon = epsilon
        self.linear_bias = self.create_parameter(
            [embed_dim], attr=bias_attr, default_initializer=Constant(0.0),
            is_bias=True)
        self.ln_scale = self.create_parameter(
            [embed_dim], attr=weight_attr, default_initializer=Constant(1.0))
        self.ln_bias = self.create_parameter(
            [embed_dim], attr=None, default_initializer=Constant(0.0),
            is_bias=True)

    def forward(self, x, residual):
        h = x + self.linear_bias
        if self.dropout_rate:
            h = F.dropout(h, p=self.dropout_rate, training=self.training)
        return F.layer_norm(residual + h, [self.embed_dim], self.ln_scale,
                            self.ln_bias, self._epsilon)

    def extra_repr(self):
        return f"embed_dim={self.embed_dim}, dropout_rate={self.dropout_rate}"

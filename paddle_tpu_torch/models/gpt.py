"""The GPT family (GPT-2/3 style): the port of paddle_tpu/models/gpt.py.

Learned position embeddings, pre-LN decoder blocks (fused QKV projection
reshaped to ``[B, S, 3, H, D]``, causal attention through the port's
``F.scaled_dot_product_attention``, a tanh-GELU MLP), a final LayerNorm and
an LM head tied to the word embeddings (``logits = h @ E^T``, nothing
registered) or a ``Linear`` of its own. The layers are the port's public
``Linear``/``Embedding``/``LayerNorm`` in the JAX layout, so a JAX
``state_dict`` loads with ``set_state_dict`` and no transpose.

On the card, a query of 128 or more rows with no attention dropout (eval, or
``attention_probs_dropout_prob=0``) runs the flash-attention kernels: the
forward, and dq and dk/dv in the backward; attention dropout in training
takes the math path, whose dropout draws from the port's generator, as do
the hidden dropouts. ``config.recompute`` checkpoints each block in training
mode through ``distributed.fleet.recompute`` (the RNG state replayed, so the
recomputed dropout masks are the forward's). ``fused_head_ce`` fuses the LM
head with the cross-entropy (``fused_linear_cross_entropy``) and returns
``(loss, None)``. Tensor, sequence and pipeline parallelism and
``recompute_policy`` raise ``NotImplementedError``: they belong to the
distributed slice.
"""
from __future__ import annotations

import torch

from .. import ops
from ..distributed.fleet.recompute import recompute
from ..incubate.nn.functional import fused_linear_cross_entropy
from ..nn import functional as F
from ..nn.initializer import Normal
from ..nn.layer.common import Dropout, Embedding, Linear
from ..nn.layer.container import LayerList
from ..nn.layer.layers import Layer
from ..nn.layer.norm import LayerNorm
from .llama import _PARALLEL_SLICE

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "GPTPretrainingCriterion"]


class GPTConfig:
    def __init__(
        self,
        vocab_size=50304,
        hidden_size=768,
        intermediate_size=None,
        num_hidden_layers=12,
        num_attention_heads=12,
        max_position_embeddings=1024,
        hidden_dropout_prob=0.1,
        attention_probs_dropout_prob=0.1,
        initializer_range=0.02,
        layer_norm_epsilon=1e-5,
        use_flash_attention=True,
        tie_word_embeddings=True,
        tensor_parallel_degree=1,
        sequence_parallel=False,
        pipeline_parallel_degree=1,
        recompute=False,
        recompute_policy=None,
        hbm_budget=None,
        **kwargs,
    ):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.max_position_embeddings = max_position_embeddings
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.initializer_range = initializer_range
        self.layer_norm_epsilon = layer_norm_epsilon
        self.use_flash_attention = use_flash_attention
        self.tie_word_embeddings = tie_word_embeddings
        self.tensor_parallel_degree = tensor_parallel_degree
        self.sequence_parallel = sequence_parallel
        self.pipeline_parallel_degree = pipeline_parallel_degree
        self.recompute = recompute
        self.recompute_policy = recompute_policy
        self.hbm_budget = hbm_budget
        for k, v in kwargs.items():
            setattr(self, k, v)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def _check_supported(config):
    """Raise for the parts of the JAX model that belong to the distributed
    slice."""
    where = _PARALLEL_SLICE
    for bad, what in (
            ((config.tensor_parallel_degree or 1) > 1, "tensor_parallel_degree > 1"),
            (config.sequence_parallel, "sequence_parallel"),
            ((getattr(config, "pipeline_parallel_degree", 1) or 1) > 1,
             "pipeline_parallel_degree > 1"),
            (getattr(config, "recompute_policy", None) not in (None, "none"),
             "recompute_policy (remat planner)")):
        if bad:
            raise NotImplementedError(f"{what} is not ported yet: it belongs to {where}")


class GPTAttention(Layer):
    def __init__(self, config: GPTConfig):
        super().__init__()
        self.config = config
        h = config.hidden_size
        init = Normal(std=config.initializer_range)
        self.qkv_proj = Linear(h, 3 * h, weight_attr=init)
        self.out_proj = Linear(h, h, weight_attr=init)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, x):
        B, S = x.shape[0], x.shape[1]
        H, D = self.config.num_attention_heads, self.config.head_dim
        q, k, v = ops.unbind(ops.reshape(self.qkv_proj(x), [B, S, 3, H, D]), axis=2)
        out = F.scaled_dot_product_attention(
            q, k, v, dropout_p=self.config.attention_probs_dropout_prob, is_causal=True,
            training=self.training)
        return self.dropout(self.out_proj(ops.reshape(out, [B, S, H * D])))


class GPTMLP(Layer):
    def __init__(self, config: GPTConfig):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        init = Normal(std=config.initializer_range)
        self.fc1 = Linear(h, m, weight_attr=init)
        self.fc2 = Linear(m, h, weight_attr=init)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, x):
        return self.dropout(self.fc2(F.gelu(self.fc1(x), approximate=True)))


class GPTDecoderLayer(Layer):
    def __init__(self, config: GPTConfig):
        super().__init__()
        self.ln_1 = LayerNorm(config.hidden_size, epsilon=config.layer_norm_epsilon)
        self.attn = GPTAttention(config)
        self.ln_2 = LayerNorm(config.hidden_size, epsilon=config.layer_norm_epsilon)
        self.mlp = GPTMLP(config)
        self._recompute = config.recompute

    def _block(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))

    def forward(self, x):
        if self._recompute and self.training:
            return recompute(self._block, x)
        return self._block(x)


class GPTEmbeddings(Layer):
    def __init__(self, config: GPTConfig):
        super().__init__()
        init = Normal(std=config.initializer_range)
        self.word_embeddings = Embedding(config.vocab_size, config.hidden_size,
                                         weight_attr=init)
        self.position_embeddings = Embedding(config.max_position_embeddings,
                                             config.hidden_size, weight_attr=init)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids):
        pos = torch.arange(input_ids.shape[-1], dtype=torch.int64, device=input_ids.device)
        return self.dropout(self.word_embeddings(input_ids) + self.position_embeddings(pos))


class GPTModel(Layer):
    def __init__(self, config: GPTConfig):
        super().__init__()
        _check_supported(config)
        self.config = config
        self.embeddings = GPTEmbeddings(config)
        self.h = LayerList([GPTDecoderLayer(config) for _ in range(config.num_hidden_layers)])
        self.ln_f = LayerNorm(config.hidden_size, epsilon=config.layer_norm_epsilon)

    def forward(self, input_ids):
        x = self.embeddings(input_ids)
        for layer in self.h:
            x = layer(x)
        return self.ln_f(x)


class GPTPretrainingCriterion(Layer):
    """The mean of ``softmax_with_cross_entropy`` over the labels that are
    not ``ignore_index`` (0 when every label is ignored)."""

    def __init__(self, config: GPTConfig, ignore_index=-100):
        super().__init__()
        self.config = config
        self.ignore_index = ignore_index

    def forward(self, logits, labels):
        tok = F.softmax_with_cross_entropy(logits, labels, ignore_index=self.ignore_index)
        tok = ops.squeeze(tok, -1) if tok.dim() > labels.dim() else tok
        return self.masked_mean(tok, labels)

    def masked_mean(self, tok, labels):
        mask = (labels != self.ignore_index).to(tok.dtype)
        denom = torch.clamp(mask.sum(), min=1.0)
        return (tok * mask).sum() / denom


class GPTForCausalLM(Layer):
    def __init__(self, config: GPTConfig):
        super().__init__()
        self.config = config
        self.gpt = GPTModel(config)
        if not config.tie_word_embeddings:
            self.lm_head = Linear(config.hidden_size, config.vocab_size,
                                  weight_attr=Normal(std=config.initializer_range),
                                  bias_attr=False)
        self.criterion = GPTPretrainingCriterion(config)

    def _head_weight(self):
        """The head in paddle's ``[hidden, vocab]`` layout."""
        if self.config.tie_word_embeddings:
            return ops.transpose(self.gpt.embeddings.word_embeddings.weight, [1, 0])
        return self.lm_head.weight

    def forward(self, input_ids, labels=None):
        """Logits; with ``labels``, ``(loss, logits)``, or ``(loss, None)``
        under ``config.fused_head_ce``."""
        h = self.gpt(input_ids)
        if labels is not None and getattr(self.config, "fused_head_ce", False):
            if labels.dim() == 3:
                labels = ops.squeeze(labels, -1)
            tok = fused_linear_cross_entropy(h, self._head_weight(), labels,
                                             ignore_index=self.criterion.ignore_index)
            return self.criterion.masked_mean(tok, labels), None
        if self.config.tie_word_embeddings:
            logits = ops.matmul(h, self._head_weight())
        else:
            logits = self.lm_head(h)
        if labels is not None:
            return self.criterion(logits, labels), logits
        return logits

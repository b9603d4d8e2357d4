"""The BERT / ERNIE encoder family: the port of paddle_tpu/models/bert.py.

Word + position + token-type (+ ERNIE's task-type) embeddings, a LayerNorm
and dropout; post-LN encoder blocks (``BertSelfAttention`` through the port's
``F.scaled_dot_product_attention``, exact GELU) registered as ``layer_{i}``;
a tanh pooler over the first token; the pretraining heads (a GELU transform,
a LayerNorm, the vocabulary decoder tied to the word embeddings, the NSP
classifier) and ``BertPretrainingCriterion`` (the MLM mean over labels that
are not -100, plus the NSP cross-entropy). The layers are the port's public
``Linear``/``Embedding``/``LayerNorm`` in the JAX layout, so a JAX
``state_dict`` loads with ``set_state_dict`` and no transpose.

The tied decoder weight is not in the ``state_dict``, as in the JAX package
(30 keys at one layer, in the JAX order): the heads keep the embedding layer
outside their registered sublayers and read its weight in ``forward``, so
one tensor serves both and ``decoder_weight`` is that tensor.

A 2-D ``attention_mask`` becomes the additive float32 ``[B, 1, 1, S]`` bias
``(1 - mask) * -1e4``. On the card an unmasked attention of 128 or more
query rows with no dropout (eval, or ``attention_probs_dropout_prob=0``)
runs the flash-attention kernels; a mask or attention dropout takes the math
path, as the JAX routing does. Tensor and sequence parallelism raise
``NotImplementedError``: they belong to the distributed slice.
"""
from __future__ import annotations

import torch

from .. import ops
from ..nn import functional as F
from ..nn.initializer import Normal
from ..nn.layer.common import Dropout, Embedding, Linear
from ..nn.layer.layers import Layer
from ..nn.layer.norm import LayerNorm
from .llama import _PARALLEL_SLICE

__all__ = ["BertConfig", "BertModel", "BertForPretraining", "BertPretrainingCriterion",
           "ErnieConfig", "ErnieModel", "ErnieForPretraining"]


class BertConfig:
    """Plain config object (bert-base defaults)."""

    def __init__(
        self,
        vocab_size=30522,
        hidden_size=768,
        num_hidden_layers=12,
        num_attention_heads=12,
        intermediate_size=3072,
        max_position_embeddings=512,
        type_vocab_size=2,
        task_type_vocab_size=0,  # > 0: ERNIE-style task embeddings
        hidden_dropout_prob=0.1,
        attention_probs_dropout_prob=0.1,
        initializer_range=0.02,
        layer_norm_eps=1e-12,
        tensor_parallel_degree=1,
        sequence_parallel=False,
        use_flash_attention=True,
        dtype="float32",
        **kwargs,
    ):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.task_type_vocab_size = task_type_vocab_size
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.initializer_range = initializer_range
        self.layer_norm_eps = layer_norm_eps
        self.tensor_parallel_degree = tensor_parallel_degree
        self.sequence_parallel = sequence_parallel
        self.use_flash_attention = use_flash_attention
        self.head_dim = hidden_size // num_attention_heads
        self.dtype = dtype
        for k, v in kwargs.items():
            setattr(self, k, v)


def _check_supported(config):
    where = _PARALLEL_SLICE
    for bad, what in (((config.tensor_parallel_degree or 1) > 1, "tensor_parallel_degree > 1"),
                      (config.sequence_parallel, "sequence_parallel")):
        if bad:
            raise NotImplementedError(f"{what} is not ported yet: it belongs to {where}")


class BertEmbeddings(Layer):
    """word + position + token_type (+ task_type for ERNIE) + LN + dropout."""

    def __init__(self, config: BertConfig):
        super().__init__()
        init = Normal(std=config.initializer_range)
        h = config.hidden_size
        self.word_embeddings = Embedding(config.vocab_size, h, weight_attr=init)
        self.position_embeddings = Embedding(config.max_position_embeddings, h,
                                             weight_attr=init)
        self.token_type_embeddings = Embedding(config.type_vocab_size, h, weight_attr=init)
        self.task_type_embeddings = (
            Embedding(config.task_type_vocab_size, h, weight_attr=init)
            if config.task_type_vocab_size > 0 else None)
        self.layer_norm = LayerNorm(h, epsilon=config.layer_norm_eps)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None, task_type_ids=None):
        B, S = input_ids.shape
        dev = input_ids.device
        if position_ids is None:
            position_ids = torch.arange(S, dtype=torch.int64, device=dev).expand(B, S)
        if token_type_ids is None:
            token_type_ids = torch.zeros(B, S, dtype=torch.int64, device=dev)
        x = (self.word_embeddings(input_ids) + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        if self.task_type_embeddings is not None:
            if task_type_ids is None:
                task_type_ids = torch.zeros(B, S, dtype=torch.int64, device=dev)
            x = x + self.task_type_embeddings(task_type_ids)
        return self.dropout(self.layer_norm(x))


class BertSelfAttention(Layer):
    def __init__(self, config: BertConfig):
        super().__init__()
        self.num_heads = config.num_attention_heads
        self.head_dim = config.head_dim
        h = config.hidden_size
        init = Normal(std=config.initializer_range)
        self.q_proj = Linear(h, h, weight_attr=init)
        self.k_proj = Linear(h, h, weight_attr=init)
        self.v_proj = Linear(h, h, weight_attr=init)
        self.out_proj = Linear(h, h, weight_attr=init)
        self.dropout_p = config.attention_probs_dropout_prob

    def forward(self, x, attn_mask=None):
        B, S = x.shape[0], x.shape[1]
        shape = [B, S, self.num_heads, self.head_dim]
        q = ops.reshape(self.q_proj(x), shape)
        k = ops.reshape(self.k_proj(x), shape)
        v = ops.reshape(self.v_proj(x), shape)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask, is_causal=False,
                                             dropout_p=self.dropout_p, training=self.training)
        return self.out_proj(ops.reshape(out, [B, S, self.num_heads * self.head_dim]))


class BertLayer(Layer):
    """Post-LN encoder block (the original BERT residual placement)."""

    def __init__(self, config: BertConfig):
        super().__init__()
        init = Normal(std=config.initializer_range)
        h, inter = config.hidden_size, config.intermediate_size
        self.attention = BertSelfAttention(config)
        self.attn_norm = LayerNorm(h, epsilon=config.layer_norm_eps)
        self.ffn_in = Linear(h, inter, weight_attr=init)
        self.ffn_out = Linear(inter, h, weight_attr=init)
        self.ffn_norm = LayerNorm(h, epsilon=config.layer_norm_eps)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, x, attn_mask=None):
        x = self.attn_norm(x + self.dropout(self.attention(x, attn_mask)))
        y = self.ffn_out(F.gelu(self.ffn_in(x)))
        return self.ffn_norm(x + self.dropout(y))


class BertPooler(Layer):
    def __init__(self, config: BertConfig):
        super().__init__()
        self.dense = Linear(config.hidden_size, config.hidden_size,
                            weight_attr=Normal(std=config.initializer_range))

    def forward(self, hidden_states):
        return torch.tanh(self.dense(hidden_states[:, 0]))


class BertModel(Layer):
    """Encoder: embeddings -> N BertLayers -> pooled first token."""

    def __init__(self, config: BertConfig):
        super().__init__()
        _check_supported(config)
        self.config = config
        self.embeddings = BertEmbeddings(config)
        self.layers = [BertLayer(config) for _ in range(config.num_hidden_layers)]
        for i, layer in enumerate(self.layers):
            self.add_sublayer(f"layer_{i}", layer)
        self.pooler = BertPooler(config)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                position_ids=None, task_type_ids=None):
        if attention_mask is not None and attention_mask.dim() == 2:
            # (B, S) padding mask -> additive (B, 1, 1, S) bias
            neg = (1.0 - attention_mask.to(torch.float32)) * -1e4
            attention_mask = neg[:, None, None, :]
        x = self.embeddings(input_ids, token_type_ids, position_ids, task_type_ids)
        for layer in self.layers:
            x = layer(x, attention_mask)
        return x, self.pooler(x)


class BertPretrainingHeads(Layer):
    """MLM transform + vocabulary decoder (tied) + NSP classifier.
    ``embedding_weights`` is the word-embedding layer, read in ``forward``
    (or, as in JAX, its weight tensor itself); it is kept outside the
    registered sublayers, so the ``state_dict`` holds it once, under the
    embeddings."""

    def __init__(self, config: BertConfig, embedding_weights):
        super().__init__()
        init = Normal(std=config.initializer_range)
        self.transform = Linear(config.hidden_size, config.hidden_size, weight_attr=init)
        self.transform_norm = LayerNorm(config.hidden_size, epsilon=config.layer_norm_eps)
        self._tied = [embedding_weights]  # a list: not a registered sublayer
        self.decoder_bias = self.create_parameter([config.vocab_size], is_bias=True)
        self.seq_relationship = Linear(config.hidden_size, 2, weight_attr=init)

    @property
    def decoder_weight(self):
        """The tied (vocab, hidden) weight."""
        tied = self._tied[0]
        return tied if isinstance(tied, torch.Tensor) else tied.weight

    def forward(self, sequence_output, pooled_output):
        x = self.transform_norm(F.gelu(self.transform(sequence_output)))
        logits = ops.matmul(x, self.decoder_weight, transpose_y=True) + self.decoder_bias
        return logits, self.seq_relationship(pooled_output)


class BertForPretraining(Layer):
    def __init__(self, config: BertConfig):
        super().__init__()
        self.config = config
        self.bert = BertModel(config)
        self.cls = BertPretrainingHeads(config, self.bert.embeddings.word_embeddings)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None, position_ids=None,
                task_type_ids=None):
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask, position_ids,
                                task_type_ids)
        return self.cls(seq, pooled)


class BertPretrainingCriterion(Layer):
    """The masked-LM cross-entropy over labels that are not -100, plus the
    NSP cross-entropy when ``next_sentence_labels`` is given."""

    def __init__(self, vocab_size):
        super().__init__()
        self.vocab_size = vocab_size

    def forward(self, prediction_scores, seq_relationship_score, masked_lm_labels,
                next_sentence_labels=None):
        logits = ops.reshape(prediction_scores, [-1, self.vocab_size])
        labels = ops.reshape(masked_lm_labels, [-1])
        kept = labels != -100
        mask = kept.to(torch.float32)
        per_tok = F.cross_entropy(logits, torch.where(kept, labels, 0), reduction="none")
        mlm = (ops.reshape(per_tok, [-1]) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        if next_sentence_labels is None:
            return mlm
        return mlm + F.cross_entropy(seq_relationship_score,
                                     ops.reshape(next_sentence_labels, [-1]))


# -- ERNIE: the same encoder with task-type embeddings ------------------------
class ErnieConfig(BertConfig):
    def __init__(self, task_type_vocab_size=3, **kwargs):
        super().__init__(task_type_vocab_size=task_type_vocab_size, **kwargs)


class ErnieModel(BertModel):
    """ERNIE-3.0-style encoder (BertModel + a task-type embedding table)."""

    def __init__(self, config=None, **kwargs):
        super().__init__(config or ErnieConfig(**kwargs))


class ErnieForPretraining(BertForPretraining):
    def __init__(self, config=None, **kwargs):
        super().__init__(config or ErnieConfig(**kwargs))

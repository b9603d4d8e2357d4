"""LLaMA for serving and training: the port of paddle_tpu/models/llama.py
(single device).

RMSNorm + rotary GQA attention + SwiGLU MLP decoder blocks, a final RMSNorm
and a causal-LM head with optional weight tying. Attention goes through
``F.scaled_dot_product_attention``, which runs the hand-written Hopper
flash-attention kernel for prompt-length queries on the card.

Every step of the forward is one of the port's ops under the JAX op's name
(``embedding_op``, ``rms_norm``, ``linear``, ``reshape``,
``fused_rotary_position_embedding``, ``flash_attention``, ``add``,
``swiglu``, ``matmul``, ``cross_entropy`` and the criterion's ``unsqueeze``,
``squeeze``, ``not_equal``, ``cast``, ``sum``, ``maximum``, ``multiply``,
``divide``), as in the JAX model, so ``amp.auto_cast`` casts each where the
JAX dispatch casts it and the operator stats of the two models agree.

Differences from the JAX module, by design:
  * Linear layers are the port's ``nn.Linear`` (torch's, weight (out, in),
    y = x @ W^T, through the ``linear`` op); paddle stores (in, out).
    ``models/convert.py`` transposes on transfer.
  * The untied LM head stores its weight as (vocab, hidden), the layout of
    the tied embedding, so both heads are one ``F.linear``.
  * Initialisation draws from a ``torch.Generator`` seeded by ``seed``; it
    can never match JAX's threefry bits, so parity goes through the converter.
  * Every parameter is a ``framework.Parameter`` named ``param_{N}`` when it
    is built, as the JAX package names its parameters, so ``AdamW``'s
    ``apply_decay_param_fun`` gets the names it gets there.
Training: ``loss, logits = model(ids, labels=labels)`` (the token-mean
cross-entropy of ``LlamaPretrainingCriterion``), ``loss.backward()``, with
per-layer recompute (``config.recompute``) in training mode
(``model.train()``; a new model is in eval mode): granularity ``"full"``
keeps only each layer's input, ``"full_attn"`` and ``"core_attn"`` keep the
outputs of the matrix products without batch dimensions as well (the JAX
model's ``dots_with_no_batch_dims_saveable``). ``config.fused_head_ce``
fuses the LM head with the cross-entropy over sequence chunks and returns
``(loss, None)``. Attention's backward runs the Hopper flash-attention
backward kernels on the card. Tensor/sequence/pipeline parallelism, MoE,
ring attention and the budget remat planner wait for the distributed slice
(ROADMAP Queue A item 10) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import ops, resolve_device
from ..distributed.fleet.recompute import recompute
from ..framework import Parameter
from ..incubate.nn.functional import (_rotate_half, fused_linear_cross_entropy,
                                     fused_rotary_position_embedding)
from ..nn import functional as F
from ..nn.layer.common import Embedding, Linear
from ..nn.layer.norm import RMSNorm

_PARALLEL_SLICE = "the distributed slice of the port (ROADMAP Queue A item 10)"


class LlamaConfig:
    """Plain config object (PaddleNLP LlamaConfig field names)."""

    def __init__(
        self,
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=11008,
        num_hidden_layers=32,
        num_attention_heads=32,
        num_key_value_heads=None,
        max_position_embeddings=4096,
        initializer_range=0.02,
        rms_norm_eps=1e-6,
        rope_theta=10000.0,
        use_flash_attention=True,
        tie_word_embeddings=False,
        num_experts=0,
        moe_topk=2,
        moe_gate="gshard",
        moe_every_k=1,
        tensor_parallel_degree=1,
        sequence_parallel=False,
        pipeline_parallel_degree=1,
        recompute=False,
        recompute_granularity="full",
        recompute_policy=None,
        hbm_budget=None,
        fused_head_ce=False,
        dtype="float32",
        **kwargs,
    ):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.num_key_value_heads = num_key_value_heads or num_attention_heads
        self.max_position_embeddings = max_position_embeddings
        self.initializer_range = initializer_range
        self.rms_norm_eps = rms_norm_eps
        self.rope_theta = rope_theta
        self.use_flash_attention = use_flash_attention
        self.tie_word_embeddings = tie_word_embeddings
        self.num_experts = num_experts
        self.moe_topk = moe_topk
        self.moe_gate = moe_gate
        self.moe_every_k = moe_every_k
        self.tensor_parallel_degree = tensor_parallel_degree
        self.sequence_parallel = sequence_parallel
        self.pipeline_parallel_degree = pipeline_parallel_degree
        self.recompute = recompute
        self.recompute_granularity = recompute_granularity
        self.recompute_policy = recompute_policy
        self.hbm_budget = hbm_budget
        self.fused_head_ce = fused_head_ce
        self.dtype = dtype
        for k, v in kwargs.items():
            setattr(self, k, v)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


@ops.fuse(static_argnums=(0, 1, 2, 3, 4))
def _rope_cos_sin(seq_len, head_dim, theta, dtype, device):
    """The JAX model's rotary cos/sin tables (``paddle_tpu/models/llama.py``
    ``_rope_cos_sin``), each (seq_len, head_dim) in ``dtype``: one compiled
    region per (seq_len, head_dim, theta, dtype, device), as the JAX model
    builds them in one ``fuse``d region. The port's attention builds its
    tables in ``incubate.nn.functional`` (``_rope_tables``); this is the JAX
    function for code that calls it."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=device) / head_dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)            # (S, D/2)
    emb = torch.cat([freqs, freqs], -1)       # (S, D)
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def _check_supported(config):
    """Raise for the parts of the JAX model this slice does not port."""
    unported = [
        (config.tensor_parallel_degree > 1, "tensor_parallel_degree > 1", _PARALLEL_SLICE),
        (config.sequence_parallel, "sequence_parallel", _PARALLEL_SLICE),
        ((config.pipeline_parallel_degree or 1) > 1, "pipeline_parallel_degree > 1",
         _PARALLEL_SLICE),
        ((config.num_experts or 0) > 1, "MoE (num_experts > 1)", _PARALLEL_SLICE),
        (getattr(config, "use_ring_attention", False), "ring attention", _PARALLEL_SLICE),
        (config.recompute_policy not in (None, "none"), "recompute_policy (remat planner)",
         _PARALLEL_SLICE),
    ]
    for bad, what, where in unported:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet: it belongs to {where}")


def apply_rotary_pos_emb(q, k, cos, sin):
    """q,k: (B, S, H, D); cos/sin: (S, D) broadcast over batch and heads."""
    cos = cos[None, :, None, :]
    sin = sin[None, :, None, :]
    return q * cos + _rotate_half(q) * sin, k * cos + _rotate_half(k) * sin


class LlamaAttention(nn.Module):
    """Multi-head attention with rotary embeddings and grouped KV heads."""

    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = config.head_dim
        h = config.hidden_size
        kv = self.num_kv_heads * self.head_dim
        kw = dict(bias=False, device=device, dtype=dtype)
        self.q_proj = Linear(h, h, **kw)
        self.k_proj = Linear(h, kv, **kw)
        self.v_proj = Linear(h, kv, **kw)
        self.o_proj = Linear(h, h, **kw)

    def forward(self, hidden_states, attn_mask=None):
        B, S = hidden_states.shape[:2]
        q = ops.reshape(self.q_proj(hidden_states), [B, S, self.num_heads, self.head_dim])
        k = ops.reshape(self.k_proj(hidden_states), [B, S, self.num_kv_heads, self.head_dim])
        v = ops.reshape(self.v_proj(hidden_states), [B, S, self.num_kv_heads, self.head_dim])
        # use_neox_rotary_style=False = rotate-half pairing, as the JAX model
        q, k, _ = fused_rotary_position_embedding(
            q, k, rotary_theta=self.config.rope_theta, use_neox_rotary_style=False)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, is_causal=attn_mask is None,
            training=self.training)
        return self.o_proj(ops.reshape(out, [B, S, self.num_heads * self.head_dim]))


class LlamaMLP(nn.Module):
    """SwiGLU feed-forward: down(silu(gate(x)) * up(x))."""

    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        kw = dict(bias=False, device=device, dtype=dtype)
        self.gate_proj = Linear(h, m, **kw)
        self.up_proj = Linear(h, m, **kw)
        self.down_proj = Linear(m, h, **kw)

    def forward(self, x):
        return self.down_proj(F.swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.self_attn = LlamaAttention(config, device, dtype)
        self.mlp = LlamaMLP(config, device, dtype)
        self.input_layernorm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                                       device, dtype)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps, device, dtype)
        self._recompute = config.recompute
        # "full_attn"/"core_attn" keep the products' outputs and recompute
        # the rest, as the JAX model maps them onto an XLA remat policy
        gran = config.recompute_granularity or "full"
        self._recompute_policy = (None if gran == "full"
                                  else "dots_with_no_batch_dims_saveable")

    def _block(self, hidden_states, attn_mask=None):
        h = ops.add(hidden_states,
                    self.self_attn(self.input_layernorm(hidden_states), attn_mask))
        return ops.add(h, self.mlp(self.post_attention_layernorm(h)))

    def forward(self, hidden_states, attn_mask=None):
        if self._recompute and self.training:
            return recompute(self._block, hidden_states, attn_mask,
                             checkpoint_policy=self._recompute_policy)
        return self._block(hidden_states, attn_mask)


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, device, dtype)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, device, dtype)

    def forward(self, input_ids, attn_mask=None):
        h = self.embed_tokens(input_ids)
        for layer in self.layers:
            h = layer(h, attn_mask)
        return self.norm(h)


class LlamaLMHead(nn.Module):
    """logits = h @ W with W (hidden, vocab) in paddle's layout; stored here
    as (vocab, hidden), or the tied embedding itself."""

    #: paddle's layout of ``weight`` is its transpose (``utils/weights.py``)
    _transposed_weight = True

    def __init__(self, config: LlamaConfig, embedding=None, device=None, dtype=None):
        super().__init__()
        self._tied = bool(config.tie_word_embeddings and embedding is not None)
        if self._tied:
            self._embedding = [embedding]  # list: not a registered submodule
        else:
            self.weight = Parameter(torch.empty(
                config.vocab_size, config.hidden_size, device=device, dtype=dtype))

    def forward(self, hidden_states):
        w = self._embedding[0].weight if self._tied else self.weight
        return ops.matmul(hidden_states, w, transpose_y=True)


class LlamaPretrainingCriterion(nn.Module):
    """Token-mean causal-LM loss with ``ignore_index`` masking. Like the JAX
    criterion it works in the logits' dtype and does not shift the labels:
    ``labels[b, s]`` is the target of ``logits[b, s]``."""

    def __init__(self, config: LlamaConfig, ignore_index=-100):
        super().__init__()
        self.config = config
        self.ignore_index = ignore_index

    def forward(self, logits, labels):
        tok_loss = F.softmax_with_cross_entropy(logits, labels,
                                                ignore_index=self.ignore_index)
        if tok_loss.dim() > labels.dim():
            tok_loss = ops.squeeze(tok_loss, -1)
        return self.masked_mean(tok_loss, labels)

    def masked_mean(self, tok_loss, labels):
        """Mean over the positions whose label is not ``ignore_index``."""
        mask = ops.cast(ops.not_equal(labels, self.ignore_index), tok_loss.dtype)
        one = torch.ones((), dtype=tok_loss.dtype, device=tok_loss.device)
        denom = ops.maximum(ops.sum(mask), one)
        return ops.divide(ops.sum(ops.multiply(tok_loss, mask)), denom)


class LlamaForCausalLM(nn.Module):
    """The causal LM, for serving and training. ``device`` defaults to CUDA
    and raises where there is no card; pass ``device="cpu"`` for the CPU.
    ``config.dtype`` sets the parameter dtype (``"bfloat16"`` for the
    flagship); weights are drawn from N(0, initializer_range) with a
    generator seeded by ``seed`` (norms 1). A new model is in eval mode; call
    ``train()`` before training (recompute runs only in training mode)."""

    def __init__(self, config: LlamaConfig, device=None, seed=0):
        super().__init__()
        _check_supported(config)
        device = resolve_device(device)
        dtype = getattr(torch, config.dtype) if isinstance(config.dtype, str) else config.dtype
        self.config = config
        self.llama = LlamaModel(config, device, dtype)
        self.lm_head = LlamaLMHead(
            config, self.llama.embed_tokens if config.tie_word_embeddings else None,
            device, dtype)
        self.criterion = LlamaPretrainingCriterion(config)
        self._init_weights(seed)
        self.eval()

    @torch.no_grad()
    def _init_weights(self, seed):
        gen = torch.Generator(device=self.llama.embed_tokens.weight.device)
        gen.manual_seed(seed)
        std = self.config.initializer_range
        for name, p in self.named_parameters():
            if not name.endswith("layernorm.weight") and name != "llama.norm.weight":
                p.normal_(0.0, std, generator=gen)

    @property
    def device(self):
        return self.llama.embed_tokens.weight.device

    def forward(self, input_ids, labels=None, attn_mask=None):
        """Logits; with ``labels``, ``(loss, logits)``, or ``(loss, None)``
        under ``config.fused_head_ce``, which never builds the [B, S, V]
        logits (``fused_linear_cross_entropy``: an fp32 per-token loss)."""
        h = self.llama(input_ids, attn_mask)
        if labels is not None and self.config.fused_head_ce:
            head = self.lm_head
            # paddle's (hidden, vocab) layout: both heads store (vocab, hidden)
            w = (head._embedding[0].weight if head._tied else head.weight).t()
            if labels.dim() == 3:  # the reference's [B, S, 1] labels
                labels = ops.squeeze(labels, -1)
            tok_loss = fused_linear_cross_entropy(
                h, w, labels, ignore_index=self.criterion.ignore_index)
            return self.criterion.masked_mean(tok_loss, labels), None
        logits = self.lm_head(h)
        if labels is None:
            return logits
        return self.criterion(logits, labels), logits

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32, temperature=0.0, generator=None):
        """Greedy / temperature sampling, recomputing the prefix each step.

        (The KV-cache decode path is LlamaDecodeEngine's job; this is the
        correctness-oriented generate.) Returns prompt + new tokens.
        """
        out = torch.as_tensor(input_ids, device=self.device).long()
        for _ in range(max_new_tokens):
            nxt = self.forward(out)[:, -1, :]
            if temperature and temperature > 0.0:
                probs = torch.softmax(nxt / temperature, dim=-1)
                tok = torch.multinomial(probs.float(), 1, generator=generator)
            else:
                tok = torch.argmax(nxt, dim=-1, keepdim=True)
            out = torch.cat([out, tok.to(out.dtype)], dim=1)
        return out

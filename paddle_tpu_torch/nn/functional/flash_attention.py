"""Attention functionals: scaled_dot_product_attention.

Counterpart of paddle_tpu/nn/functional/flash_attention.py. The hot path is
the hand-written Hopper flash-attention kernel (ops/cuda/flash_attention.py),
differentiable through its backward kernels; the math path is the plain
PyTorch attention used on the CPU, for short queries, masks and dropout. Layout is paddle's (batch, seq, num_heads,
head_dim).
"""
from __future__ import annotations

import math

import torch

from ...ops.cuda.flash_attention import FlashShapeError, flash_attention_fwd


def _math_sdpa(q, k, v, attn_mask=None, causal=False, dropout_p=0.0, scale=None,
               generator=None):
    # (B, S, H, D) -> (B, H, S, D)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    # GQA: kv heads may be fewer
    hq, hk = qt.shape[1], kt.shape[1]
    if hq != hk:
        rep = hq // hk
        kt = kt.repeat_interleave(rep, dim=1)
        vt = vt.repeat_interleave(rep, dim=1)
    logits = (qt @ kt.transpose(-1, -2)) * s
    # -1e30 in the logits' dtype: -inf in float16, as in JAX
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(sk - sq)
        logits = torch.where(mask, logits, -1e30)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = torch.where(attn_mask, logits, -1e30)
        else:
            logits = logits + attn_mask.to(logits.dtype)
    # promote, don't demote: bf16 -> f32 for stability, f64 stays f64
    ct = torch.promote_types(qt.dtype, torch.float32)
    probs = torch.softmax(logits.to(ct), dim=-1).to(qt.dtype)
    if dropout_p > 0.0:
        keep = torch.rand(probs.shape, generator=generator, device=probs.device,
                          dtype=torch.float32) >= dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p), 0.0)
    out = probs @ vt
    return out.transpose(1, 2)


def _use_kernel(q):
    return q.is_cuda and q.shape[1] >= 128


def _sdpa(q, k, v, attn_mask=None, dropout_p=0.0, causal=False, scale=None,
          use_kernel=False, generator=None):
    if use_kernel and attn_mask is None and dropout_p == 0.0:
        try:
            return flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        except FlashShapeError:
            # documented fallback contract: unsupported shapes -> math path.
            # build and launch errors surface: they must not silently
            # degrade to O(S^2) attention
            pass
    return _math_sdpa(q, k, v, attn_mask, causal, dropout_p, scale, generator)


def scaled_dot_product_attention(query, key, value, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, training=True, generator=None):
    """paddle.nn.functional.scaled_dot_product_attention on (B, S, H, D)
    tensors. A CUDA query of 128 or more rows with no mask and no dropout
    runs the flash-attention kernel; everything else the math path."""
    p = float(dropout_p) if training else 0.0
    return _sdpa(query, key, value, attn_mask, p, causal=bool(is_causal),
                 use_kernel=_use_kernel(query), generator=generator)

"""Attention functionals: scaled_dot_product_attention, flash_attention,
flash_attn_unpadded (with the segment-masked ``_varlen``) and sdp_kernel.

Counterpart of paddle_tpu/nn/functional/flash_attention.py. The hot path is
the hand-written Hopper flash-attention kernel (ops/cuda/flash_attention.py),
differentiable through its backward kernels; the math path is the plain
PyTorch attention used on the CPU, for short queries, masks and dropout.
``_varlen`` is plain torch, as it is an XLA einsum in the JAX package. Layout
is paddle's (batch, seq, num_heads, head_dim). ``_sdpa`` is the op
``flash_attention`` and ``_varlen`` the op ``flash_attn_varlen``, both
white-listed under AMP, so inside ``auto_cast`` q, k and v reach the kernel
in the low dtype.
"""
from __future__ import annotations

import contextlib
import math

import torch

from ...ops._apply import defop
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


@defop("flash_attention", amp_category="white")
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


def flash_attention(query, key, value, dropout=0.0, causal=False, return_softmax=False,
                    fixed_seed_offset=None, rng_name="", training=True, name=None):
    """paddle.nn.functional.flash_attention: ``(out, None)`` through
    ``scaled_dot_product_attention`` (the softmax is never returned, as in the
    JAX package), so a CUDA query of 128 or more rows reaches the kernel."""
    return scaled_dot_product_attention(query, key, value, None, dropout, causal,
                                        training), None


@defop("flash_attn_varlen", amp_category="white")
def _varlen(q, k, v, seg_q, seg_k, scale=None, causal=False):
    """Segment-masked attention over packed (total, H, D) rows: the JAX
    package's arithmetic (logits in q's dtype, -1e30 outside the segment and,
    when causal, above the diagonal of the packed positions, the softmax in
    ``promote_types(dtype, float32)``, probabilities cast back to q's dtype
    before the product with V)."""
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("qhd,khd->hqk", q, k) * s
    mask = seg_q[:, None] == seg_k[None, :]
    if causal:
        mask = mask & (torch.arange(q.shape[0], device=q.device)[:, None]
                       >= torch.arange(k.shape[0], device=q.device)[None, :])
    logits = torch.where(mask[None], logits, -1e30)
    ct = torch.promote_types(q.dtype, torch.float32)
    probs = torch.softmax(logits.to(ct), -1).to(q.dtype)
    return torch.einsum("hqk,khd->qhd", probs, v)


def _segment_ids(cu_seqlens, total, device):
    """Segment id of each of ``total`` packed rows from the cumulative
    lengths, as the JAX package builds it: ones scattered at the inner
    boundaries (an index past the rows is dropped, as JAX's scatter drops
    it), then a running sum."""
    cu = torch.as_tensor(cu_seqlens, device=device).reshape(-1).long()[1:-1]
    cu = cu[(cu >= 0) & (cu < total)]
    marks = torch.zeros(total, dtype=torch.int32, device=device)
    marks.index_add_(0, cu, torch.ones_like(cu, dtype=torch.int32))
    return torch.cumsum(marks, 0, dtype=torch.int32)


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                        max_seqlen_k, scale=None, dropout=0.0, causal=False,
                        return_softmax=False, fixed_seed_offset=None, rng_name="",
                        training=True, name=None):
    """Varlen attention: ragged batches packed as one (total, H, D) sequence,
    computed by segment-masked attention (``_varlen``, static shapes, as in
    the JAX package; dropout is not applied there either). Returns
    ``(out, None)``."""
    seg_q = _segment_ids(cu_seqlens_q, query.shape[0], query.device)
    seg_k = _segment_ids(cu_seqlens_k, key.shape[0], query.device)
    return _varlen(query, key, value, seg_q, seg_k, scale=scale, causal=bool(causal)), None


def sdp_kernel(*args, **kwargs):
    """A context manager that changes nothing, as in the JAX package: the
    port chooses between its kernel and the math path itself and never calls
    torch's ``scaled_dot_product_attention``, so torch's backend switches are
    left alone."""
    return contextlib.nullcontext()

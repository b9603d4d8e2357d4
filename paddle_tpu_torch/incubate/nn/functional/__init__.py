"""Fused functionals (counterpart of paddle_tpu/incubate/nn/functional).

Only the rotate-half rotary pairing (``use_neox_rotary_style=False``), which
the LLaMA model uses, is ported so far; the interleaved rotate-every-two
pairing raises ``NotImplementedError``.
"""
from __future__ import annotations

import torch


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _rope_tables(seq_len, head_dim, theta, dtype, device, position_ids=None):
    """Rotate-half cos/sin tables: computed in float32, cast to ``dtype``
    before they multiply the activations (the JAX package's order)."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=device) / head_dim))
    if position_ids is None:
        t = torch.arange(seq_len, dtype=torch.float32, device=device)
    else:
        t = position_ids.to(device=device, dtype=torch.float32)
    freqs = t[..., None] * inv_freq                          # (..., S, D/2)
    emb = torch.cat([freqs, freqs], dim=-1)                  # [f0..f_{D/2-1}, f0..]
    return emb.cos().to(dtype), emb.sin().to(dtype)


def _normalize_rope_table(tbl):
    """Accept (S,D), (B,S,D), (1,S,1,D)/(B,S,1,D) layouts -> (S,D) or (B,S,D)."""
    if tbl.dim() == 4:                                       # (B,S,1,D) head axis
        tbl = tbl.reshape(tbl.shape[0], tbl.shape[1], tbl.shape[3])
    if tbl.dim() == 3 and tbl.shape[0] == 1:
        tbl = tbl[0]
    return tbl


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None, use_neox_rotary_style=True,
                                    rotary_theta=10000.0):
    """Rotary embedding of every given (B, S, H, D) input; a None input gives
    None in its own slot. ``use_neox_rotary_style=False`` is the rotate-half
    pairing (the reference kernel's dispatch, not the usual HF naming)."""
    if use_neox_rotary_style:
        raise NotImplementedError(
            "the rotate-every-two rotary pairing (use_neox_rotary_style=True) "
            "is not ported yet; paddle_tpu_torch has rotate-half only")
    S, D = q.shape[1], q.shape[-1]
    if cos is None or sin is None:
        cos, sin = _rope_tables(S, D, rotary_theta, q.dtype, q.device, position_ids)
    else:
        cos = _normalize_rope_table(cos)
        sin = _normalize_rope_table(sin)
    if cos.dim() == 2:                                       # (S,D) over batch/heads
        cos_b, sin_b = cos[None, :, None, :], sin[None, :, None, :]
    else:                                                    # (B,S,D) from position_ids
        cos_b, sin_b = cos[:, :, None, :], sin[:, :, None, :]
    return tuple(None if x is None else x * cos_b + _rotate_half(x) * sin_b
                 for x in (q, k, v))

"""Packed flash-attention wrappers (counterpart of the two in
paddle_tpu/nn/functional/extras.py; the rest of that file is not ported)."""
from __future__ import annotations

from .flash_attention import flash_attention, flash_attn_unpadded


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False, return_softmax=False,
                         training=True, name=None):
    """(B, S, 3, H, D) packed q, k, v through ``flash_attention``."""
    return flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], dropout=dropout,
                           causal=causal, return_softmax=return_softmax, training=training)


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens, max_seqlen, scale=None, dropout=0.0,
                                causal=False, return_softmax=False, training=True,
                                name=None):
    """(total, 3, H, D) packed ragged batches through ``flash_attn_unpadded``."""
    return flash_attn_unpadded(qkv[:, 0], qkv[:, 1], qkv[:, 2], cu_seqlens, cu_seqlens,
                               max_seqlen, max_seqlen, scale=scale, dropout=dropout,
                               causal=causal, return_softmax=return_softmax,
                               training=training)

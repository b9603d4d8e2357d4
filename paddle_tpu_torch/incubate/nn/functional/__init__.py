"""Fused functionals (counterpart of paddle_tpu/incubate/nn/functional).

Ported so far: ``fused_rotary_position_embedding`` with both pairings (the
interleaved rotate-every-two of ``use_neox_rotary_style=True``, the default,
and the rotate-half of ``False``, which the LLaMA model uses),
``block_multihead_attention`` over the paged KV pool, and the fused LM-head
cross-entropy (``fused_linear_cross_entropy``). The rotary embedding is the
op ``fused_rotary_position_embedding`` (white-listed under AMP) and the
fused cross-entropy the op ``fused_linear_cross_entropy`` (black-listed).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ....ops._apply import defop


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _rotate_every_two(x):
    # interleaved layout: rotation pairs are (2i, 2i+1)
    x1 = x[..., ::2]
    x2 = x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def _rope_tables(seq_len, head_dim, theta, dtype, device, position_ids=None,
                 every_two=True):
    """cos/sin tables: computed in float32, cast to ``dtype`` before they
    multiply the activations (the JAX package's order). ``every_two`` (the
    JAX default) lays the frequencies out for the rotate-every-two pairing
    ``[f0, f0, f1, f1, ...]``; ``every_two=False`` for rotate-half
    ``[f0 .. f_{D/2-1}, f0 ..]``, which the LLaMA model, the decode engine
    and the serving engine ask for by name."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=device) / head_dim))
    if position_ids is None:
        t = torch.arange(seq_len, dtype=torch.float32, device=device)
    else:
        t = position_ids.to(device=device, dtype=torch.float32)
    freqs = t[..., None] * inv_freq                          # (..., S, D/2)
    if every_two:
        emb = torch.repeat_interleave(freqs, 2, dim=-1)      # [f0, f0, f1, f1, ...]
    else:
        emb = torch.cat([freqs, freqs], dim=-1)              # [f0..f_{D/2-1}, f0..]
    return emb.cos().to(dtype), emb.sin().to(dtype)


def _normalize_rope_table(tbl):
    """Accept (S,D), (B,S,D), (1,S,1,D)/(B,S,1,D) layouts -> (S,D) or (B,S,D)."""
    if tbl.dim() == 4:                                       # (B,S,1,D) head axis
        tbl = tbl.reshape(tbl.shape[0], tbl.shape[1], tbl.shape[3])
    if tbl.dim() == 3 and tbl.shape[0] == 1:
        tbl = tbl[0]
    return tbl


@defop("fused_rotary_position_embedding", amp_category="white")
def _fused_rope(q, k=None, v=None, sin=None, cos=None, position_ids=None,
                use_neox_rotary_style=True, rotary_theta=10000.0):
    """The rotated inputs that were given, in order (a tuple of one or more)."""
    S, D = q.shape[1], q.shape[-1]
    if cos is None or sin is None:
        cos, sin = _rope_tables(S, D, rotary_theta, q.dtype, q.device, position_ids,
                                every_two=use_neox_rotary_style)
    else:
        cos = _normalize_rope_table(cos)
        sin = _normalize_rope_table(sin)
    if cos.dim() == 2:                                       # (S,D) over batch/heads
        cos_b, sin_b = cos[None, :, None, :], sin[None, :, None, :]
    else:                                                    # (B,S,D) from position_ids
        cos_b, sin_b = cos[:, :, None, :], sin[:, :, None, :]
    rotate = _rotate_every_two if use_neox_rotary_style else _rotate_half
    return tuple(x * cos_b + rotate(x) * sin_b for x in (q, k, v) if x is not None)


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None, use_neox_rotary_style=True,
                                    rotary_theta=10000.0, name=None):
    """Rotary embedding of every given (B, S, H, D) input; a None input gives
    None in its own slot. ``use_neox_rotary_style=True`` is the interleaved
    rotate-every-two pairing, ``False`` the rotate-half pairing (the
    reference kernel's dispatch, not the usual HF naming); generated tables
    take the layout of the chosen pairing."""
    out = iter(_fused_rope(q, k, v, sin=sin, cos=cos, position_ids=position_ids,
                           use_neox_rotary_style=use_neox_rotary_style,
                           rotary_theta=rotary_theta))
    return tuple(None if x is None else next(out) for x in (q, k, v))


def _check(cond, exc, msg):
    """A check of length values: raised here for host values (numpy, CPU
    tensors); for tensors on the card an asynchronous device assert, so the
    check costs no host sync. A failed device assert is a sticky CUDA error
    that ends the process's CUDA context, so it is kept for lengths the
    caller already holds on the card."""
    if not isinstance(cond, torch.Tensor) or cond.device.type == "cpu":
        if not bool(cond):
            raise exc(msg)
    else:
        torch._assert_async(cond, msg)


def _host_lengths(*lens):
    """The length vectors as flat numpy arrays when every one is a host value
    (numpy, a Python sequence or number, a CPU tensor), else None."""
    if any(isinstance(x, torch.Tensor) and x.device.type != "cpu" for x in lens):
        return None
    return [np.asarray(x).reshape(-1) for x in lens]


def _check_lengths(is_prefill, enc, dec, this, cap):
    """The JAX function's rejections (mixed, chunked, multi-token decode) and
    the port's bounds checks, on numpy arrays or on tensors (``_check``)."""
    if is_prefill:
        _check((dec == 0).all(), NotImplementedError,
               "block_multihead_attention: mixed prefill+decode batches are not "
               "supported; split the batch by phase")
        _check((this == enc).all(), NotImplementedError,
               "block_multihead_attention: chunked prefill (seq_lens_this_time != "
               "seq_lens_encoder) is not supported")
        _check((enc <= cap).all(), ValueError,
               f"block_multihead_attention: a prompt is longer than its block table "
               f"({cap} positions)")
    else:
        _check((this == 1).all(), NotImplementedError,
               "block_multihead_attention decode phase expects one token per sequence "
               "(seq_lens_this_time == 1)")
        _check((dec < cap).all(), ValueError,
               f"block_multihead_attention: a decode position is past its block table "
               f"({cap} positions)")


def block_multihead_attention(
        qkv, key_cache, value_cache, seq_lens_encoder, seq_lens_decoder,
        seq_lens_this_time, padding_offsets=None, cum_offsets=None,
        cu_seqlens_q=None, cu_seqlens_k=None, block_tables=None,
        pre_key_cache=None, pre_value_cache=None, cache_k_quant_scales=None,
        cache_v_quant_scales=None, cache_k_dequant_scales=None,
        cache_v_dequant_scales=None, qkv_out_scale=None, qkv_bias=None,
        out_shift=None, out_smooth=None, max_enc_len_this_time=None,
        max_dec_len_this_time=None, rope_emb=None, mask=None, tgt_mask=None,
        max_seq_len=-1, block_size=64, use_neox_style=False,
        use_dynamic_cachekv_quant=False, quant_round_type=1,
        quant_max_bound=127.0, quant_min_bound=-127.0, out_scale=-1,
        compute_dtype="default", rope_theta=10000.0, name=None):
    """Paged-KV serving attention with the reference surface (the JAX
    package's ``block_multihead_attention``): ``qkv`` holds varlen rows
    ``[token_num, (q_heads + 2 * kv_heads) * head_dim]``; ``key_cache`` and
    ``value_cache`` are ``[max_block_num, kv_heads, block_size, head_dim]``
    pools whose rows a sequence owns through ``block_tables``. A prefill call
    (``seq_lens_encoder`` > 0) runs causal self-attention over each prompt
    with an fp32 softmax and writes the prompt into its blocks; a decode call
    (``seq_lens_this_time`` == 1) appends one token a sequence at position
    ``seq_lens_decoder`` and attends over its paged history
    (``models/paged_kv.py``). Returns ``(out, qkv, key_cache, value_cache)``:
    the caches are written in place and returned, ``qkv`` with its bias.

    The phase comes from ``max_enc_len_this_time`` when it is given (a host
    value, as the reference's ``blha_get_max_len`` gives it), else from the
    lengths, which are then read once. The checks of the lengths (one phase a
    call, no chunked prefill, one token a decode row, positions inside the
    block tables) run on the host, before anything is copied to the device,
    when all three length vectors are host values (numpy arrays, Python
    sequences, CPU tensors): they raise the JAX package's exception types.
    Lengths that are already tensors on the card are checked there by device
    asserts, without a host sync; a failed device assert ends the process's
    CUDA context, so pass host lengths where a batch may be rejected.
    Unsupported arguments raise as in the JAX package. Plain torch: the JAX
    function has no Pallas kernel."""
    for bad_name, bad in (
            ("cache_k_quant_scales", cache_k_quant_scales),
            ("cache_v_quant_scales", cache_v_quant_scales),
            ("cache_k_dequant_scales", cache_k_dequant_scales),
            ("cache_v_dequant_scales", cache_v_dequant_scales),
            ("qkv_out_scale", qkv_out_scale), ("out_shift", out_shift),
            ("out_smooth", out_smooth), ("rope_emb", rope_emb),
            ("pre_key_cache", pre_key_cache), ("pre_value_cache", pre_value_cache)):
        if bad is not None:
            raise NotImplementedError(
                f"block_multihead_attention: {bad_name} is not supported by this build "
                "(apply rotary in the model; use LlamaDecodeEngine(kv_cache_dtype='int8') "
                "for quantized KV)")
    if use_dynamic_cachekv_quant or out_scale != -1:
        raise NotImplementedError(
            "block_multihead_attention: cache-KV quantization paths are not supported here")
    if mask is not None or tgt_mask is not None:
        raise NotImplementedError(
            "block_multihead_attention: custom mask/tgt_mask are not supported; the paged "
            "path computes causal prefill and full-history decode masking only")
    if block_tables is None:
        raise ValueError("block_tables is required")
    from ....models import paged_kv as _pk

    qkv = torch.as_tensor(qkv)
    dev = qkv.device
    n_kv, bs, hd = key_cache.shape[1], key_cache.shape[2], key_cache.shape[3]
    n_q = qkv.shape[-1] // hd - 2 * n_kv
    B, blocks_per_row = np.shape(block_tables)
    cap = blocks_per_row * bs
    if max_enc_len_this_time is not None:
        max_enc = int(torch.as_tensor(max_enc_len_this_time).reshape(-1)[0])
    else:
        max_enc = None
    host = _host_lengths(seq_lens_encoder, seq_lens_decoder, seq_lens_this_time)
    if host is not None:
        # checked before any copy to the device, with the JAX exception types
        is_prefill = max_enc > 0 if max_enc is not None else bool((host[0] > 0).any())
        _check_lengths(is_prefill, *host, cap)
    tables = torch.as_tensor(block_tables).to(dev, torch.int32)
    enc, dec, this = (torch.as_tensor(x).to(dev).reshape(-1)
                      for x in (seq_lens_encoder, seq_lens_decoder, seq_lens_this_time))
    if host is None:
        is_prefill = max_enc > 0 if max_enc is not None else bool((enc > 0).any())
        _check_lengths(is_prefill, enc, dec, this, cap)
    if qkv_bias is not None:
        qkv = qkv + torch.as_tensor(qkv_bias).to(dev).reshape(-1)
    # the reference layout [nb, kv, bs, d] seen as the pool layout [nb, bs,
    # kv, d]: the paged writes go through these views into the caches
    kc_p, vc_p = key_cache.transpose(1, 2), value_cache.transpose(1, 2)
    if is_prefill:
        n_tok = qkv.shape[0]
        S = max_enc if max_enc is not None else min(n_tok, cap)
        # varlen rows -> padded [B, S, ...] and back, with index vectors built
        # on the device (no host copy of the lengths)
        row_b = torch.repeat_interleave(torch.arange(B, device=dev), this.long(),
                                        output_size=n_tok)
        starts = torch.cumsum(this.long(), 0) - this.long()
        row_t = torch.arange(n_tok, device=dev) - starts[row_b]
        rows_all = qkv.reshape(n_tok, n_q + 2 * n_kv, hd)

        def padded(part, heads):
            pad = qkv.new_zeros((B, S, heads, hd))
            pad[row_b, row_t] = part
            return pad

        q_pad = padded(rows_all[:, :n_q], n_q)
        k_pad = padded(rows_all[:, n_q:n_q + n_kv], n_kv)
        v_pad = padded(rows_all[:, n_q + n_kv:], n_kv)
        lens = enc.to(torch.int32)
        _pk.paged_write_prefill(kc_p, vc_p, tables, lens, k_pad, v_pad)
        # causal self-attention over the prompt (fp32 softmax)
        groups = n_q // n_kv
        qg = q_pad.reshape(B, S, n_kv, groups, hd)
        logits = torch.einsum("bshgd,bthd->bhgst", qg.float(), k_pad.float()) / math.sqrt(hd)
        t_idx = torch.arange(S, device=dev)
        causal = t_idx[None, :] <= t_idx[:, None]                # [S, S]
        valid = t_idx[None, :] < lens[:, None]                   # [B, S]
        keep = causal[None, None, None] & valid[:, None, None, None, :]
        probs = torch.softmax(torch.where(keep, logits, -1e30), dim=-1)
        o = torch.einsum("bhgst,bthd->bshgd", probs, v_pad.float()).to(qkv.dtype)
        out = o.reshape(B, S, n_q * hd)[row_b, row_t]
    else:
        rows = qkv.reshape(B, n_q + 2 * n_kv, hd)
        lens = dec.to(torch.int32)
        _pk.paged_write_decode(kc_p, vc_p, tables, lens, rows[:, n_q:n_q + n_kv],
                               rows[:, n_q + n_kv:])
        o = _pk.paged_attention_decode(rows[:, :n_q], kc_p, vc_p, tables, lens)
        out = o.reshape(B, n_q * hd)
    return out, qkv, key_cache, value_cache


class _FusedLinearCrossEntropy(torch.autograd.Function):
    """Per-token loss of ``hidden @ weight`` over sequence chunks. The forward
    keeps only ``hidden``, ``weight`` and the labels; the backward recomputes
    each chunk's logits and their softmax, forms ``softmax - onehot`` and
    gives that chunk's dHidden and its share of dWeight, so no more than one
    chunk's [B, C, V] logits is ever held."""

    @staticmethod
    def forward(ctx, hidden, weight, labels, ignore_index, chunk):
        B, Sp, _ = hidden.shape
        tok = torch.empty((B, Sp), dtype=torch.float32, device=hidden.device)
        for c0 in range(0, Sp, chunk):
            lc = labels[:, c0:c0 + chunk]
            ignored = lc == ignore_index
            # lse - logit[label] = -log_softmax[label], in fp32 in one pass
            logp = torch.log_softmax(torch.matmul(hidden[:, c0:c0 + chunk], weight), dim=-1,
                                     dtype=torch.float32)
            picked = torch.gather(logp, -1, torch.where(ignored, 0, lc).unsqueeze(-1))
            tok[:, c0:c0 + chunk] = torch.where(ignored, 0.0, -picked.squeeze(-1))
        ctx.save_for_backward(hidden, weight, labels)
        ctx.ignore_index, ctx.chunk = ignore_index, chunk
        return tok

    @staticmethod
    def backward(ctx, g_tok):
        hidden, weight, labels = ctx.saved_tensors
        chunk = ctx.chunk
        d_hidden = torch.empty_like(hidden) if ctx.needs_input_grad[0] else None
        d_weight = (torch.zeros(weight.shape, dtype=torch.float32, device=weight.device)
                    if ctx.needs_input_grad[1] else None)
        for c0 in range(0, hidden.shape[1], chunk):
            hc = hidden[:, c0:c0 + chunk]
            lc = labels[:, c0:c0 + chunk]
            ignored = lc == ctx.ignore_index
            probs = torch.softmax(torch.matmul(hc, weight), dim=-1, dtype=torch.float32)
            probs.scatter_add_(-1, torch.where(ignored, 0, lc).unsqueeze(-1),
                               torch.full_like(probs[..., :1], -1.0))
            g = torch.where(ignored, 0.0, g_tok[:, c0:c0 + chunk].float())
            # dlogits in fp32, rounded to the input dtype before the products
            # (the transpose of the forward's cast to fp32): one pass
            d_logits = torch.empty(probs.shape, dtype=hidden.dtype, device=probs.device)
            torch.mul(probs, g.unsqueeze(-1), out=d_logits)
            if d_hidden is not None:
                d_hidden[:, c0:c0 + chunk] = torch.matmul(d_logits, weight.t())
            if d_weight is not None:
                d_weight += torch.matmul(hc.reshape(-1, hc.shape[-1]).t(),
                                         d_logits.reshape(-1, d_logits.shape[-1])).float()
        if d_weight is not None:
            d_weight = d_weight.to(weight.dtype)
        return d_hidden, d_weight, None, None, None


@defop("fused_linear_cross_entropy", amp_category="black")
def _fused_linear_cross_entropy(hidden, weight, labels, ignore_index=-100, chunk_size=512):
    """Chunked LM-head matmul and softmax cross-entropy that never holds the
    full [B, S, V] logits: the port of the JAX package's
    ``_fused_linear_cross_entropy``. ``hidden`` is [B, S, H], ``weight``
    [H, V] (paddle's layout; a transposed view is fine), ``labels`` [B, S].
    S is padded to a multiple of ``chunk_size`` with ``ignore_index`` labels.
    Returns the fp32 per-token loss [B, S], 0 at ignored positions.

    The matmuls stay in the input dtype and the softmax runs in fp32, as in
    JAX; the per-token loss ``lse - logit[label]`` is taken as
    ``-log_softmax[label]`` (one fp32 pass over a chunk's logits where the
    log-sum-exp and a subtraction take three). The backward recomputes each
    chunk's logits (JAX's ``jax.checkpoint`` over ``lax.map``). dWeight
    accumulates across chunks in fp32: each chunk's [H, V] product, in the
    input dtype, is added to an fp32 sum, which is cast to ``weight``'s dtype
    once at the end (XLA's scan carries that sum in ``weight``'s dtype; at
    fp32 the two are the same). Plain torch: the JAX function is XLA, not a
    Pallas kernel."""
    B, S, _ = hidden.shape
    C = min(int(chunk_size), S)
    pad = (-S) % C
    labels = labels.long()
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=ignore_index)
    tok = _FusedLinearCrossEntropy.apply(hidden, weight, labels, int(ignore_index), C)
    return tok[:, :S]


def fused_linear_cross_entropy(hidden, weight, labels, ignore_index=-100, chunk_size=512,
                               name=None):
    """Per-token causal-LM loss fused with the LM-head projection; see
    ``_fused_linear_cross_entropy``. ``weight`` is [hidden, vocab]."""
    return _fused_linear_cross_entropy(hidden, weight, labels, ignore_index=int(ignore_index),
                                       chunk_size=int(chunk_size))

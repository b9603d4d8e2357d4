"""Fused functionals (counterpart of paddle_tpu/incubate/nn/functional).

``fused_rotary_position_embedding`` with both pairings (the interleaved
rotate-every-two of ``use_neox_rotary_style=True``, the default, and the
rotate-half of ``False``, which the LLaMA model uses),
``block_multihead_attention`` over the paged KV pool, the fused LM-head
cross-entropy (``fused_linear_cross_entropy``), and the rest of the JAX
module: the norms, dropout-add, linear, bias-activation and gate-attention
ops, the fused transformer functionals (``fused_multi_head_attention``,
``fused_feedforward``, ``fused_multi_transformer`` with its cached
generation contract), ``masked_multihead_attention``, ``fused_moe``,
``variable_length_memory_efficient_attention`` and ``blha_get_max_len``.
Every JAX ``defop`` keeps its name and AMP category here (the rotary
embedding and the gate attention white, the norms fp32, the cross-entropy
black).

The attention of ``fused_dot_product_attention``,
``fused_multi_head_attention`` and the uncached ``fused_multi_transformer``
is the port's ``scaled_dot_product_attention``: a CUDA query of 128 or more
rows with no mask and no dropout runs the flash kernels (forward, and under
autograd the backward), anything else the math path, as in the JAX package.
The cached ``fused_multi_transformer`` and ``masked_multihead_attention``
take the JAX package's plain attention over the cache and return new caches:
the caller's caches are never written. The dropout variants draw their masks
from the port's generator, not JAX's key stream.
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


# -- norms, dropout-add, linear, bias-activation ------------------------------
from ....nn.functional.activation import swiglu  # noqa: E402,F401  (already fused)


@defop("fused_rms_norm", amp_category="fp32")
def _fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6, begin_norm_axis=-1):
    dims = tuple(range(begin_norm_axis % x.dim(), x.dim()))
    # promote, don't demote: bf16 -> f32 for stability, f64 stays f64
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    var = (xf * xf).mean(dim=dims, keepdim=True)
    y = (xf * torch.rsqrt(var + epsilon)).to(x.dtype)
    if norm_weight is not None:
        y = y * norm_weight
    if norm_bias is not None:
        y = y + norm_bias
    return y


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6, begin_norm_axis=-1,
                   name=None):
    return _fused_rms_norm(x, norm_weight, norm_bias, epsilon=epsilon,
                           begin_norm_axis=begin_norm_axis)


@defop("fused_layer_norm", amp_category="fp32")
def _fused_layer_norm(x, norm_weight=None, norm_bias=None, epsilon=1e-5, begin_norm_axis=-1,
                      residual=None):
    if residual is not None:
        x = x + residual
    dims = tuple(range(begin_norm_axis % x.dim(), x.dim()))
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(dim=dims, keepdim=True)
    var = (xf - mean).square().mean(dim=dims, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if norm_weight is not None:
        y = y * norm_weight
    if norm_bias is not None:
        y = y + norm_bias
    return y


def fused_layer_norm(x, norm_weight=None, norm_bias=None, epsilon=1e-5, begin_norm_axis=-1,
                     residual=None, name=None):
    return _fused_layer_norm(x, norm_weight, norm_bias, epsilon=epsilon,
                             begin_norm_axis=begin_norm_axis, residual=residual)


@defop("fused_dropout_add")
def _fused_dropout_add(x, y, keep=None, p=0.5, training=True, mode="upscale_in_train"):
    """``keep`` is the boolean mask of kept elements (None: no dropout)."""
    if not training or p == 0.0 or keep is None:
        return x + y
    if mode == "upscale_in_train":
        dropped = torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    else:
        dropped = torch.where(keep, x, 0.0).to(x.dtype)
    return dropped + y


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train", name=None):
    """dropout(x) + y; the mask comes from the port's generator for x's
    device (in eval, or at p = 0, x + y in every mode, as in JAX)."""
    from ....nn.functional.common import _keep_mask

    keep = _keep_mask(x, 1.0 - p, x.shape) if (training and p > 0.0) else None
    return _fused_dropout_add(x, y, keep=keep, p=p, training=training, mode=mode)


@defop("fused_linear")
def _fused_linear(x, weight, bias=None, transpose_weight=False):
    y = torch.matmul(x, weight.t() if transpose_weight else weight)
    if bias is not None:
        y = y + bias
    return y


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    return _fused_linear(x, weight, bias, transpose_weight=transpose_weight)


@defop("fused_bias_act")
def _fused_bias_act(x, bias=None, act_method="gelu"):
    if bias is not None:
        x = x + bias
    if act_method in ("gelu", "geglu"):
        return torch.nn.functional.gelu(x)
    if act_method == "relu":
        return torch.relu(x)
    if act_method in ("swiglu",):
        a, b = torch.chunk(x, 2, dim=-1)
        return torch.nn.functional.silu(a) * b
    if act_method in ("silu", "swish"):
        return torch.nn.functional.silu(x)
    raise ValueError(f"unsupported act_method {act_method}")


def fused_bias_act(x, bias=None, act_method="gelu", name=None, **kwargs):
    return _fused_bias_act(x, bias, act_method=act_method)


def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False, name=None):
    """fused_matmul_bias.py: the port's ``matmul`` and the bias."""
    from ....ops.linalg import matmul

    out = matmul(x, y, transpose_x=transpose_x, transpose_y=transpose_y)
    return out + bias if bias is not None else out


def fused_linear_activation(x, y, bias=None, trans_x=False, trans_y=False, activation=None,
                            name=None):
    """reference fused_ops fused_linear_activation: matmul + bias + act."""
    out = fused_matmul_bias(x, y, bias, transpose_x=trans_x, transpose_y=trans_y)
    if activation in (None, "", "none"):
        return out
    from ....nn import functional as F

    act = {"relu": F.relu, "gelu": F.gelu, "swish": F.silu, "silu": F.silu}.get(activation)
    if act is None:
        raise ValueError(f"unsupported activation {activation!r}")
    return act(out)


# -- attention ------------------------------------------------------------------
@defop("fused_gate_attention", amp_category="white")
def _fused_gate_attention(query, key=None, query_weight=None, key_weight=None,
                          value_weight=None, qkv_weight=None, gate_linear_weight=None,
                          gate_linear_bias=None, out_linear_weight=None, out_linear_bias=None,
                          nonbatched_bias=None, attn_mask=None, has_gating=True,
                          merge_qkv=True):
    """AlphaFold-style gated MSA self-attention (reference
    fused_gate_attention.py:26) as one op, in the JAX package's einsums:
    query [N, B, Q, A]; merged qkv_weight [3, H, D, A]; separate
    query/key/value weights [A, H, D]; gating [A, H, D] + [H, D]; output
    [H, D, A_out]; nonbatched_bias [N, H, Q, M]; attn_mask added as a bias."""
    if merge_qkv:
        qkv = torch.einsum("nbqa,thda->tnbqhd", query, qkv_weight)
        q, k, v = qkv[0], qkv[1], qkv[2]
    else:
        kin = query if key is None else key
        q = torch.einsum("nbqa,ahd->nbqhd", query, query_weight)
        k = torch.einsum("nbka,ahd->nbkhd", kin, key_weight)
        v = torch.einsum("nbka,ahd->nbkhd", kin, value_weight)
    q = q * (q.shape[-1] ** -0.5)
    logits = torch.einsum("nbqhd,nbkhd->nbhqk", q, k)
    if attn_mask is not None:
        logits = logits + attn_mask
    if nonbatched_bias is not None:
        logits = logits + nonbatched_bias[:, None]
    ct = torch.promote_types(logits.dtype, torch.float32)
    probs = torch.softmax(logits.to(ct), -1).to(logits.dtype)
    out = torch.einsum("nbhqk,nbkhd->nbqhd", probs, v)
    if has_gating:
        gate = torch.einsum("nbqa,ahd->nbqhd", query, gate_linear_weight)
        if gate_linear_bias is not None:
            gate = gate + gate_linear_bias
        out = out * torch.sigmoid(gate)
    out = torch.einsum("nbqhd,hdo->nbqo", out, out_linear_weight)
    if out_linear_bias is not None:
        out = out + out_linear_bias
    return out


def fused_gate_attention(query, key=None, query_weight=None, key_weight=None,
                         value_weight=None, qkv_weight=None, gate_linear_weight=None,
                         gate_linear_bias=None, out_linear_weight=None, out_linear_bias=None,
                         nonbatched_bias=None, attn_mask=None, has_gating=True,
                         merge_qkv=True, use_flash_attn=False):
    """reference incubate/nn/functional/fused_gate_attention.py:26 public
    surface; ``use_flash_attn`` is accepted and changes nothing (as in the
    JAX package). The shape checks and refusals are the JAX function's."""
    if merge_qkv and key is not None:
        # the merged path is self-attention only (reference contract):
        # silently dropping `key` would return plausible-but-wrong numbers
        raise ValueError(
            "fused_gate_attention: merge_qkv=True is self-attention only "
            "(qkv projected from `query`); pass merge_qkv=False with "
            "query/key/value weights for cross-attention over `key`")
    if merge_qkv and qkv_weight is None:
        raise ValueError(
            "fused_gate_attention: merge_qkv=True needs qkv_weight "
            "([3, num_heads, head_dim, q_dim])")
    if not merge_qkv and (query_weight is None or key_weight is None
                          or value_weight is None):
        raise ValueError(
            "fused_gate_attention: merge_qkv=False needs query_weight, "
            "key_weight and value_weight ([dim, num_heads, head_dim])")
    if has_gating and gate_linear_weight is None:
        raise ValueError(
            "fused_gate_attention: has_gating=True needs "
            "gate_linear_weight (pass has_gating=False to skip gating)")
    if out_linear_weight is None:
        raise ValueError("fused_gate_attention: out_linear_weight is "
                         "required ([num_heads, head_dim, out_dim])")
    return _fused_gate_attention(
        query, key, query_weight, key_weight, value_weight, qkv_weight,
        gate_linear_weight, gate_linear_bias, out_linear_weight, out_linear_bias,
        nonbatched_bias, attn_mask, has_gating=bool(has_gating), merge_qkv=bool(merge_qkv))


def fused_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0, is_causal=False,
                                training=True, scaling_factor=None, name=None):
    """fused_dot_product_attention.py: the port's sdpa (the flash kernels for
    a CUDA query of 128 or more rows, no mask and no dropout).
    ``scaling_factor`` is accepted and not applied, as in the JAX package."""
    from ....nn.functional.flash_attention import scaled_dot_product_attention

    return scaled_dot_product_attention(q, k, v, attn_mask=attn_mask, dropout_p=dropout_p,
                                        is_causal=is_causal, training=training)


def variable_length_memory_efficient_attention(query, key, value, seq_lens, kv_seq_lens,
                                               mask=None, scale=None, causal=False,
                                               name=None):
    """variable_length_memory_efficient_attention.py on (B, H, S, D) inputs:
    key columns at or past a row's ``kv_seq_lens`` (``seq_lens`` when that is
    None) are masked out. The mask sends sdpa to the math path, as in JAX."""
    from ....nn.functional.flash_attention import _sdpa, _use_kernel
    from ....ops.manipulation import transpose

    q = transpose(query, [0, 2, 1, 3])
    k = transpose(key, [0, 2, 1, 3])
    v = transpose(value, [0, 2, 1, 3])
    sk = int(k.shape[1])
    kv_lens = kv_seq_lens if kv_seq_lens is not None else seq_lens
    if kv_lens is not None:
        lens = torch.as_tensor(kv_lens).to(q.device).reshape(-1)
        # keep key column j for batch b iff j < kv_len[b]; (B, 1, 1, Sk)
        keep = (torch.arange(sk, device=q.device)[None, :] < lens[:, None])[:, None, None, :]
        if mask is None:
            mask = keep
        else:
            # a mask is data here: no gradient reaches it (as in JAX)
            mv = torch.as_tensor(mask).detach().to(q.device)
            if mv.dtype == torch.bool:
                mask = mv & keep
            else:
                mask = mv + torch.where(keep, 0.0, -1e30).to(mv.dtype)
    out = _sdpa(q, k, v, mask, dropout_p=0.0, causal=bool(causal), scale=scale,
                use_kernel=_use_kernel(q))
    return transpose(out, [0, 2, 1, 3])


def _topk_lowest_index_first(probs, k):
    """``jax.lax.top_k``: the k largest along the last axis, ties broken
    lowest index first (a stable descending sort; ``torch.topk`` on CUDA
    gives no tie order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def fused_moe(x, gate_weight, ffn1_weight, ffn2_weight, ffn1_bias=None, ffn2_bias=None,
              quant_method="None", moe_topk=2, norm_topk_prob=True, name=None):
    """fused_moe.py: token top-k routing and expert FFNs, dispatched densely
    by einsum as in the JAX package. x: (B, S, D); gate_weight: (D, E);
    ffn1_weight: (E, D, I) (swiglu packs 2*I); ffn2_weight: (E, I, D)."""
    B, S, D = x.shape
    E = gate_weight.shape[1]
    tokens = x.reshape(B * S, D)
    probs = torch.softmax(tokens @ gate_weight, dim=-1)
    top_p, top_e = _topk_lowest_index_first(probs, moe_topk)
    if norm_topk_prob:
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    # dense dispatch: each expert weighted by its routed probability (0 when
    # not in the top-k)
    weights = torch.zeros((B * S, E), dtype=x.dtype, device=x.device).scatter(
        1, top_e, top_p.to(x.dtype))
    h = torch.einsum("td,edi->tei", tokens, ffn1_weight)
    if ffn1_bias is not None:
        h = h + ffn1_bias[None]
    if h.shape[-1] == 2 * ffn2_weight.shape[1]:  # swiglu-packed ffn1
        gate_h, up = torch.chunk(h, 2, dim=-1)
        h = torch.nn.functional.silu(gate_h) * up
    else:
        h = torch.nn.functional.gelu(h)
    y = torch.einsum("tei,eid->ted", h, ffn2_weight)
    if ffn2_bias is not None:
        y = y + ffn2_bias[None]
    return torch.einsum("ted,te->td", y, weights).reshape(B, S, D)


# -- the fused transformer functionals ----------------------------------------
def fused_bias_dropout_residual_layer_norm(x, residual, bias=None, ln_scale=None, ln_bias=None,
                                           dropout_rate=0.5, ln_epsilon=1e-5, training=True,
                                           mode="upscale_in_train", name=None):
    """reference fused_transformer.py fused_bias_dropout_residual_layer_norm:
    out = LN(residual + dropout(x + bias))."""
    from ....nn import functional as F

    y = x if bias is None else x + bias
    if dropout_rate:
        y = F.dropout(y, p=dropout_rate, training=training, mode=mode)
    y = residual + y
    return F.layer_norm(y, [int(y.shape[-1])], ln_scale, ln_bias, ln_epsilon)


def fused_multi_head_attention(
        x, qkv_weight, linear_weight, pre_layer_norm=False, pre_ln_scale=None,
        pre_ln_bias=None, ln_scale=None, ln_bias=None, pre_ln_epsilon=1e-5, qkv_bias=None,
        linear_bias=None, cache_kv=None, attn_mask=None, dropout_rate=0.5,
        attn_dropout_rate=0.5, ln_epsilon=1e-5, training=True, mode="upscale_in_train",
        ring_id=-1, add_residual=True, num_heads=-1, transpose_qkv_wb=False, name=None):
    """reference fused_transformer.py fused_multi_head_attention — the
    functional form of FusedMultiHeadAttention (packed [3, H, D, E] qkv
    weight). ``cache_kv`` [2, B, H, T, D] holds past K/V: the new tokens are
    appended and the call returns ``(out, new cache)``."""
    from ....nn import functional as F
    from ....ops import manipulation as m

    if transpose_qkv_wb:
        raise NotImplementedError(
            "transpose_qkv_wb=True is not implemented (packed [3, H, D, E] "
            "layout is — matches incubate.nn.FusedMultiHeadAttention)")
    three, heads, head_dim, embed = (int(s) for s in qkv_weight.shape)
    residual = x
    if pre_layer_norm:
        x = F.layer_norm(x, [embed], pre_ln_scale, pre_ln_bias, pre_ln_epsilon)
    w = m.reshape(qkv_weight, [3 * embed, embed])
    qkv = fused_matmul_bias(x, w, None if qkv_bias is None
                            else m.reshape(qkv_bias, [3 * embed]), transpose_y=True)
    qkv = m.reshape(qkv, [0, 0, 3, heads, head_dim])
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    cache_out = None
    if cache_kv is not None:
        # the caches are data on both sides: no gradient reaches the past K/V
        # nor flows back from the returned cache (as in JAX, on raw arrays)
        past = cache_kv.detach()
        past_k = past[0].transpose(1, 2)     # -> (B, T, H, D)
        past_v = past[1].transpose(1, 2)
        k = m.concat([past_k, k], axis=1)
        v = m.concat([past_v, v], axis=1)
        cache_out = torch.stack([k.transpose(1, 2), v.transpose(1, 2)]).detach()
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                         dropout_p=attn_dropout_rate, is_causal=False,
                                         training=training)
    out = m.reshape(out, [0, 0, embed])
    out = fused_matmul_bias(out, linear_weight, linear_bias)
    if dropout_rate:
        out = F.dropout(out, p=dropout_rate, training=training, mode=mode)
    if add_residual:
        out = residual + out
    if not pre_layer_norm:
        out = F.layer_norm(out, [embed], ln_scale, ln_bias, ln_epsilon)
    if cache_out is not None:
        return out, cache_out
    return out


def fused_feedforward(
        x, linear1_weight, linear2_weight, linear1_bias=None, linear2_bias=None,
        ln1_scale=None, ln1_bias=None, ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
        dropout2_rate=0.5, activation="relu", ln1_epsilon=1e-5, ln2_epsilon=1e-5,
        pre_layer_norm=False, training=True, mode="upscale_in_train", ring_id=-1,
        add_residual=True, name=None):
    """reference fused_transformer.py fused_feedforward: [LN ->] linear1 ->
    act -> dropout -> linear2 -> dropout -> residual [-> LN]."""
    from ....nn import functional as F

    embed = int(x.shape[-1])
    residual = x
    if pre_layer_norm:
        x = F.layer_norm(x, [embed], ln1_scale, ln1_bias, ln1_epsilon)
    h = fused_linear_activation(x, linear1_weight, linear1_bias, activation=activation)
    if dropout1_rate:
        h = F.dropout(h, p=dropout1_rate, training=training, mode=mode)
    h = fused_matmul_bias(h, linear2_weight, linear2_bias)
    if dropout2_rate:
        h = F.dropout(h, p=dropout2_rate, training=training, mode=mode)
    out = residual + h if add_residual else h
    if not pre_layer_norm:
        out = F.layer_norm(out, [embed], ln2_scale, ln2_bias, ln2_epsilon)
    return out


def _ith(xs, i):
    return xs[i] if xs else None


def fused_multi_transformer(
        x, ln_scales, ln_biases, qkv_weights, qkv_biases, linear_weights, linear_biases,
        ffn_ln_scales, ffn_ln_biases, ffn1_weights, ffn1_biases, ffn2_weights, ffn2_biases,
        pre_layer_norm=True, epsilon=1e-5, cache_kvs=None, pre_caches=None, seq_lens=None,
        rotary_embs=None, time_step=None, attn_mask=None, dropout_rate=0.0,
        activation="gelu", training=False, mode="upscale_in_train", trans_qkvw=True,
        ring_id=-1, name=None, **unused):
    """reference fused_transformer.py fused_multi_transformer — the whole
    decoder stack as one call: per layer, fused attention + fused FFN. With
    ``cache_kvs`` (per-layer [2, B, H, max_len, D]) it is the cached
    generation contract and returns ``(out, new caches)``."""
    # semantically significant rotary/varlen args must not be silently dropped
    for arg_name, arg in (("rotary_embs", rotary_embs), ("pre_caches", pre_caches),
                          ("seq_lens", seq_lens)):
        if arg is not None:
            raise NotImplementedError(
                f"fused_multi_transformer: {arg_name} is not supported by "
                "this build; apply rotary embeddings in the model (see "
                "models/llama.py) or use models.llama_decode."
                "LlamaDecodeEngine for cached decoding")
    if unused:
        raise TypeError("fused_multi_transformer: unexpected keyword arguments "
                        f"{sorted(unused)}")
    if not trans_qkvw:
        raise NotImplementedError(
            "fused_multi_transformer: trans_qkvw=False ([E, 3, H, D] weight "
            "layout) is not supported; pass the default transposed "
            "[3, H, D, E] layout")
    if cache_kvs is not None:
        if attn_mask is not None:
            raise NotImplementedError(
                "fused_multi_transformer: attn_mask with cache_kvs is not "
                "supported (the cached path masks by position only); for "
                "padded batches use models.serving.ContinuousBatchingEngine "
                "or left-trim the prompts")
        if training or (dropout_rate and mode == "downscale_in_infer"):
            raise ValueError(
                "fused_multi_transformer: the cached path is inference-only "
                "(training=False; downscale_in_infer dropout would change "
                "eval numerics and is not supported with cache_kvs)")
        return _fused_multi_transformer_cached(
            x, ln_scales, ln_biases, qkv_weights, qkv_biases, linear_weights, linear_biases,
            ffn_ln_scales, ffn_ln_biases, ffn1_weights, ffn1_biases, ffn2_weights,
            ffn2_biases, pre_layer_norm=pre_layer_norm, epsilon=epsilon, cache_kvs=cache_kvs,
            time_step=time_step, activation=activation)
    if time_step is not None:
        raise ValueError(
            "fused_multi_transformer: time_step needs cache_kvs (the "
            "preallocated [2, B, H, max_len, D] per-layer caches)")
    out = x
    for i in range(len(qkv_weights)):
        out = fused_multi_head_attention(
            out, qkv_weights[i], linear_weights[i], pre_layer_norm=pre_layer_norm,
            pre_ln_scale=_ith(ln_scales, i), pre_ln_bias=_ith(ln_biases, i),
            ln_scale=_ith(ln_scales, i), ln_bias=_ith(ln_biases, i),
            pre_ln_epsilon=epsilon, ln_epsilon=epsilon, qkv_bias=_ith(qkv_biases, i),
            linear_bias=_ith(linear_biases, i), attn_mask=attn_mask,
            dropout_rate=dropout_rate, attn_dropout_rate=dropout_rate, training=training,
            mode=mode)
        out = fused_feedforward(
            out, ffn1_weights[i], ffn2_weights[i], linear1_bias=_ith(ffn1_biases, i),
            linear2_bias=_ith(ffn2_biases, i), ln1_scale=_ith(ffn_ln_scales, i),
            ln1_bias=_ith(ffn_ln_biases, i), ln2_scale=_ith(ffn_ln_scales, i),
            ln2_bias=_ith(ffn_ln_biases, i), dropout1_rate=dropout_rate,
            dropout2_rate=dropout_rate, activation=activation, ln1_epsilon=epsilon,
            ln2_epsilon=epsilon, pre_layer_norm=pre_layer_norm, training=training, mode=mode)
    return out


def _host_int(t):
    """A host integer from a Python number, numpy value or tensor (a CUDA
    tensor is read back: the JAX function reads ``time_step`` on the host)."""
    if isinstance(t, torch.Tensor):
        return int(t.reshape(-1)[0])
    return int(np.asarray(t).reshape(-1)[0])


def _fused_multi_transformer_cached(
        x, ln_scales, ln_biases, qkv_weights, qkv_biases, linear_weights, linear_biases,
        ffn_ln_scales, ffn_ln_biases, ffn1_weights, ffn1_biases, ffn2_weights, ffn2_biases,
        pre_layer_norm, epsilon, cache_kvs, time_step, activation):
    """The reference's cached generation contract
    (fused_multi_transformer_op.cu): per-layer PREALLOCATED caches
    [2, B, H, max_len, D]; with ``time_step=None`` the call is the context/
    prefill phase (writes positions 0..S-1, causal attention within the
    prompt); with ``time_step=t`` it is one decode step (x is [B, 1, E],
    K/V written at position t, attention over positions <= t). Returns
    (out, new cache_kvs): each layer's cache is copied and the copy written,
    the caller's caches are left as they were (the JAX function's
    ``dynamic_update_slice``). The attention is the JAX function's, softmax
    in ``promote_types(dtype, float32)`` over the whole cache with a position
    mask. Inference semantics: dropout off."""
    from ....nn import functional as F
    from ....ops import manipulation as m

    B, S, E = x.shape
    t0 = None if time_step is None else _host_int(time_step)
    if t0 is not None and S != 1:
        raise ValueError(
            "fused_multi_transformer decode (time_step given) expects one "
            f"token per call, got S={S}")
    max_len = int(cache_kvs[0].shape[3])
    start = 0 if t0 is None else t0
    if start + S > max_len:
        raise ValueError(
            f"fused_multi_transformer: writing positions "
            f"{start}..{start + S - 1} overflows the preallocated cache "
            f"(max_len={max_len}); allocate larger cache_kvs")
    out = x
    new_caches = []
    positions = start + torch.arange(S, device=x.device)                  # query pos
    pos_mask = torch.arange(max_len, device=x.device)[None, None, :] <= positions[None, :, None]
    for i in range(len(qkv_weights)):
        residual = out
        h = out
        if pre_layer_norm:
            h = F.layer_norm(h, [E], _ith(ln_scales, i), _ith(ln_biases, i), epsilon)
        three, heads, head_dim, _ = (int(s) for s in qkv_weights[i].shape)
        w = m.reshape(qkv_weights[i], [3 * E, E])
        qkv = fused_matmul_bias(h, w, None if not qkv_biases
                                else m.reshape(qkv_biases[i], [3 * E]), transpose_y=True)
        qkv = qkv.reshape(B, S, 3, heads, head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        cache = cache_kvs[i].clone()                  # [2, B, H, max_len, D]
        cache[:, :, :, start:start + S] = torch.stack(
            [k.transpose(1, 2), v.transpose(1, 2)]).to(cache.dtype)
        new_caches.append(cache)
        ck, cvv = cache[0], cache[1]
        ct = torch.promote_types(q.dtype, torch.float32)
        logits = torch.einsum("bshd,bhtd->bhst", q.to(ct), ck.to(ct)) / math.sqrt(head_dim)
        logits = torch.where(pos_mask[:, None], logits, -1e30)
        probs = torch.softmax(logits, -1)
        attn = torch.einsum("bhst,bhtd->bshd", probs, cvv.to(ct))
        attn = attn.reshape(B, S, heads * head_dim).to(x.dtype)
        o = fused_matmul_bias(attn, linear_weights[i], _ith(linear_biases, i))
        o = residual + o
        if not pre_layer_norm:
            o = F.layer_norm(o, [E], _ith(ln_scales, i), _ith(ln_biases, i), epsilon)
        out = fused_feedforward(
            o, ffn1_weights[i], ffn2_weights[i], linear1_bias=_ith(ffn1_biases, i),
            linear2_bias=_ith(ffn2_biases, i), ln1_scale=_ith(ffn_ln_scales, i),
            ln1_bias=_ith(ffn_ln_biases, i), ln2_scale=_ith(ffn_ln_scales, i),
            ln2_bias=_ith(ffn_ln_biases, i), dropout1_rate=0.0, dropout2_rate=0.0,
            activation=activation, ln1_epsilon=epsilon, ln2_epsilon=epsilon,
            pre_layer_norm=pre_layer_norm, training=False)
    return out, new_caches


def blha_get_max_len(seq_lens_encoder, seq_lens_decoder, batch_size=None, name=None):
    """reference blha_get_max_len: the (max encoder len, max decoder len)
    pair, each a one-element tensor where the lengths lie (host lengths give
    CPU tensors, the host values ``block_multihead_attention`` reads)."""
    enc = torch.as_tensor(seq_lens_encoder)
    dec = torch.as_tensor(seq_lens_decoder)
    return enc.max().reshape(1), dec.max().reshape(1)


def _host_max(x):
    """max of a host length vector (numpy, sequence, CPU tensor), else None."""
    if isinstance(x, torch.Tensor) and x.device.type != "cpu":
        return None
    return int(np.asarray(x).max())


def masked_multihead_attention(
        x, cache_kv=None, bias=None, src_mask=None, sequence_lengths=None,
        rotary_tensor=None, beam_cache_offset=None, qkv_out_scale=None, out_shift=None,
        out_smooth=None, seq_len=1, rotary_emb_dims=0, use_neox_rotary_style=False,
        compute_dtype="default", out_scale=-1.0, quant_round_type=1, quant_max_bound=127.0,
        quant_min_bound=-127.0, name=None):
    """reference masked_multihead_attention: ONE decode step of multi-head
    attention against a [2, B, H, T, D] cache — the generation-loop kernel.
    x is the packed qkv for the new token: (B, 3*H*D); ``sequence_lengths``
    is each row's write position. Returns ``(out, new cache)``; the caller's
    cache is not written.

    The bounds of the write positions (the cache, the rotary table) are
    checked on the host with the JAX exception when the lengths are host
    data (numpy, a sequence, a CPU tensor); lengths already on the card are
    checked there by a device assert, with no host sync (``_check``)."""
    if rotary_emb_dims not in (0, 1):
        raise NotImplementedError(
            "masked_multihead_attention: rotary_emb_dims=2 (extra position "
            "ids) is not supported; the standard rotary_emb_dims=1 form is")
    if rotary_tensor is None and rotary_emb_dims:
        raise ValueError(
            "masked_multihead_attention: rotary_emb_dims=1 needs "
            "rotary_tensor ([2, B, max_seq, 1, head_dim] cos/sin tables)")
    if rotary_tensor is not None and not rotary_emb_dims:
        raise ValueError(
            "masked_multihead_attention: rotary_tensor given but "
            "rotary_emb_dims=0 (the reference kernel gates rotation on "
            "rotary_emb_dims; pass rotary_emb_dims=1)")
    if beam_cache_offset is not None:
        raise NotImplementedError(
            "masked_multihead_attention: beam_cache_offset (beam-search KV "
            "reordering) is not supported; use LlamaDecodeEngine's beam "
            "search for reordered-cache generation")
    if qkv_out_scale is not None or out_shift is not None \
            or out_smooth is not None or out_scale != -1.0:
        raise NotImplementedError(
            "masked_multihead_attention: int8 quantization params "
            "(qkv_out_scale/out_shift/out_smooth/out_scale) are not "
            "supported; use LlamaDecodeEngine(kv_cache_dtype='int8') for "
            "quantized-KV decoding")
    if cache_kv is None:
        raise ValueError("cache_kv is required (shape [2, B, H, T, D])")
    xv = x
    if bias is not None:
        xv = xv + torch.as_tensor(bias).to(xv.device).reshape(-1)
    two, B, H, T, D = cache_kv.shape
    qkv = xv.reshape(B, 3, H, D)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]        # (B, H, D)
    if sequence_lengths is None:
        raise ValueError(
            "sequence_lengths is required: it is the per-row cache write "
            "position — without it every step would overwrite slot 0 and "
            "decode with no history")
    host_max = _host_max(sequence_lengths)
    pos = torch.as_tensor(sequence_lengths).to(x.device).reshape(-1).long()
    if host_max is not None:
        if host_max >= T:
            # the scatter would silently drop/clamp the write while the causal
            # mask opens the whole cache — plausible-but-wrong logits
            raise ValueError(
                f"masked_multihead_attention: write position {host_max} exceeds "
                f"the cache (T={T}); allocate a longer cache_kv")
    else:
        _check((pos < T).all(), ValueError,
               f"masked_multihead_attention: a write position exceeds the cache (T={T}); "
               "allocate a longer cache_kv")
    bidx = torch.arange(B, device=x.device)
    if rotary_tensor is not None and rotary_emb_dims:
        # reference mmha_util.cu.h:46: rotary_emb [2, B, max_seq, 1, D]
        # (cos at [0], sin at [1]) read at the row's CURRENT position; the
        # default (use_neox_rotary_style=False) is the interleaved pairing,
        # neox the half-split pairing
        rv = rotary_tensor
        max_rot = int(rv.shape[2])
        if host_max is not None:
            if host_max >= max_rot:
                raise ValueError(
                    f"masked_multihead_attention: position {host_max} exceeds the "
                    f"rotary table (max_seq={max_rot}); build larger rotary_tensor tables")
        else:
            _check((pos < max_rot).all(), ValueError,
                   f"masked_multihead_attention: a position exceeds the rotary table "
                   f"(max_seq={max_rot}); build larger rotary_tensor tables")
        cos = rv[0][bidx, pos, 0].to(q.dtype)[:, None, :]   # (B, 1, D)
        sin = rv[1][bidx, pos, 0].to(q.dtype)[:, None, :]
        rotate = _rotate_half if use_neox_rotary_style else _rotate_every_two
        q = q * cos + rotate(q) * sin
        k = k * cos + rotate(k) * sin
    cache = cache_kv.clone()
    cache[0, bidx, :, pos] = k.to(cache.dtype)
    cache[1, bidx, :, pos] = v.to(cache.dtype)
    ck, cvv = cache[0], cache[1]
    mask = torch.arange(T, device=x.device)[None, None, :] <= pos[:, None, None]   # (B, 1, T)
    scale = torch.sqrt(torch.tensor(D, dtype=torch.float32)).to(q.dtype)
    logits = (torch.einsum("bhd,bhtd->bht", q, ck) / scale.to(q.device)).float()
    if src_mask is not None:
        # reference kernel: qk += mask (additive, [B, 1, 1, T] broadcast
        # over heads — masked_multihead_attention_kernel.cu:385)
        sm = torch.as_tensor(src_mask).to(x.device)
        if sm.shape[-1] != T or sm.shape[0] not in (1, B):
            raise ValueError(
                "masked_multihead_attention: src_mask must be "
                f"[B|1, 1, 1, T] with T={T} (the cache length); got "
                f"{tuple(sm.shape)}")
        logits = logits + sm.reshape(sm.shape[0], 1, T).float()
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, -1).to(q.dtype)
    out = torch.einsum("bht,bhtd->bhd", probs, cvv).reshape(B, H * D)
    return out, cache

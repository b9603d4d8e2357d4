"""Flash attention: the hand-written Hopper kernels (forward; backward dq and
dk/dv), their wrappers, their plain PyTorch versions and the autograd glue.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``: ``_fwd_kernel``
(launched by ``_fwd``) is ``paddle_tpu_torch/csrc/flash_attention_fwd.cu``;
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` (launched by ``_bwd``) are
``paddle_tpu_torch/csrc/flash_attention_bwd.cu``. Layout contract: paddle's
(batch, seq, num_heads, head_dim) at the entry, read through strides by the
kernels.

The kernels are ``torch.library`` ops, so a compiled graph (``jit.to_static``,
Inductor) calls them where eager code does: ``paddle_tpu_torch::
flash_attention_fwd`` (q, k, v, causal, scale, head_dim) -> (O, LSE) and
``paddle_tpu_torch::flash_attention_bwd`` (q, k, v, O, LSE, dO, causal,
scale) -> (dq, dk, dv). Each has a shape rule for fake tensors, and the
forward's autograd formula (``register_autograd``) is the backward op: the
JAX package's ``custom_vjp`` ``_flash``. Whatever reads an address (the TMA
alignment checks and copies) and the counters live in the ops' real
implementations, which a compiled step calls as an eager one does; the
head-dim pad (``_at_native_dim``) stays outside, in traced torch code, so the
ops only ever see the kernels' native head dims, and the forward op takes
the head dim before the pad (``head_dim``) to count the pad where it runs.

A tensor on the CPU takes the plain versions (the CPU tests and the card's
reference); a CUDA tensor launches the kernels or raises. The TPU kernels'
"shrink the block to a divisor or raise" rule is a TPU tiling artifact: the
kernels mask ragged tiles, so any Sq, Sk >= 1 runs. The kernels are built for
head dims 32, 64, 96, 128 and 256; on the card any other head dim up to 256
is zero-padded to the next of them and the result sliced back (zero columns
of q and k leave Q K^T unchanged, zero columns of v give zero output columns,
and the scale stays that of the true head dim), so the same kernels run.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.autograd import forward_ad as fwAD

from . import _build

_NAME = "flash_attention_fwd"
_NAME_BWD = "flash_attention_bwd"
_NEG_INF = -1e30

#: forward kernel launches since the count was last set to 0 (one per
#: wrapper call that reaches the card)
launches = 0
#: backward dq kernel launches, counted the same way
launches_bwd_dq = 0
#: backward dk/dv kernel launches, counted the same way
launches_bwd_dkv = 0
#: of those, the float32 kernels' (``fa_fwd_f32``, the ``F32Tile`` dq and
#: dk/dv), which master-grad training runs in its float32 pullbacks
launches_f32 = 0
launches_bwd_dq_f32 = 0
launches_bwd_dkv_f32 = 0
#: q, k or v tensors the forward wrapper copied because TMA cannot read them
#: where they lie (a base or a stride that is not a multiple of 16 bytes)
copies_for_alignment = 0
#: q, k or v tensors zero-padded along the head dim to the kernels' next
#: native head dim (the backward then gets a padded dO from autograd),
#: counted by the forward op, so a compiled or captured call counts too
pads_for_head_dim = 0

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
#: the head dims the kernels are built for; any other D <= 256 is padded
_HEAD_DIMS = (32, 64, 96, 128, 256)


class FlashShapeError(ValueError):
    """The shape policy refused the inputs. ``F.scaled_dot_product_attention``
    takes the math path for this error, and for no other."""


def _check_shapes(q, k, v, causal):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise FlashShapeError("flash attention takes (B, S, H, D) tensors")
    B, Sq, Hq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise FlashShapeError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} "
                              f"do not match q {tuple(q.shape)}")
    Sk, Hkv = k.shape[1], k.shape[2]
    if min(B, Sq, Sk, Hq, Hkv, D) < 1:
        raise FlashShapeError(f"empty attention: q {tuple(q.shape)}, "
                              f"k {tuple(k.shape)}")
    if Hq % Hkv != 0:
        raise FlashShapeError(f"GQA head counts {Hq}/{Hkv} not divisible")
    if causal and Sq > Sk:
        # rows past Sk would attend to nothing
        raise FlashShapeError(
            f"causal flash attention requires Sq<=Sk, got ({Sq},{Sk})")


def _check_kernel_dtypes(q, k, v):
    """The kernels' device and dtype rules (checked before a head dim is
    padded)."""
    if not (k.device == q.device and v.device == q.device):
        raise RuntimeError(f"q/k/v on different devices: {q.device}, "
                           f"{k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise FlashShapeError(
            f"kernel takes float32/float16/bfloat16 q/k/v of one dtype, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}")


def _check_kernel_inputs(q, k, v):
    """What the CUDA kernel takes beyond the shape rules (the wrappers pad
    other head dims to these before they launch it)."""
    _check_kernel_dtypes(q, k, v)
    if q.shape[3] not in _HEAD_DIMS:
        raise FlashShapeError(f"kernel takes head_dim in {_HEAD_DIMS}, got "
                              f"{q.shape[3]}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise FlashShapeError("kernel needs the head dim contiguous")


def _native_dim(D):
    """The smallest head dim the kernels are built for that holds ``D``;
    ``FlashShapeError`` above 256 (sdpa then takes the math path)."""
    for n in _HEAD_DIMS:
        if D <= n:
            return n
    raise FlashShapeError(f"kernel takes head_dim up to {_HEAD_DIMS[-1]}, got {D}")


def _pad_head_dim(ts, n):
    """Each tensor of ``ts`` zero-padded along its last dim to ``n``;
    differentiable, so a gradient is sliced back."""
    return [torch.nn.functional.pad(t, (0, n - t.shape[-1])) for t in ts]


def _at_native_dim(q, k, v, causal, scale):
    """The forward op at the kernels' next native head dim: q, k,
    v zero-padded there when D is not one, O sliced back to D; the padded
    columns' gradients are dropped by autograd (the pad's backward).
    ``scale`` is the true head dim's. Raises ``FlashShapeError`` above 256 or
    for a dtype the kernels do not take, before anything is padded."""
    _check_kernel_dtypes(q, k, v)
    D = q.shape[-1]
    n = _native_dim(D)
    if n == D:
        return _fwd_op(q, k, v, causal, scale, D)
    out, lse = _fwd_op(*_pad_head_dim((q, k, v), n), causal, scale, D)
    return out[..., :D], lse


def flash_attention_fwd_plain(q, k, v, causal=False, scale=None):
    """The plain PyTorch version: the kernel's function, written out.

    Returns (O (B, Sq, Hq, D) in q's dtype, LSE (B, Hq, Sq) float32). Scores,
    softmax and the weighted sum are float32, as in the kernel.
    """
    _check_shapes(q, k, v, causal)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    s = float(scale if scale is not None else 1.0 / math.sqrt(D))
    rep = Hq // Hkv
    qt = q.transpose(1, 2).float() * s
    kt = k.transpose(1, 2).float().repeat_interleave(rep, dim=1)
    vt = v.transpose(1, 2).float().repeat_interleave(rep, dim=1)
    scores = qt @ kt.transpose(-1, -2)                      # (B, Hq, Sq, Sk)
    if causal:
        # bottom-right aligned: key t visible to query s iff t <= s + Sk - Sq
        mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril(Sk - Sq)
        scores = scores.masked_fill(~mask, _NEG_INF)
    lse = torch.logsumexp(scores, dim=-1)
    out = torch.exp(scores - lse[..., None]) @ vt
    return out.transpose(1, 2).to(q.dtype), lse


def _needs_alignment_copy(t):
    """Whether TMA cannot read ``t`` where it lies: its base must be 16-byte
    aligned and the (batch, seq, head) strides positive multiples of 16 bytes
    (a dimension of size 1 is never stepped over, so its stride is free)."""
    elt = t.element_size()
    return t.data_ptr() % 16 != 0 or any(
        n > 1 and (st <= 0 or st * elt % 16 != 0)
        for n, st in zip(t.shape[:3], t.stride()[:3]))


def _strides(t):
    """(batch, seq, head) strides for the kernel; a dimension of size 1 gets
    the head dim as its stride, which TMA takes (it is never stepped over)."""
    return [st if n > 1 else t.shape[3] for n, st in zip(t.shape[:3], t.stride()[:3])]


def _tma_ready(t):
    """``t``, or an aligned contiguous copy of it where TMA cannot read it
    (counted in ``copies_for_alignment``): the same kernel runs either way."""
    global copies_for_alignment
    if not _needs_alignment_copy(t):
        return t
    copies_for_alignment += 1
    return t.clone(memory_format=torch.contiguous_format)


def _rows_ready(t):
    """A contiguous float32 (B, Hq, Sq) LSE, or a copy of it where its base is
    not 16-byte aligned (counted): the dk/dv kernel reads it by TMA."""
    global copies_for_alignment
    if t.data_ptr() % 16 == 0:
        return t
    copies_for_alignment += 1
    return t.clone()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(q, k, v, causal, scale):
    global launches, launches_f32
    _check_kernel_inputs(q, k, v)
    if q.dtype != torch.float32:  # the 16-bit kernel reads q, k, v by TMA
        q, k, v = _tma_ready(q), _tma_ready(k), _tma_ready(v)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    fn = _kernel()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                 _DTYPE_CODE[q.dtype], B, Hq, Hkv, Sq, Sk, D,
                 *_strides(q), *_strides(k), *_strides(v), *out.stride()[:3],
                 scale, int(causal), _stream(q))
    if err:
        _build.check(_build.load(_NAME), err, "flash_attention_fwd launch")
    launches += 1
    launches_f32 += q.dtype == torch.float32
    return out, lse


@functools.cache
def _kernel():
    """The C entry point, built and loaded on first use."""
    fn = _build.load(_NAME).pt_flash_attention_fwd
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # every pointer and the stream as c_void_p: an undeclared argument
    # would pass as a 32-bit int and cut the address
    fn.argtypes = [ptr] * 5 + [i32] * 7 + [i64] * 12 + [ctypes.c_float, i32, ptr]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_kernels():
    """The backward C entry points (dq, dk/dv), built and loaded on first use."""
    lib = _build.load(_NAME_BWD)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dq, dkv = lib.pt_flash_attention_bwd_dq, lib.pt_flash_attention_bwd_dkv
    # dq: q, k, v, dO, O, lse, delta (written), dq; dk/dv: q, k, v, dO, lse,
    # delta, dk, dv
    dq.argtypes = [ptr] * 8 + [i32] * 7 + [i64] * 15 + [ctypes.c_float, i32, ptr]
    dkv.argtypes = [ptr] * 8 + [i32] * 7 + [i64] * 12 + [ctypes.c_float, i32, ptr]
    dq.restype = dkv.restype = ctypes.c_int
    return dq, dkv


def _check_bwd_inputs(q, k, v, do, lse, delta=None, out=None):
    """What the backward kernels take beyond the forward's rules: dO (and O)
    like q with a contiguous head dim, LSE (and delta) contiguous float32
    (B, Hq, Sq). Raises ``FlashShapeError``."""
    _check_kernel_inputs(q, k, v)
    B, Sq, Hq, D = q.shape
    for name, t in (("dO", do), ("O", out)):
        if t is None:
            continue
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise FlashShapeError(f"{name} {tuple(t.shape)} {t.dtype} does not match q "
                                  f"{tuple(q.shape)} {q.dtype}")
        if t.stride(3) != 1:
            raise FlashShapeError(f"kernel needs {name}'s head dim contiguous, strides "
                                  f"{t.stride()}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t is None:
            continue
        if (t.shape != (B, Hq, Sq) or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != q.device):
            raise FlashShapeError(f"{name} must be a contiguous float32 (B, Hq, Sq) "
                                  f"tensor beside q, got {tuple(t.shape)} {t.dtype}")


def _delta(out, do):
    """delta = rowsum(dO * O) in float32, (B, Hq, Sq): the per-row term of dS,
    as the JAX package's ``_bwd`` computes it. The plain version's; on the
    card the dq kernel computes it."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _launch_bwd_dq(q, k, v, do, out, lse, causal, scale):
    """(dq, delta): the dq kernel, which also writes delta = rowsum(dO * O)
    for the dk/dv kernel. 16-bit inputs must be readable by TMA where they
    lie (``flash_attention_bwd`` copies what is not)."""
    global launches_bwd_dq, launches_bwd_dq_f32
    _check_bwd_inputs(q, k, v, do, lse, out=out)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    dq = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    fn = _bwd_kernels()[0]
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), _DTYPE_CODE[q.dtype],
                 B, Hq, Hkv, Sq, Sk, D, *_strides(q), *_strides(k), *_strides(v),
                 *_strides(do), *_strides(out), scale, int(causal), _stream(q))
    if err:
        _build.check(_build.load(_NAME_BWD), err, "flash_attention_bwd dq launch")
    launches_bwd_dq += 1
    launches_bwd_dq_f32 += q.dtype == torch.float32
    return dq, delta


def _launch_bwd_dkv(q, k, v, do, lse, delta, causal, scale):
    """(dk, dv), each summed over its GQA group, from the dq kernel's delta."""
    global launches_bwd_dkv, launches_bwd_dkv_f32
    _check_bwd_inputs(q, k, v, do, lse, delta)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    dk = torch.empty((B, Sk, Hkv, D), dtype=k.dtype, device=k.device)
    dv = torch.empty((B, Sk, Hkv, D), dtype=v.dtype, device=v.device)
    fn = _bwd_kernels()[1]
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), _DTYPE_CODE[q.dtype],
                 B, Hq, Hkv, Sq, Sk, D, *_strides(q), *_strides(k), *_strides(v),
                 *_strides(do), scale, int(causal), _stream(q))
    if err:
        _build.check(_build.load(_NAME_BWD), err, "flash_attention_bwd dk/dv launch")
    launches_bwd_dkv += 1
    launches_bwd_dkv_f32 += q.dtype == torch.float32
    return dk, dv


def flash_attention_bwd_plain(q, k, v, out, lse, do, causal=False, scale=None):
    """The plain PyTorch version of the backward kernels: (dq, dk, dv).

    Flash-attention-2's recomputation, written out in float32: P from the
    saved LSE, dP = dO V^T, dS = P (dP - rowsum(dO O)) scale, the three
    products and the sum of dk, dv over each GQA group. Gradients come back in
    the dtypes of q, k and v.
    """
    _check_shapes(q, k, v, causal)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    s = float(scale if scale is not None else 1.0 / math.sqrt(D))
    rep = Hq // Hkv
    qt = q.transpose(1, 2).float()
    kt = k.transpose(1, 2).float().repeat_interleave(rep, dim=1)
    vt = v.transpose(1, 2).float().repeat_interleave(rep, dim=1)
    dot = do.transpose(1, 2).float()
    scores = (qt * s) @ kt.transpose(-1, -2)                # (B, Hq, Sq, Sk)
    p = torch.exp(scores - lse[..., None])
    if causal:
        mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril(Sk - Sq)
        p = p.masked_fill(~mask, 0.0)
    dp = dot @ vt.transpose(-1, -2)
    delta = _delta(out, do)[..., None]
    ds = p * (dp - delta) * s
    dq = ds @ kt
    dk = (ds.transpose(-1, -2) @ qt).view(B, Hkv, rep, Sk, D).sum(2)
    dv = (p.transpose(-1, -2) @ dot).view(B, Hkv, rep, Sk, D).sum(2)
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def flash_attention_bwd(q, k, v, out, lse, do, causal=False, scale=None):
    """(dq, dk, dv) of flash attention from the forward's inputs, its output
    and LSE, and the output's gradient ``do``; all (B, S, H, D) but the LSE
    (B, Hq, Sq) float32.

    On the card: the dq kernel (which computes delta = rowsum(dO O) for its
    rows and writes it), then the dk/dv kernel (which reads delta and sums dk
    and dv over each GQA group itself). The head dim must be one the kernels
    are built for (the backward of a padded forward gets padded tensors from
    autograd). ``do`` and ``out`` need a contiguous head dim; anything else
    raises ``FlashShapeError``.
    """
    _check_shapes(q, k, v, causal)
    s = float(scale if scale is not None else 1.0 / math.sqrt(q.shape[-1]))
    return _bwd_op(q, k, v, out, lse, do, bool(causal), s)


def _device_check(t):
    if t.device.type != "cpu":
        raise RuntimeError(f"flash attention runs on CUDA or the CPU, not {t.device}")


@torch.library.custom_op("paddle_tpu_torch::flash_attention_fwd", mutates_args=())
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            scale: float, head_dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel on a CUDA tensor, the plain version on the CPU:
    (O (B, Sq, Hq, D) in q's dtype, LSE (B, Hq, Sq) float32), both
    contiguous. ``head_dim`` is the head dim before any pad: where q's
    differs, q, k and v were padded, and the call counts it in
    ``pads_for_head_dim``."""
    global pads_for_head_dim
    if head_dim != q.shape[-1]:
        pads_for_head_dim += 3
    if q.is_cuda:
        return _launch(q, k, v, causal, scale)
    _device_check(q)
    out, lse = flash_attention_fwd_plain(q, k, v, causal, scale)
    return out.contiguous(), lse.contiguous()


@_fwd_op.register_fake
def _fwd_fake(q, k, v, causal, scale, head_dim):
    B, Sq, Hq, D = q.shape
    return q.new_empty((B, Sq, Hq, D)), q.new_empty((B, Hq, Sq), dtype=torch.float32)


@torch.library.custom_op("paddle_tpu_torch::flash_attention_bwd", mutates_args=())
def _bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
            lse: torch.Tensor, do: torch.Tensor, causal: bool,
            scale: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dq and dk/dv kernels on CUDA tensors, the plain backward on the
    CPU: (dq, dk, dv) in the dtypes of q, k and v, contiguous."""
    if q.is_cuda:
        if q.dtype != torch.float32:
            # the 16-bit kernels read every input by TMA: copy (and count)
            # what it cannot read where it lies, once for both kernels
            q, k, v, do, out = (_tma_ready(t) for t in (q, k, v, do, out))
            lse = _rows_ready(lse)
        dq, delta = _launch_bwd_dq(q, k, v, do, out, lse, causal, scale)
        dk, dv = _launch_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
        return dq, dk, dv
    _device_check(q)
    dq, dk, dv = flash_attention_bwd_plain(q, k, v, out, lse, do, causal, scale)
    return dq.contiguous(), dk.contiguous(), dv.contiguous()


@_bwd_op.register_fake
def _bwd_fake(q, k, v, out, lse, do, causal, scale):
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            torch.empty_like(k, memory_format=torch.contiguous_format),
            torch.empty_like(v, memory_format=torch.contiguous_format))


def _fwd_setup_context(ctx, inputs, output):
    q, k, v, causal, scale, _ = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.causal, ctx.scale = causal, scale
    ctx.mark_non_differentiable(lse)


def _fwd_backward(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = _bwd_op(q, k, v, out, lse, dout, ctx.causal, ctx.scale)
    return dq, dk, dv, None, None, None


# the JAX package's custom_vjp ``_flash``: the forward saves (q, k, v, O, LSE)
# and the backward runs the two backward kernels
_fwd_op.register_autograd(_fwd_backward, setup_context=_fwd_setup_context)


def flash_attention_fwd_lse(q, k, v, causal=False, scale=None):
    """(O, LSE) for (B, S, H, D) inputs; LSE is (B, Hq, Sq) float32, the
    residual the backward needs. O is differentiable on both devices (the
    forward op's autograd formula runs the backward op).

    Raises ``FlashShapeError`` (a ValueError) for what the JAX entry rejects:
    ``Hq % Hkv != 0``, causal with ``Sq > Sk``, mismatched shapes. On the card
    it also raises it for inputs the kernels do not take: dtypes other than
    float32, float16 and bfloat16 (one dtype for q, k and v), head dims above
    256, and a head dim that is not contiguous. Head dims 32, 64, 96, 128 and
    256 run as they are; any other is zero-padded to the next of them
    (``_at_native_dim``). The backward kernels take every head dim the
    forward takes.
    """
    _check_shapes(q, k, v, causal)
    if not torch.compiler.is_compiling() and any(
            fwAD.unpack_dual(t).tangent is not None for t in (q, k, v)):
        # the JAX entry is a custom_vjp, which jax.jvp refuses; the op has
        # an autograd formula and no forward-mode rule
        raise TypeError("flash attention has no forward-mode (jvp) rule: "
                        "differentiate it in reverse mode")
    s = float(scale if scale is not None else 1.0 / math.sqrt(q.shape[-1]))
    if q.is_cuda:
        return _at_native_dim(q, k, v, bool(causal), s)
    _device_check(q)
    return _fwd_op(q, k, v, bool(causal), s, q.shape[-1])


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """(B, S, H, D) flash attention forward; see ``flash_attention_fwd_lse``."""
    return flash_attention_fwd_lse(q, k, v, causal, scale)[0]

"""Flash-attention forward: the hand-written Hopper kernel, its wrapper and its
plain PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py`` (``_fwd_kernel``,
launched by ``_fwd``); the kernel is ``paddle_tpu_torch/csrc/
flash_attention_fwd.cu``. Layout contract: paddle's (batch, seq, num_heads,
head_dim) at the entry, read through strides by the kernel.

A tensor on the CPU takes the plain version (the CPU tests and the card's
reference); a CUDA tensor launches the kernel or raises. The TPU kernel's
"shrink the block to a divisor or raise" rule is a TPU tiling artifact: the
kernel masks ragged tiles, so any Sq, Sk >= 1 runs.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

_NAME = "flash_attention_fwd"
_NEG_INF = -1e30

#: kernel launches since the count was last set to 0 (one per wrapper call
#: that reaches the card)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_HEAD_DIMS = (64, 128)


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


def _check_kernel_inputs(q, k, v):
    """What the CUDA kernel takes beyond the shape rules."""
    if not (k.device == q.device and v.device == q.device):
        raise RuntimeError(f"q/k/v on different devices: {q.device}, "
                           f"{k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise FlashShapeError(
            f"kernel takes float32/float16/bfloat16 q/k/v of one dtype, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.shape[3] not in _HEAD_DIMS:
        raise FlashShapeError(f"kernel takes head_dim in {_HEAD_DIMS}, got "
                              f"{q.shape[3]}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise FlashShapeError("kernel needs the head dim contiguous")


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


def _launch(q, k, v, causal, scale):
    global launches
    _check_kernel_inputs(q, k, v)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    # 16-byte vector loads need every (b, s, h) row of q/k/v 16-byte aligned
    elt = q.element_size()
    aligned16 = all(t.data_ptr() % 16 == 0 and all((st * elt) % 16 == 0
                                                  for st in t.stride()[:3])
                    for t in (q, k, v))
    fn = _kernel()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                 _DTYPE_CODE[q.dtype], B, Hq, Hkv, Sq, Sk, D,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                 scale, int(causal), int(aligned16),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        _build.check(_build.load(_NAME), err, "flash_attention_fwd launch")
    launches += 1
    return out, lse


@functools.cache
def _kernel():
    """The C entry point, built and loaded on first use."""
    fn = _build.load(_NAME).pt_flash_attention_fwd
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # every pointer and the stream as c_void_p: an undeclared argument
    # would pass as a 32-bit int and cut the address
    fn.argtypes = [ptr] * 5 + [i32] * 7 + [i64] * 12 + [ctypes.c_float, i32, i32, ptr]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_fwd_lse(q, k, v, causal=False, scale=None):
    """(O, LSE) for (B, S, H, D) inputs; LSE is (B, Hq, Sq) float32, the
    residual a backward pass needs.

    Raises ``FlashShapeError`` (a ValueError) for what the JAX entry rejects:
    ``Hq % Hkv != 0``, causal with ``Sq > Sk``, mismatched shapes. On the card
    it also raises it for inputs the kernel does not take: dtypes other than
    float32, float16 and bfloat16 (one dtype for q, k and v), head dims other
    than 64 and 128, and a head dim that is not contiguous.
    """
    _check_shapes(q, k, v, causal)
    s = float(scale if scale is not None else 1.0 / math.sqrt(q.shape[-1]))
    if q.is_cuda:
        return _launch(q, k, v, causal, s)
    if q.device.type != "cpu":
        raise RuntimeError(f"flash attention runs on CUDA or the CPU, not {q.device}")
    return flash_attention_fwd_plain(q, k, v, causal, s)


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """(B, S, H, D) flash attention forward; see ``flash_attention_fwd_lse``."""
    return flash_attention_fwd_lse(q, k, v, causal, scale)[0]

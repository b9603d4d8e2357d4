"""y = 2x + 1: the custom-op example's hand-written Hopper kernel, its plain
PyTorch version and its registration.

Counterpart of the test-only Pallas kernel ``kernel`` of
``tests/test_extension_points.py:57`` (launched by ``fwd``, :60-65), which the
JAX package's test registers as op ``test_pallas_axpy`` through
``register_custom_op(..., differentiable=False)``. The kernel is
``paddle_tpu_torch/csrc/axpy.cu``.

What bounds it on the card: bytes, 2 x elements x itemsize over 3.35 TB/s
(0.160 ms for 2^26 float32 elements); the kernel streams 16-byte vectors
(source note in ``axpy.cu``).

A tensor on the CPU takes the plain version; a CUDA tensor launches the kernel
or raises. On both, ``axpy`` takes float32, float16 and bfloat16 (anything else
raises ``TypeError``) and contiguous tensors (anything else raises
``ValueError``); the result is bit for bit the plain version's, NaN payloads
aside.

The kernel is the ``torch.library`` op ``paddle_tpu_torch::axpy``, so a
registered custom op that calls ``axpy`` traces under ``jit.to_static`` with
``full_graph=True`` and its compiled graph launches the kernel (the launch
counter lives in the op's real implementation).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ...utils.custom_op import register_custom_op

_NAME = "axpy"

#: kernel launches since the count was last set to 0 (one per ``axpy`` call
#: that reaches the card with at least one element)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def axpy_plain(x):
    """The plain PyTorch version: ``x * 2.0 + 1.0`` in x's dtype."""
    return x * 2.0 + 1.0


def _check(x):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"axpy takes float32, float16 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"axpy takes a contiguous tensor, got strides {x.stride()}")


@functools.cache
def _kernel():
    """The C entry point, built and loaded on first use."""
    fn = _build.load(_NAME).pt_axpy
    # every pointer and the stream as c_void_p: an undeclared argument would
    # pass as a 32-bit int and cut the address
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x):
    global launches
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _kernel()(x.data_ptr(), y.data_ptr(), x.numel(), _DTYPE_CODE[x.dtype],
                        stream)
    if err:
        _build.check(_build.load(_NAME), err, "axpy launch")
    launches += 1
    return y


@torch.library.custom_op("paddle_tpu_torch::axpy", mutates_args=())
def _axpy_op(x: torch.Tensor) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on the CPU; an empty
    tensor comes back empty without a launch."""
    if x.numel() == 0:
        return torch.empty_like(x)
    if x.is_cuda:
        return _launch(x)
    if x.device.type != "cpu":
        raise RuntimeError(f"axpy runs on CUDA or the CPU, not {x.device}")
    return axpy_plain(x)


@_axpy_op.register_fake
def _axpy_fake(x):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def axpy(x):
    """``x * 2 + 1`` in x's dtype: the kernel on the card, the plain version on
    the CPU. An empty tensor comes back empty without a launch. The result
    has no gradient on either device (the op is given a detached ``x``), so
    a differentiable registration of ``axpy`` raises ``CustomOpError`` at
    the backward pass, as a kernel launched outside autograd does."""
    _check(x)
    return _axpy_op(x.detach())


def register_example(name="test_pallas_axpy"):
    """Register ``axpy`` as custom op ``name``, as the JAX package's test
    registers its Pallas kernel: ``register_custom_op(name, fwd,
    differentiable=False)``. Returns the op."""
    return register_custom_op(name, axpy, differentiable=False)

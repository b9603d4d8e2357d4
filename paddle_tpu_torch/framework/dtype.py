"""Dtypes of the port: the port of ``paddle_tpu/framework/dtype.py``.

The JAX package's dtypes are numpy/jnp dtypes; here they are ``torch.dtype``s
under the same names. ``convert_dtype`` takes what a paddle script passes (a
name such as ``"float32"`` or ``"bf16"``, a ``torch.dtype``, a numpy dtype or
a Python type) and gives a ``torch.dtype``. The default dtype is the port's
own (the dtype of a Python float in ``to_tensor`` and of float creation ops):
``set_default_dtype`` does not change torch's.
"""
from __future__ import annotations

import numpy as np
import torch

bfloat16 = torch.bfloat16
float16 = torch.float16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
uint16 = torch.uint16
uint32 = torch.uint32
uint64 = torch.uint64
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128

_STR2DTYPE = {
    "bfloat16": bfloat16,
    "bf16": bfloat16,
    "float16": float16,
    "fp16": float16,
    "half": float16,
    "float32": float32,
    "fp32": float32,
    "float": float32,
    "float64": float64,
    "fp64": float64,
    "double": float64,
    "int8": int8,
    "int16": int16,
    "int32": int32,
    "int64": int64,
    "uint8": uint8,
    "uint16": uint16,
    "uint32": uint32,
    "uint64": uint64,
    "bool": bool_,
    "complex64": complex64,
    "complex128": complex128,
}

_DEFAULT_DTYPE = [torch.float32]


def set_default_dtype(d):
    _DEFAULT_DTYPE[0] = convert_dtype(d)


def get_default_dtype():
    return _DEFAULT_DTYPE[0]


def convert_dtype(dtype):
    """A ``torch.dtype`` from a name, a ``torch.dtype``, a numpy dtype or a
    Python type (None stays None)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        key = dtype.lower()
        if key not in _STR2DTYPE:
            raise ValueError(f"Unknown dtype string: {dtype!r}")
        return _STR2DTYPE[key]
    name = np.dtype(dtype).name
    if name not in _STR2DTYPE:
        raise ValueError(f"dtype {dtype!r} has no torch counterpart")
    return _STR2DTYPE[name]


def dtype_name(dtype) -> str:
    """Canonical paddle-style name ('float32', 'bfloat16', ...)."""
    return str(convert_dtype(dtype)).removeprefix("torch.")


def is_floating(dtype) -> bool:
    return convert_dtype(dtype).is_floating_point


def is_integer(dtype) -> bool:
    d = convert_dtype(dtype)
    return not (d.is_floating_point or d.is_complex or d == torch.bool)


def is_complex(dtype) -> bool:
    return convert_dtype(dtype).is_complex


def is_bool(dtype) -> bool:
    return convert_dtype(dtype) == torch.bool


def promote_types(a, b):
    return torch.promote_types(convert_dtype(a), convert_dtype(b))

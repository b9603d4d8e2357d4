"""Tensor creation ops: the port of ``paddle_tpu/ops/creation.py``.

The same ops under the same names: those the JAX package registers
(``zeros_like``, ``assign``, ``tril``, ...) are ``defop``s here too, the rest
plain functions. Float creation takes the port's default dtype
(``framework.dtype.get_default_dtype``), integer creation int64. A tensor
with no input tensor to follow is built where entry points build: on the
card, or on the CPU after ``device.set_device("cpu")``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework import dtype as dtype_mod
from ..framework.core import to_tensor  # noqa: F401  (re-export)
from ._apply import defop


def _device():
    from .. import resolve_device

    return resolve_device(None)


def _dt(dtype, default=None):
    d = dtype_mod.convert_dtype(dtype)
    if d is None:
        d = default if default is not None else dtype_mod.get_default_dtype()
    return d


def _scalar(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.reshape(-1).tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(_scalar(s)) for s in shape)


def zeros(shape, dtype=None, name=None):
    return torch.zeros(_shape(shape), dtype=_dt(dtype), device=_device())


def ones(shape, dtype=None, name=None):
    return torch.ones(_shape(shape), dtype=_dt(dtype), device=_device())


def full(shape, fill_value, dtype=None, name=None):
    fill_value = _scalar(fill_value)
    if dtype is None:
        if isinstance(fill_value, bool):
            dtype = torch.bool
        elif isinstance(fill_value, int):
            dtype = torch.int64
    return torch.full(_shape(shape), fill_value, dtype=_dt(dtype), device=_device())


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


@defop("zeros_like")
def _zeros_like(x, dtype=None):
    return torch.zeros_like(x, dtype=dtype_mod.convert_dtype(dtype))


@defop("ones_like")
def _ones_like(x, dtype=None):
    return torch.ones_like(x, dtype=dtype_mod.convert_dtype(dtype))


def zeros_like(x, dtype=None, name=None):
    return _zeros_like(x, dtype=dtype)


def ones_like(x, dtype=None, name=None):
    return _ones_like(x, dtype=dtype)


def full_like(x, fill_value, dtype=None, name=None):
    return torch.full(x.shape, _scalar(fill_value),
                      dtype=dtype_mod.convert_dtype(dtype) or x.dtype, device=x.device)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = (torch.int64
                 if all(isinstance(v, (int, np.integer)) for v in (start, end, step))
                 else dtype_mod.get_default_dtype())
    return torch.arange(start, end, step, dtype=_dt(dtype), device=_device())


def linspace(start, stop, num, dtype=None, name=None):
    return torch.linspace(_scalar(start), _scalar(stop), int(_scalar(num)),
                          dtype=_dt(dtype), device=_device())


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return torch.logspace(float(_scalar(start)), float(_scalar(stop)), int(_scalar(num)),
                          base=base, dtype=_dt(dtype), device=_device())


def eye(num_rows, num_columns=None, dtype=None, name=None):
    n = int(num_rows)
    return torch.eye(n, int(num_columns) if num_columns else n, dtype=_dt(dtype),
                     device=_device())


@defop("assign")
def _assign(x):
    return x.clone()


def assign(x, output=None):
    if not isinstance(x, torch.Tensor):
        x = to_tensor(x)
    out = _assign(x)
    if output is not None:
        output.copy_(out)
        return output
    return out


def clone(x):
    return assign(x)


@defop("tril")
def _tril(x, diagonal=0):
    return torch.tril(x, diagonal)


@defop("triu")
def _triu(x, diagonal=0):
    return torch.triu(x, diagonal)


def tril(x, diagonal=0, name=None):
    return _tril(x, diagonal=int(diagonal))


def triu(x, diagonal=0, name=None):
    return _triu(x, diagonal=int(diagonal))


def tril_indices(row, col=None, offset=0, dtype="int64"):
    col = col if col is not None else row
    return torch.tril_indices(row, col, offset, dtype=_dt(dtype), device=_device())


def triu_indices(row, col=None, offset=0, dtype="int64"):
    col = col if col is not None else row
    return torch.triu_indices(row, col, offset, dtype=_dt(dtype), device=_device())


@defop("diag")
def _diag(x, offset=0, padding_value=0):
    if x.dim() == 1:
        out = torch.diag(x, offset)
        if padding_value != 0:
            mask = torch.diag(torch.ones_like(x, dtype=torch.bool), offset)
            out = torch.where(mask, out, torch.tensor(padding_value, dtype=out.dtype,
                                                      device=out.device))
        return out
    return torch.diagonal(x, offset)


def diag(x, offset=0, padding_value=0, name=None):
    return _diag(x, offset=int(offset), padding_value=padding_value)


def diagflat(x, offset=0, name=None):
    return torch.diagflat(x, offset)


@defop("diag_embed")
def _diag_embed(x, offset=0, dim1=-2, dim2=-1):
    return torch.diag_embed(x, offset, dim1, dim2)


def diag_embed(x, offset=0, dim1=-2, dim2=-1):
    return _diag_embed(x, offset=int(offset), dim1=int(dim1), dim2=int(dim2))


def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = args[0]
    return list(torch.meshgrid(*args, indexing="ij"))


@defop("complex")
def _complex(real, imag):
    return torch.complex(real, imag)


def complex(real, imag, name=None):  # noqa: A001
    return _complex(real, imag)


@defop("polar")
def _polar(abs_, angle):
    return torch.polar(abs_, angle)


def polar(abs_, angle, name=None):
    return _polar(abs_, angle)


def numel(x, name=None):
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)

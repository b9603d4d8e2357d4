"""Reduction ops: the port of ``paddle_tpu/ops/reduction.py``.

``axis`` is None (every axis), an int, a list or tuple of ints or a tensor
of them; ``keepdim`` keeps reduced axes as size 1. ``median`` and
``nanmedian`` average the two middle values of an even count
(``mode="avg"``, numpy's and the JAX package's rule, where ``torch.median``
takes the lower one).
"""
from __future__ import annotations

import builtins

import torch

from ..framework import dtype as dtype_mod
from ._apply import defop
from .math import _float


def _axes(axis):
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        return tuple(int(v) for v in axis.reshape(-1).tolist())
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(x, axis):
    """``axis`` as the tuple of dims torch takes (every dim for None)."""
    if axis is None:
        return tuple(range(x.dim()))
    return (axis,) if isinstance(axis, int) else tuple(axis)


def _reduced(x, axis, keepdim):
    """``(x, dims, keepdim)`` for a torch reduction. An empty axis list
    reduces no axis (jnp's ``axis=()``), where torch's ``dim=()`` reduces
    every one: the reduction then runs over a new unit axis."""
    if axis == ():
        return x.unsqueeze(0), (0,), False
    return x, _dims(x, axis), keepdim


@defop("sum")
def _sum(x, axis=None, keepdim=False, dtype=None):
    x, dims, keepdim = _reduced(x, axis, keepdim)
    return torch.sum(x, dim=dims, keepdim=keepdim, dtype=dtype)


def sum(x, axis=None, dtype=None, keepdim=False, name=None):  # noqa: A001
    return _sum(x, axis=_axes(axis), keepdim=keepdim, dtype=dtype_mod.convert_dtype(dtype))


@defop("mean")
def _mean(x, axis=None, keepdim=False):
    x, dims, keepdim = _reduced(_float(x), axis, keepdim)
    return torch.mean(x, dim=dims, keepdim=keepdim)


def mean(x, axis=None, keepdim=False, name=None):
    return _mean(x, axis=_axes(axis), keepdim=keepdim)


@defop("prod")
def _prod(x, axis=None, keepdim=False, dtype=None):
    if dtype is not None:
        x = x.to(dtype)
    for d in sorted((a % builtins.max(x.dim(), 1) for a in _dims(x, axis)), reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    return _prod(x, axis=_axes(axis), keepdim=keepdim, dtype=dtype_mod.convert_dtype(dtype))


@defop("max")
def _max(x, axis=None, keepdim=False):
    x, dims, keepdim = _reduced(x, axis, keepdim)
    return torch.amax(x, dim=dims, keepdim=keepdim)


def max(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return _max(x, axis=_axes(axis), keepdim=keepdim)


@defop("min")
def _min(x, axis=None, keepdim=False):
    x, dims, keepdim = _reduced(x, axis, keepdim)
    return torch.amin(x, dim=dims, keepdim=keepdim)


def min(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return _min(x, axis=_axes(axis), keepdim=keepdim)


amax = max
amin = min


@defop("std")
def _std(x, axis=None, unbiased=True, keepdim=False):
    x, dims, keepdim = _reduced(_float(x), axis, keepdim)
    return torch.std(x, dim=dims, correction=1 if unbiased else 0, keepdim=keepdim)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _std(x, axis=_axes(axis), unbiased=unbiased, keepdim=keepdim)


@defop("var")
def _var(x, axis=None, unbiased=True, keepdim=False):
    x, dims, keepdim = _reduced(_float(x), axis, keepdim)
    return torch.var(x, dim=dims, correction=1 if unbiased else 0, keepdim=keepdim)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _var(x, axis=_axes(axis), unbiased=unbiased, keepdim=keepdim)


@defop("all", differentiable=False)
def _all(x, axis=None, keepdim=False):
    return torch.all(x, dim=_dims(x, axis), keepdim=keepdim)


def all(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return _all(x, axis=_axes(axis), keepdim=keepdim)


@defop("any", differentiable=False)
def _any(x, axis=None, keepdim=False):
    return torch.any(x, dim=_dims(x, axis), keepdim=keepdim)


def any(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return _any(x, axis=_axes(axis), keepdim=keepdim)


@defop("logsumexp")
def _logsumexp(x, axis=None, keepdim=False):
    x, dims, keepdim = _reduced(_float(x), axis, keepdim)
    return torch.logsumexp(x, dim=dims, keepdim=keepdim)


def logsumexp(x, axis=None, keepdim=False, name=None):
    return _logsumexp(x, axis=_axes(axis), keepdim=keepdim)


@defop("nansum")
def _nansum(x, axis=None, keepdim=False, dtype=None):
    return torch.nansum(x, dim=_dims(x, axis), keepdim=keepdim, dtype=dtype)


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    return _nansum(x, axis=_axes(axis), keepdim=keepdim, dtype=dtype_mod.convert_dtype(dtype))


@defop("nanmean")
def _nanmean(x, axis=None, keepdim=False):
    return torch.nanmean(_float(x), dim=_dims(x, axis), keepdim=keepdim)


def nanmean(x, axis=None, keepdim=False, name=None):
    return _nanmean(x, axis=_axes(axis), keepdim=keepdim)


def _middle(x, axis, keepdim, nan):
    """The median along ``axis`` (None: all), the mean of the two middle
    values of an even count; ``nan``: NaNs are left out of the count."""
    xx = _float(x)
    if axis is None:
        xx, ax = xx.reshape(-1), 0
    else:
        ax = axis % xx.dim()
    s = torch.sort(xx, dim=ax).values  # NaNs sort last
    if nan:
        n = (~torch.isnan(xx)).sum(dim=ax, keepdim=True)
    else:
        n = torch.full_like(s.narrow(ax, 0, 1), s.shape[ax], dtype=torch.int64)
    lo = ((n - 1).clamp(min=0) // 2)
    hi = (n // 2).clamp(max=s.shape[ax] - 1)
    out = (s.gather(ax, lo) + s.gather(ax, hi)) / 2
    if nan:
        out = torch.where(n > 0, out, torch.full_like(out, float("nan")))
    elif xx.is_floating_point():
        out = torch.where(torch.isnan(xx).any(dim=ax, keepdim=True),
                          torch.full_like(out, float("nan")), out)
    if axis is None:
        return out.reshape([1] * x.dim()) if keepdim else out.reshape(())
    return out if keepdim else out.squeeze(ax)


@defop("median")
def _median(x, axis=None, keepdim=False):
    return _middle(x, axis, keepdim, nan=False)


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    if mode == "min":
        ax = _axes(axis)
        xx = x.reshape(-1) if ax is None else x
        ax = 0 if ax is None else ax
        k = (xx.shape[ax] - 1) // 2
        return torch.sort(xx, dim=ax).values.select(ax, k)
    return _median(x, axis=_axes(axis), keepdim=keepdim)


@defop("nanmedian")
def _nanmedian(x, axis=None, keepdim=False):
    return _middle(x, axis, keepdim, nan=True)


def nanmedian(x, axis=None, keepdim=False, mode="avg", name=None):
    return _nanmedian(x, axis=_axes(axis), keepdim=keepdim)


def _quantile_in(x, q, axis):
    x = _float(x)
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    return (x.reshape(-1), qt, 0) if axis is None else (x, qt, axis)


@defop("quantile")
def _quantile(x, q, axis=None, keepdim=False, interpolation="linear"):
    xx, qt, ax = _quantile_in(x, q, axis)
    out = torch.quantile(xx, qt, dim=ax, keepdim=keepdim, interpolation=interpolation)
    if axis is None and keepdim:
        out = out.reshape(out.shape[:qt.dim()] + (1,) * x.dim())
    return out


def quantile(x, q, axis=None, keepdim=False, interpolation="linear", name=None):
    return _quantile(x, q, axis=_axes(axis), keepdim=keepdim, interpolation=interpolation)


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    xx, qt, ax = _quantile_in(x, q, _axes(axis))
    out = torch.nanquantile(xx, qt, dim=ax, keepdim=keepdim)
    if axis is None and keepdim:
        out = out.reshape(out.shape[:qt.dim()] + (1,) * x.dim())
    return out


@defop("count_nonzero", differentiable=False)
def _count_nonzero(x, axis=None, keepdim=False):
    return torch.sum(x != 0, dim=_dims(x, axis), keepdim=keepdim)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    return _count_nonzero(x, axis=_axes(axis), keepdim=keepdim)


@defop("norm_op")
def _norm(x, p=None, axis=None, keepdim=False):
    dims = _dims(x, axis)
    if p is None or p == "fro":
        return torch.sqrt(torch.sum(torch.square(torch.abs(x)), dim=dims,
                                    keepdim=keepdim and axis is not None))
    if p == "nuc":
        return torch.linalg.matrix_norm(x, "nuc", dim=dims, keepdim=keepdim)
    if p == float("inf"):
        return torch.amax(torch.abs(x), dim=dims, keepdim=keepdim)
    if p == float("-inf"):
        return torch.amin(torch.abs(x), dim=dims, keepdim=keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), dim=dims, keepdim=keepdim)
    return torch.sum(torch.abs(x) ** p, dim=dims, keepdim=keepdim) ** (1.0 / p)


def norm(x, p=None, axis=None, keepdim=False, name=None):
    return _norm(x, p=p, axis=_axes(axis), keepdim=keepdim)


@defop("dist")
def _dist(x, y, p=2.0):
    d = x - y
    if p == float("inf"):
        return torch.amax(torch.abs(d))
    if p == float("-inf"):
        return torch.amin(torch.abs(d))
    if p == 0:
        return torch.sum((d != 0).to(d.dtype))
    return torch.sum(torch.abs(d) ** p) ** (1.0 / p)


def dist(x, y, p=2.0, name=None):
    return _dist(x, y, p=float(p))

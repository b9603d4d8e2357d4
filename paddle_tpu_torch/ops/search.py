"""Search and sort ops: the port of ``paddle_tpu/ops/search.py``.

Indices come back as int64 (``argmax``/``argmin`` in ``dtype``), through the
``cast`` op as the JAX wrappers cast them. ``topk`` and ``kthvalue`` break
ties as the JAX functions do on distinct values; ``mode`` takes the smallest
of the most frequent values and the last index where it occurs.
"""
from __future__ import annotations

import torch

from ._apply import defop
from .manipulation import cast


@defop("argmax", differentiable=False)
def _argmax(x, axis=None, keepdim=False):
    if axis is None:
        return torch.argmax(x.reshape(-1))
    return torch.argmax(x, dim=axis, keepdim=keepdim)


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    out = _argmax(x, axis=axis if axis is None else int(axis), keepdim=keepdim)
    return cast(out, dtype)


@defop("argmin", differentiable=False)
def _argmin(x, axis=None, keepdim=False):
    if axis is None:
        return torch.argmin(x.reshape(-1))
    return torch.argmin(x, dim=axis, keepdim=keepdim)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    out = _argmin(x, axis=axis if axis is None else int(axis), keepdim=keepdim)
    return cast(out, dtype)


@defop("argsort", differentiable=False)
def _argsort(x, axis=-1, descending=False, stable=False):
    return torch.argsort(x, dim=axis, descending=descending, stable=True)


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    return cast(_argsort(x, axis=int(axis), descending=bool(descending),
                         stable=bool(stable)), "int64")


@defop("sort")
def _sort(x, axis=-1, descending=False):
    return torch.sort(x, dim=axis, descending=descending, stable=True).values


def sort(x, axis=-1, descending=False, stable=False, name=None):
    return _sort(x, axis=int(axis), descending=bool(descending))


@defop("topk")
def _topk(x, k, axis=-1, largest=True, sorted=True):  # noqa: A002
    v, i = torch.topk(x, k, dim=axis, largest=largest, sorted=True)
    return v, i


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):  # noqa: A002
    if isinstance(k, torch.Tensor):
        k = int(k.item())
    v, i = _topk(x, k=int(k), axis=int(axis), largest=bool(largest), sorted=bool(sorted))
    return v, cast(i, "int64")


@defop("kthvalue")
def _kthvalue(x, k, axis=-1, keepdim=False):
    s, si = torch.sort(x, dim=axis, stable=True)
    v = s.select(axis, k - 1)
    i = si.select(axis, k - 1)
    if keepdim:
        v, i = v.unsqueeze(axis), i.unsqueeze(axis)
    return v, i


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    v, i = _kthvalue(x, k=int(k), axis=int(axis), keepdim=bool(keepdim))
    return v, cast(i, "int64")


@defop("mode_op")
def _mode(x, axis=-1, keepdim=False):
    xm = torch.movedim(x, axis, -1)
    flat = xm.reshape(-1, xm.shape[-1])
    n = flat.shape[-1]
    s = torch.sort(flat, dim=-1).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    grp = torch.cumsum(first.long(), -1) - 1
    counts = torch.zeros_like(grp).scatter_add_(-1, grp, torch.ones_like(grp))
    runcnt = torch.gather(counts, -1, grp)
    # the first index of the longest run: ties go to the smallest value
    best = torch.argmax(runcnt, dim=-1, keepdim=True)
    val = torch.gather(s, -1, best)
    pos = torch.arange(n, device=x.device).expand_as(flat)
    idx = torch.where(flat == val, pos, torch.full_like(pos, -1)).amax(-1)
    vals = val.squeeze(-1).reshape(xm.shape[:-1])
    idxs = idx.reshape(xm.shape[:-1])
    if keepdim:
        vals, idxs = vals.unsqueeze(axis), idxs.unsqueeze(axis)
    return vals, idxs


def mode(x, axis=-1, keepdim=False, name=None):
    v, i = _mode(x, axis=int(axis), keepdim=bool(keepdim))
    return v, cast(i, "int64")


@defop("searchsorted", differentiable=False)
def _searchsorted(sorted_sequence, values, right=False):
    return torch.searchsorted(sorted_sequence, values, right=right)


def searchsorted(sorted_sequence, values, out_int32=False, right=False, name=None):
    out = _searchsorted(sorted_sequence, values, right=bool(right))
    return cast(out, "int32" if out_int32 else "int64")


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)

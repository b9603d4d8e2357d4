"""``getitem`` and ``setitem_`` with paddle's indexing rules: the port of
``paddle_tpu/ops/indexing.py``.

An index is an int, a slice (a negative step as numpy's), ``None``,
``Ellipsis``, an integer tensor, a list or an array, or a tuple of them,
with numpy's rules for advanced indexing. A 1-D boolean mask, or a boolean
list, becomes the indices of its True entries; a k-D boolean tensor alone
selects cells over the first k dims (``[n_true, *trailing]``), and with
other indices raises ``NotImplementedError``, as in the JAX package. The
op ``getitem`` serves ``strided_slice`` and ``crop`` too.

``setitem_(x, idx, value)`` writes in place. Its value is the JAX op's
(``x.at[idx].set(value)``): the op ``setitem`` builds the new tensor out
of place, so the gradient reaches ``value`` and the cells of the old ``x``
that were not written, and ``x`` takes it with one in-place copy, which
autograd records. A leaf that requires grad cannot be written in place in
torch: there it raises, as ``reshape_`` does (the JAX package swaps the
value under its tape).
"""
from __future__ import annotations

import numpy as np
import torch

from ._apply import defop

_py_slice = slice


def _as_index_tensor(it, device):
    if isinstance(it, torch.Tensor):
        if it.dtype == torch.bool and it.dim() == 1:
            return torch.nonzero(it).reshape(-1)
        return it
    arr = np.asarray(it)
    if arr.dtype == np.bool_:
        return torch.from_numpy(np.nonzero(arr)[0]).to(device)
    return torch.as_tensor(arr, device=device)


def _norm_index(idx, device):
    """The index as a tuple with tensors for every array-like part."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    return tuple(_as_index_tensor(it, device)
                 if isinstance(it, (torch.Tensor, list, np.ndarray)) else it for it in idx)


def _dims_taken(it):
    if it is None:
        return 0
    if isinstance(it, torch.Tensor) and it.dtype == torch.bool:
        return it.dim()
    return 1


def _positive_steps(x, idx):
    """Apply every negative-step slice of ``idx`` to ``x`` (a flip of the
    positive-step slice that visits the same elements) and return the
    index with those slices replaced by full ones."""
    if not any(isinstance(it, _py_slice) and it.step is not None and it.step < 0
               for it in idx):
        return x, idx
    n_ell = sum(1 for it in idx if it is Ellipsis)
    fill = x.dim() - sum(_dims_taken(it) for it in idx if it is not Ellipsis)
    dim, out = 0, []
    for it in idx:
        if it is Ellipsis:
            dim += fill if n_ell else 0
            out.append(it)
            continue
        if isinstance(it, _py_slice) and it.step is not None and it.step < 0:
            start, stop, step = it.indices(x.shape[dim])
            pos = list(range(start, stop, step))
            if pos:
                sl = (_py_slice(None),) * dim + (_py_slice(pos[-1], pos[0] + 1, -step),)
                x = torch.flip(x[sl], (dim,))
            else:
                x = x.narrow(dim, 0, 0)
            it = _py_slice(None)
        out.append(it)
        dim += _dims_taken(it)
    return x, tuple(out)


@defop("getitem")
def _getitem(x, idx):
    x, idx = _positive_steps(x, idx)
    return x[idx]


def getitem(x, idx):
    """``x[idx]`` with paddle's rules (the module's docstring)."""
    idx = _norm_index(idx, x.device)
    if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in idx):
        if len(idx) != 1:
            raise NotImplementedError("mixed boolean advanced indexing")
        mask = idx[0]
        from .manipulation import gather, masked_select, reshape

        if mask.dim() == x.dim():
            return masked_select(x, mask)
        k = mask.dim()
        lead = int(np.prod(tuple(x.shape[:k])))
        flat = reshape(x, [lead] + list(x.shape[k:]))
        return gather(flat, torch.nonzero(mask.reshape(-1)).reshape(-1), axis=0)
    return _getitem(x, idx=idx)


@defop("setitem")
def _setitem(x, idx, value):
    out = x.clone()
    out[idx] = value.to(x.dtype)
    return out


def setitem_(x, idx, value):
    """``x[idx] = value`` in place (the module's docstring)."""
    if x.is_leaf and x.requires_grad:
        raise RuntimeError(
            "setitem_: a leaf tensor that requires grad cannot be written in place in "
            "torch; write into a copy (the JAX package swaps the value under its tape)")
    idx = _norm_index(idx, x.device)
    if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in idx) and len(idx) == 1:
        from .manipulation import _masked_fill, _where

        mask = idx[0]
        if isinstance(value, torch.Tensor):
            out = _where(mask, value.to(x.dtype), x)
        else:
            out = _masked_fill(x, mask, value)
    else:
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value), device=x.device)
        out = _setitem(x, idx, value)
    x.copy_(out)
    return x

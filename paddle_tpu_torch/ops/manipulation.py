"""Shape and layout manipulation ops: the port of
``paddle_tpu/ops/manipulation.py``.

Paddle's semantics where torch's differ: ``reshape``'s 0 copies the input's
dim; ``split`` takes a count or section sizes (one of them -1); ``squeeze``
drops only the named axes that have size 1; ``expand``'s -1 keeps a dim;
``transpose`` takes the full permutation; ``unsqueeze`` takes several axes;
``pad`` takes paddle's pairs. The ops whose output shape depends on the data
(``nonzero``, ``masked_select``, ``unique``, ``unique_consecutive``) read the
data on the host, as in the JAX package. In-place forms write into ``x``
(``copy_``); ``reshape_`` changes ``x``'s shape where it needs no gradient.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework import dtype as dtype_mod
from ._apply import defop
from .indexing import _getitem


def _ints(seq):
    if isinstance(seq, torch.Tensor):
        return tuple(int(v) for v in seq.reshape(-1).tolist())
    if isinstance(seq, (bool, int, np.integer)):
        return (_int(seq),)
    return tuple(_int(v) for v in seq)


def _int(v):
    # an int subclass passes as it is: a static graph's dynamic dim
    # (framework/capture.py ``_SymDim``) must reach the recorded op
    if isinstance(v, int) and not isinstance(v, bool):
        return v
    return int(v.item() if isinstance(v, torch.Tensor) else v)


@defop("cast")
def _cast(x, dtype):
    return x.to(dtype)


def cast(x, dtype):
    d = dtype_mod.convert_dtype(dtype)
    if x.dtype == d:
        from .creation import assign

        return assign(x)
    return _cast(x, dtype=d)


@defop("reshape")
def _reshape(x, shape):
    return torch.reshape(x, shape)


def reshape(x, shape, name=None):
    shape = list(_ints(shape))
    # paddle semantics: 0 means "copy dim from input"
    for i, s in enumerate(shape):
        if s == 0:
            shape[i] = x.shape[i]
    return _reshape(x, shape=tuple(shape))


def reshape_(x, shape, name=None):
    out = reshape(x, shape)
    if x.requires_grad:
        raise RuntimeError("reshape_ changes the shape of a tensor in place, which "
                           "autograd cannot follow for a tensor that requires grad; "
                           "use reshape")
    with torch.no_grad():
        x.set_(out.contiguous())
    return x


view = reshape


def view_as(x, other, name=None):
    return reshape(x, other.shape)


@defop("transpose")
def _transpose(x, perm):
    return torch.permute(x, perm)


def transpose(x, perm, name=None):
    return _transpose(x, perm=_ints(perm))


def t(x, name=None):
    if x.dim() < 2:
        from .creation import assign

        return assign(x)
    return transpose(x, [1, 0])


@defop("concat")
def _concat(xs, axis=0):
    return torch.cat(list(xs), dim=axis)


def concat(x, axis=0, name=None):
    return _concat(list(x), axis=_int(axis))


@defop("stack")
def _stack(xs, axis=0):
    return torch.stack(list(xs), dim=axis)


def stack(x, axis=0, name=None):
    return _stack(list(x), axis=int(axis))


@defop("split_op")
def _split(x, indices, axis):
    return tuple(torch.tensor_split(x, list(indices), dim=axis))


def split(x, num_or_sections, axis=0, name=None):
    axis = _int(axis)
    dim = x.shape[axis]
    if isinstance(num_or_sections, int):
        n = num_or_sections
        indices = [dim // n * i for i in range(1, n)]
    else:
        secs = list(_ints(num_or_sections))
        total_known = sum(s for s in secs if s > 0)
        secs = [s if s > 0 else dim - total_known for s in secs]
        indices = list(np.cumsum(secs)[:-1])
    return list(_split(x, indices=tuple(int(i) for i in indices), axis=axis))


def chunk(x, chunks, axis=0, name=None):
    return split(x, int(chunks), axis)


def tensor_split(x, num_or_indices, axis=0, name=None):
    if isinstance(num_or_indices, int):
        return list(torch.tensor_split(x, num_or_indices, dim=int(axis)))
    # a list is cut indices (numpy's array_split), not section sizes
    return list(_split(x, indices=_ints(num_or_indices), axis=int(axis)))


@defop("squeeze")
def _squeeze(x, axis=None):
    return torch.squeeze(x) if axis is None else torch.squeeze(x, axis)


def squeeze(x, axis=None, name=None):
    if axis is not None:
        ax = tuple(a for a in _ints(axis) if x.shape[a] == 1)
        if not ax:
            from .creation import assign

            return assign(x)
        return _squeeze(x, axis=ax)
    return _squeeze(x, axis=None)


squeeze_ = squeeze


@defop("unsqueeze")
def _unsqueeze(x, axis):
    nd = x.dim() + len(axis)
    for a in sorted(a % nd for a in axis):
        x = torch.unsqueeze(x, a)
    return x


def unsqueeze(x, axis, name=None):
    return _unsqueeze(x, axis=_ints(axis))


unsqueeze_ = unsqueeze


@defop("flatten_op")
def _flatten(x, start_axis=0, stop_axis=-1):
    return torch.flatten(x, start_axis, stop_axis)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    return _flatten(x, start_axis=int(start_axis), stop_axis=int(stop_axis))


@defop("tile")
def _tile(x, repeat_times):
    return torch.tile(x, repeat_times)


def tile(x, repeat_times, name=None):
    return _tile(x, repeat_times=_ints(repeat_times))


@defop("expand")
def _expand(x, shape):
    return x.expand(*shape)


def expand(x, shape, name=None):
    return _expand(x, shape=_ints(shape))


broadcast_to = expand


def expand_as(x, y, name=None):
    return expand(x, y.shape)


def broadcast_tensors(inputs, name=None):
    return list(torch.broadcast_tensors(*inputs))


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


@defop("flip")
def _flip(x, axis):
    return torch.flip(x, axis)


def flip(x, axis, name=None):
    return _flip(x, axis=_ints(axis))


@defop("rot90")
def _rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(x, k, axes)


def rot90(x, k=1, axes=(0, 1), name=None):
    return _rot90(x, k=int(k), axes=tuple(_ints(axes)))


@defop("roll")
def _roll(x, shifts, axis=None):
    return torch.roll(x, shifts, axis)


def roll(x, shifts, axis=None, name=None):
    return _roll(x, shifts=shifts if isinstance(shifts, int) else _ints(shifts),
                 axis=_ints(axis) if axis is not None else None)


@defop("diff")
def _diff(x, prepend=None, append=None, n=1, axis=-1):
    return torch.diff(x, n=n, dim=axis, prepend=prepend, append=append)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    return _diff(x, prepend, append, n=int(n), axis=int(axis))


def _take(x, index, axis):
    """numpy's ``take`` along ``axis`` for an index of any shape."""
    axis = axis % x.dim()
    out = torch.index_select(x, axis, index.reshape(-1))
    return out.reshape(x.shape[:axis] + index.shape + x.shape[axis + 1:])


@defop("gather")
def _gather(x, index, axis=0):
    return _take(x, index, axis)


def gather(x, index, axis=0, name=None):
    if index.dim() == 2 and index.shape[1] == 1:
        index = index.reshape(-1)
    return _gather(x, index, axis=_int(axis))


@defop("gather_nd")
def _gather_nd(x, index):
    return x[tuple(torch.movedim(index, -1, 0))]


def gather_nd(x, index, name=None):
    return _gather_nd(x, index)


@defop("scatter_op")
def _scatter(x, index, updates, overwrite=True):
    if index.dim() == 2:
        index = index[:, 0]
    if overwrite:
        return x.index_put((index,), updates)
    # paddle overwrite=False: zero the rows, then accumulate
    zeroed = x.index_put((index,), torch.zeros_like(updates))
    return zeroed.index_put((index,), updates, accumulate=True)


def scatter(x, index, updates, overwrite=True, name=None):
    return _scatter(x, index, updates, overwrite=bool(overwrite))


def scatter_(x, index, updates, overwrite=True, name=None):
    x.copy_(scatter(x, index, updates, overwrite))
    return x


@defop("scatter_nd_add")
def _scatter_nd_add(x, index, updates):
    return x.index_put(tuple(torch.movedim(index, -1, 0)), updates, accumulate=True)


def scatter_nd_add(x, index, updates, name=None):
    return _scatter_nd_add(x, index, updates)


def scatter_nd(index, updates, shape, name=None):
    base = torch.zeros(_ints(shape), dtype=updates.dtype, device=updates.device)
    return scatter_nd_add(base, index, updates)


@defop("index_select")
def _index_select(x, index, axis=0):
    return _take(x, index, axis)


def index_select(x, index, axis=0, name=None):
    return _index_select(x, index, axis=int(axis))


@defop("index_sample")
def _index_sample(x, index):
    return torch.gather(x, 1, index)


def index_sample(x, index, name=None):
    return _index_sample(x, index)


@defop("index_add")
def _index_add(x, index, value, axis=0):
    return torch.index_add(x, axis, index, value)


def index_add(x, index, axis, value, name=None):
    return _index_add(x, index, value, axis=int(axis))


@defop("index_put")
def _index_put(x, indices, value, accumulate=False):
    return x.index_put(tuple(indices), value, accumulate=accumulate)


def index_put(x, indices, value, accumulate=False, name=None):
    return _index_put(x, tuple(indices), value, accumulate=bool(accumulate))


@defop("index_fill")
def _index_fill(x, index, value, axis=0):
    return torch.index_fill(x, axis, index, value)


def index_fill(x, index, axis, value, name=None):
    return _index_fill(x, index, value, axis=int(axis))


@defop("masked_fill")
def _masked_fill(x, mask, value):
    if isinstance(value, torch.Tensor):
        v = value.to(x.dtype)
    elif isinstance(value, float) and x.is_floating_point():
        v = torch.full((), value, dtype=torch.float64, device=x.device).to(x.dtype)
    else:
        v = torch.full((), value, dtype=x.dtype, device=x.device)
    return torch.where(mask, v, x)


def masked_fill(x, mask, value, name=None):
    return _masked_fill(x, mask, value)


@defop("where_op")
def _where(condition, x, y):
    from .math import _pair

    return torch.where(condition, *_pair(x, y))


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    return _where(condition, x, y)


@defop("take_along_axis")
def _take_along_axis(x, indices, axis):
    return torch.take_along_dim(x, indices, dim=axis)


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    return _take_along_axis(arr, indices, axis=int(axis))


@defop("put_along_axis")
def _put_along_axis(x, indices, values, axis, reduce="assign", include_self=True,
                    broadcast=False):
    if broadcast:
        tgt = list(x.shape)
        tgt[axis] = indices.shape[axis]
        indices = indices.expand(tgt)
        values = values.expand(tgt)
    if reduce == "assign":
        return torch.scatter(x, axis, indices, values)
    if reduce not in ("add", "sum", "mul", "multiply"):
        raise ValueError(f"unknown reduce {reduce}")
    # the JAX package zeroes the indexed cells when include_self is False,
    # then accumulates into them (so "mul" gives 0 there)
    base = x if include_self else torch.scatter(x, axis, indices, torch.zeros_like(values))
    indices = indices.expand(x.shape)
    values = values.expand(x.shape)
    if reduce in ("add", "sum"):
        return torch.scatter_add(base, axis, indices, values)
    return torch.scatter_reduce(base, axis, indices, values, "prod", include_self=True)


def put_along_axis(arr, indices, values, axis, reduce="assign", include_self=True,
                   broadcast=True, name=None):
    if not isinstance(values, torch.Tensor):
        values = torch.tensor(values, dtype=arr.dtype, device=arr.device)
    return _put_along_axis(arr, indices, values, axis=int(axis), reduce=reduce,
                           include_self=bool(include_self), broadcast=bool(broadcast))


@defop("repeat_interleave")
def _repeat_interleave(x, repeats, axis=None):
    return torch.repeat_interleave(x, repeats, dim=axis)


def repeat_interleave(x, repeats, axis=None, name=None):
    if isinstance(repeats, torch.Tensor):
        return torch.repeat_interleave(x, repeats, dim=axis)
    return _repeat_interleave(x, repeats=int(repeats), axis=axis)


def unbind(x, axis=0, name=None):
    n = x.shape[int(axis)]
    return [squeeze(o, [int(axis)]) for o in split(x, n, axis)]


unstack = unbind


@defop("moveaxis")
def _moveaxis(x, source, destination):
    return torch.movedim(x, source, destination)


def moveaxis(x, source, destination, name=None):
    return _moveaxis(x, source=_ints(source), destination=_ints(destination))


def swapaxes(x, axis0, axis1, name=None):
    perm = list(range(x.dim()))
    perm[axis0], perm[axis1] = perm[axis1], perm[axis0]
    return transpose(x, perm)


@defop("as_strided")
def _as_strided(x, shape, stride, offset=0):
    idx = torch.full(tuple(shape), offset, dtype=torch.int64, device=x.device)
    for dim, (s, st) in enumerate(zip(shape, stride)):
        view = [-1 if i == dim else 1 for i in range(len(shape))]
        idx = idx + (torch.arange(s, device=x.device) * st).reshape(view)
    return torch.reshape(x, (-1,))[idx]


def as_strided(x, shape, stride, offset=0, name=None):
    return _as_strided(x, shape=_ints(shape), stride=_ints(stride), offset=int(offset))


_py_slice = slice  # the builtin, before the public ``slice`` op shadows it


@defop("slice_op")
def _slice(x, axes, starts, ends):
    idx = [_py_slice(None)] * x.dim()
    for a, s, e in zip(axes, starts, ends):
        idx[a] = _py_slice(s, e)
    return x[tuple(idx)]


def slice(x, axes, starts, ends):  # noqa: A001
    axes = _ints(axes)
    norm_s, norm_e = [], []
    for a, s, e in zip(axes, starts, ends):
        n = x.shape[a]
        s, e = _int(s), _int(e)
        s = s + n if s < 0 else s
        e = e + n if e < 0 else e
        norm_s.append(min(max(s, 0), n))
        norm_e.append(min(max(e, 0), n))
    return _slice(x, axes=tuple(axes), starts=tuple(norm_s), ends=tuple(norm_e))


def strided_slice(x, axes, starts, ends, strides, name=None):
    idx = [_py_slice(None)] * x.dim()
    for a, s, e, st in zip(_ints(axes), _ints(starts), _ints(ends), _ints(strides)):
        idx[a] = _py_slice(s, e, st)
    return _getitem(x, tuple(idx))


def _pad_index(n, lo, hi, mode, device):
    """The source index of every output position along one dim."""
    pos = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return pos.clamp(0, n - 1)
    if mode == "circular":
        return pos % n
    period = 2 * (n - 1)  # reflect: ... 2 1 | 0 1 2 ... n-1 | n-2 ...
    pos = pos.abs() % period if period else torch.zeros_like(pos)
    return torch.where(pos >= n, period - pos, pos)


@defop("pad_op")
def _pad(x, pad, mode="constant", value=0.0):
    nd = x.dim()
    if len(pad) == 2 * nd:
        cfg = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        # paddle's NCHW convention: pairs for the trailing dims
        k = len(pad) // 2
        cfg = [(0, 0)] * (nd - k) + [(pad[2 * i], pad[2 * i + 1]) for i in range(k)]
    if mode == "constant":
        flat = [v for lo_hi in reversed(cfg) for v in lo_hi]
        return torch.nn.functional.pad(x, flat, mode="constant", value=value)
    if mode not in ("reflect", "replicate", "circular"):
        raise ValueError(f"unknown pad mode {mode!r}")
    for dim, (lo, hi) in enumerate(cfg):
        if lo or hi:
            x = torch.index_select(x, dim, _pad_index(x.shape[dim], lo, hi, mode, x.device))
    return x


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):  # noqa: A002
    pad = list(_ints(pad))
    nd = x.dim()
    if len(pad) != 2 * nd:
        # paddle's functional pad: [left, right, top, bottom, ...] over spatial dims
        k = len(pad) // 2
        pairs = [(pad[2 * i], pad[2 * i + 1]) for i in range(k)][::-1]
        if data_format.endswith("C") and nd >= 3:  # NHWC / NLC / NDHWC
            cfg = [(0, 0)] + list(pairs) + [(0, 0)]
            cfg += [(0, 0)] * (nd - len(cfg))
        else:
            cfg = [(0, 0)] * (nd - k) + list(pairs)
        pad = [v for p in cfg for v in p]
    return _pad(x, pad=tuple(pad), mode=mode, value=float(value))


# ---- data-dependent output shapes: read on the host -----------------------
def _host(x):
    return (x.detach().float() if x.dtype == torch.bfloat16 else x.detach()).cpu().numpy()


def nonzero(x, as_tuple=False):
    idx = np.nonzero(_host(x))
    if as_tuple:
        return tuple(torch.from_numpy(i[:, None].astype(np.int64)).to(x.device) for i in idx)
    return torch.from_numpy(np.stack(idx, axis=1).astype(np.int64)).to(x.device)


def masked_select(x, mask, name=None):
    m = np.broadcast_to(_host(mask).astype(bool), tuple(x.shape)).reshape(-1)
    flat_idx = torch.from_numpy(np.nonzero(m)[0].astype(np.int64)).to(x.device)
    return gather(reshape(x, [-1]), flat_idx)


@defop("masked_scatter")
def _masked_scatter(x, mask, value):
    cnt = torch.cumsum(mask.reshape(-1).to(torch.int32), 0) - 1
    flat_v = value.reshape(-1)
    picked = flat_v[cnt.clamp(0, flat_v.shape[0] - 1).long()].reshape(x.shape)
    return torch.where(mask, picked, x)


def masked_scatter(x, mask, value, name=None):
    return _masked_scatter(x, mask, value)


def _from_host(arr, like):
    out = torch.from_numpy(np.ascontiguousarray(arr)).to(like.device)
    return out.to(like.dtype) if out.is_floating_point() else out


def unique(x, return_index=False, return_inverse=False, return_counts=False, axis=None,
           dtype="int64", name=None):
    vals, index, inverse, counts = np.unique(_host(x), return_index=True,
                                             return_inverse=True, return_counts=True,
                                             axis=axis)
    outs = [_from_host(vals, x)]
    for want, arr in ((return_index, index), (return_inverse, inverse),
                      (return_counts, counts)):
        if want:
            outs.append(torch.from_numpy(arr.astype(np.int64)).to(x.device))
    return outs[0] if len(outs) == 1 else tuple(outs)


def unique_consecutive(x, return_inverse=False, return_counts=False, axis=None, dtype="int64",
                       name=None):
    if axis is not None:
        raise NotImplementedError("unique_consecutive over axis")
    arr = _host(x).reshape(-1)
    keep = np.ones(arr.shape[0], bool)
    keep[1:] = arr[1:] != arr[:-1]
    outs = [_from_host(arr[keep], x)]
    if return_inverse:
        outs.append(torch.from_numpy((np.cumsum(keep) - 1).astype(np.int64)).to(x.device))
    if return_counts:
        counts = np.diff(np.append(np.nonzero(keep)[0], arr.shape[0]))
        outs.append(torch.from_numpy(counts.astype(np.int64)).to(x.device))
    return outs[0] if len(outs) == 1 else tuple(outs)


def atleast_1d(*inputs, name=None):
    outs = [torch.atleast_1d(t) for t in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_2d(*inputs, name=None):
    outs = [torch.atleast_2d(t) for t in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_3d(*inputs, name=None):
    outs = [torch.atleast_3d(t) for t in inputs]
    return outs[0] if len(outs) == 1 else outs


def crop(x, shape=None, offsets=None, name=None):
    shape = _ints(shape)
    offsets = _ints(offsets) if offsets is not None else (0,) * x.dim()
    idx = tuple(_py_slice(o, o + (s if s != -1 else x.shape[i] - o))
                for i, (o, s) in enumerate(zip(offsets, shape)))
    return _getitem(x, idx)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):  # noqa: A002
    size = index_num // nshards
    lo, hi = shard_id * size, (shard_id + 1) * size
    return torch.where((input >= lo) & (input < hi), input - lo,
                       torch.full_like(input, ignore_value))

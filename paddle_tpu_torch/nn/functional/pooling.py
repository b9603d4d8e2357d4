"""Pooling functionals: the port of paddle_tpu/nn/functional/pooling.py.

The ops (``max_pool``, ``avg_pool``, ``adaptive_avg_pool``,
``adaptive_max_pool``) compute the JAX package's windows, which are not
always torch's:

  * padding is conv's ``_norm_padding`` (an int, one int a dim, (lo, hi)
    pairs, or XLA's padding strings for any stride), padded with -inf for
    max and 0 for average; asymmetric pads go through ``F.pad`` first;
  * ``max_pool2d``'s ``ceil_mode`` pads the high side by ``stride - 1``
    (a last window that starts in the padding is kept, where torch drops
    it, and may read only padding: -inf); ``max_pool1d``/``max_pool3d``
    ignore ``ceil_mode``, and every
    ``avg_pool*`` ignores it and ``divisor_override`` (floor-mode windows),
    as in JAX;
  * ``exclusive`` divides by the count of input elements in the window,
    except under a padding string, which divides by the window's size;
  * ``return_mask`` gives the flat per-channel spatial index of the first
    maximum in row-major window order, from the low pads and floor-mode
    windows only (``_argmax_mask``), in NC* layout whatever the data
    format; ``max_pool1d`` ignores it, as in JAX;
  * adaptive pools reduce one spatial dim after another over the bins
    ``[floor(i n / m), ceil((i + 1) n / m))``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

from ...ops._apply import defop
from .common import _adaptive_reduce, _mean
from .conv import _norm_padding as _pool_padding
from .conv import _string_pads, _torch_pad, _tup

_MAX = {1: tF.max_pool1d, 2: tF.max_pool2d, 3: tF.max_pool3d}
_AVG = {1: tF.avg_pool1d, 2: tF.avg_pool2d, 3: tF.avg_pool3d}


def _channels_first(x, data_format):
    return x if data_format.startswith("NC") else x.movedim(-1, 1)


def _channels_back(out, data_format):
    return out if data_format.startswith("NC") else out.movedim(1, -1)


def _pairs(x, ksize, stride, padding):
    if isinstance(padding, str):
        return _string_pads(padding, x.shape[2:], ksize, stride)
    return list(padding)


@defop("max_pool")
def _max_pool(x, ksize, stride, padding, data_format="NCHW", ceil_mode=False):
    x = _channels_first(x, data_format)
    pads = _pairs(x, ksize, stride, padding)
    if ceil_mode and not isinstance(padding, str):
        pads = [(lo, hi + s - 1) for (lo, hi), s in zip(pads, stride)]
    fn = _MAX[len(ksize)]
    if all(lo == hi and 0 <= lo <= k // 2 for (lo, hi), k in zip(pads, ksize)):
        out = fn(x, ksize, stride, [lo for lo, _ in pads])
    else:
        out = fn(tF.pad(x, _torch_pad(pads), value=-math.inf), ksize, stride)
    return _channels_back(out, data_format)


@defop("avg_pool")
def _avg_pool(x, ksize, stride, padding, data_format="NCHW", exclusive=True,
              ceil_mode=False):
    x = _channels_first(x, data_format)
    pads = _pairs(x, ksize, stride, padding)
    fn = _AVG[len(ksize)]
    padded = any(lo or hi for lo, hi in pads)
    out = fn(tF.pad(x, _torch_pad(pads)) if padded else x, ksize, stride)
    if exclusive and padded and not isinstance(padding, str):
        # the sum over the window's input elements, over their count
        size = math.prod(ksize)
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=out.dtype, device=x.device)
        counts = fn(tF.pad(ones, _torch_pad(pads)), ksize, stride) * size
        out = out * (size / counts)
    return _channels_back(out, data_format)


def _argmax_mask(x, ksize, stride, pad, data_format):
    """The flat per-channel spatial index of each window's first maximum
    (row-major within the window), from the low pads on both sides and
    floor-mode windows, in NC* layout."""
    nd = len(ksize)
    with torch.no_grad():
        v = _channels_first(x, data_format)
        lows = [0] * nd if isinstance(pad, str) else [p[0] for p in pad]
        vp = tF.pad(v, _torch_pad([(lo, lo) for lo in lows]), value=-math.inf)
        for i in range(nd):
            vp = vp.unfold(2 + i, ksize[i], stride[i])
        best = vp.reshape(vp.shape[:2 + nd] + (-1,)).argmax(-1)
        offsets = []
        for k in reversed(ksize):
            offsets.insert(0, best % k)
            best = best // k
        flat = 0
        for i, n in enumerate(v.shape[2:]):
            shape = [1] * (2 + nd)
            shape[2 + i] = -1
            base = torch.arange(offsets[i].shape[2 + i], device=x.device).reshape(shape)
            flat = flat * n + (base * stride[i] + offsets[i] - lows[i])
        return flat.to(torch.int64)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False, ceil_mode=False,
               name=None):
    """``return_mask`` and ``ceil_mode`` are ignored, as in JAX."""
    ksize = _tup(kernel_size, 1)
    stride = _tup(stride, 1) if stride is not None else ksize
    return _max_pool(x, ksize=ksize, stride=stride, padding=_pool_padding(padding, 1),
                     data_format="NCL")


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False, ceil_mode=False,
               data_format="NCHW", name=None):
    ksize = _tup(kernel_size, 2)
    stride = _tup(stride, 2) if stride is not None else ksize
    pad = _pool_padding(padding, 2)
    out = _max_pool(x, ksize=ksize, stride=stride, padding=pad, data_format=data_format,
                    ceil_mode=bool(ceil_mode))
    if return_mask:
        return out, _argmax_mask(x, ksize, stride, pad, data_format)
    return out


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False, ceil_mode=False,
               data_format="NCDHW", name=None):
    """``ceil_mode`` is ignored, as in JAX."""
    ksize = _tup(kernel_size, 3)
    stride = _tup(stride, 3) if stride is not None else ksize
    pad = _pool_padding(padding, 3)
    out = _max_pool(x, ksize=ksize, stride=stride, padding=pad, data_format=data_format)
    if return_mask:
        return out, _argmax_mask(x, ksize, stride, pad, data_format)
    return out


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True, ceil_mode=False,
               name=None):
    """``ceil_mode`` is ignored, as in JAX."""
    ksize = _tup(kernel_size, 1)
    stride = _tup(stride, 1) if stride is not None else ksize
    return _avg_pool(x, ksize=ksize, stride=stride, padding=_pool_padding(padding, 1),
                     data_format="NCL", exclusive=bool(exclusive))


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True,
               divisor_override=None, data_format="NCHW", name=None):
    """``ceil_mode`` and ``divisor_override`` are ignored, as in JAX."""
    ksize = _tup(kernel_size, 2)
    stride = _tup(stride, 2) if stride is not None else ksize
    return _avg_pool(x, ksize=ksize, stride=stride, padding=_pool_padding(padding, 2),
                     data_format=data_format, exclusive=bool(exclusive),
                     ceil_mode=bool(ceil_mode))


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True,
               divisor_override=None, data_format="NCDHW", name=None):
    """``ceil_mode`` and ``divisor_override`` are ignored, as in JAX."""
    ksize = _tup(kernel_size, 3)
    stride = _tup(stride, 3) if stride is not None else ksize
    return _avg_pool(x, ksize=ksize, stride=stride, padding=_pool_padding(padding, 3),
                     data_format=data_format, exclusive=bool(exclusive))


def _amax(t, axis, keepdim):
    return torch.amax(t, dim=axis, keepdim=keepdim)


@defop("adaptive_avg_pool")
def _adaptive_avg_pool(x, out_size, data_format="NCHW"):
    return _adaptive_reduce(x, out_size, 2 if data_format.startswith("NC") else 1, _mean)


@defop("adaptive_max_pool")
def _adaptive_max_pool(x, out_size, data_format="NCHW"):
    return _adaptive_reduce(x, out_size, 2 if data_format.startswith("NC") else 1, _amax)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_avg_pool(x, out_size=_tup(output_size, 1), data_format="NCL")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_avg_pool(x, out_size=_tup(output_size, 2), data_format=data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_avg_pool(x, out_size=_tup(output_size, 3), data_format=data_format)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    """``return_mask`` is ignored, as in JAX."""
    return _adaptive_max_pool(x, out_size=_tup(output_size, 1), data_format="NCL")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    out = _adaptive_max_pool(x, out_size=_tup(output_size, 2))
    if return_mask:
        raise NotImplementedError("adaptive_max_pool2d return_mask")
    return out


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    """``return_mask`` is ignored, as in JAX."""
    return _adaptive_max_pool(x, out_size=_tup(output_size, 3), data_format="NCDHW")

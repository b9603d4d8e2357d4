"""Calibration observers: the port of paddle_tpu/quantization/observers.py.

Each observer folds the batches it sees into a statistic on the host and
yields the quantization scale: the running absmax (``AbsmaxObserver``, read
from the tensor in its own dtype), per channel along ``axis``
(``AbsmaxChannelWiseObserver``), per ``group_size`` input rows of an ``[in,
out]`` weight (``GroupWiseWeightObserver``, the last group zero-padded), or
the ``percent`` quantile of a histogram of ``|x|`` that re-bins onto a wider
range when a batch exceeds it (``HistObserver``). The statistics are numpy
float64, as in the JAX package, so the scales equal its scales.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["AbsmaxObserver", "AbsmaxChannelWiseObserver", "HistObserver",
           "GroupWiseWeightObserver"]


def _abs_np(x):
    """|x| as a float64 numpy array (bfloat16 included, exactly)."""
    if isinstance(x, torch.Tensor):
        return np.abs(x.detach().cpu().to(torch.float64).numpy())
    return np.abs(np.asarray(x, np.float64))


class AbsmaxObserver:
    """Running absmax over every observed batch (observers/abs_max.py)."""

    def __init__(self, quant_bits=8):
        self.quant_bits = quant_bits
        self._absmax = 0.0

    def observe(self, x):
        self._absmax = max(self._absmax, float(torch.as_tensor(x).detach().abs().max()))

    def scale(self):
        return self._absmax

    # reference observer API alias
    def cal_thresholds(self):
        return self.scale()


class AbsmaxChannelWiseObserver:
    """Per-channel absmax: one scale per slice along ``axis``."""

    def __init__(self, quant_bits=8, axis=0):
        self.quant_bits = quant_bits
        self.axis = axis
        self._absmax = None

    def observe(self, x):
        a = _abs_np(x)
        reduce_axes = tuple(i for i in range(a.ndim) if i != self.axis)
        cur = a.max(axis=reduce_axes) if reduce_axes else a
        self._absmax = cur if self._absmax is None else np.maximum(self._absmax, cur)

    def scale(self):
        return None if self._absmax is None else self._absmax.astype(np.float32)


class HistObserver:
    """Histogram/percentile observer: the ``percent`` quantile of ``|x|``
    as the scale, clipping the long tail."""

    def __init__(self, quant_bits=8, bins=2048, percent=0.9999):
        self.quant_bits = quant_bits
        self.bins = bins
        self.percent = percent
        self._hist = None
        self._range = 0.0

    def observe(self, x):
        a = _abs_np(x).ravel()
        mx = float(a.max()) if a.size else 0.0
        if self._hist is None:
            self._range = max(mx, 1e-12)
            self._hist = np.histogram(a, bins=self.bins,
                                      range=(0.0, self._range))[0].astype(np.float64)
            return
        if mx > self._range:
            # fold the counts into the wider range's bins by index mapping
            # (error at most one bin width)
            new = np.zeros(self.bins, np.float64)
            old_centers = (np.arange(self.bins) + 0.5) * (self._range / self.bins)
            idx = np.minimum((old_centers / mx * self.bins).astype(int), self.bins - 1)
            np.add.at(new, idx, self._hist)
            self._hist = new
            self._range = mx
        self._hist += np.histogram(a, bins=self.bins, range=(0.0, self._range))[0]

    def scale(self):
        if self._hist is None:
            return 0.0
        cum = np.cumsum(self._hist)
        total = cum[-1]
        if total == 0:
            return 0.0
        k = int(np.searchsorted(cum, self.percent * total))
        return float((k + 1) * self._range / self.bins)

    cal_thresholds = scale


class GroupWiseWeightObserver:
    """Group-wise absmax for weight-only int4: one scale per ``group_size``
    input-dim slice per output channel."""

    def __init__(self, quant_bits=4, group_size=64):
        self.quant_bits = quant_bits
        self.group_size = group_size
        self._absmax = None

    def observe(self, w):
        a = _abs_np(w)              # the (in, out) layout of Linear.weight
        k, n = a.shape
        g = self.group_size
        pad = (-k) % g
        if pad:
            a = np.concatenate([a, np.zeros((pad, n))], 0)
        cur = a.reshape(-1, g, n).max(axis=1)   # (groups, out)
        self._absmax = cur if self._absmax is None else np.maximum(self._absmax, cur)

    def scale(self):
        return None if self._absmax is None else self._absmax.astype(np.float32)

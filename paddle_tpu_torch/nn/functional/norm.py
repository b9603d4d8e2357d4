"""RMS normalisation (counterpart of paddle_tpu/nn/functional/norm.py::_rms_norm),
the op ``rms_norm``, black-listed under AMP (float32 inputs)."""
from __future__ import annotations

import torch

from ...ops._apply import defop


@defop("rms_norm", amp_category="black")
def _rms_norm(x, weight=None, bias=None, epsilon=1e-6, begin_norm_axis=-1):
    """Normalise over the axes from ``begin_norm_axis`` on, in float32 (float64
    stays float64), cast back to x's dtype, and only then scale by ``weight``
    and shift by ``bias``: the JAX package's order, which decides the bf16
    rounding."""
    begin = begin_norm_axis % x.dim()
    dims = tuple(range(begin, x.dim()))
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    ms = xf.square().mean(dim=dims, keepdim=True)
    out = (xf * torch.rsqrt(ms + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def rms_norm(x, weight=None, bias=None, epsilon=1e-6, begin_norm_axis=-1, name=None):
    """Reference: python/paddle/incubate/nn/functional/fused_rms_norm.py."""
    return _rms_norm(x, weight, bias, epsilon=float(epsilon),
                     begin_norm_axis=begin_norm_axis % x.dim())

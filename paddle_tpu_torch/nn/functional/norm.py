"""RMS normalisation (counterpart of paddle_tpu/nn/functional/norm.py::_rms_norm)."""
from __future__ import annotations

import torch


def rms_norm(x, weight=None, bias=None, epsilon=1e-6, begin_norm_axis=-1):
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

"""``to_tensor``: the port of ``paddle_tpu/framework/core.py`` :303-327.

The port's tensor is ``torch.Tensor``; ``to_tensor`` builds one with the JAX
package's dtype rules: a Python float (or a list of them) takes the default
dtype (``framework.dtype.set_default_dtype``), a Python int int64, a numpy
array keeps its dtype, a tensor keeps its own; ``dtype`` casts. The result
is a new leaf (a copy) with ``requires_grad = not stop_gradient`` (floating
and complex dtypes only: torch keeps integer tensors out of autograd). It
lies on ``place`` (``"cpu"``, ``"gpu:N"``, a ``torch.device``), or where
``paddle_tpu_torch.resolve_device`` puts entry points: the card, the CPU
after ``set_device("cpu")``, and a raise with neither.
"""
from __future__ import annotations

import numpy as np
import torch

from . import dtype as dtype_mod


def _place(place):
    from .. import resolve_device
    from ..device import CPUPlace, CUDAPlace

    if isinstance(place, (CPUPlace, CUDAPlace)):
        place = place.device
    if isinstance(place, str):
        name, _, idx = place.lower().partition(":")
        if name in ("gpu", "cuda"):
            place = torch.device("cuda", int(idx) if idx else 0)
    return resolve_device(place)


def _from_numpy(arr):
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: through float32
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """paddle.to_tensor (python/paddle/tensor/creation.py to_tensor)."""
    dtype = dtype_mod.convert_dtype(dtype)
    device = _place(place)
    if isinstance(data, torch.Tensor):
        val = data.detach()
    elif isinstance(data, np.ndarray):
        val = _from_numpy(data)
    else:
        arr = np.asarray(data)
        if dtype is None:
            # paddle's default for Python scalars and lists: floats take the
            # default float dtype, ints int64; numpy arrays keep theirs
            if arr.dtype == np.float64:
                dtype = dtype_mod.get_default_dtype()
            elif arr.dtype == np.int32:
                dtype = torch.int64
        val = _from_numpy(arr)
    out = val.to(device=device, dtype=dtype or val.dtype, copy=True)
    if not stop_gradient and (out.is_floating_point() or out.is_complex()):
        out.requires_grad_(True)
    return out

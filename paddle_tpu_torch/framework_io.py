"""paddle.save / paddle.load: the port of ``paddle_tpu/framework_io.py``.

The file is the JAX package's pickle (protocol 4), so each package reads what
the other writes, bit for bit. A tensor is stored as a dict: ``__tensor__``,
``data`` (a numpy array), ``dtype`` (numpy's name of it), ``stop_gradient``,
``is_param`` and ``name``. bfloat16 goes as its uint16 bits under the
``_BF16_TAG`` dtype, since numpy has no bfloat16 of its own. Dicts, lists and
tuples nest; anything else is pickled as it is. The file holds numpy arrays
and Python objects only: the JAX package reads it without torch, and the port
reads the JAX package's files without ``ml_dtypes``.

``load`` puts every tensor on the card unless ``device="cpu"`` is asked for.
With ``return_numpy=True`` it returns numpy arrays; a bfloat16 tensor then
comes back as float32 holding the same values (the JAX package returns an
``ml_dtypes.bfloat16`` array there, which the port cannot make).
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from .framework import Parameter

_BF16_TAG = "__bf16_as_uint16__"


def tensor_payload(t):
    """``(data, dtype)`` as the file stores a tensor: a numpy array on the
    host and its dtype's name, bfloat16 as uint16 bits under ``_BF16_TAG``."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), _BF16_TAG
    arr = t.numpy()
    return arr, str(arr.dtype)


def tensor_from_payload(data, dtype, device):
    """The tensor ``tensor_payload`` stored, on ``device``."""
    arr = np.asarray(data, order="C")
    if dtype == _BF16_TAG:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _pack(obj):
    if isinstance(obj, torch.Tensor):
        data, dtype = tensor_payload(obj)
        return {
            "__tensor__": True,
            "data": data,
            "dtype": dtype,
            "stop_gradient": not obj.requires_grad,
            "is_param": isinstance(obj, torch.nn.Parameter),
            "name": getattr(obj, "name", None),
        }
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        packed = [_pack(v) for v in obj]
        return packed if isinstance(obj, list) else tuple(packed)
    return obj


def _unpack(obj, return_numpy, device):
    """``device`` is a function that gives the device, resolved at the first
    tensor (a file of numpy and scalars needs no card)."""
    if isinstance(obj, dict):
        if obj.get("__tensor__"):
            if return_numpy:
                if obj["dtype"] == _BF16_TAG:   # bf16 bits are float32's top half
                    return (obj["data"].astype(np.uint32) << 16).view(np.float32)
                return obj["data"]
            t = tensor_from_payload(obj["data"], obj["dtype"], device())
            grad = not obj["stop_gradient"] and (t.is_floating_point() or t.is_complex())
            if obj.get("is_param"):
                return Parameter(t, requires_grad=grad, name=obj.get("name"))
            return t.requires_grad_(grad)
        return {k: _unpack(v, return_numpy, device) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unpack(v, return_numpy, device) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_unpack(v, return_numpy, device) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    """Pickle ``obj`` (a state dict, a tensor, nested containers) to ``path``
    in the JAX package's format."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_pack(obj), f, protocol=protocol)


def load(path, return_numpy=False, device=None, **configs):
    """What ``save`` (of either package) wrote to ``path``: tensors on
    ``device`` (the card unless ``"cpu"``), or numpy arrays with
    ``return_numpy``. A parameter comes back as a named ``Parameter``."""
    from . import resolve_device

    with open(path, "rb") as f:
        obj = pickle.load(f)
    resolved = []

    def dev():
        if not resolved:
            resolved.append(resolve_device(device))
        return resolved[0]

    return _unpack(obj, return_numpy, dev)

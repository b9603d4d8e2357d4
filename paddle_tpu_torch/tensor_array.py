"""TensorArray: the port of ``paddle_tpu/tensor_array.py`` (reference
python/paddle/tensor/array.py and phi/core/tensor_array.h).

As in the JAX package and in the reference's dygraph mode, a TensorArray is
a Python list of tensors. An index is an int or a tensor of one element (0-d
or shape [1]); a write at the end appends, past the end raises.
"""
from __future__ import annotations

import torch

__all__ = ["create_array", "array_length", "array_read", "array_write"]


def _index(i):
    if isinstance(i, torch.Tensor):
        return int(i.reshape(-1)[0].item())
    return int(i)


def _check(array):
    if not isinstance(array, list):
        raise TypeError("array must be a list (dygraph TensorArray)")


def create_array(dtype="float32", initialized_list=None):
    """array.py create_array: a new TensorArray, optionally filled."""
    if initialized_list is None:
        return []
    out = list(initialized_list)
    for v in out:
        if not isinstance(v, torch.Tensor):
            raise TypeError(f"initialized_list entries must be Tensors, got {type(v)}")
    return out


def array_length(array):
    """array.py array_length."""
    _check(array)
    return len(array)


def array_read(array, i):
    """array.py array_read: array[i]."""
    _check(array)
    return array[_index(i)]


def array_write(x, i, array=None):
    """array.py array_write: write x at index i (appending at the end)."""
    idx = _index(i)
    if array is None:
        array = []
    _check(array)
    if idx < len(array):
        array[idx] = x
    elif idx == len(array):
        array.append(x)
    else:
        raise ValueError(f"array_write index {idx} out of range (len {len(array)})")
    return array

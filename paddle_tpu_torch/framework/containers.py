"""SelectedRows and StringTensor: the port of
``paddle_tpu/framework/containers.py``.

Reference analogs: paddle/phi/core/selected_rows.h (the sparse-gradient
container, a {rows, value, height} triple) and paddle/phi/core/string_tensor.h
(the variable-length string tensor that feeds tokenizer ops).

Both stay on the host, as in the JAX package. ``SelectedRows`` holds the
triple and densifies on demand: ``to_dense`` builds the dense tensor on the
value's device, summing the rows of repeated ids. ``StringTensor`` wraps a
numpy object array.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["SelectedRows", "StringTensor"]


class SelectedRows:
    """{height, rows, value}: rows[i] is the dense row index of value[i]."""

    def __init__(self, rows=None, height=0, value=None):
        # not `rows or []`: a numpy array has no truth value
        self._rows = [int(r) for r in (rows if rows is not None else [])]
        self._height = int(height)
        self._value = value

    # -- the reference accessors (selected_rows.h) ---------------------------
    def rows(self):
        return list(self._rows)

    def set_rows(self, rows):
        self._rows = [int(r) for r in rows]

    def height(self):
        return self._height

    def set_height(self, h):
        self._height = int(h)

    def get_tensor(self):
        return self._value

    def set_tensor(self, value):
        self._value = value

    def sync_index(self):
        pass  # the id -> offset map is rebuilt by every to_dense

    def to_dense(self):
        """The dense tensor: repeated row ids add up (the reference's
        MergeAdd + scatter for sparse gradients). A row outside
        [0, height) raises, as in the JAX package."""
        if self._value is None:
            raise ValueError("SelectedRows has no value tensor")
        if self._rows and not (0 <= min(self._rows) and max(self._rows) < self._height):
            raise ValueError(
                f"SelectedRows rows {min(self._rows)}..{max(self._rows)} out "
                f"of range for height {self._height}")
        v = self._value if isinstance(self._value, torch.Tensor) \
            else torch.from_numpy(np.array(self._value))
        out = torch.zeros((self._height,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
        idx = torch.tensor(self._rows, dtype=torch.int64, device=v.device)
        return out.index_add(0, idx, v)

    def __repr__(self):
        return (f"SelectedRows(height={self._height}, "
                f"rows={self._rows}, value_shape="
                f"{getattr(self._value, 'shape', None)})")


class StringTensor:
    """Variable-length string tensor (string_tensor.h): numpy object storage
    with the tensor-like surface tokenizer code expects."""

    def __init__(self, data=None, name=""):
        self._data = np.asarray(data if data is not None else [], dtype=object)
        self.name = name

    @property
    def shape(self):
        return list(self._data.shape)

    def numpy(self):
        return self._data

    def __getitem__(self, idx):
        out = self._data[idx]
        return out if isinstance(out, str) else StringTensor(out, self.name)

    def __len__(self):
        return len(self._data)

    def __iter__(self):
        return iter(self._data.ravel())

    def __repr__(self):
        return f"StringTensor(shape={self.shape}, data={self._data!r})"

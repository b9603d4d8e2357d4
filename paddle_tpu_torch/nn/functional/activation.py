"""Activations (counterpart of paddle_tpu/nn/functional/activation.py):
``swiglu`` and the black-listed ``softmax``/``log_softmax``, each an op."""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ...ops._apply import defop


@defop("swiglu")
def _swiglu(x, y=None):
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return tF.silu(x) * y


def swiglu(x, y=None, name=None):
    """silu(x) * y; with ``y`` None, x is split in two along the last axis."""
    return _swiglu(x, y)


@defop("softmax", amp_category="black")
def _softmax(x, axis=-1):
    return torch.softmax(x, dim=axis)


def softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        from ...ops.manipulation import cast

        x = cast(x, dtype)
    return _softmax(x, axis=int(axis))


@defop("log_softmax", amp_category="black")
def _log_softmax(x, axis=-1):
    return torch.log_softmax(x, dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        from ...ops.manipulation import cast

        x = cast(x, dtype)
    return _log_softmax(x, axis=int(axis))

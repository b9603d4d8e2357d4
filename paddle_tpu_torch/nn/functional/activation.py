"""Activations (counterpart of paddle_tpu/nn/functional/activation.py)."""
from __future__ import annotations

import torch
import torch.nn.functional as tF


def swiglu(x, y=None):
    """silu(x) * y; with ``y`` None, x is split in two along the last axis."""
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return tF.silu(x) * y

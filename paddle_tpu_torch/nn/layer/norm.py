"""Norm layers (counterpart of paddle_tpu/nn/layer/norm.py)."""
from __future__ import annotations

import torch
from torch import nn

from ...framework import Parameter
from ..functional.norm import rms_norm


class RMSNorm(nn.Module):
    """Paddle's RMSNorm: weight initialised to ones, no bias."""

    def __init__(self, normalized_shape, epsilon=1e-6, device=None, dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = Parameter(
            torch.ones(self._normalized_shape, device=device, dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.weight, None, self._epsilon,
                        begin_norm_axis=x.dim() - len(self._normalized_shape))

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}, epsilon={self._epsilon}"

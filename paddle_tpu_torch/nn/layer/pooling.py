"""Pooling layers: the port of paddle_tpu/nn/layer/pooling.py, each calling
its functional (``nn/functional/pooling.py``, whose docstring lists the
arguments the JAX package ignores) with the arguments it was built with."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D"]


class _Pool(Layer):
    _FN = None

    def __init__(self, *args):
        super().__init__()
        self.args = args

    def forward(self, x):
        return getattr(F, self._FN)(x, *self.args)


class MaxPool1D(_Pool):
    _FN = "max_pool1d"

    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, name=None):
        super().__init__(kernel_size, stride, padding, return_mask, ceil_mode)


class MaxPool2D(_Pool):
    _FN = "max_pool2d"

    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__(kernel_size, stride, padding, return_mask, ceil_mode, data_format)


class MaxPool3D(_Pool):
    _FN = "max_pool3d"

    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCDHW", name=None):
        super().__init__(kernel_size, stride, padding, return_mask, ceil_mode, data_format)


class AvgPool1D(_Pool):
    _FN = "avg_pool1d"

    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True, ceil_mode=False,
                 name=None):
        super().__init__(kernel_size, stride, padding, exclusive, ceil_mode)


class AvgPool2D(_Pool):
    _FN = "avg_pool2d"

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True,
                 divisor_override=None, data_format="NCHW", name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode, exclusive, divisor_override,
                         data_format)


class AvgPool3D(_Pool):
    _FN = "avg_pool3d"

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True,
                 divisor_override=None, data_format="NCDHW", name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode, exclusive, divisor_override,
                         data_format)


class AdaptiveAvgPool1D(_Pool):
    _FN = "adaptive_avg_pool1d"

    def __init__(self, output_size, name=None):
        super().__init__(output_size)


class AdaptiveAvgPool2D(_Pool):
    _FN = "adaptive_avg_pool2d"

    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__(output_size, data_format)


class AdaptiveAvgPool3D(_Pool):
    _FN = "adaptive_avg_pool3d"

    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__(output_size, data_format)


class AdaptiveMaxPool1D(_Pool):
    _FN = "adaptive_max_pool1d"

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size, return_mask)


class AdaptiveMaxPool2D(_Pool):
    _FN = "adaptive_max_pool2d"

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size, return_mask)


class AdaptiveMaxPool3D(_Pool):
    _FN = "adaptive_max_pool3d"

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size, return_mask)

"""Conv layers: the port of paddle_tpu/nn/layer/conv.py.

Weights in paddle's layout, as the JAX layers hold them: ``[out, in //
groups, *k]``, and ``[in, out // groups, *k]`` for the ``Transpose`` layers,
built by ``weight_attr`` or ``XavierUniform`` with the JAX package's fans
(``shape[0] * prod(k)`` in, ``shape[1] * prod(k)`` out) through
``create_parameter``; the bias ``[out]`` by ``bias_attr`` or ``Constant(0)``.
A JAX ``state_dict`` loads with no transpose. As in JAX, ``padding_mode`` is
stored and never applied (the padding is zeros), and the ``Transpose``
layers' ``output_size`` is ignored.
"""
from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose"]


def _tup(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, ndim, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCHW", transposed=False, output_padding=0):
        super().__init__()
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _tup(kernel_size, ndim)
        self._stride = _tup(stride, ndim)
        self._padding = padding
        self._dilation = _tup(dilation, ndim)
        self._groups = groups
        self._data_format = data_format
        self._padding_mode = padding_mode
        self._output_padding = output_padding
        if transposed:
            w_shape = [in_channels, out_channels // groups] + list(self._kernel_size)
        else:
            w_shape = [out_channels, in_channels // groups] + list(self._kernel_size)
        self.weight = self.create_parameter(w_shape, attr=weight_attr)
        self.bias = self.create_parameter([out_channels], attr=bias_attr, is_bias=True)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, kernel_size={self._kernel_size}, "
                f"stride={self._stride}, padding={self._padding}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride, padding,
                         dilation, groups, padding_mode, weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride, padding,
                         dilation, groups, padding_mode, weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride, padding,
                         dilation, groups, padding_mode, weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, groups=1, dilation=1, weight_attr=None, bias_attr=None,
                 data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride, padding,
                         dilation, groups, "zeros", weight_attr, bias_attr, data_format,
                         transposed=True, output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, self.weight, self.bias, self._stride, self._padding,
                                  self._output_padding, self._groups, self._dilation,
                                  self._data_format, output_size)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, dilation=1, groups=1, weight_attr=None, bias_attr=None,
                 data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride, padding,
                         dilation, groups, "zeros", weight_attr, bias_attr, data_format,
                         transposed=True, output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self._stride, self._padding,
                                  self._output_padding, self._groups, self._dilation,
                                  self._data_format, output_size)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, dilation=1, groups=1, weight_attr=None, bias_attr=None,
                 data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride, padding,
                         dilation, groups, "zeros", weight_attr, bias_attr, data_format,
                         transposed=True, output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(x, self.weight, self.bias, self._stride, self._padding,
                                  self._output_padding, self._groups, self._dilation,
                                  self._data_format, output_size)

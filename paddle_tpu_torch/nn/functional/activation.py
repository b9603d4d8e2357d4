"""Activation functionals: the port of paddle_tpu/nn/functional/activation.py.

Each is an op under the JAX op's name and AMP category (``softmax`` and
``log_softmax`` black-listed, the rest unlisted, so they run in their
input's dtype), over torch's functions with the JAX arithmetic:
``softplus`` is linear above ``threshold`` (in units of ``beta * x``),
``hardswish`` is ``x * clip(x + 3, 0, 6) / 6``, ``maxout`` splits the
``axis`` into ``(C // groups, groups)`` and takes the max over the groups,
``prelu``'s weight is a scalar or one slope per channel of ``data_format``.
``relu_`` and ``softmax_`` write their result into ``x``
(``ops/math.py`` ``_make_inplace``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ...ops._apply import defop
from ...ops.math import _make_inplace

__all__ = ["relu", "relu6", "sigmoid", "tanh", "silu", "swish", "mish", "hardswish",
           "hardsigmoid", "hardtanh", "tanhshrink", "softsign", "selu", "celu", "elu",
           "leaky_relu", "prelu", "gelu", "softmax", "log_softmax", "softplus",
           "softshrink", "hardshrink", "thresholded_relu", "maxout", "glu", "swiglu",
           "relu_", "softmax_"]


@defop("relu")
def _relu(x):
    return torch.relu(x)


def relu(x, name=None):
    return _relu(x)


@defop("relu6")
def _relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def relu6(x, name=None):
    return _relu6(x)


@defop("sigmoid_fn")
def _sigmoid(x):
    return torch.sigmoid(x)


def sigmoid(x, name=None):
    return _sigmoid(x)


@defop("tanh_fn")
def _tanh(x):
    return torch.tanh(x)


def tanh(x, name=None):
    return _tanh(x)


@defop("silu")
def _silu(x):
    return tF.silu(x)


def silu(x, name=None):
    return _silu(x)


swish = silu


@defop("mish")
def _mish(x):
    return tF.mish(x)


def mish(x, name=None):
    return _mish(x)


@defop("hardswish")
def _hardswish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardswish(x, name=None):
    return _hardswish(x)


@defop("hardsigmoid")
def _hardsigmoid(x, slope=1.0 / 6, offset=0.5):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardsigmoid(x, slope=1.0 / 6, offset=0.5, name=None):
    return _hardsigmoid(x, slope=float(slope), offset=float(offset))


@defop("hardtanh")
def _hardtanh(x, min=-1.0, max=1.0):  # noqa: A002
    return torch.clamp(x, min, max)


def hardtanh(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    return _hardtanh(x, min=float(min), max=float(max))


@defop("tanhshrink")
def _tanhshrink(x):
    return x - torch.tanh(x)


def tanhshrink(x, name=None):
    return _tanhshrink(x)


@defop("softsign")
def _softsign(x):
    return x / (1 + torch.abs(x))


def softsign(x, name=None):
    return _softsign(x)


@defop("selu")
def _selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return _selu(x, scale=float(scale), alpha=float(alpha))


@defop("celu")
def _celu(x, alpha=1.0):
    return tF.celu(x, alpha)


def celu(x, alpha=1.0, name=None):
    return _celu(x, alpha=float(alpha))


@defop("elu")
def _elu(x, alpha=1.0):
    return tF.elu(x, alpha)


def elu(x, alpha=1.0, name=None):
    return _elu(x, alpha=float(alpha))


@defop("leaky_relu")
def _leaky_relu(x, negative_slope=0.01):
    return tF.leaky_relu(x, negative_slope)


def leaky_relu(x, negative_slope=0.01, name=None):
    return _leaky_relu(x, negative_slope=float(negative_slope))


@defop("prelu_op")
def _prelu(x, weight, data_format="NCHW"):
    if weight.numel() == 1:
        w = weight.reshape(())
    elif weight.dim() > 1:
        # element mode: one alpha an element of x.shape[1:] (the JAX package
        # reshapes it as a channel vector and raises)
        w = weight.reshape((1,) + tuple(x.shape[1:]))
    else:
        axis = 1 if data_format == "NCHW" else x.dim() - 1
        shape = [1] * x.dim()
        shape[axis] = weight.shape[0]
        w = weight.reshape(shape)
    return torch.where(x > 0, x, w * x)


def prelu(x, weight, data_format="NCHW", name=None):
    return _prelu(x, weight, data_format=data_format)


@defop("gelu")
def _gelu(x, approximate=False):
    return tF.gelu(x, approximate="tanh" if approximate else "none")


def gelu(x, approximate=False, name=None):
    return _gelu(x, approximate=bool(approximate))


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


@defop("softplus")
def _softplus(x, beta=1.0, threshold=20.0):
    scaled = beta * x
    return torch.where(scaled > threshold, x,
                       torch.logaddexp(scaled, torch.zeros_like(scaled)) / beta)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return _softplus(x, beta=float(beta), threshold=float(threshold))


@defop("softshrink")
def _softshrink(x, threshold=0.5):
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def softshrink(x, threshold=0.5, name=None):
    return _softshrink(x, threshold=float(threshold))


@defop("hardshrink")
def _hardshrink(x, threshold=0.5):
    return torch.where(torch.abs(x) > threshold, x, torch.zeros_like(x))


def hardshrink(x, threshold=0.5, name=None):
    return _hardshrink(x, threshold=float(threshold))


@defop("thresholded_relu")
def _thresholded_relu(x, threshold=1.0, value=0.0):
    return torch.where(x > threshold, x, torch.full_like(x, value))


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return _thresholded_relu(x, threshold=float(threshold), value=float(value))


@defop("maxout")
def _maxout(x, groups, axis=1):
    c = x.shape[axis]
    new_shape = list(x.shape)
    new_shape[axis] = c // groups
    new_shape.insert(axis + 1, groups)
    return torch.amax(x.reshape(new_shape), dim=axis + 1)


def maxout(x, groups, axis=1, name=None):
    return _maxout(x, groups=int(groups), axis=int(axis))


@defop("glu")
def _glu(x, axis=-1):
    return tF.glu(x, dim=axis)


def glu(x, axis=-1, name=None):
    return _glu(x, axis=int(axis))


@defop("swiglu")
def _swiglu(x, y=None):
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return tF.silu(x) * y


def swiglu(x, y=None, name=None):
    """silu(x) * y; with ``y`` None, x is split in two along the last axis."""
    return _swiglu(x, y)


relu_ = _make_inplace(relu)
softmax_ = _make_inplace(softmax)

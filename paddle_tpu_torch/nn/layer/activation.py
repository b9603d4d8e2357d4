"""Activation layers: the port of paddle_tpu/nn/layer/activation.py. Each
layer of ``_simple`` calls its functional (``nn/functional/activation.py``)
with the arguments it was built with, positional ones mapped onto the
functional's parameters in order, as the JAX layers map them; ``PReLU``
holds its slopes as a parameter (``Constant(init)``, or ``weight_attr``)."""
from __future__ import annotations

import inspect

from .. import functional as F
from ..initializer import Constant
from .layers import Layer

__all__ = ["ReLU", "ReLU6", "Sigmoid", "Tanh", "Silu", "Swish", "Mish", "Hardswish",
           "Hardsigmoid", "Hardtanh", "Tanhshrink", "Softsign", "Softshrink", "Hardshrink",
           "Softplus", "ELU", "CELU", "SELU", "LeakyReLU", "GELU", "LogSoftmax", "Softmax",
           "ThresholdedReLU", "Maxout", "GLU", "PReLU", "Softmax2D"]


def _simple(cls_name, fn_name):
    params = [p for p in inspect.signature(getattr(F, fn_name)).parameters
              if p not in ("x", "name")]

    class _Act(Layer):
        def __init__(self, *args, **kwargs):
            super().__init__(name_scope=fn_name)
            self._kwargs = dict(zip(params, args))
            self._kwargs.update((k, v) for k, v in kwargs.items() if k != "name")

        def forward(self, x):
            return getattr(F, fn_name)(x, **self._kwargs)

    _Act.__name__ = _Act.__qualname__ = cls_name
    return _Act


ReLU = _simple("ReLU", "relu")
ReLU6 = _simple("ReLU6", "relu6")
Sigmoid = _simple("Sigmoid", "sigmoid")
Tanh = _simple("Tanh", "tanh")
Silu = _simple("Silu", "silu")
Swish = _simple("Swish", "swish")
Mish = _simple("Mish", "mish")
Hardswish = _simple("Hardswish", "hardswish")
Hardsigmoid = _simple("Hardsigmoid", "hardsigmoid")
Hardtanh = _simple("Hardtanh", "hardtanh")
Tanhshrink = _simple("Tanhshrink", "tanhshrink")
Softsign = _simple("Softsign", "softsign")
Softshrink = _simple("Softshrink", "softshrink")
Hardshrink = _simple("Hardshrink", "hardshrink")
Softplus = _simple("Softplus", "softplus")
ELU = _simple("ELU", "elu")
CELU = _simple("CELU", "celu")
SELU = _simple("SELU", "selu")
LeakyReLU = _simple("LeakyReLU", "leaky_relu")
GELU = _simple("GELU", "gelu")
LogSoftmax = _simple("LogSoftmax", "log_softmax")
Softmax = _simple("Softmax", "softmax")
ThresholdedReLU = _simple("ThresholdedReLU", "thresholded_relu")
Maxout = _simple("Maxout", "maxout")
GLU = _simple("GLU", "glu")


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter([num_parameters], attr=weight_attr,
                                            default_initializer=Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


class Softmax2D(Layer):
    def forward(self, x):
        return F.softmax(x, axis=-3)

"""paddle.nn.quant of the port: the port of paddle_tpu/nn/quant.py.

``Stub`` (a placeholder layer, the identity until a QAT pass replaces it),
``llm_int8_linear`` (an alias of int8 ``weight_only_linear``, as in the JAX
package: no outlier split, ``threshold`` is ignored) and the weight-only
functions of ``quantization/weight_only.py``."""
from ..quantization.weight_only import (  # noqa: F401
    weight_dequantize,
    weight_only_linear,
    weight_quantize,
)
from .layer.layers import Layer as _Layer

__all__ = ["Stub", "weight_only_linear", "llm_int8_linear", "weight_quantize",
           "weight_dequantize"]


def llm_int8_linear(x, weight, bias=None, weight_scale=None, threshold=6.0, name=None):
    """int8 ``weight_only_linear``; ``threshold`` is ignored (module
    docstring)."""
    return weight_only_linear(x, weight, bias=bias, weight_scale=weight_scale,
                              weight_dtype="int8")


class Stub(_Layer):
    """reference nn/quant/stub.py Stub: a layer the QAT pass replaces with a
    quanter; the identity before that."""

    def __init__(self, observer=None):
        super().__init__()
        self._observer = observer

    def forward(self, x):
        return x

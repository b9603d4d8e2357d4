"""``Linear`` and ``Embedding`` (counterpart of the two in
paddle_tpu/nn/layer/common.py; the rest of that module is ROADMAP Queue A
item 7b), and the flagship LLaMA's torch-layout pair.

``Linear`` and ``Embedding`` are ``Layer``s with the JAX layout and
arguments: ``Linear``'s weight is ``[in_features, out_features]`` (paddle's,
y = x W + b through the ``linear`` op), built by ``weight_attr`` or
``XavierUniform`` with paddle's fans, its bias by ``bias_attr`` or
``Constant(0)`` (``bias_attr=False``: none); ``Embedding``'s weight is
``[num_embeddings, embedding_dim]`` from ``Normal(0, 1)``, the
``padding_idx`` row zeroed. A JAX ``state_dict`` loads into either with no
transpose. Both also take ``device=`` and ``dtype=``.

``_TorchLinear`` and ``_TorchEmbedding`` are torch's layers, weights in
torch's layout (``Linear``: (out, in)) and named ``Parameter``s, whose
forward goes through the same ops (``linear`` takes the transpose, a
view): the flagship LLaMA (``models/llama.py``) is built of them, so its
conversions (``models/convert.py``), its captured programs and its saved
programs keep torch's layout.
"""
from __future__ import annotations

import torch
from torch import nn

from ...framework import name_parameters
from ..functional.common import embedding, linear
from ..initializer import Normal
from .layers import Layer

__all__ = ["Linear", "Embedding"]


class Linear(Layer):
    """y = x W + b, W of shape (in_features, out_features)."""

    def __init__(self, in_features, out_features, weight_attr=None, bias_attr=None, name=None,
                 *, device=None, dtype=None):
        super().__init__()
        self._device = device
        if dtype is not None:
            self._dtype = dtype
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter([in_features, out_features], attr=weight_attr)
        self.bias = self.create_parameter([out_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, out_features={self.out_features}"


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None, sparse=False,
                 weight_attr=None, name=None, *, device=None, dtype=None):
        super().__init__()
        self._device = device
        if dtype is not None:
            self._dtype = dtype
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self.weight = self.create_parameter([num_embeddings, embedding_dim], attr=weight_attr,
                                            default_initializer=Normal(0.0, 1.0))
        if padding_idx is not None:
            idx = padding_idx if padding_idx >= 0 else num_embeddings + padding_idx
            with torch.no_grad():
                self.weight[idx] = 0.0

    def forward(self, x):
        return embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class _TorchLinear(nn.Linear):
    def __init__(self, in_features, out_features, bias=True, device=None, dtype=None):
        super().__init__(in_features, out_features, bias=bias, device=device, dtype=dtype)
        name_parameters(self)

    def forward(self, x):
        return linear(x, self.weight.t(), self.bias)


class _TorchEmbedding(nn.Embedding):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None, device=None,
                 dtype=None):
        super().__init__(num_embeddings, embedding_dim, padding_idx=padding_idx,
                         device=device, dtype=dtype)
        name_parameters(self)

    def forward(self, x):
        return embedding(x, self.weight, padding_idx=self.padding_idx)

"""``Linear`` and ``Embedding`` (counterpart of paddle_tpu/nn/layer/common.py):
torch's layers, with their weights in torch's layout and their parameters
named ``Parameter``s, whose forward goes through the port's ops
(``F.linear``, ``F.embedding``), so the AMP cast, the NaN/Inf scan and the
operator stats see them. ``Linear``'s weight is (out, in), as
``models/convert.py`` expects; the ``linear`` op takes its transpose, a
view."""
from __future__ import annotations

from torch import nn

from ...framework import name_parameters
from ..functional.common import embedding, linear


class Linear(nn.Linear):
    def __init__(self, in_features, out_features, bias=True, device=None, dtype=None):
        super().__init__(in_features, out_features, bias=bias, device=device, dtype=dtype)
        name_parameters(self)

    def forward(self, x):
        return linear(x, self.weight.t(), self.bias)


class Embedding(nn.Embedding):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None, device=None,
                 dtype=None):
        super().__init__(num_embeddings, embedding_dim, padding_idx=padding_idx,
                         device=device, dtype=dtype)
        name_parameters(self)

    def forward(self, x):
        return embedding(x, self.weight, padding_idx=self.padding_idx)

"""``linear`` and ``embedding`` (counterpart of the two in
paddle_tpu/nn/functional/common.py), the ops ``linear`` (white-listed under
AMP) and ``embedding_op``.

``linear`` takes paddle's weight layout, (in_features, out_features): the
port's ``nn.Linear`` keeps torch's (out, in) weight and passes its
transpose, a view. ``embedding`` gathers rows of ``weight``; a
``padding_idx`` zeroes the output rows (and so the gradient) of that id, as
the JAX function does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ...ops._apply import defop


@defop("linear", amp_category="white")
def _linear(x, weight, bias=None):
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias
    return out


def linear(x, weight, bias=None, name=None):
    return _linear(x, weight, bias)


@defop("embedding_op")
def _embedding(weight, x, padding_idx=None):
    out = tF.embedding(x, weight)
    if padding_idx is not None:
        out = out * (x != padding_idx).unsqueeze(-1).to(out.dtype)
    return out


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    idx = padding_idx
    if idx is not None and idx < 0:
        idx = weight.shape[0] + idx
    return _embedding(weight, x, padding_idx=idx)

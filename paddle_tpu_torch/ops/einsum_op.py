"""einsum: the port of ``paddle_tpu/ops/einsum_op.py`` (reference
python/paddle/tensor/einsum.py), a white-list op under AMP."""
from __future__ import annotations

import torch

from ._apply import defop


@defop("einsum", amp_category="white")
def _einsum(operands, equation):
    return torch.einsum(equation, *operands)


def einsum(equation, *operands):
    return _einsum(list(operands), equation=equation)

"""The matrix-product family of ``paddle_tpu/ops/linalg.py``: ``matmul``
(with ``transpose_x``/``transpose_y``), ``mm``, ``bmm``, ``mv`` and
``multi_dot``, white-list ops under AMP. The decompositions of that file wait
for a later slice (ROADMAP Queue A item 6); ``dot`` is in ``ops/math.py``, as
in the JAX package. The products are cuBLAS's on the card (the JAX
package's are XLA's).
"""
from __future__ import annotations

import torch

from ._apply import defop


@defop("matmul", amp_category="white")
def _matmul(x, y, transpose_x=False, transpose_y=False):
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    return _matmul(x, y, transpose_x=bool(transpose_x), transpose_y=bool(transpose_y))


mm = matmul


@defop("bmm", amp_category="white")
def bmm(x, y):
    return torch.matmul(x, y)


@defop("mv", amp_category="white")
def mv(x, vec):
    return torch.matmul(x, vec)


@defop("multi_dot", amp_category="white")
def _multi_dot(xs):
    return torch.linalg.multi_dot(list(xs))


def multi_dot(x, name=None):
    return _multi_dot(list(x))

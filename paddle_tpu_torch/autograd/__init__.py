"""paddle.autograd for the port: the counterpart of
``paddle_tpu/autograd/__init__.py``.

PyTorch's autograd engine stands in for the JAX tape: ``backward``, ``grad``
(with ``no_grad_vars``) and the grad-mode helpers run on it; ``PyLayer`` is a
``torch.autograd.Function``; ``jacobian``/``hessian``/``jvp``/``vjp`` run over
``torch.func``; ``saved_tensors_hooks`` is torch's, so its hooks see every
tensor saved for backward (in the JAX package, those of the eager path).
Master gradients are ``master_grad.py``.
"""
import torch

from .backward_mode import (  # noqa: F401
    backward, enable_grad, grad, is_grad_enabled, no_grad, set_grad_enabled)
from .py_layer import LegacyPyLayer, PyLayer, PyLayerContext  # noqa: F401
from .functional import Hessian, Jacobian, hessian, jacobian, jvp, vjp  # noqa: F401
from . import master_grad  # noqa: F401


class saved_tensors_hooks(torch.autograd.graph.saved_tensors_hooks):  # noqa: N801
    """paddle.autograd.saved_tensors_hooks(pack_hook, unpack_hook): pack and
    unpack every tensor autograd saves for backward inside the context."""

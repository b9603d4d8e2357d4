"""The op registry: ``OpDef``, ``register_op``, ``get_registry`` and ``defop``.

Counterpart of the registry half of ``paddle_tpu/ops/_apply.py`` (``OpDef``
:29-36, ``register_op`` :39-42, ``get_registry`` :45-46, ``defop`` :468-486).
There every op is a pure jax function and ``apply`` is the eager dispatch with
its tape, caches and hooks. Here an op's function takes torch tensors and
PyTorch's autograd stands in for the tape, so ``apply`` only runs the
function: under ``torch.no_grad()`` when the op is not differentiable (the JAX
package marks such outputs ``stop_gradient``), as it is otherwise.

Not ported with the registry (each belongs to its module's slice): the AMP
cast of every op's inputs (``amp/auto_cast.py``), SPMD sharding rules, the
eager VJP cache, graph capture, ``check_nan_inf``, op statistics and the
profiler and monitor spans.

The JAX package registers its built-in ops here when it is imported; the port
has none, so their names are kept in ``_builtin_names.py`` and
``is_registered`` counts them as taken.
"""
from __future__ import annotations

import functools

import torch

from ._builtin_names import BUILTIN_OP_NAMES

_REGISTRY = {}
_BUILTIN = frozenset(BUILTIN_OP_NAMES)


class OpDef:
    __slots__ = ("name", "fn", "differentiable", "amp_category")

    def __init__(self, name, fn, differentiable=True, amp_category=None):
        self.name = name
        self.fn = fn
        self.differentiable = differentiable
        self.amp_category = amp_category


def register_op(name, fn, differentiable=True, amp_category=None):
    opdef = OpDef(name, fn, differentiable, amp_category)
    _REGISTRY[name] = opdef
    return opdef


def get_registry():
    return dict(_REGISTRY)


def is_registered(name):
    """Whether ``name`` is taken: one of the JAX package's built-in op names,
    or an op registered here."""
    return name in _BUILTIN or name in _REGISTRY


def apply(opdef: OpDef, *args, **kwargs):
    """Run an op's function on torch tensors."""
    if not opdef.differentiable:
        with torch.no_grad():
            return opdef.fn(*args, **kwargs)
    return opdef.fn(*args, **kwargs)


def defop(name, differentiable=True, amp_category=None):
    """Decorator: define an op from its function over torch tensors and return
    the public wrapper, which drops paddle's cosmetic ``name=`` keyword."""

    def deco(fn):
        opdef = register_op(name, fn, differentiable, amp_category)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            kwargs.pop("name", None)  # paddle APIs accept a cosmetic name= kwarg
            return apply(opdef, *args, **kwargs)

        wrapper.opdef = opdef
        return wrapper

    return deco

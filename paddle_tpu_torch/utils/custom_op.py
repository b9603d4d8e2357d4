"""Custom op extension point: register user ops into the port.

Counterpart of ``paddle_tpu/utils/custom_op.py``. There a "kernel" is any
jax-traceable function, a Pallas TPU kernel included; here it is any function
over torch tensors: torch code, or a wrapper that launches a hand-written CUDA
kernel (``paddle_tpu_torch/ops/cuda/axpy.py`` registers one). Registration
goes through the same ``defop`` registry as in the JAX package
(``paddle_tpu_torch/ops/_apply.py``).

Gradients, by the arguments of ``register_custom_op``:

* ``backward`` given: the op is a ``torch.autograd.Function``. Its residuals
  are the forward's arguments, as the JAX ``fwd`` saves them: tensors through
  ``ctx.save_for_backward``, anything else unchanged. ``backward(residuals,
  g)`` returns one gradient per input (``None`` for none), where ``g`` has the
  output's structure (a tuple of gradients for a tuple output): the
  ``jax.custom_vjp`` contract. An output that does not reach the loss gets a
  gradient of zeros, as in JAX.
* no ``backward``: autograd differentiates the torch ops of ``forward``. A
  floating-point output autograd cannot follow (no ``grad_fn``) while an
  input requires grad is what a kernel launched through ctypes returns. The
  call returns its value, and a gradient that reaches it raises
  ``CustomOpError`` instead of stopping there silently: the JAX package's
  ``pure_callback`` computes the value and fails at the backward pass in the
  same way. One difference from JAX: a float output that depends only on
  inputs that do not require grad also has no ``grad_fn``, and it raises
  there too, where JAX gives it a zero gradient; the port cannot tell it from
  a launch outside autograd.
* ``differentiable=False``: ``forward`` runs under ``torch.no_grad()``, so no
  output requires grad (the JAX package's ``stop_gradient`` outputs).

``amp_category`` is kept on the op's ``OpDef`` as given; like the JAX package,
registration does not check it. Inside ``amp.auto_cast`` the dispatch reads
it as the JAX package does: ``"white"`` casts the op's floating inputs to the
low dtype, ``"black"`` to float32, ``"skip"`` leaves them (``amp/auto_cast.py``).
"""
from __future__ import annotations

import functools
import inspect

import torch

from ..ops._apply import defop, is_registered

__all__ = ["register_custom_op", "get_custom_op", "CustomOpError"]


class CustomOpError(RuntimeError):
    pass


_CUSTOM_OPS = {}


def register_custom_op(name, forward=None, backward=None, amp_category=None,
                       differentiable=True):
    """Register ``forward`` (a function over torch tensors) as op ``name``;
    returns the public callable.

    With ``backward``, gradients use it instead of autograd:
    ``backward(residuals, g) -> input grads``, the residuals being the
    forward's arguments and ``g`` the output's gradient (the
    ``jax.custom_vjp`` contract, mirroring PD_BUILD_GRAD_OP; module
    docstring).

    Usable as a decorator: ``@register_custom_op("my_op")``.
    """
    if forward is None:
        def deco(fn):
            return register_custom_op(name, fn, backward=backward,
                                      amp_category=amp_category,
                                      differentiable=differentiable)

        return deco

    if is_registered(name):
        raise CustomOpError(f"op {name!r} is already registered")

    if backward is not None:
        fn = _with_backward(name, forward, backward)
    else:
        fn = _guarded(name, forward)
    op = defop(name, differentiable=differentiable,
               amp_category=amp_category)(fn)
    _CUSTOM_OPS[name] = op
    return op


def get_custom_op(name):
    if name not in _CUSTOM_OPS:
        raise CustomOpError(f"no custom op {name!r} registered")
    return _CUSTOM_OPS[name]


def _tensors(obj):
    """The tensors in ``obj``, looking inside tuples, lists and dicts."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for item in obj:
            yield from _tensors(item)
    elif isinstance(obj, dict):
        for item in obj.values():
            yield from _tensors(item)


class _GradientCut(torch.autograd.Function):
    """Stands where a forward left autograd: the value passes through
    unchanged (a view), and a gradient that reaches it raises, as the JAX
    package's ``pure_callback`` outputs do."""

    @staticmethod
    def forward(ctx, name, out, *inputs):
        ctx.name = name
        return out.view_as(out)

    @staticmethod
    def backward(ctx, *grads):
        raise CustomOpError(
            f"custom op {ctx.name!r} returned a floating-point output without "
            f"grad_fn while an input required grad: its forward leaves "
            f"autograd (as a kernel launched through ctypes does), so it has "
            f"no gradient. Pass backward= to give the gradient, or "
            f"differentiable=False if the op has none")


def _cut(obj, name, inputs):
    """``obj`` with every floating-point tensor that autograd cannot follow
    routed through ``_GradientCut``."""
    if isinstance(obj, torch.Tensor):
        if obj.requires_grad or not (obj.is_floating_point() or obj.is_complex()):
            return obj
        return _GradientCut.apply(name, obj, *inputs)
    if isinstance(obj, (tuple, list)):
        items = [_cut(item, name, inputs) for item in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else type(obj)(items)
    if isinstance(obj, dict):
        return type(obj)((k, _cut(v, name, inputs)) for k, v in obj.items())
    return obj


def _guarded(name, forward):
    """``forward``, with a gradient that raises where autograd could not
    follow it."""

    @functools.wraps(forward)
    def fn(*args, **kwargs):
        out = forward(*args, **kwargs)
        if not torch.is_grad_enabled():
            return out
        inputs = [t for t in _tensors((args, kwargs)) if t.requires_grad]
        return _cut(out, name, inputs) if inputs else out

    return fn


def _positional(forward, args, kwargs):
    """Keyword arguments bound to positions, as ``jax.custom_vjp`` does."""
    bound = inspect.signature(forward).bind(*args, **kwargs)
    bound.apply_defaults()
    if bound.kwargs:
        raise TypeError(f"keyword arguments {sorted(bound.kwargs)} could not "
                        f"be resolved to positions")
    return bound.args


def _with_backward(name, forward, backward):
    """``forward`` as a ``torch.autograd.Function`` whose gradient is
    ``backward(residuals, g)``."""

    class CustomOpFunction(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            out = forward(*args)
            ctx.is_tensor = [isinstance(a, torch.Tensor) for a in args]
            ctx.others = [None if t else a for a, t in zip(args, ctx.is_tensor)]
            ctx.save_for_backward(*(a for a in args if isinstance(a, torch.Tensor)))
            ctx.tuple_out = isinstance(out, (tuple, list))
            return tuple(out) if ctx.tuple_out else out

        @staticmethod
        def backward(ctx, *grads):
            # grads of unused outputs arrive as zeros (materialize_grads)
            saved = iter(ctx.saved_tensors)
            residuals = tuple(next(saved) if t else a
                              for a, t in zip(ctx.others, ctx.is_tensor))
            gin = tuple(backward(residuals, grads if ctx.tuple_out else grads[0]))
            if len(gin) != len(residuals):
                raise CustomOpError(
                    f"backward of custom op {name!r} returned {len(gin)} "
                    f"gradients for {len(residuals)} inputs")
            return tuple(g if t else None for g, t in zip(gin, ctx.is_tensor))

    CustomOpFunction.__name__ = CustomOpFunction.__qualname__ = f"CustomOp[{name}]"

    @functools.wraps(forward)
    def fn(*args, **kwargs):
        if kwargs:
            args = _positional(forward, args, kwargs)
        return CustomOpFunction.apply(*args)

    return fn

"""Functional autograd transforms: jacobian, hessian, jvp and vjp, the port
of ``paddle_tpu/autograd/functional.py`` over ``torch.func``.

The user function is built from the port's ops, which are torch functions.
The reverse-mode transforms (``vjp``, ``jacobian``) run on the autograd
engine, one backward a row of the jacobian: torch's custom ops, the
flash-attention kernel op among them, have autograd formulas that
``torch.func``'s transforms cannot enter, and a JAX ``custom_vjp`` function
takes ``jax.vjp`` and ``jax.jacrev``. The forward-mode ones (``jvp``,
``hessian``) run over ``torch.func``; the kernel op raises there, as a JAX
``custom_vjp`` function does under ``jax.jvp``. The output structure is the
JAX package's: a single input gives one result, a tuple of inputs a tuple;
``batch_axis=0`` maps the transform over the leading axis (``vmap`` for
``hessian``, a loop over the samples for ``jacobian``); ``v=None`` means
ones.
"""
from __future__ import annotations

import torch
import torch.func as tf


def _lift(func):
    def pure(*vals):
        out = func(*vals)
        if isinstance(out, (tuple, list)):
            return tuple(o if isinstance(o, torch.Tensor) else torch.as_tensor(o)
                         for o in out)
        return out if isinstance(out, torch.Tensor) else torch.as_tensor(out)

    return pure


def _unpack(xs):
    single = not isinstance(xs, (tuple, list))
    lst = [xs] if single else list(xs)
    return single, [x if isinstance(x, torch.Tensor) else torch.as_tensor(x) for x in lst]


def _tuples(v):
    if isinstance(v, (tuple, list)):
        return tuple(_tuples(x) for x in v)
    return v


def _leaves(vals):
    return [v.detach().requires_grad_(True) for v in vals]


def _jacrev(pure, vals):
    """``jax.jacrev(pure, argnums=all)(*vals)``: per output a tuple per
    input of out.shape + in.shape (just the tuple for a single output)."""
    xs = _leaves(vals)
    with torch.enable_grad():
        out = pure(*xs)
    outs = out if isinstance(out, tuple) else (out,)
    per_out = []
    for o in outs:
        flat = o.reshape(-1)
        jac = [torch.zeros((flat.numel(),) + tuple(x.shape), dtype=x.dtype, device=x.device)
               for x in xs]
        if o.requires_grad:
            for r in range(flat.numel()):
                gs = torch.autograd.grad(flat[r], xs, retain_graph=True, allow_unused=True)
                for j, g in zip(jac, gs):
                    if g is not None:
                        j[r] = g
        per_out.append(tuple(j.reshape(tuple(o.shape) + tuple(x.shape))
                             for j, x in zip(jac, xs)))
    return tuple(per_out) if isinstance(out, tuple) else per_out[0]


def _stack(trees):
    if isinstance(trees[0], tuple):
        return tuple(_stack([t[i] for t in trees]) for i in range(len(trees[0])))
    return torch.stack(trees)


def jacobian(func, xs, batch_axis=None):
    """d func(xs) / d xs: a tensor (or a tuple per input); with
    ``batch_axis=0``, per-sample jacobians."""
    single, vals = _unpack(xs)
    pure = _lift(func)
    if batch_axis == 0:
        jacs = _stack([_jacrev(pure, [v[b] for v in vals]) for b in range(vals[0].shape[0])])
    else:
        jacs = _jacrev(pure, vals)
    if single:
        jacs = jacs[0] if isinstance(jacs, tuple) and len(jacs) == 1 else jacs
    return _tuples(jacs)


def hessian(func, xs, batch_axis=None):
    """d^2 func(xs) / d xs^2 of a scalar-valued ``func``."""
    single, vals = _unpack(xs)
    pure = _lift(func)

    def scalar(*vs):
        out = pure(*vs)
        out = out[0] if isinstance(out, tuple) else out
        return out.reshape(())

    hess_fn = tf.hessian(scalar, argnums=tuple(range(len(vals))))
    if batch_axis == 0:
        hess_fn = tf.vmap(hess_fn)
    h = hess_fn(*vals)
    if single:
        h = h[0][0]
    return _tuples(h)


def jvp(func, xs, v=None):
    """Forward mode: ``(func(xs), J @ v)``."""
    single, vals = _unpack(xs)
    tangents = [torch.ones_like(x) for x in vals] if v is None else _unpack(v)[1]
    out, tangent_out = tf.jvp(_lift(func), tuple(vals), tuple(tangents))
    return _tuples(out), _tuples(tangent_out)


def vjp(func, xs, v=None):
    """Reverse mode: ``(func(xs), v @ J)``."""
    single, vals = _unpack(xs)
    xs_ = _leaves(vals)
    with torch.enable_grad():
        out = _lift(func)(*xs_)
    outs = out if isinstance(out, tuple) else (out,)
    if v is None:
        cots = [torch.ones_like(o) for o in outs]
    else:
        cv = _unpack(v)[1]
        cots = list(cv) if isinstance(out, tuple) else cv[:1]
    pairs = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
    got = torch.autograd.grad([o for o, _ in pairs], xs_, [c for _, c in pairs],
                              allow_unused=True) if pairs else [None] * len(xs_)
    grads = tuple(torch.zeros_like(x) if g is None else g for g, x in zip(got, xs_))
    out = tuple(o.detach() for o in outs) if isinstance(out, tuple) else out.detach()
    if single:
        grads = grads[0]
    return out, grads


def Jacobian(func, xs, is_batched=False):  # noqa: N802 (paddle's name)
    return jacobian(func, xs, batch_axis=0 if is_batched else None)


def Hessian(func, xs, is_batched=False):  # noqa: N802 (paddle's name)
    return hessian(func, xs, batch_axis=0 if is_batched else None)

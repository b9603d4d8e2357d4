"""Activation recomputation: the port of
paddle_tpu/distributed/fleet/recompute.py.

The JAX package wraps the segment in ``jax.checkpoint``; here it is
``torch.utils.checkpoint.checkpoint`` with ``use_reentrant=False``: the
forward keeps only the segment's inputs, and the backward runs the segment
again (with the RNG state replayed) before differentiating it. Parameters
used inside the segment get their gradients as in a plain call, so no layer
bookkeeping is needed.

Policies, as the JAX package names its ``jax.checkpoint`` policies:
``None``, ``"full"`` and ``"nothing_saveable"`` keep nothing; the selective
ones keep the outputs of matrix products and recompute the rest, through
``create_selective_checkpoint_contexts``:
  * ``"dots_with_no_batch_dims_saveable"`` (what
    ``recompute_granularity="full_attn"``/``"core_attn"`` select) keeps the
    products without batch dimensions: ``aten.mm``, ``aten.addmm`` and
    ``aten._addmm_activation``, the ops ``F.linear`` reaches on the CPU and
    on the card;
  * ``"dots_saveable"`` keeps the batched ones (``aten.bmm``,
    ``aten.baddbmm``) as well.
The flash-attention kernels are launched inside an autograd Function and are
no aten op, so they run again in the recompute, as a ``pallas_call`` (not a
dot) is recomputed under the JAX policies.

A segment run inside ``amp.auto_cast`` is recomputed under the same AMP
state (the backward runs after the context has closed), so the recompute
casts as the forward did: ``jax.checkpoint`` traces the segment once, under
the state of its forward.
"""
from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ...framework import capture as _capture
from ...ops._apply import _AMP_STATE

_CAPTURE = _capture._ANY

_FULL = (None, "full", "nothing_saveable")
_aten = torch.ops.aten
_UNBATCHED_DOTS = (_aten.mm.default, _aten.addmm.default, _aten._addmm_activation.default)
SAVED_OPS = {
    "dots_with_no_batch_dims_saveable": frozenset(_UNBATCHED_DOTS),
    "dots_saveable": frozenset(_UNBATCHED_DOTS + (_aten.bmm.default, _aten.baddbmm.default)),
}


def _policy(saved, ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE


@contextlib.contextmanager
def _amp_entered(state):
    _AMP_STATE.append(state)
    try:
        yield
    finally:
        _AMP_STATE.pop()


def _with_amp(state, context_fn):
    """``context_fn``'s (forward, recompute) contexts, the recompute one also
    under the AMP ``state`` of the forward."""

    def contexts():
        fwd, rec = context_fn() if context_fn is not None else (
            contextlib.nullcontext(), contextlib.nullcontext())

        @contextlib.contextmanager
        def recompute_ctx():
            with _amp_entered(state), rec:
                yield

        return fwd, recompute_ctx()

    return contexts


def recompute(function, *args, **kwargs):
    """Run ``function(*args, **kwargs)`` without keeping its intermediate
    activations (all of them, or all but the products' outputs under a
    selective ``checkpoint_policy``); they are recomputed in the backward
    pass."""
    if _CAPTURE[0]:
        # static capture: the segment is one entry, replayed as a segment
        prog = _capture.wants(args, kwargs)
        if prog is not None:
            return _capture.call(recompute, (function,) + args, kwargs, prog)
    preserve_rng_state = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", None)
    policy = kwargs.pop("checkpoint_policy", None)
    context_fn = None
    if policy in SAVED_OPS:
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       functools.partial(_policy, SAVED_OPS[policy]))
    elif policy not in _FULL:
        raise ValueError(f"unknown checkpoint_policy {policy!r}; expected one of "
                         f"{sorted(p for p in _FULL + tuple(SAVED_OPS) if p)}")
    if _AMP_STATE:
        context_fn = _with_amp(_AMP_STATE[-1], context_fn)
    if context_fn is not None:
        kwargs["context_fn"] = context_fn
    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state, **kwargs)

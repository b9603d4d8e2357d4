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
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

_FULL = (None, "full", "nothing_saveable")
_aten = torch.ops.aten
_UNBATCHED_DOTS = (_aten.mm.default, _aten.addmm.default, _aten._addmm_activation.default)
SAVED_OPS = {
    "dots_with_no_batch_dims_saveable": frozenset(_UNBATCHED_DOTS),
    "dots_saveable": frozenset(_UNBATCHED_DOTS + (_aten.bmm.default, _aten.baddbmm.default)),
}


def _policy(saved, ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE


def recompute(function, *args, **kwargs):
    """Run ``function(*args, **kwargs)`` without keeping its intermediate
    activations (all of them, or all but the products' outputs under a
    selective ``checkpoint_policy``); they are recomputed in the backward
    pass."""
    preserve_rng_state = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", None)
    policy = kwargs.pop("checkpoint_policy", None)
    if policy in SAVED_OPS:
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       functools.partial(_policy, SAVED_OPS[policy]))
        return checkpoint(function, *args, use_reentrant=False, context_fn=context_fn,
                          preserve_rng_state=preserve_rng_state, **kwargs)
    if policy not in _FULL:
        raise ValueError(f"unknown checkpoint_policy {policy!r}; expected one of "
                         f"{sorted(p for p in _FULL + tuple(SAVED_OPS) if p)}")
    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state, **kwargs)

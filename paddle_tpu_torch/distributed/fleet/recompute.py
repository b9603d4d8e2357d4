"""Activation recomputation: the port of
paddle_tpu/distributed/fleet/recompute.py.

The JAX package wraps the segment in ``jax.checkpoint``; here it is
``torch.utils.checkpoint.checkpoint`` with ``use_reentrant=False``: the
forward keeps only the segment's inputs, and the backward runs the segment
again (with the RNG state replayed) before differentiating it. Parameters
used inside the segment get their gradients as in a plain call, so no layer
bookkeeping is needed.

Policies: ``None``, ``"full"`` and ``"nothing_saveable"`` (keep nothing, the
``jax.checkpoint`` default) are ported. The selective XLA policies
(``"dots_saveable"``, ``"dots_with_no_batch_dims_saveable"``, which
``recompute_granularity="full_attn"``/``"core_attn"`` select) belong to a
later slice and raise ``NotImplementedError``.
"""
from __future__ import annotations

from torch.utils.checkpoint import checkpoint

_FULL = (None, "full", "nothing_saveable")
_SELECTIVE = ("dots_saveable", "dots_with_no_batch_dims_saveable")


def recompute(function, *args, **kwargs):
    """Run ``function(*args, **kwargs)`` without keeping its intermediate
    activations; they are recomputed in the backward pass."""
    preserve_rng_state = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", None)
    policy = kwargs.pop("checkpoint_policy", None)
    if policy in _SELECTIVE:
        raise NotImplementedError(
            f"checkpoint_policy {policy!r} (selective recompute) is not ported yet: "
            f"it belongs to a later slice of the port")
    if policy not in _FULL:
        raise ValueError(f"unknown checkpoint_policy {policy!r}; expected one of "
                         f"{sorted(p for p in _FULL + _SELECTIVE if p)}")
    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state, **kwargs)

"""graftnum runtime: the device-side finiteness check behind
:func:`paddle_tpu_torch.analysis.sanitizers.numsan_check` and the eager
tensor checker in ``amp/debugging.py`` (the port of
``paddle_tpu/analysis/numerics.py``).

``sanitizers.py`` imports no torch at module level, so everything that
touches tensors lives here and is imported lazily, on the first enabled
check. The step check is ONE all-finite reduction per device over every
float leaf of every registered region, joined on the device: one bool
crosses to the host per step (read under ``allow_host_sync``), no per-op
sync, no data leaves the device. Each leaf is reduced by ``torch.aminmax``
(one pass, no temporary of the leaf's size) and the extremes are tested with
``torch.isfinite``: a NaN anywhere propagates into both, an inf shows in one
of them, and a finite value can never overflow into a false trip, as a sum
or a norm could. The per-region checks that localize a trip run only
on the trip path. In the JAX package this is a ``jax.jit`` program, not a
Pallas kernel; plain torch is its counterpart here.
"""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_leaves

__all__ = ["all_finite", "all_finite_device", "first_bad_region", "poisoned"]


def _float_leaves(tree):
    return [x for x in tree_leaves(tree)
            if isinstance(x, torch.Tensor) and x.numel()
            and (x.is_floating_point() or x.is_complex())]


def all_finite_device(tree):
    """``{device: 0-d bool tensor}``: the joined all-finite flag of the float
    leaves of ``tree`` on each device, still on that device (nothing is read
    back). Non-float leaves (int token ids, the int8 KV pools) are
    skipped — finiteness is not a question for them. Each leaf costs one
    ``aminmax``; the extremes of a (device, dtype) group are stacked and
    tested by one ``isfinite``, so a step's check is about one kernel a
    leaf."""
    groups = {}
    for x in _float_leaves(tree):
        if x.is_complex():
            x = torch.view_as_real(x)
        groups.setdefault((x.device, x.dtype), []).extend(torch.aminmax(x.reshape(-1)))
    out = {}
    for (dev, _dt), ext in groups.items():
        f = torch.isfinite(torch.stack(ext)).all()
        prev = out.get(dev)
        out[dev] = f if prev is None else prev & f
    return out


def all_finite(tree):
    """One device-side reduction over every float leaf of ``tree`` and a
    single bool read back per device (one for a step on one card). The read
    is sanctioned: it sits in ``allow_host_sync``, so it never crosses the
    hostsync tripwire."""
    from .sanitizers import allow_host_sync

    flags = all_finite_device(tree)
    if not flags:
        return True
    with allow_host_sync():
        return all(bool(f) for f in flags.values())


def first_bad_region(regions):
    """The first region of ``((tag, tree), ...)`` (registration order)
    holding a non-finite float leaf. Only runs on the trip path. Returns
    the tag, or None when the combined check tripped but every region
    checks clean in isolation (a region changed between the two checks)."""
    for tag, tree in regions:
        if not all_finite(tree):
            return tag
    return None


def poisoned(tree):
    """``tree`` plus one appended NaN leaf on the host — the
    ``numsan.check`` fault drill. The engine's own values are never
    touched, so outputs stay bit for bit whether or not the drill (or
    numsan itself) is on."""
    return (tree, torch.tensor(float("nan"), dtype=torch.float32))

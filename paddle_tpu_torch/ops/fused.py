"""``fuse``: the port of ``paddle_tpu/ops/fused.py``.

The JAX decorator hands a chain of elementwise ops to XLA as one ``jax.jit``
region, keyed on its static arguments, so an eager call is one cached
executable instead of one per op. Here the region is ``torch.compile``
(Inductor, ``fullgraph=True``, ``dynamic=False``): one compiled variant per
key of the ``static_argnums`` arguments' values, each a program of its own
in which Inductor fuses the chain into as few kernels as it can.

No fallback: a region Dynamo cannot trace whole raises, and a variant past
Dynamo's recompile limit raises too (``jit.api._recompile_budget``) instead
of running eagerly. Inside an outer compiled region (``jit.to_static``) the
function is traced inline, as a nested ``jax.jit`` is.
"""
from __future__ import annotations

import functools

import torch

__all__ = ["fuse"]


def fuse(fn=None, *, static_argnums=()):
    """Decorator: run ``fn`` as one compiled region per key of its static
    arguments (``static_argnums``: shapes, dtypes, devices, Python scalars;
    ``jax.jit``'s contract). The wrapper keeps the eager signature and
    ``__wrapped__``; ``wrapper.variants`` maps each key to its compiled
    callable and the backend that counts its graphs."""
    static = tuple(int(i) for i in (
        static_argnums if isinstance(static_argnums, (list, tuple)) else (static_argnums,)))

    def deco(f):
        variants = {}

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            if torch.compiler.is_compiling():
                return f(*args, **kwargs)
            from ..jit import sot
            from ..jit.api import _recompile_budget

            key = tuple(args[i] for i in static if i < len(args))
            entry = variants.get(key)
            if entry is None:
                backend = sot.CountingBackend("inductor")
                entry = (torch.compile(f, fullgraph=True, dynamic=False, backend=backend),
                         backend)
            with _recompile_budget(f, entry[1].graphs):
                out = entry[0](*args, **kwargs)
            variants.setdefault(key, entry)
            return out

        wrapper.__wrapped__ = f
        wrapper.variants = variants
        return wrapper

    return deco(fn) if fn is not None else deco

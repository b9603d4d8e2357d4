"""The op registry and the op dispatch: the port of ``paddle_tpu/ops/_apply.py``.

Every op of the port is an ``OpDef`` (its JAX name, its function over torch
tensors, ``differentiable`` and ``amp_category``), defined with ``defop``;
the public wrapper calls ``apply``, which does what the JAX dispatch does
around an op, in the same order:

  1. the AMP cast (``amp/auto_cast.py``): inside ``auto_cast`` the floating
     tensor inputs are cast by the op's name and ``amp_category`` through
     the ``cast`` op, a differentiable ``.to(dtype)``, so the gradient is
     cast back as the JAX cast through ``ops.manipulation.cast`` casts it;
  2. the op's function, under ``torch.no_grad()`` when the op is not
     differentiable (the JAX package marks such outputs ``stop_gradient``);
  3. the NaN/Inf scan of the floating outputs when ``FLAGS_check_nan_inf``
     is on (``amp/debugging.py``), and the operator-stats record by output
     dtype while a collection is open.
With AMP off, no scan and no collection, ``apply`` costs three checks over
calling the function. PyTorch's autograd stands in for the JAX tape, so the
eager VJP cache (``_cached_pos_fns``/``_cached_op_fns``/``_LazyVjp``) has no
counterpart, and ``jit.to_static`` (Dynamo) traces through ``apply``: the AMP
state, the flag and the stats slot are guarded, so a step compiled outside
``auto_cast`` compiles again inside it. Python operators on tensors
(``a @ b``, ``a + b``) are torch's own and bypass this dispatch (in the JAX
package they are ``Tensor`` methods that dispatch).

Not ported here: graph capture (``to_static`` is Dynamo), the SPMD rules slot
(ROADMAP Queue A item 10) and the profiler and monitor spans (item 7).

The JAX package registers its built-in ops when it is imported; the port
registers those it has ported, under the same names, and keeps every JAX
built-in name in ``_builtin_names.py``, which ``is_registered`` counts as
taken.
"""
from __future__ import annotations

import functools

import torch

from ..framework import flags as _flags
from ._builtin_names import BUILTIN_OP_NAMES

_REGISTRY = {}
_BUILTIN = frozenset(BUILTIN_OP_NAMES)

#: the ``auto_cast`` state stack (``amp/auto_cast.py`` pushes and pops it)
_AMP_STATE = []
#: ``[amp_cast_inputs]``, bound when ``amp/auto_cast.py`` is imported
_AMP_CAST = [None]
#: operator stats, op name -> [fp16, bf16, fp32, other] calls; None: off
_OP_STATS = [None]
_NAN_FLAG = _flags._REGISTRY["FLAGS_check_nan_inf"]
_NAN_INF_HOOK = [None]  # bound to amp.debugging._scan_op_outputs on first use
_STATS_COLUMN = {torch.float16: 0, torch.bfloat16: 1, torch.float32: 2}


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


def _output_tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for t in out if isinstance(t, torch.Tensor)]
    return []


def _record_op_call(name, vals):
    """One call of ``name`` in the stats table, in the column of the first
    float16, bfloat16 or float32 output (else "other"), as the JAX
    ``_record_op_call`` counts it."""
    row = _OP_STATS[0].setdefault(name, [0, 0, 0, 0])
    col = 3
    for v in vals:
        c = _STATS_COLUMN.get(v.dtype)
        if c is not None:
            col = c
            break
    row[col] += 1


def _finish_outputs(name, out):
    """The dispatch postlude: NaN/Inf scan and op stats."""
    vals = _output_tensors(out)
    if _NAN_FLAG["value"]:
        hook = _NAN_INF_HOOK[0]
        if hook is None:
            from ..amp import debugging as _dbg

            hook = _NAN_INF_HOOK[0] = _dbg._scan_op_outputs
        hook(name, vals)
    if _OP_STATS[0] is not None:
        _record_op_call(name, vals)


def apply(opdef: OpDef, *args, **kwargs):
    """Dispatch one op call: AMP cast, the function, scan and stats."""
    if _AMP_STATE:
        args, kwargs = _AMP_CAST[0](opdef, args, kwargs)
    if opdef.differentiable:
        out = opdef.fn(*args, **kwargs)
    else:
        with torch.no_grad():
            out = opdef.fn(*args, **kwargs)
    if _NAN_FLAG["value"] or _OP_STATS[0] is not None:
        _finish_outputs(opdef.name, out)
    return out


def apply_raw(name, fn, tensor_args, n_outs=1):
    """Call ``fn`` on positional tensors and return its outputs as a tuple
    (the JAX entry for PyLayer and create_graph replay; autograd records it
    as it records any torch code)."""
    out = fn(*tensor_args)
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


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

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
     differentiable (the JAX package marks such outputs ``stop_gradient``),
     and under master-grad mode through ``autograd/master_grad.py``, which
     reruns its pullback in float32;
  3. the NaN/Inf scan of the floating outputs when ``FLAGS_check_nan_inf``
     is on (``amp/debugging.py``), and the operator-stats record by output
     dtype while a collection is open.
With AMP off, no scan, no collection, no profiler and no monitor, ``apply``
costs six slot loads over calling the function. While a
``paddle_tpu_torch.profiler`` RECORD window is open, each call is an
``op::<name>`` Operator span in the profiler's host events (``_PROFILER``),
as in the JAX dispatch. With the monitor on, each call bumps
``paddle_tpu_dispatch_op_calls_total{op}`` and lands in the
``paddle_tpu_dispatch_latency_ns`` histogram; with tracing on, one call in
``trace.dispatch_sample_every()`` is a ``dispatch.op`` span. One clock
(``monitor.now_ns``) feeds all three. The latency is host time: the op's
CUDA kernels run on after the call returns. PyTorch's autograd stands in for the JAX tape, so the
eager VJP cache (``_cached_pos_fns``/``_cached_op_fns``/``_LazyVjp``) has no
counterpart, and ``jit.to_static`` (Dynamo) traces through ``apply``: the AMP
state, the flag and the stats slot are guarded, so a step compiled outside
``auto_cast`` compiles again inside it. Python operators on tensors
(``a @ b``, ``a + b``) are torch's own and bypass this dispatch (in the JAX
package they are ``Tensor`` methods that dispatch).

Not ported here: graph capture (``to_static`` is Dynamo) and the SPMD rules
slot (ROADMAP Queue A item 10).

The JAX package registers its built-in ops when it is imported; the port
registers those it has ported, under the same names, and keeps every JAX
built-in name in ``_builtin_names.py``, which ``is_registered`` counts as
taken.
"""
from __future__ import annotations

import functools

import torch

from .. import monitor as _monitor
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
#: master-grad mode (``autograd/master_grad.py``): [on], and the call it
#: routes a differentiable op through, bound when that module is imported
_MASTER_GRAD = [False]
_MASTER_CALL = [None]
_STATS_COLUMN = {torch.float16: 0, torch.bfloat16: 1, torch.float32: 2}
#: the profiler's host-event collector while a RECORD window is open, else
#: None (``profiler/profiler.py`` sets it): the one check ``apply`` makes
#: for the profiler
_PROFILER = [None]
_OPERATOR = [None]  # TracerEventType.Operator, bound at the first span
_MON_STATE = _monitor._state
_TRACE = _monitor.trace
_TRACE_STATE = _TRACE._state
_MON = [None]  # (op-calls counter, latency histogram), bound on first use


class OpDef:
    __slots__ = ("name", "fn", "differentiable", "amp_category", "series")

    def __init__(self, name, fn, differentiable=True, amp_category=None):
        self.name = name
        # the label values of the op's series in the calls counter
        self.series = (name,)
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
    """Dispatch one op call: AMP cast, the function, scan and stats; while a
    profiler RECORD window is open, or the monitor or tracing is on, timed
    and recorded by ``_observed``."""
    if _PROFILER[0] is not None or _MON_STATE.on or _TRACE_STATE.on:
        return _observed(opdef, args, kwargs)
    return _dispatch(opdef, args, kwargs)


def _observed(opdef, args, kwargs):
    """``apply`` under the profiler, the monitor or tracing. The profiler's
    Operator span is the reference's per-op record event (eager_gen.py's
    record-event preamble); the monitor's counter and histogram and the
    sampled ``dispatch.op`` span are the JAX dispatch's
    (``paddle_tpu/ops/_apply.py`` ``apply``). The span ticket is drawn
    before any timing, so unsampled calls with only tracing on read no
    clock. A traced call (``to_static``) records nothing, as the JAX trace
    records no Operator span."""
    if torch.compiler.is_compiling():
        return _dispatch(opdef, args, kwargs)
    trace_this = (_TRACE_STATE.on and next(_TRACE._dispatch_tick)
                  % _TRACE._DISPATCH_SAMPLE_EVERY == 0)
    if _PROFILER[0] is None and not _MON_STATE.on and not trace_this:
        return _dispatch(opdef, args, kwargs)
    now_ns = _monitor.now_ns
    t0 = now_ns()
    try:
        return _dispatch(opdef, args, kwargs)
    finally:
        t1 = now_ns()
        if _MON_STATE.on:
            mon = _MON[0]
            if mon is None:
                mon = _MON[0] = (
                    _monitor.counter("paddle_tpu_dispatch_op_calls_total",
                                     labelnames=("op",)),
                    _monitor.histogram("paddle_tpu_dispatch_latency_ns"))
            mon[0].child(opdef.series).inc()
            mon[1].observe_ns(t1 - t0)
        if trace_this:
            _TRACE.record_span("dispatch.op", t0, t1,
                               attrs={"op": opdef.name,
                                      "sample_every": _TRACE._DISPATCH_SAMPLE_EVERY})
        collector = _PROFILER[0]
        if collector is not None:
            if _OPERATOR[0] is None:
                from ..profiler.profiler import TracerEventType

                _OPERATOR[0] = TracerEventType.Operator
            collector.emit(f"op::{opdef.name}", _OPERATOR[0], t0, t1)


def _dispatch(opdef, args, kwargs):
    if _AMP_STATE:
        args, kwargs = _AMP_CAST[0](opdef, args, kwargs)
    if opdef.differentiable:
        if _MASTER_GRAD[0] and torch.is_grad_enabled():
            out = _MASTER_CALL[0](opdef, args, kwargs)
        else:
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

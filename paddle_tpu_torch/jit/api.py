"""jit.to_static: a function or a Module's forward compiled into one cached
program per input signature.

Counterpart of ``paddle_tpu/jit/api.py``. There capture is jax tracing and
XLA compiles the trace; here capture is Dynamo (``torch.compile``), a
bytecode tracer with guards and graph breaks as the reference's SOT is, and
Inductor compiles the graph, in XLA's part of both IR and fusion compiler.
The port's hand-written kernels are ``torch.library`` ops
(``ops/cuda/flash_attention.py``, ``ops/cuda/axpy.py``), so a compiled
graph calls them where eager code does and Inductor fuses what lies
between.

The contract, as in the JAX package:

* one compiled program per call SIGNATURE: the tree of the arguments, each
  tensor's shape, dtype, device and ``requires_grad``, the non-tensor
  arguments, every submodule's ``training`` flag, the parameters'
  ``requires_grad`` and ``torch.is_grad_enabled()``. ``dynamic=False``:
  a new shape compiles its own program, as a new shape retraces in JAX.
* Python control flow on tensor VALUES is not traced: under
  ``full_graph=True`` (the default) a host read (``.item()``, ``float(t)``,
  ``if t:``) raises Dynamo's ``Unsupported`` (``UserError`` where the
  read value feeds a comparison), naming the line; under
  ``full_graph=False`` that signature warns once and runs as compiled
  segments around the read (``sot.py``) while every other signature stays
  whole-compiled.
* gradients run through the compiled function (AOTAutograd), so a
  ``to_static`` Module trains as the eager one does.
* buffers a forward updates in place (BatchNorm's running statistics) are
  updated through the compiled call.

One difference: Dynamo replays a function's side effects on Python objects
(an appended list, a mutated dict) on every compiled call, where jax tracing
runs them once per signature. The compiled tensor program is the same.

``backend=None`` is Inductor on every device; a string or a callable goes
to ``torch.compile`` as it is (the CPU tests pass ``"aot_eager"``: AOTAutograd
without Inductor's code generation). A new signature always compiles its
program, however many the function's code already holds (Dynamo keeps one
cache and one ``recompile_limit`` per code object, shared by every
``StaticFunction`` of that code, such as every to_static'd instance of one
Module class), as a new signature always traces in JAX. Under
``full_graph=True`` a signature that Dynamo's guards make recompile past
``recompile_limit`` programs of its own raises instead of running eagerly.
``not_to_static`` only marks a function: it is traced through, as in JAX.
``input_spec`` and ``build_strategy`` are kept and not read, as in JAX.

Telemetry, as in the JAX package: with the monitor on, a signature miss
bumps ``paddle_tpu_jit_compiles_total{function}`` and lands its host time
(Dynamo's trace, Inductor's compile, the first run) in
``paddle_tpu_jit_trace_compile_seconds``, a hit bumps
``paddle_tpu_jit_cache_hits_total``; with tracing on a miss is a
``jit.compile`` span; with the recompile sanitizer on every miss is one
``note_compile("to_static.<name>")``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch._dynamo.eval_frame import _debug_get_cache_entry_list
from torch.utils import _pytree as pytree

from .. import monitor as _monitor
from ..analysis import sanitizers as _sanitizers
from . import sot as _sot


class InputSpec:
    """paddle.static.InputSpec: symbolic input signature (shape with None = dynamic)."""

    def __init__(self, shape, dtype="float32", name=None, stop_gradient=True):
        self.shape = list(shape)
        self.dtype = dtype
        self.name = name
        self.stop_gradient = stop_gradient

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype}, name={self.name})"


def _const_key(leaf):
    """Hashable identity for a non-tensor argument, which Dynamo bakes into
    the trace as a constant (and guards on)."""
    if isinstance(leaf, np.ndarray):
        return (leaf.shape, str(leaf.dtype), leaf.tobytes())
    try:
        hash(leaf)
        return leaf
    except TypeError:
        return repr(leaf)


def _tensor_key(t):
    return (tuple(t.shape), t.dtype, t.device, t.requires_grad)


def _recompile_budget(function, compiled):
    """A context in which a signature that has ``compiled`` programs so far
    may compile up to ``recompile_limit`` of its own whatever else the
    function's code object holds, and past that Dynamo raises rather than
    running the frame eagerly (a whole-graph signature must stay
    compiled)."""
    cfg = torch._dynamo.config
    code = getattr(getattr(function, "__func__", function), "__code__", None)
    held = 0 if code is None else len(_debug_get_cache_entry_list(code))
    limit = held - compiled + cfg.recompile_limit
    return cfg.patch(fail_on_recompile_limit_hit=True, recompile_limit=limit,
                     accumulated_recompile_limit=max(limit, cfg.accumulated_recompile_limit))


class StaticFunction:
    """A callable whose body runs as one cached compiled program per input
    signature (``torch.compile`` with ``fullgraph=True``, ``dynamic=False``)."""

    def __init__(self, function, layer=None, input_spec=None, full_graph=True, backend=None):
        self._function = function
        self._layer = layer
        self._input_spec = input_spec
        self._full_graph = full_graph
        self._backend = "inductor" if backend is None else backend
        self._cache = {}        # signature -> (compiled callable, its CountingBackend)
        self._segmented = {}    # graph-broken signature -> sot.SegmentedFunction
        functools.update_wrapper(self, function)

    @property
    def _fallback_keys(self):
        """The graph-broken signatures (as JAX's attribute)."""
        return set(self._segmented)

    @property
    def _fallback(self):
        """True once any signature graph-broke (diagnostic, as in JAX)."""
        return bool(self._segmented)

    # -- cache key ----------------------------------------------------------
    def _signature(self, args, kwargs):
        leaves, spec = pytree.tree_flatten((args, kwargs))
        tensors = tuple(_tensor_key(l) for l in leaves if isinstance(l, torch.Tensor))
        consts = tuple(_const_key(l) for l in leaves if not isinstance(l, torch.Tensor))
        if self._layer is None:
            mode, state = (), ()
        else:
            mode = tuple(m.training for m in self._layer.modules())
            state = tuple(p.requires_grad for p in self._layer.parameters())
        return (str(spec), tensors, consts, mode, state, torch.is_grad_enabled())

    def _compile(self):
        backend = _sot.CountingBackend(self._backend)
        fn = torch.compile(self._function, fullgraph=True, dynamic=False, backend=backend)
        return fn, backend

    # -- call ---------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        if not _TO_STATIC_STATE[0] or torch.compiler.is_compiling():
            # disabled, or inside an outer trace, which traces through (as a
            # nested to_static call is traced inline by jax)
            return self._function(*args, **kwargs)
        key = self._signature(args, kwargs)
        if key in self._segmented:
            return self._segmented[key](*args, **kwargs)
        entry = self._cache.get(key)
        miss = entry is None
        if miss:
            entry = self._compile()
            if _sanitizers._state.recompile:
                # graftsan's recompile sentinel: every signature miss is one
                # trace+compile; past the threshold it raises with the recent
                # signature history
                _sanitizers.note_compile(
                    "to_static." + getattr(self._function, "__name__", "fn"),
                    signature=key[1])
        mon = _monitor._state.on or _monitor.trace._state.on
        t0 = _monitor.now_ns() if mon else 0
        try:
            with _recompile_budget(self._function, entry[1].graphs):
                out = entry[0](*args, **kwargs)
        except (torch._dynamo.exc.Unsupported, torch._dynamo.exc.UserError) as e:
            # a graph break (Unsupported), or a guard on a value read from a
            # tensor (UserError): Python control flow needs a tensor's value
            if self._full_graph:
                raise
            _sot.warn_graph_break(self._function, e)
            seg = self._segmented[key] = _sot.SegmentedFunction(
                self._function, self._backend,
                label="sot." + getattr(self._function, "__name__", "fn"))
            return seg(*args, **kwargs)
        # a signature is cached once its program has run
        self._cache.setdefault(key, entry)
        if mon:
            self._record(miss, t0)
        return out

    def _record(self, miss, t0):
        """The monitor's view of one whole-compiled call (the JAX
        ``_traced_call_keyed``): a signature miss is one compile (Dynamo's
        trace, Inductor's compile and the first run, timed on the host) and,
        with tracing on, a ``jit.compile`` span; a hit bumps the hit
        counter."""
        fname = getattr(self._function, "__name__", "fn")
        if miss:
            t1 = _monitor.now_ns()
            if _monitor.trace._state.on:
                _monitor.trace.record_span("jit.compile", t0, t1,
                                           attrs={"function": fname})
            if _monitor._state.on:
                _monitor.counter("paddle_tpu_jit_compiles_total",
                                 labelnames=("function",)).labels(fname).inc()
                _monitor.histogram("paddle_tpu_jit_trace_compile_seconds",
                                   buckets=_monitor.DEFAULT_SECONDS_BUCKETS
                                   ).observe((t1 - t0) / 1e9)
                _monitor.gauge("paddle_tpu_jit_cached_signatures",
                               labelnames=("function",)).labels(fname).set(len(self._cache))
        elif _monitor._state.on:
            _monitor.counter("paddle_tpu_jit_cache_hits_total",
                             labelnames=("function",)).labels(fname).inc()

    # -- introspection -------------------------------------------------------
    @property
    def code(self):
        import inspect

        try:
            return inspect.getsource(self._function)
        except (OSError, TypeError):
            return "<source unavailable>"

    def concrete_program_specs(self):
        """The signatures compiled whole, in the order they were first seen."""
        return list(self._cache.keys())

    def compiled_segment_counts(self):
        """signature -> number of graphs Dynamo compiled for it (graph-broken
        signatures only; whole-compiled ones are in the program cache)."""
        return {k: s.compiled_segment_count for k, s in self._segmented.items()}

    def rollback(self):
        """Undo to_static on a Module's forward; returns the original function."""
        if self._layer is not None and hasattr(self._layer, "_orig_forward"):
            self._layer.forward = self._layer._orig_forward
        return self._function


def to_static(function=None, input_spec=None, build_strategy=None, backend=None,
              full_graph=True, **kwargs):
    """Compile a function or a Module's forward into one cached program per
    input signature (module docstring). A Module comes back with its
    ``forward`` replaced (``rollback()`` restores it); a function comes back
    as a ``StaticFunction``. Usable as a decorator, with or without
    arguments."""

    def decorate(obj):
        if isinstance(obj, torch.nn.Module):
            layer = obj
            fwd = layer.forward
            layer._orig_forward = fwd
            layer.forward = StaticFunction(fwd, layer=layer, input_spec=input_spec,
                                           full_graph=full_graph, backend=backend)
            return layer
        return StaticFunction(obj, input_spec=input_spec, full_graph=full_graph,
                              backend=backend)

    if function is not None:
        return decorate(function)
    return decorate


def not_to_static(fn):
    """Marker only: the function is traced through (as jax traces through it),
    not made a graph break."""
    fn._not_to_static = True
    return fn


def enable_to_static(flag=True):
    """With False, every ``StaticFunction`` runs its function eagerly."""
    _TO_STATIC_STATE[0] = bool(flag)


_TO_STATIC_STATE = [True]


def ignore_module(modules):
    """Accepted and ignored, as in the JAX package."""
    return None

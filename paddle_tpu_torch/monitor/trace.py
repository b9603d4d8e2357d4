"""Structured span tracing + flight recorder.

The metrics registry answers *aggregate* questions; this module
answers *causal* ones — "where did THIS request's 900 ms TTFT go?", "what
was in flight when rank 2 hung?". It is the span layer under the serving
request lifecycle, JIT compiles, sampled op dispatch, dataloader batches
and training steps:

- DISABLED BY DEFAULT, same policy as the metrics registry: every
  instrument site guards on ``trace._state.on`` (one slot load on a
  preallocated object), so the cost when off is a few nanoseconds —
  one slot load per dispatch.
- spans carry an explicit ``span_id``, a ``parent_id`` link and a
  ``trace_id`` shared by a whole tree (one per serving request); implicit
  parenting nests ``span()`` context managers per thread, explicit
  ``start_span(parent=...)`` crosses threads/steps.
- completed spans land in a BOUNDED preallocated ring buffer (no lock on
  the write path: one ``itertools.count`` ticket + one list-slot store,
  both atomic under the GIL) that doubles as a **flight recorder**: the
  last-N spans plus the still-open spans are exactly the post-mortem a
  hang needs, and :func:`flight_dump` writes them (with the monitor
  snapshot and the provenance block) to a per-rank file —
  ``distributed/watchdog.py`` calls it on a watchdog timeout and the
  serving engine on a recovery.
- the clock is :func:`paddle_tpu_torch.monitor.now_ns` — the same
  perf_counter_ns domain as the profiler's host spans and the metric
  timeline samples, so :func:`chrome_span_events` merges into the ONE
  chrome timeline the profiler exports (profiler/profiler.py).

Spans are HOST time. CUDA launches are asynchronous and a replayed CUDA
graph is one host call, so a span ends when the host returns from the
launches it covers, not when the card finishes them — exactly where the
JAX package's asynchronous dispatch ends its spans. A span that must
cover device work has to end after a synchronising read (the serving
step's one sampled-token readback does that).

Span names are a contract, declared in ``monitor/catalog.py`` ``SPANS``
(the JAX package's names).
"""
from __future__ import annotations

import itertools
import json
import os
import tempfile
import threading
import time

from ..analysis import sanitizers as _san
from . import provenance as _prov
from .registry import now_ns

__all__ = [
    "Span", "enable", "disable", "enabled", "reset",
    "new_trace_id", "span", "start_span", "end_span", "record_span",
    "current_span", "thread_span_stack", "spans", "open_spans", "drop",
    "chrome_span_events", "span_dump", "flight_dump",
    "register_flight_section", "unregister_flight_section",
    "training_step", "set_dispatch_sampling", "dispatch_sample_every",
]

_RING_CAPACITY = 4096


class _TraceState:
    """The disabled-mode fast path: instrument sites read ``_state.on`` —
    a single slot load — before doing any span work."""

    __slots__ = ("on",)

    def __init__(self):
        self.on = False


_state = _TraceState()

# ring of COMPLETED spans: preallocated slots; writers take an atomic
# sequence ticket (itertools.count.__next__ is one bytecode under the GIL)
# and store into seq % capacity — no lock anywhere on the record path
_ring = [None] * _RING_CAPACITY
_ring_seq = itertools.count()

_ids = itertools.count(1)          # span ids (also trace ids: shared pool)

# OPEN spans: the flight recorder's "what was in flight" view. Start/end
# are not the sampled-dispatch hot path (requests, compiles, steps), so a
# small lock here is fine — and a dump from the watchdog's scanner thread
# needs a consistent snapshot.
_open = {}
_open_lock = threading.Lock()

_tls = threading.local()           # implicit parenting stack per thread

_DISPATCH_SAMPLE_EVERY = 64        # record 1 in N dispatch spans
_dispatch_tick = itertools.count()


class Span:
    """One span: explicit id, parent link, trace id, [t0, t1] on the
    monitor clock, and a small attrs dict. ``t1_ns`` is None while open."""

    __slots__ = ("span_id", "trace_id", "parent_id", "name", "t0_ns",
                 "t1_ns", "thread_id", "attrs", "seq")

    def __init__(self, name, span_id, trace_id, parent_id, t0_ns, attrs):
        self.name = name
        self.span_id = span_id
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.t0_ns = t0_ns
        self.t1_ns = None
        self.thread_id = threading.get_ident()
        self.attrs = attrs
        self.seq = None

    @property
    def duration_ns(self):
        return None if self.t1_ns is None else self.t1_ns - self.t0_ns

    def to_dict(self):
        d = {
            "name": self.name,
            "span_id": self.span_id,
            "trace_id": self.trace_id,
            "parent_id": self.parent_id,
            "t0_ns": self.t0_ns,
            "t1_ns": self.t1_ns,
            "dur_ns": self.duration_ns,
            "thread_id": self.thread_id,
        }
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        return d

    def __repr__(self):
        state = "open" if self.t1_ns is None else f"{self.duration_ns}ns"
        return (f"Span({self.name}, id={self.span_id}, "
                f"trace={self.trace_id}, {state})")


def enable():
    """Turn span collection on process-wide."""
    _state.on = True


def disable():
    """Turn span collection off (recorded spans are kept; reset() drops)."""
    _state.on = False


def enabled():
    return _state.on


def reset(capacity=None):
    """Drop every recorded and open span (test isolation / between-run
    hygiene); ``capacity`` resizes the ring (default keeps the current
    size)."""
    global _ring, _ring_seq, _ids, _dispatch_tick
    with _open_lock:
        _open.clear()
    _ring = [None] * int(capacity or len(_ring))
    _ring_seq = itertools.count()
    _ids = itertools.count(1)
    _dispatch_tick = itertools.count()
    _tls.__dict__.clear()
    with _dump_lock:
        _last_dumps.clear()


def set_dispatch_sampling(every):
    """Record 1 in ``every`` op-dispatch spans (default 64). Sampling keeps
    the per-dispatch span tax far off the 40us eager budget while still
    populating the timeline."""
    global _DISPATCH_SAMPLE_EVERY
    every = int(every)
    if every < 1:
        raise ValueError("dispatch sampling rate must be >= 1")
    _DISPATCH_SAMPLE_EVERY = every


def dispatch_sample_every():
    return _DISPATCH_SAMPLE_EVERY


def new_trace_id():
    """Fresh trace id (one per serving request / user-defined tree)."""
    return next(_ids)


def _stack():
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_span():
    """The innermost span() open on THIS thread, or None."""
    st = getattr(_tls, "stack", None)
    return st[-1] if st else None


def thread_span_stack():
    """The implicit span() context stack of THIS thread, outermost first
    (graftsan's host-sync tripwire scans it for protected train/serving
    regions)."""
    st = getattr(_tls, "stack", None)
    return tuple(st) if st else ()


def _commit(sp, t1_ns=None):
    """Close a span and write it into the ring (lock-free ticket store)."""
    sp.t1_ns = now_ns() if t1_ns is None else t1_ns
    sp.seq = next(_ring_seq)
    _ring[sp.seq % len(_ring)] = sp


def start_span(name, parent=None, trace_id=None, attrs=None):
    """Open a span explicitly (cross-thread / cross-step lifecycles like a
    serving request). Does NOT touch the implicit per-thread stack; close
    with :func:`end_span`. Returns the Span (a no-op None when tracing is
    off — end_span(None) is tolerated)."""
    if not _state.on:
        return None
    if parent is not None:
        parent_id = parent.span_id
        trace_id = parent.trace_id if trace_id is None else trace_id
    else:
        parent_id = None
    sid = next(_ids)
    sp = Span(name, sid, sid if trace_id is None else trace_id, parent_id,
              now_ns(), attrs)
    with _open_lock:
        _open[sid] = sp
    return sp


def end_span(sp, t1_ns=None):
    """Close a span opened by start_span (None and double-close tolerated,
    so instrument sites need no tracing-state bookkeeping)."""
    if sp is None or sp.t1_ns is not None:
        return
    with _open_lock:
        _open.pop(sp.span_id, None)
    _commit(sp, t1_ns)


def record_span(name, t0_ns, t1_ns, parent=None, trace_id=None, attrs=None):
    """Record an already-timed complete span (the sampled dispatch path:
    the caller timed [t0, t1] itself, nothing ever sits in _open)."""
    if not _state.on:
        return None
    if parent is not None:
        parent_id = parent.span_id
        trace_id = parent.trace_id if trace_id is None else trace_id
    else:
        parent_id = None
    sid = next(_ids)
    sp = Span(name, sid, sid if trace_id is None else trace_id, parent_id,
              t0_ns, attrs)
    _commit(sp, t1_ns)
    return sp


class _SpanCtx:
    """Context manager for implicit (thread-nested) spans. The span opens
    and joins the parenting stack in __enter__, NOT at construction — a
    context that is created but never entered must not leave a phantom
    open span parenting everything after it."""

    __slots__ = ("_args", "_sp", "_hs")

    def __init__(self, name, parent, trace_id, attrs):
        self._args = (name, parent, trace_id, attrs)
        self._sp = None
        self._hs = False

    @property
    def span(self):
        return self._sp

    def __enter__(self):
        name, parent, trace_id, attrs = self._args
        if parent is None:
            parent = current_span()
        self._sp = start_span(name, parent=parent, trace_id=trace_id,
                              attrs=attrs)
        if self._sp is not None:
            _stack().append(self._sp)
            # a train.*/serving.* span is a protected region: the host-sync
            # tripwire is pushed for it while the sanitizer is on
            if _san._state.hostsync and _san.protected_span(name):
                self._hs = _san.push_hostsync(name)
        return self._sp

    def __exit__(self, *exc):
        if self._hs:
            self._hs = False
            _san.pop_hostsync()
        if self._sp is not None:
            st = _stack()
            if st and st[-1] is self._sp:
                st.pop()
            end_span(self._sp)
        return False


class _NoopCtx:
    __slots__ = ()
    span = None

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _NoopCtx()


def span(name, parent=None, trace_id=None, attrs=None):
    """Context-manager span. Parent defaults to the innermost open span()
    on this thread at __enter__ time (implicit nesting); pass ``parent=``
    to attach to an explicit tree (e.g. a serving request root). When
    tracing is off this returns a shared no-op context — zero
    allocation."""
    if not _state.on:
        return _NOOP
    return _SpanCtx(name, parent, trace_id, attrs)


class _TrainStep:
    """The training-step decomposition hapi/model.py drives: a ``train.step``
    root with dataload/forward/backward/optimizer child stages. Usable
    directly::

        with trace.training_step(step=i) as ts:
            with ts.stage("dataload"):
                batch = next(it)
            ...
    """

    __slots__ = ("_ctx",)

    def __init__(self, step):
        self._ctx = span("train.step",
                         attrs=None if step is None else {"step": step})

    def stage(self, name):
        """Child span for one stage; name is the suffix of ``train.<name>``
        (dataload / forward / backward / optimizer)."""
        return span("train." + name, parent=self._ctx.span)

    def __enter__(self):
        self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        return self._ctx.__exit__(*exc)


def training_step(step=None):
    return _TrainStep(step)


# -- export ------------------------------------------------------------------

def spans(limit=None):
    """Completed spans, oldest first (at most the ring capacity; ``limit``
    keeps the newest N)."""
    out = [sp for sp in list(_ring) if sp is not None]
    out.sort(key=lambda sp: sp.seq)
    if limit is not None:
        out = out[-int(limit):]
    return out


def open_spans():
    """Spans started but not yet ended (the in-flight view), oldest first."""
    with _open_lock:
        out = list(_open.values())
    return sorted(out, key=lambda sp: sp.span_id)


def drop(sp):
    """Abandon an open span without recording it (e.g. a serving request
    dropped before admission)."""
    if sp is not None:
        with _open_lock:
            _open.pop(sp.span_id, None)


def chrome_span_events(include_open=False, now=None):
    """Completed spans as chrome-trace "X" events on the monitor clock
    (merged by the profiler into its host/device timeline). Open spans can
    be included as running-to-now slices for hang visualization."""
    pid = os.getpid()
    out = []
    todo = spans()
    if include_open:
        todo = todo + open_spans()
    for sp in todo:
        t1 = sp.t1_ns if sp.t1_ns is not None else (now or now_ns())
        args = {"span_id": sp.span_id, "trace_id": sp.trace_id}
        if sp.parent_id is not None:
            args["parent_id"] = sp.parent_id
        if sp.t1_ns is None:
            args["open"] = True
        if sp.attrs:
            args.update(sp.attrs)
        out.append({
            "name": sp.name,
            "cat": "TraceSpan",
            "ph": "X",
            "ts": sp.t0_ns / 1e3,          # chrome trace wants microseconds
            "dur": max(t1 - sp.t0_ns, 1) / 1e3,
            "pid": pid,
            "tid": sp.thread_id % 10 ** 6,
            "args": args,
        })
    return out


def span_dump(tail=None):
    """JSON-able dict of the recorded + open spans with the provenance
    block (same contract as monitor.snapshot())."""
    return {
        "provenance": _prov.provenance(),
        "clock": "perf_counter_ns",
        "spans": [sp.to_dict() for sp in spans(limit=tail)],
        "open_spans": [sp.to_dict() for sp in open_spans()],
    }


def _rank():
    for var in ("PADDLE_TRAINER_ID", "PADDLE_TPU_RANK", "RANK"):
        v = os.environ.get(var)
        if v is not None:
            try:
                return int(v)
            except ValueError:
                continue
    return 0


def default_flight_path(rank=None, key=None):
    """Per-rank flight-dump file: ``$PADDLE_TPU_FLIGHT_DIR`` (default the
    temporary directory, ``$TMPDIR``) /
    paddle_tpu_flight_rank<r>_pid<pid>[_<key>].json. ``key``
    names the observed component (e.g. a serving engine/replica tag):
    a multi-engine process dumps each engine's post-mortem to ITS OWN
    file instead of blending replicas."""
    d = os.environ.get("PADDLE_TPU_FLIGHT_DIR") or tempfile.gettempdir()
    r = _rank() if rank is None else rank
    suffix = f"_{key}" if key else ""
    return os.path.join(
        d, f"paddle_tpu_flight_rank{r}_pid{os.getpid()}{suffix}.json")


# Dump coalescing: one hang is often observed by SEVERAL watchers (the
# comm watchdog's scanner, the serving engine's recovery, a sanitizer
# trip). Within the window, dumps to the same path MERGE — the file
# carries every observer's reason and (being written last) every
# observer's open spans — instead of the last partial dump clobbering
# the first. The merge state is PER PATH: a fleet of in-process engine
# replicas dumps one file per replica (`key=` above), and replica A's
# observers keep coalescing with each other even when replica B dumps
# in between — never across paths.
DUMP_COALESCE_S = 10.0
_dump_lock = threading.Lock()
_last_dumps = {}     # path -> {"t": first-dump monotonic, reasons, extras}

# Flight-dump sections: subsystems that want their host-readable state
# merged into every post-mortem (the graftpilot controller registers its
# decision tail here). Same weak-ref lifetime contract as the graftscope
# provider registries — a collected owner never leaks a section.
_section_lock = threading.Lock()
_flight_sections = {}      # name -> WeakMethod | callable


def register_flight_section(name, fn):
    """Register one flight-dump section: ``fn()`` -> JSON-able value,
    written under ``doc["sections"][name]`` in every dump. Bound methods
    are held weakly; a raising/dead section is skipped (a failing
    contributor must not mask the hang the dump documents)."""
    import weakref

    ref = weakref.WeakMethod(fn) if hasattr(fn, "__self__") else fn
    with _section_lock:
        _flight_sections[str(name)] = ref


def unregister_flight_section(name, fn=None):
    import weakref

    with _section_lock:
        ref = _flight_sections.get(str(name))
        if ref is None:
            return
        if fn is not None:
            cur = ref() if isinstance(ref, weakref.WeakMethod) else ref
            if cur is not None and cur != fn:
                return
        _flight_sections.pop(str(name), None)


def _collect_sections():
    """{name: section} of the live registered contributors (best
    effort: dead weakrefs pruned, raising sections skipped)."""
    import weakref

    with _section_lock:
        items = list(_flight_sections.items())
    out, dead = {}, []
    for name, ref in items:
        fn = ref() if isinstance(ref, weakref.WeakMethod) else ref
        if fn is None:
            dead.append((name, ref))
            continue
        try:
            out[name] = fn()
        except Exception:  # noqa: BLE001 - a failing section is dropped
            pass
    if dead:
        with _section_lock:
            for name, ref in dead:
                if _flight_sections.get(name) is ref:
                    _flight_sections.pop(name)
    return out


def flight_dump(path=None, reason="", tail=256, extra=None,
                coalesce_s=None, key=None):
    """Write the flight-recorder post-mortem: last-``tail`` completed spans,
    every OPEN span, the monitor metrics snapshot and the provenance block,
    to a per-rank file. Called by the watchdog timeout path, serving
    recovery and elastic restarts; never raises (a failing dump must not
    mask the hang it documents). ``key`` suffixes the default path with
    the observed component (engine/replica tag) so a multi-replica
    process yields one dump per replica. Dumps to the same path within
    ``coalesce_s`` (default :data:`DUMP_COALESCE_S`) seconds merge their
    reasons into ONE file (``reasons`` list + joined ``reason``) — a hang
    the watchdog and the engine both observe produces a single dump
    naming both, not two partial ones — while dumps to different paths
    (two different replicas) never fuse. Returns the path written, or
    None."""
    try:
        from . import snapshot as _metrics_snapshot

        doc = span_dump(tail=tail)
        window = DUMP_COALESCE_S if coalesce_s is None else coalesce_s
        target = path or default_flight_path(key=key)
        with _dump_lock:
            now_mono = time.monotonic()
            last = _last_dumps.get(target)
            if last is not None and now_mono - last["t"] < window:
                reasons = last["reasons"] + [reason]
                extras = last["extras"] + ([extra] if extra else [])
                t_anchor = last["t"]
            else:
                reasons = [reason]
                extras = [extra] if extra else []
                # anchor the window to the FIRST dump of the series: a
                # recurring fault (recovery loop dumping every few
                # seconds) must start a fresh file once the window
                # elapses, not merge — and grow — forever
                t_anchor = now_mono
            if len(_last_dumps) > 64:
                # bounded: drop expired windows (a long-lived process
                # cycling many paths must not grow this forever)
                for p in [p for p, d in _last_dumps.items()
                          if now_mono - d["t"] >= window and p != target]:
                    _last_dumps.pop(p)
            _last_dumps[target] = {"t": t_anchor, "reasons": reasons,
                                   "extras": extras}
        doc["reason"] = "; ".join(r for r in reasons if r)
        doc["reasons"] = reasons
        if extras:
            # every coalesced observer's state view survives in the one
            # file — the watchdog's stuck-section table AND the engine's
            # recovery context, not just the last writer's
            doc["extras"] = extras
        doc["rank"] = _rank()
        doc["pid"] = os.getpid()
        doc["tracing_enabled"] = _state.on
        try:
            doc["monitor"] = _metrics_snapshot()
        except Exception:  # noqa: BLE001 - spans alone still diagnose
            doc["monitor"] = None
        sections = _collect_sections()
        if sections:
            doc["sections"] = sections
        if extra:
            doc["extra"] = extra
        path = target
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True, default=str)
        os.replace(tmp, path)   # readers never see a torn dump
        return path
    except Exception:  # noqa: BLE001
        return None

"""graftsan: opt-in runtime sanitizers (the port of
``paddle_tpu/analysis/sanitizers.py``).

Five sanitizers, enabled via
``PADDLE_TPU_SANITIZE=lock,recompile,hostsync,race,numerics`` (or
``all``) at process start, or programmatically with :func:`enable`:

- **lock** — a lock-order witness: the stack's known locks are wrapped so
  every acquisition-while-holding records an ordered edge; acquiring B
  while holding A after some thread acquired A while holding B raises
  :class:`LockOrderInversion` *before blocking*, naming both
  first-witness acquisition stacks. :func:`check_wait` trips a declared
  blocking wait made while the calling thread holds a sanitized lock.
- **recompile** — a recompile sentinel: the program caches (``jit/api.py``
  to_static signatures, ``jit/sot.py`` captures, the serving engine's CUDA
  graph captures per bucket and per batch) report every cache miss via
  :func:`note_compile`; more misses for one callable than the threshold
  (``PADDLE_TPU_SANITIZE_RECOMPILE_THRESHOLD``, default 8) raises
  :class:`RecompileStorm` with the recent signature history.
- **hostsync** — a host-sync tripwire. The JAX package hooks its
  ``Tensor`` concretization slot; the port has no ``Tensor`` wrapper, so
  it pushes a ``TorchDispatchMode`` on the thread while a
  :func:`protected_region` or a ``train.``/``serving.`` span is open (and
  only while ``hostsync`` is on: the cost when off stays one slot load at
  region entry). Inside, ``aten._local_scalar_dense`` (``.item()``,
  ``float()``, ``int()``, ``bool()``), a copy from a CUDA tensor to the
  host (``.cpu()``, ``.tolist()``, ``.numpy()`` after it) and an op whose
  output size depends on the values of a CUDA tensor (``nonzero``,
  boolean masks, ``unique``) raise :class:`HostSyncInProtectedRegion`.
  Reads wrapped in :func:`allow_host_sync` are sanctioned. A CUDA graph
  captured under the mode records the same kernels (the mode calls each op
  unchanged); a replay dispatches no aten op, so it neither trips nor pays
  for the mode. ``torch.cuda.set_sync_debug_mode`` cannot be the mechanism:
  it is process-wide and does nothing on the CPU.
- **race** — a data-race witness: instrumented hot classes (the serving
  engine's stats/span tables, FleetRouter, SLOTracker,
  CheckpointManager) report field accesses via :func:`race_access`; an
  Eraser-style candidate-lockset intersection over the SanitizedLock
  held-set per (owner, field) raises :class:`DataRace` when a mutated
  field's candidate set empties. Enabling ``race`` makes :func:`new_lock`
  return sanitized locks (held-set maintenance) even when the order
  witness is off.
- **numerics** — numsan: one device-side all-finite reduction over the
  registered step outputs at every step/burst boundary
  (:func:`numsan_check`), ONE bool to the host per step. A non-finite value
  raises :class:`NumericsTrip` naming the step and the first non-finite
  region tag; drilled via the ``numsan.check`` fault point. The eager
  per-op checker in ``amp/debugging.py`` shares the same check
  (``numerics.py``).

Discipline matches monitor/trace: **disabled by default**, every guard is
one slot load on a preallocated ``_state`` object, nothing is wrapped or
pushed until enabled.

Every trip also (best-effort) bumps
``paddle_tpu_monitor_sanitizer_trips_total``, records a
``monitor.sanitizer_trip`` span (``monitor.numsan_trip`` for numerics,
which carries the site/step/region attrs), and writes the trace
flight-recorder dump before raising.

This module imports only the standard library at module level; torch (the
dispatch mode, numsan's reductions in ``numerics.py``) and the
monitor/trace bindings resolve lazily at enable, region or trip time.
"""
from __future__ import annotations

import collections
import os
import threading
import traceback

__all__ = [
    "SanitizerError", "LockOrderInversion", "RecompileStorm",
    "HostSyncInProtectedRegion", "BlockingWaitUnderLock", "DataRace",
    "NumericsTrip",
    "enable", "disable", "enabled", "install_from_env", "reset",
    "SanitizedLock", "new_lock", "wrap_lock", "lock_order_edges",
    "check_wait",
    "note_compile", "compile_counts", "recompile_threshold",
    "set_recompile_threshold",
    "protected_region", "allow_host_sync", "protected_span",
    "push_hostsync", "pop_hostsync", "trips",
    "race_access", "race_fields",
    "numsan_check", "numsan_counts",
]

_KINDS = ("lock", "recompile", "hostsync", "race", "numerics")


class SanitizerError(RuntimeError):
    """Base class: a graftsan sanitizer tripped."""


class LockOrderInversion(SanitizerError):
    """Two threads acquired the same two locks in opposite orders."""


class RecompileStorm(SanitizerError):
    """One callable crossed the compile-count threshold."""


class HostSyncInProtectedRegion(SanitizerError):
    """A device→host sync fired inside an active training/serving span."""


class BlockingWaitUnderLock(SanitizerError):
    """A declared blocking wait ran while holding a sanitized lock."""


class DataRace(SanitizerError):
    """An instrumented field's candidate lockset emptied while mutated —
    two threads touch it with no common lock."""


class NumericsTrip(SanitizerError):
    """A registered step-boundary region holds a non-finite value."""


class _State:
    """One slot load per guard when disabled — the monitor discipline.
    ``locktrack`` is the derived held-set-maintenance flag: on when the
    order witness OR the race witness needs to know which sanitized
    locks each thread holds."""

    __slots__ = ("on", "lock", "recompile", "hostsync", "race",
                 "numerics", "locktrack")

    def __init__(self):
        self.on = False
        self.lock = False
        self.recompile = False
        self.hostsync = False
        self.race = False
        self.numerics = False
        self.locktrack = False


_state = _state_singleton = _State()
_tls = threading.local()

# -- lock-order witness -------------------------------------------------------

_graph_lock = threading.Lock()
_edges = {}          # (held, acquired) -> first-witness stack (str)
_trips = []          # [(kind, message)] — test/postmortem introspection

# -- race witness -------------------------------------------------------------

_race_lock = threading.Lock()
_fields = {}         # (owner, field) -> _FieldAccess

# -- recompile sentinel -------------------------------------------------------

_recompile_lock = threading.Lock()
_compiles = {}       # label -> count
_signatures = {}     # label -> deque of recent signature reprs
_DEFAULT_THRESHOLD = 8
_threshold = [_DEFAULT_THRESHOLD]

# -- hostsync tripwire --------------------------------------------------------

_mode_cls = [None]   # the TorchDispatchMode subclass, built on first use

# -- numerics sentinel --------------------------------------------------------

_numsan_lock = threading.Lock()
_numsan_counts = {}  # site -> device-side checks issued


def enabled(kind=None):
    """Whether any sanitizer (or one specific kind) is enabled."""
    if kind is None:
        return _state.on
    if kind not in _KINDS:
        raise ValueError(f"unknown sanitizer {kind!r} (known: {_KINDS})")
    return getattr(_state, kind)


def enable(*kinds):
    """Enable sanitizers (all five when called bare). Module-level monitor
    locks are wrapped now; locks constructed AFTER this call pick up
    wrapping via :func:`new_lock` at their construction sites."""
    kinds = kinds or _KINDS
    for k in kinds:
        if k not in _KINDS:
            raise ValueError(f"unknown sanitizer {k!r} (known: {_KINDS})")
        setattr(_state, k, True)
    _state.on = True
    _state.locktrack = _state.lock or _state.race
    if _state.locktrack:
        _wrap_known_locks()


def disable(*kinds):
    """Disable sanitizers (all when called bare). Wrapped locks stay
    wrapped (they become pass-throughs: the guard slot is off)."""
    for k in (kinds or _KINDS):
        if k not in _KINDS:
            raise ValueError(f"unknown sanitizer {k!r} (known: {_KINDS})")
        setattr(_state, k, False)
    _state.on = (_state.lock or _state.recompile or _state.hostsync
                 or _state.race or _state.numerics)
    _state.locktrack = _state.lock or _state.race


def install_from_env(env=None):
    """Enable from ``PADDLE_TPU_SANITIZE`` (comma list, ``all``, or ``1``);
    called once at package import. Returns the enabled kinds."""
    spec = (env if env is not None
            else os.environ.get("PADDLE_TPU_SANITIZE", "")).strip().lower()
    if not spec:
        return ()
    if spec in ("all", "1", "true", "on"):
        kinds = _KINDS
    else:
        kinds = tuple(k.strip() for k in spec.split(",") if k.strip())
        bad = [k for k in kinds if k not in _KINDS]
        if bad:
            import warnings

            warnings.warn(f"PADDLE_TPU_SANITIZE: unknown sanitizer(s) "
                          f"{bad}; known: {list(_KINDS)}", stacklevel=2)
            kinds = tuple(k for k in kinds if k in _KINDS)
    if kinds:
        enable(*kinds)
    thr = os.environ.get("PADDLE_TPU_SANITIZE_RECOMPILE_THRESHOLD")
    if thr:
        try:
            set_recompile_threshold(int(thr))
        except ValueError:
            pass
    return kinds


def reset():
    """Drop witnessed edges, compile counts and trip records (test
    isolation). Enable state is untouched."""
    with _graph_lock:
        _edges.clear()
    with _race_lock:
        _fields.clear()
    with _recompile_lock:
        _compiles.clear()
        _signatures.clear()
    with _numsan_lock:
        _numsan_counts.clear()
    del _trips[:]
    # keep a pushed tripwire's bookkeeping: a reset inside an open region
    # must still pop the mode at the region's end
    for k in [k for k in _tls.__dict__ if k not in ("hs_depth", "hs_mode")]:
        del _tls.__dict__[k]


def trips():
    """[(kind, message)] recorded by every trip so far."""
    return list(_trips)


# -- trip plumbing ------------------------------------------------------------

def _trip(exc_type, kind, message):
    """Record, export (metric + span + flight dump, all best-effort), then
    raise. The raise is the contract; the telemetry documents it."""
    _trips.append((kind, message))
    try:
        from .. import monitor as _m

        if _m._state.on:
            _m.counter("paddle_tpu_monitor_sanitizer_trips_total",
                       labelnames=("sanitizer",)).labels(kind).inc()
        t = _m.trace
        if t._state.on:
            now = _m.now_ns()
            t.record_span("monitor.sanitizer_trip", now, now,
                          attrs={"sanitizer": kind})
        if t._state.on or os.environ.get("PADDLE_TPU_FLIGHT_DIR"):
            t.flight_dump(reason=f"graftsan {kind} trip: {message[:300]}")
    except Exception:  # noqa: BLE001 — telemetry must not mask the trip
        pass
    raise exc_type(message)


# -- lock-order witness -------------------------------------------------------

def _held():
    st = getattr(_tls, "held", None)
    if st is None:
        st = _tls.held = []
    return st


class SanitizedLock:
    """Thin proxy over a real lock that feeds the order witness. The inner
    lock keeps the blocking semantics; the witness only reads/writes the
    per-thread held list and the (tiny) process-wide edge map. Stacks are
    captured ONLY when a new edge is first witnessed, so steady-state
    acquisition cost is a list append."""

    __slots__ = ("name", "_inner")

    def __init__(self, name, inner=None):
        self.name = name
        self._inner = inner if inner is not None else threading.Lock()

    def acquire(self, blocking=True, timeout=-1):
        if _state.lock:
            self._witness()
        ok = self._inner.acquire(blocking, timeout)
        if ok and _state.locktrack:
            # the race witness reads this held-set too, so maintenance
            # stays on whenever either consumer is enabled
            _held().append(self.name)
        return ok

    def _witness(self):
        """Record held→this edges; trip on a known reverse edge BEFORE
        blocking (the reproducer raises instead of deadlocking)."""
        held = _held()
        if not held:
            return
        trip_msg = None
        with _graph_lock:
            for h in held:
                if h == self.name:
                    continue
                rev = _edges.get((self.name, h))
                if rev is not None:
                    here = "".join(traceback.format_stack(limit=12))
                    trip_msg = (
                        f"lock-order inversion: this thread holds '{h}' and "
                        f"is acquiring '{self.name}', but the opposite "
                        f"order '{self.name}' -> '{h}' was already "
                        "witnessed — a deadlock under the right "
                        "interleaving.\n"
                        f"-- first witness of {self.name} -> {h}:\n{rev}\n"
                        f"-- this acquisition of {h} -> {self.name}:\n"
                        f"{here}")
                    break
                if (h, self.name) not in _edges:
                    _edges[(h, self.name)] = "".join(
                        traceback.format_stack(limit=12))
        if trip_msg is not None:
            _trip(LockOrderInversion, "lock", trip_msg)

    def release(self):
        self._inner.release()
        # pop unconditionally: a disable() between another thread's acquire
        # and its release must not leak a phantom held entry that causes
        # false trips after the next enable (no-op when the name is absent)
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] == self.name:
                del held[i]
                break

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    def __repr__(self):
        return f"SanitizedLock({self.name!r}, {self._inner!r})"


def new_lock(name, factory=threading.Lock):
    """A lock for construction sites on the sanitizer's known-lock list
    (watchdog, registry): sanitized when the lock sanitizer is on at
    construction, a plain lock (zero overhead) otherwise."""
    inner = factory()
    return SanitizedLock(name, inner) if _state.locktrack else inner


def wrap_lock(name, lock):
    """Wrap an existing lock (module-level monitor/trace locks at
    enable time). Idempotent."""
    if isinstance(lock, SanitizedLock):
        return lock
    return SanitizedLock(name, lock)


def lock_order_edges():
    """Snapshot of witnessed ordered edges: {(held, acquired): stack}."""
    with _graph_lock:
        return dict(_edges)


def check_wait(site):
    """Declare an about-to-block wait (queue get, join). Trips when the
    calling thread holds any sanitized lock."""
    if not _state.lock:
        return
    held = _held()
    if held:
        _trip(BlockingWaitUnderLock, "lock",
              f"blocking wait at {site} while holding {held} — every "
              "other thread touching the lock(s) convoys behind this "
              "wait; move it outside the critical section")


def _wrap_known_locks():
    """Swap the module-level monitor/trace/obs-server/fault-harness locks for sanitized
    proxies. Instrument sites reference the module globals by name, so the
    swap takes effect everywhere at once. Lazy: pulls in the monitor
    package (already imported in any running process). Instance locks in
    the fleet/checkpoint tier (FleetRouter, SLOTracker, per-metric
    Registry locks, the checkpoint writer's error lock) are constructed
    through :func:`new_lock` and pick up wrapping at construction — enable
    sanitizers before building the objects you want witnessed."""
    try:
        from .. import monitor as _m
        from ..monitor import trace as _t

        _t._open_lock = wrap_lock("monitor.trace._open_lock", _t._open_lock)
        _m._sample_lock = wrap_lock("monitor._sample_lock", _m._sample_lock)
        # the default Registry is constructed at package import, BEFORE an
        # env-driven enable runs — wrap its (held-across-construction-and-
        # snapshot) lock here; per-metric locks created after enable pick
        # up wrapping via new_lock at their construction sites
        _m.registry._lock = wrap_lock("monitor.registry.Registry",
                                      _m.registry._lock)
    except Exception:  # noqa: BLE001 — partial bootstrap must not fail
        pass
    try:
        # the obs-server module lock guards the scrape/statusz section
        # registry from request-handler threads (also import-time state)
        from ..monitor import server as _srv

        _srv._lock = wrap_lock("monitor.server._lock", _srv._lock)
    except Exception:  # noqa: BLE001
        pass
    try:
        # the fault harness's armed-point table (read by every fire())
        from . import faultinject as _fi

        _fi._lock = wrap_lock("analysis.faultinject._lock", _fi._lock)
    except Exception:  # noqa: BLE001
        pass


# -- race witness -------------------------------------------------------------

class _FieldAccess:
    """Eraser state for one (owner, field): ``exclusive`` while a single
    thread touches it (initialization), then ``shared``/``shared_mod``
    with a candidate lockset that intersects toward the truth."""

    __slots__ = ("state", "tid", "written", "lockset", "stack",
                 "stack_locks", "tripped")

    def __init__(self, tid, written):
        self.state = "exclusive"
        self.tid = tid
        self.written = written
        self.lockset = None         # TOP until a second thread arrives
        self.stack = None           # first conflicting-access stack
        self.stack_locks = None
        self.tripped = False


def race_access(owner, field, write=False):
    """One access to an instrumented shared field. ``owner`` names the
    instance (the engine's ``_san_tag``, ``fleet.<tag>``), ``field`` the
    attribute. Per (owner, field), the candidate lockset starts at TOP
    during single-threaded initialization and intersects with the
    caller's sanitized-lock held-set on every access once a second
    thread arrives (Eraser). An empty candidate set on a written field
    raises :class:`DataRace` naming BOTH conflicting stacks — the first
    cross-thread access and this one. Disabled cost: one slot load."""
    if not _state.race:
        return
    held = frozenset(_held())
    me = threading.get_ident()
    trip = None
    with _race_lock:
        fa = _fields.get((owner, field))
        if fa is None:
            _fields[(owner, field)] = _FieldAccess(me, write)
            return
        if fa.state == "exclusive" and fa.tid == me:
            fa.written = fa.written or write
            return
        if fa.state == "exclusive":
            # second thread: initialization is over, constraints begin
            fa.state = "shared_mod" if (write or fa.written) else "shared"
            fa.lockset = set(held)
            fa.stack = "".join(traceback.format_stack(limit=12))
            fa.stack_locks = held
        else:
            fa.lockset &= held
            if write and fa.state == "shared":
                fa.state = "shared_mod"
        if fa.state == "shared_mod" and not fa.lockset \
                and not fa.tripped:
            fa.tripped = True     # one report per field, not a cascade
            here = "".join(traceback.format_stack(limit=12))
            trip = (
                f"data race on '{field}' of '{owner}': the candidate "
                "lockset is EMPTY for a written shared field — no "
                "single lock is held at every access, so two threads "
                "can interleave on it.\n"
                f"-- first cross-thread access (held "
                f"{sorted(fa.stack_locks or ())}):\n{fa.stack}\n"
                f"-- this access (held {sorted(held)}):\n{here}")
    if trip is not None:
        _trip(DataRace, "race", trip)


def race_fields():
    """Snapshot: {(owner, field): (state, sorted candidate locks|None)}
    for every instrumented field seen while enabled."""
    with _race_lock:
        return {k: (fa.state,
                    None if fa.lockset is None else sorted(fa.lockset))
                for k, fa in _fields.items()}


# -- recompile sentinel -------------------------------------------------------

def recompile_threshold():
    return _threshold[0]


def set_recompile_threshold(n):
    n = int(n)
    if n < 1:
        raise ValueError("recompile threshold must be >= 1")
    _threshold[0] = n


def note_compile(label, signature=None):
    """One program-cache miss for ``label``. Called by jit/api.py,
    jit/sot.py and the serving engine's jit caches — guarded at the call
    site on ``_state.recompile`` so the disabled cost is one slot load."""
    if not _state.recompile:
        return
    trip_msg = None
    with _recompile_lock:
        c = _compiles.get(label, 0) + 1
        _compiles[label] = c
        sigs = _signatures.get(label)
        if sigs is None:
            sigs = _signatures[label] = collections.deque(maxlen=8)
        if signature is not None:
            sigs.append(str(signature)[:200])
        if c == _threshold[0] + 1:
            recent = "\n  ".join(sigs) or "<signatures not reported>"
            trip_msg = (
                f"recompile storm: '{label}' compiled {c} times "
                f"(threshold {_threshold[0]}). Each miss pays a full "
                "trace+compile (a Dynamo trace, or a CUDA graph capture). "
                "Shape-varying inputs? Pad or bucket "
                "them; unhashable/per-call static args? Hoist them. "
                f"Recent signatures:\n  {recent}")
    if trip_msg is not None:
        _trip(RecompileStorm, "recompile", trip_msg)


def compile_counts():
    """Snapshot: {label: cache-miss count} recorded while enabled."""
    with _recompile_lock:
        return dict(_compiles)


# -- hostsync tripwire --------------------------------------------------------

class _Region:
    __slots__ = ("name", "_pushed")

    def __init__(self, name):
        self.name = name
        self._pushed = False

    def __enter__(self):
        st = getattr(_tls, "regions", None)
        if st is None:
            st = _tls.regions = []
        st.append(self.name)
        if _state.hostsync:
            self._pushed = push_hostsync(self.name)
        return self

    def __exit__(self, *exc):
        if self._pushed:
            self._pushed = False
            pop_hostsync()
        st = getattr(_tls, "regions", None)
        if st:
            st.pop()
        return False


def protected_region(name):
    """Mark a host-code region (serving step, custom training loop) in
    which a device→host sync is a bug. Nestable, per-thread."""
    return _Region(name)


class _Allow:
    __slots__ = ()

    def __enter__(self):
        _tls.allow = getattr(_tls, "allow", 0) + 1
        return self

    def __exit__(self, *exc):
        _tls.allow = max(0, getattr(_tls, "allow", 1) - 1)
        return False


def allow_host_sync():
    """Sanction an intentional sync inside a protected region (the serving
    step's one sampled-token readback, numsan's bool, metrics readout)."""
    return _Allow()


_PROTECTED_PREFIXES = ("train", "serving")


def protected_span(name):
    """Whether a span of this name is a protected region (``train.*``,
    ``serving.*``): ``monitor.trace`` pushes the tripwire for it."""
    return name.split(".", 1)[0] in _PROTECTED_PREFIXES


def _active_protected_region():
    st = getattr(_tls, "regions", None)
    if st:
        return st[-1]
    try:
        from ..monitor import trace as _t

        if _t._state.on:
            for sp in reversed(_t.thread_span_stack()):
                if protected_span(sp.name):
                    return sp.name
    except Exception:  # noqa: BLE001
        return None
    return None


def _hostsync_mode_cls():
    """The tripwire's ``TorchDispatchMode`` (built on first use, so that a
    process that never enables hostsync never imports the dispatch-mode
    machinery)."""
    cls = _mode_cls[0]
    if cls is not None:
        return cls
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten
    scalar = aten._local_scalar_dense
    copies = (aten._to_copy, aten.copy_, aten._copy_from,
              aten._copy_from_and_resize)
    # output size depends on the values: the host waits for the count
    sized = (aten.nonzero, aten.masked_select, aten._unique2,
             aten.unique_dim, aten.unique_consecutive, aten.argwhere)
    indexed = (aten.index, aten.index_put, aten.index_put_,
               aten._index_put_impl_)

    def is_cuda(x):
        return isinstance(x, torch.Tensor) and x.is_cuda

    def reason(func, args, kwargs):
        packet = func.overloadpacket
        if packet is scalar:
            return f"{func} (a Tensor read: .item()/float()/int()/bool())"
        if packet in copies:
            if packet is aten._to_copy:
                dev = kwargs.get("device")
                to_host = dev is not None and torch.device(dev).type == "cpu"
                src = args[0]
            elif packet is aten.copy_:
                to_host, src = not args[0].is_cuda, args[1]
            else:   # _copy_from(self, dst)
                to_host, src = not args[1].is_cuda, args[0]
            if to_host and is_cuda(src):
                return f"{func} (a copy from the card to the host)"
            return None
        if packet in sized and any(is_cuda(a) for a in args):
            return f"{func} (its output size depends on a CUDA tensor's values)"
        if packet is aten.repeat_interleave and kwargs.get("output_size") is None \
                and any(is_cuda(a) for a in args):
            return f"{func} (no output_size: it reads the repeats back)"
        if packet in indexed and is_cuda(args[0]):
            idx = args[1] if len(args) > 1 else ()
            if any(isinstance(t, torch.Tensor)
                   and t.dtype in (torch.bool, torch.uint8) for t in idx or ()):
                return f"{func} (a boolean mask index: it counts the mask on the host)"
        return None

    class _HostSyncMode(TorchDispatchMode):
        """Pushed while a protected region is open on the thread; trips the
        ops that make the host wait for the card."""

        def __init__(self, region):
            super().__init__()
            self.region = region

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if _state.hostsync and not getattr(_tls, "allow", 0):
                why = reason(func, args, kwargs)
                if why is not None:
                    # the autograd engine runs backward on its own threads,
                    # which inherit the mode but not the region stack
                    region = _active_protected_region() or self.region
                    _trip(HostSyncInProtectedRegion, "hostsync",
                          f"device->host sync {why} inside active span "
                          f"'{region}': a hidden round-trip stalls the "
                          "launch pipeline. Hoist the read out of the hot "
                          "region, keep the reduction on the device, or "
                          "wrap an intentional read in "
                          "sanitizers.allow_host_sync().")
            return func(*args, **kwargs)

    _mode_cls[0] = cls = _HostSyncMode
    return cls


def push_hostsync(region):
    """Push the tripwire on this thread for a protected region (the first
    of a nest pushes, the others count). Returns True when the caller must
    :func:`pop_hostsync` at the region's end."""
    depth = getattr(_tls, "hs_depth", 0)
    if depth == 0:
        mode = _hostsync_mode_cls()(region)
        mode.__enter__()
        _tls.hs_mode = mode
    _tls.hs_depth = depth + 1
    return True


def pop_hostsync():
    depth = getattr(_tls, "hs_depth", 0) - 1
    _tls.hs_depth = max(depth, 0)
    if depth == 0:
        mode = _tls.hs_mode
        _tls.hs_mode = None
        mode.__exit__(None, None, None)


# -- numerics sentinel (numsan) -----------------------------------------------

def numsan_check(site, regions, step=None):
    """One device-side all-finite check over ``regions`` at a step/burst
    boundary. ``regions`` is ``((tag, pytree), ...)`` — the step's
    committed outputs (serving tokens + KV pools, the mesh step's loss /
    params / optimizer state), in the order the bisection should report
    them. Callers guard on ``_state.numerics`` so the disabled cost is
    one slot load; the enabled cost is one device-side reduction and ONE
    bool to the host per step, read under :func:`allow_host_sync`.

    The ``numsan.check`` fault point drills the path: armed with
    ``action="flag"``, the check sees region ``seed % len(regions)``
    with one extra NaN leaf appended host-side — the engine's values are
    never touched, so step outputs stay bit-exact whether or not the
    drill (or numsan itself) is on.
    """
    if not _state.numerics:
        return
    regions = tuple(regions)
    if not regions:
        return
    from . import faultinject as _fi
    from . import numerics as _num

    spec = _fi.fire("numsan.check")
    if spec is not None:
        k = spec.seed % len(regions)
        tag, tree = regions[k]
        regions = (regions[:k] + ((tag, _num.poisoned(tree)),)
                   + regions[k + 1:])
    with _numsan_lock:
        _numsan_counts[site] = _numsan_counts.get(site, 0) + 1
    try:
        from .. import monitor as _m

        if _m._state.on:
            _m.counter("paddle_tpu_monitor_numsan_checks_total",
                       labelnames=("site",)).labels(site).inc()
    except Exception:  # noqa: BLE001 — telemetry must not break the check
        pass
    if _num.all_finite(tuple(t for _, t in regions)):
        return
    bad = _num.first_bad_region(regions)
    at = f"step {step}" if step is not None else "an untracked step"
    msg = (f"non-finite value at {site} ({at}): first non-finite region "
           f"is '{bad or '<combined check only>'}' of "
           f"{[t for t, _ in regions]} — a NaN/inf crossed the step "
           "boundary; replay under the eager checker "
           "(amp.debugging.enable_tensor_checker) to name the op")
    _numsan_trip(site, step, bad, msg)


def numsan_counts():
    """Snapshot: {site: device-side checks issued} while enabled."""
    with _numsan_lock:
        return dict(_numsan_counts)


def _numsan_trip(site, step, region, message):
    """The numerics flavor of :func:`_trip`: same record/export/raise
    contract, but the span is ``monitor.numsan_trip`` carrying the
    site/step/region the bisection localized."""
    _trips.append(("numerics", message))
    try:
        from .. import monitor as _m

        if _m._state.on:
            _m.counter("paddle_tpu_monitor_sanitizer_trips_total",
                       labelnames=("sanitizer",)).labels("numerics").inc()
        t = _m.trace
        if t._state.on:
            now = _m.now_ns()
            t.record_span("monitor.numsan_trip", now, now,
                          attrs={"site": site,
                                 "step": "?" if step is None
                                 else str(step),
                                 "region": region or "?"})
        if t._state.on or os.environ.get("PADDLE_TPU_FLIGHT_DIR"):
            t.flight_dump(
                reason=f"graftsan numerics trip: {message[:300]}")
    except Exception:  # noqa: BLE001 — telemetry must not mask the trip
        pass
    raise NumericsTrip(message)

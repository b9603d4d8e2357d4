"""Fault injection: the port of paddle_tpu/analysis/faultinject.py.

The hazards the serving resilience layer must survive, injected on purpose
at named points, so the recovery paths run in the tests instead of being
trusted:

- **off by default**: every site guards on one slot load (``_state.on``),
  so the cost when disarmed is a few nanoseconds;
- **armed from the environment** (``PADDLE_TPU_FAULTS=point:action:trigger;
  ...``, read by :func:`install_from_env` when the package is imported) or
  by :func:`arm`;
- **standard library only**.

Every point the port fires is declared in :data:`POINTS` and fired by name
(``_fi.fire("<point>")``) at its code site. Triggers are deterministic:
``nth=N`` fires from the Nth call on (bounded by ``times``, default 1),
``prob=P`` draws from an explicit ``seed`` (``times`` default unlimited).
Actions:

- ``raise``: raise :class:`InjectedFault` at the site (kill drills);
- ``delay``: sleep ``delay_s`` at the site (hang drills: a long enough delay
  trips the serving watchdog);
- ``flag``: return the armed spec to the site, which raises its own typed
  error with local context (a real ``CowPoolExhausted`` carrying the live
  pools) or corrupts a value (the radix digest).

Every trip is recorded (:func:`trips`) and mirrored best-effort into
``paddle_tpu_monitor_fault_injections_total{point}`` plus a
``monitor.fault_injection`` span, as in the JAX package. What differs from
it: the catalog holds only the points the port fires (serving, fleet, paged
KV, radix cache, checkpoint, the debug server and numsan).
"""
from __future__ import annotations

import os
import random
import threading
import time

__all__ = [
    "InjectedFault", "POINTS", "ACTIONS",
    "enable", "disable", "enabled", "install_from_env", "reset",
    "arm", "disarm", "fire", "trips", "armed",
]

# The fault-point catalog: every name a code site of the port may fire.
POINTS = {
    "serving.step": (
        "Entry of ContinuousBatchingEngine.step(), before any slot or pager "
        "change. raise = the step dies with a typed error; delay = the step "
        "hangs (the serving watchdog's drill)."),
    "serving.drive": (
        "One iteration of the engine's driving thread, before a step that has "
        "work. raise = the driving thread dies mid-decode (the crash-recovery "
        "drill)."),
    "serving.admission": (
        "Entry of the driving thread's queue drain (_drain_pending). delay = "
        "admission stalls while decode continues."),
    "serving.spec_verify": (
        "The speculative-decoding verify site. flag = the drafter degrades to "
        "plain one-token decode for the step; outputs stay correct."),
    "fleet.route": (
        "The FleetRouter's routing decision, before a replica is chosen. "
        "raise = routing dies and submit() surfaces a typed error; delay = a "
        "slow control plane while replicas keep serving."),
    "fleet.replica_step": (
        "One iteration of a fleet replica's driving loop, before a step that "
        "has work. raise = the replica dies mid-decode (the fleet kill "
        "drill); delay = the replica hangs (the per-replica watchdog drill)."),
    "fleet.health": (
        "One pass of the fleet health monitor. delay = health and hedging "
        "decisions stall; raise = the pass dies and the loop scans again."),
    "paged_kv.ensure": (
        "Entry of PagedKVCache.ensure_capacity. flag = the site raises the "
        "allocator's pool-exhausted RuntimeError without touching the free "
        "list (drills the engine's eviction relief and preemption)."),
    "paged_kv.cow": (
        "Entry of make_positions_exclusive, before any copy. flag = the site "
        "raises a real CowPoolExhausted carrying the live pools."),
    "radix.digest": (
        "Prefix-cache lookup digest chain. flag = the match walk reads a wrong "
        "cache entry for the computed digest, so the verified-tokens fallback "
        "must degrade it to a collision instead of serving another prompt's "
        "KV."),
    "ckpt.write": (
        "The checkpoint writer thread, after the temp directory exists "
        "and before any shard lands (checkpoint/manager.py). raise = a "
        "torn write: the step is never committed and restore must fall "
        "back to the previous commit; flag = one shard's on-disk bytes "
        "are corrupted AFTER its digest was recorded, so restore's "
        "verification must reject the checkpoint."),
    "ckpt.restore": (
        "Entry of CheckpointManager.restore (checkpoint/manager.py). "
        "raise = the restore path itself dies (a recovery that cannot "
        "reload must propagate, not loop); delay = a slow restore."),
    "obs.scrape": (
        "The graftscope debug endpoint's request handler "
        "(monitor/server.py do_GET, fired once per scrape before any "
        "route dispatch). flag (or raise) = the endpoint answers 503 "
        "while the engine underneath keeps serving untouched."),
    "control.tick": (
        "The graftpilot controller's decision site (control/controller.py "
        "Controller.tick, fired once per cycle before the telemetry read). "
        "raise = the whole tick fails: recorded as an error decision, and "
        "max_failures consecutive trips degrade the controller to the static "
        "configuration while serving continues untouched; delay = a slow "
        "controller, which never blocks a request path (the loop runs on its "
        "own thread)."),
    "control.actuate": (
        "The graftpilot actuation site (control/controller.py "
        "Controller._actuate, fired once per knob move or hook action before "
        "the setter runs). raise = the actuation fails after the decision: "
        "the knob holds its old value, the decision records outcome=error, "
        "and the rules keep proposing."),
    "numsan.check": (
        "numsan's step-boundary finiteness check "
        "(analysis/sanitizers.py numsan_check, fired once per enabled "
        "check before the device-side reduction). flag = the check sees "
        "region ``seed % len(regions)`` with one NaN leaf appended "
        "host-side — the trip/bisection drill; the engine's own values "
        "are never touched, so outputs stay bit for bit."),
}

ACTIONS = ("raise", "delay", "flag")


class InjectedFault(RuntimeError):
    """A fault-injection point fired with action=raise."""

    def __init__(self, message, point=""):
        super().__init__(message)
        self.point = point


class _State:
    """One slot load per ``fire()`` when disabled."""

    __slots__ = ("on",)

    def __init__(self):
        self.on = False


_state = _State()
_lock = threading.Lock()
_specs = {}          # point -> _Spec
_trips = []          # [(point, action)] in trip order


class _Spec:
    __slots__ = ("point", "action", "delay_s", "nth", "prob", "seed",
                 "times", "calls", "trip_count", "_rng")

    def __init__(self, point, action, delay_s, nth, prob, seed, times):
        self.point = point
        self.action = action
        self.delay_s = delay_s
        self.nth = nth
        self.prob = prob
        self.seed = seed
        # nth-triggers fire once by default (a kill drill kills once, then
        # the recovered engine must run clean); prob-triggers keep drawing
        self.times = times if times is not None else (1 if nth is not None else None)
        self.calls = 0
        self.trip_count = 0
        self._rng = random.Random(seed)

    def triggered(self):
        self.calls += 1
        if self.times is not None and self.trip_count >= self.times:
            return False
        if self.nth is not None:
            if self.calls < self.nth:
                return False
        elif self.prob is not None:
            if self._rng.random() >= self.prob:
                return False
        self.trip_count += 1
        return True


def enabled():
    return _state.on


def enable():
    _state.on = True


def disable():
    _state.on = False


def armed():
    """Snapshot of armed points: {point: (action, trips_so_far)}."""
    with _lock:
        return {p: (s.action, s.trip_count) for p, s in _specs.items()}


def arm(point, action="raise", delay_s=0.05, nth=None, prob=None, seed=0, times=None):
    """Arm one injection point. ``nth=N`` triggers from the Nth call on
    (``times`` bounds the trips, default 1 for nth-triggers); ``prob=P``
    triggers with probability P a call, drawn from ``seed`` so runs replay.
    Arming enables the harness."""
    if point not in POINTS:
        raise ValueError(f"unknown fault point {point!r} (known: {sorted(POINTS)})")
    if action not in ACTIONS:
        raise ValueError(f"unknown action {action!r} (known: {ACTIONS})")
    if nth is None and prob is None:
        nth = 1
    with _lock:
        _specs[point] = _Spec(point, action, float(delay_s),
                              None if nth is None else int(nth),
                              None if prob is None else float(prob), int(seed), times)
    _state.on = True


def disarm(point=None):
    """Disarm one point (or all); the harness disables when none stays armed."""
    with _lock:
        if point is None:
            _specs.clear()
        else:
            _specs.pop(point, None)
        if not _specs:
            _state.on = False


def reset():
    """Disarm everything and drop the trip record (test isolation)."""
    with _lock:
        _specs.clear()
        del _trips[:]
    _state.on = False


def trips():
    """[(point, action)] recorded by every trip so far."""
    return list(_trips)


def _export(point):
    """Best-effort telemetry for one trip: counter + span. Never raises —
    the drill is the contract, the telemetry documents it."""
    try:
        from .. import monitor as _m

        if _m._state.on:
            _m.counter("paddle_tpu_monitor_fault_injections_total",
                       labelnames=("point",)).labels(point).inc()
        t = _m.trace
        if t._state.on:
            now = _m.now_ns()
            t.record_span("monitor.fault_injection", now, now,
                          attrs={"point": point})
    except Exception:  # noqa: BLE001
        pass


def fire(point):
    """One call of the named injection point. Returns None when disarmed or
    not triggered. When triggered: ``raise`` raises :class:`InjectedFault`,
    ``delay`` sleeps ``delay_s`` then returns the spec, ``flag`` returns the
    spec for the site to interpret."""
    if not _state.on:
        return None
    with _lock:
        spec = _specs.get(point)
        if spec is None or not spec.triggered():
            return None
        _trips.append((point, spec.action))
    _export(point)
    if spec.action == "raise":
        raise InjectedFault(f"injected fault at {point!r} (trip {spec.trip_count})",
                            point=point)
    if spec.action == "delay":
        time.sleep(spec.delay_s)
    return spec


def install_from_env(env=None):
    """Arm from ``PADDLE_TPU_FAULTS``: semicolon-separated
    ``point:action[:k=v[,k=v...]]`` specs, e.g.
    ``serving.drive:raise:nth=12;paged_kv.cow:flag:prob=0.5,seed=7``.
    Unknown points or actions warn and are skipped. Returns the armed point
    names."""
    spec = (env if env is not None else os.environ.get("PADDLE_TPU_FAULTS", "")).strip()
    if not spec:
        return ()
    armed_points = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        point = fields[0].strip()
        action = fields[1].strip() if len(fields) > 1 and fields[1] else "raise"
        kwargs = {}
        bad = False
        if len(fields) > 2 and fields[2].strip():
            for kv in fields[2].split(","):
                if "=" not in kv:
                    bad = True
                    break
                k, v = kv.split("=", 1)
                k = k.strip()
                try:
                    if k in ("nth", "times", "seed"):
                        kwargs[k] = int(v)
                    elif k in ("prob", "delay_s"):
                        kwargs[k] = float(v)
                    else:
                        bad = True
                except ValueError:
                    bad = True
                if bad:
                    break
        if bad or point not in POINTS or action not in ACTIONS:
            import warnings

            warnings.warn(f"PADDLE_TPU_FAULTS: bad spec {part!r} (points: {sorted(POINTS)}; "
                          f"actions: {ACTIONS}); skipped", stacklevel=2)
            continue
        arm(point, action, **kwargs)
        armed_points.append(point)
    return tuple(armed_points)

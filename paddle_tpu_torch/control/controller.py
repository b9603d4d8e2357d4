"""graftpilot: the closed-loop controller (the port of
``paddle_tpu/control/controller.py``).

``Controller`` ties the pieces together: each ``tick()`` reads ONE
telemetry snapshot (``telemetry_fn``), evaluates the rule catalog in
order, and actuates the resulting proposals through bounded,
slew-limited :class:`~paddle_tpu_torch.control.knobs.Knob` setters — recording
every step in the bounded :class:`~paddle_tpu_torch.control.recorder
.DecisionRecorder`. The clock is injectable (``now_fn``) and the rules
are deterministic, so :func:`replay` can feed a recorded telemetry
stream back through fresh rules and shadow knobs and MUST reproduce the
identical decision sequence — the flight-recorder answer to "why did it
scale up at 3am".

Failure discipline: a controller failure degrades to the static
configuration, never wedges serving. Every tick is fully fenced — a
telemetry read that raises, a rule that raises, a setter that raises is
recorded as an ``error`` decision and counted; ``max_failures``
CONSECUTIVE failed ticks disable the loop (``degraded``), leaving every
knob at its last good value. The ``control.tick`` / ``control.actuate``
fault points (``analysis/faultinject.py``) drill exactly these paths.

Observability: the controller registers a ``control`` status provider
(graftscope ``/statusz``), a ``/controlz`` control provider (the
decision record), and a flight-dump section — all through the standard
weak-ref contracts, so a collected controller unregisters itself. With
the monitor on, the cataloged ``paddle_tpu_control_*`` metrics count the
ticks and the decisions and gauge each knob; with tracing on, each tick is a
``control.tick`` span.
"""
from __future__ import annotations

import threading
import time

from ..analysis import faultinject as _fi
from ..analysis.sanitizers import new_lock as _new_lock
from .knobs import Knob
from .recorder import DecisionRecorder, decision_sequence

__all__ = ["Controller", "replay"]

_UNSET = object()


class Controller:
    """Rule-driven closed-loop controller over a set of declared knobs.

    ``rules`` is an ordered list of rule objects (``control.rules``);
    ``knobs`` a dict ``name -> Knob`` (or an iterable of Knobs);
    ``telemetry_fn`` returns one JSON-able snapshot dict per call;
    ``hooks`` maps action names (e.g. ``"replan"``) to callables invoked
    with the snapshot. ``register=False`` builds a *shadow* controller
    (replay): no providers, no metrics, no spans.
    """

    def __init__(self, rules, knobs, *, telemetry_fn=None, interval_s=0.25,
                 now_fn=None, hooks=None, max_failures=3, record_tail=1024,
                 controlz_tail=256, register=True, name="control"):
        if not isinstance(knobs, dict):
            knobs = {k.name: k for k in knobs}
        self.rules = list(rules)
        self.knobs = dict(knobs)
        self.interval_s = float(interval_s)
        self.max_failures = int(max_failures)
        self.controlz_tail = int(controlz_tail)
        self.name = name
        self.enabled = True
        self.degraded = False
        self.recorder = DecisionRecorder(maxlen=record_tail)
        self.recorder.set_initial({k: v.value for k, v in self.knobs.items()})
        self.hooks = dict(hooks or {})
        self._telemetry = telemetry_fn
        self._now = now_fn if now_fn is not None else time.monotonic
        self._observe = bool(register)
        self._lock = _new_lock("control.Controller")
        self._tick_seq = 0
        self._failures = 0
        self._last_tick_t = None
        self._ticking = False
        self._thread = None
        self._stop_evt = threading.Event()  # assigned ONCE: lock-free ok
        self._registered = False
        if register:
            self._register_providers()
            self._export_knob_gauges(self.knobs.values())

    # ------------------------------------------------------------------
    # the loop

    def tick(self, now=None, telemetry=_UNSET):
        """Run one control cycle; returns the list of decision rows
        recorded this tick (empty when the rules held). Never raises.

        Locking: ``_lock`` guards the recorder and the controller flags,
        never the slow parts. The fault points, the telemetry read, rule
        evaluation and actuation (a ``fleet.scale_to`` drain can block
        for seconds) all run OUTSIDE it, so a ``/statusz`` or
        ``/controlz`` scrape never convoys behind a drain. A ``_ticking``
        flag makes an overlapping tick a skip, not a race — knobs and
        rule state are only ever touched by the one live tick."""
        err = None
        try:
            # outside the lock: a delay drill stalls only this thread
            _fi.fire("control.tick")
        except Exception as e:  # noqa: BLE001 - fenced by design
            err = e
        with self._lock:
            if not self.enabled or self._ticking:
                return []
            self._ticking = True
            n = self._tick_seq
            self._tick_seq += 1
        t_wall0 = time.monotonic_ns()
        t = self._now() if now is None else now
        snap = None
        if err is None:
            try:
                snap = (self._telemetry() if telemetry is _UNSET
                        else telemetry)
            except Exception as e:  # noqa: BLE001 - fenced by design
                err = e
        try:
            with self._lock:
                self.recorder.begin(n, t, snap)
            decided = []
            if snap is None:
                with self._lock:
                    self.recorder.decide(
                        "controller", None, None, None, "error",
                        "tick failed",
                        outcome=f"error: {err!r}" if err
                        else "no telemetry")
                err = err or RuntimeError("no telemetry")
            else:
                err = self._evaluate(snap, decided) or err
            with self._lock:
                if err is None:
                    self._failures = 0
                else:
                    self._failures += 1
                    if self._failures >= self.max_failures \
                            and self.enabled:
                        self.enabled = False
                        self.degraded = True
                        self.recorder.decide(
                            "controller", None, None, None, "degrade",
                            f"{self._failures} consecutive failures: "
                            "holding static configuration")
                decisions = list(self.recorder._open["decisions"])
                self.recorder.end()
                self._last_tick_t = t
        finally:
            with self._lock:
                self._ticking = False
        if self._observe:
            self._export_tick(n, t_wall0, decisions)
        return decisions

    def _evaluate(self, snap, decided):
        """Evaluate every rule against one snapshot, actuating proposals.
        Returns the first error (or None); always evaluates all rules.
        Runs on the (single) ticking thread, OUTSIDE ``_lock`` — only
        the recorder appends take it."""
        first_err = None
        for rule in self.rules:
            try:
                proposals = rule.evaluate(snap, self.knobs)
            except Exception as e:  # noqa: BLE001 - fenced by design
                with self._lock:
                    self.recorder.decide(rule.name, None, None, None,
                                         "error", "rule evaluate failed",
                                         outcome=f"error: {e!r}")
                first_err = first_err or e
                continue
            for p in proposals:
                err = self._actuate(rule, p, snap, decided)
                first_err = first_err or err
        return first_err

    def _actuate(self, rule, proposal, snap, decided):
        action = proposal.get("action")
        reason = proposal.get("reason", "")
        if action is not None:
            # named hook (e.g. the HBM guard's budget-remat re-plan)
            fn = self.hooks.get(action)
            try:
                _fi.fire("control.actuate")
                outcome = "no-hook"
                if fn is not None:
                    fn(snap)
                    outcome = "ok"
            except Exception as e:  # noqa: BLE001 - fenced by design
                with self._lock:
                    self.recorder.decide(rule.name, None, None, None,
                                         action, reason,
                                         outcome=f"error: {e!r}")
                return e
            with self._lock:
                d = self.recorder.decide(rule.name, None, None, None,
                                         action, reason, outcome=outcome)
            decided.append(d)
            return None
        knob = self.knobs.get(proposal["knob"])
        if knob is None:
            e = KeyError(proposal["knob"])
            with self._lock:
                self.recorder.decide(rule.name, proposal["knob"], None,
                                     None, "error", "unknown knob",
                                     outcome=f"error: {e!r}")
            return e
        new = knob.propose(proposal["target"])
        if new == knob.value:
            return None  # clamped/slewed to a no-op: nothing fired
        old = knob.value
        try:
            _fi.fire("control.actuate")
            old, new = knob.set(proposal["target"])
        except Exception as e:  # noqa: BLE001 - setter failed: value held
            with self._lock:
                self.recorder.decide(rule.name, knob.name, old, old,
                                     "set", reason,
                                     outcome=f"error: {e!r}")
            return e
        with self._lock:
            d = self.recorder.decide(rule.name, knob.name, old, new,
                                     "set", reason)
        decided.append(d)
        if self._observe:
            self._export_knob_gauges([knob])
        return None

    # ------------------------------------------------------------------
    # background loop

    def start(self):
        """Start the controller thread (idempotent)."""
        with self._lock:
            if self._thread is not None:
                return self
            self._stop_evt.clear()
            self._thread = threading.Thread(
                target=self._loop, name=f"graftpilot:{self.name}",
                daemon=True)
            self._thread.start()
        return self

    def _loop(self):
        # _stop_evt is assigned once in __init__ and internally
        # synchronized; only start()/stop() flip it
        while not self._stop_evt.wait(self.interval_s):
            self.tick()

    def stop(self, timeout=5.0):
        """Stop the controller thread (the providers stay registered)."""
        with self._lock:
            th = self._thread
            self._thread = None
        self._stop_evt.set()
        if th is not None:
            th.join(timeout=timeout)

    def close(self):
        """Stop the loop and unregister every graftscope provider."""
        self.stop()
        self._unregister_providers()

    def enable(self):
        """Re-arm a degraded controller."""
        with self._lock:
            self.enabled = True
            self.degraded = False
            self._failures = 0

    # ------------------------------------------------------------------
    # observability

    def status(self):
        """The ``control`` status-provider section (``/statusz``)."""
        with self._lock:
            last = self.recorder.last_decision_t()
            age = None
            if last is not None:
                try:
                    age = max(0.0, float(self._now()) - float(last))
                except (TypeError, ValueError):
                    age = None
            return {
                "health": "ok",
                "enabled": self.enabled,
                "degraded": self.degraded,
                "failures": self._failures,
                "running": self._thread is not None,
                "interval_s": self.interval_s,
                "ticks": self.recorder.ticks_total,
                "decisions": self.recorder.decisions_total,
                "rules": [r.name for r in self.rules],
                "last_decision_age_s": age,
                "knobs": {k: v.spec() for k, v in self.knobs.items()},
            }

    def controlz(self):
        """The ``/controlz`` document: status summary + the newest
        ``controlz_tail`` recorded ticks."""
        doc = self.status()
        with self._lock:
            doc["record"] = self.recorder.export(tail=self.controlz_tail)
        return doc

    def flight_section(self):
        """Compact controller section merged into flight dumps."""
        with self._lock:
            seq = decision_sequence(self.recorder.export(tail=64))
            return {
                "enabled": self.enabled,
                "degraded": self.degraded,
                "ticks": self.recorder.ticks_total,
                "decisions": [list(row) for row in seq],
                "knobs": {k: v.value for k, v in self.knobs.items()},
            }

    # ------------------------------------------------------------------
    # wiring

    def _register_providers(self):
        from ..monitor import server as _server
        from ..monitor import trace as _trace
        _server.register_status_provider(self.name, self.status)
        _server.register_control_provider(self.name, self.controlz)
        _trace.register_flight_section(self.name, self.flight_section)
        self._registered = True

    def _unregister_providers(self):
        if not self._registered:
            return
        from ..monitor import server as _server
        from ..monitor import trace as _trace
        _server.unregister_status_provider(self.name, self.status)
        _server.unregister_control_provider(self.name, self.controlz)
        _trace.unregister_flight_section(self.name, self.flight_section)
        self._registered = False

    def _monitor(self):
        from .. import monitor as _m
        return _m

    def _export_knob_gauges(self, knobs):
        _m = self._monitor()
        if not _m._state.on:
            return
        g = _m.gauge("paddle_tpu_control_knob_value", labelnames=("knob",))
        for k in knobs:
            g.labels(k.name).set(float(k.value))

    def _export_tick(self, n, t_wall0, decisions):
        _m = self._monitor()
        if _m._state.on:
            _m.counter("paddle_tpu_control_ticks_total").inc()
            c = _m.counter("paddle_tpu_control_decisions_total",
                           labelnames=("rule",))
            for d in decisions:
                c.labels(d["rule"]).inc()
        t = _m.trace
        if t._state.on:
            t.record_span("control.tick", t_wall0, time.monotonic_ns(),
                          attrs={"tick": n, "decisions": len(decisions)})


def replay(record, rules):
    """Feed a recorded telemetry stream back through fresh ``rules`` and
    shadow knobs; returns the shadow recorder's export. The decision
    sequence (:func:`~paddle_tpu_torch.control.recorder.decision_sequence`) of
    the result MUST equal the original's — rules are deterministic
    functions of the snapshot sequence and the clock is the recorded one,
    so any divergence means a rule broke the purity contract."""
    knobs = {name: Knob(name, value)
             for name, value in record["initial_knobs"].items()}
    shadow = Controller(rules, knobs, register=False,
                        now_fn=lambda: 0.0)
    for entry in record["ticks"]:
        shadow.tick(now=entry["t"], telemetry=entry["telemetry"])
    return shadow.recorder.export()

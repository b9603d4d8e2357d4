"""Wiring: a graftpilot controller over a live serving fleet (the port of
``paddle_tpu/control/serving.py``).

:func:`fleet_telemetry` builds the controller's ``telemetry_fn`` — ONE
host-readable snapshot per tick over a
:class:`~paddle_tpu_torch.serving.fleet.FleetRouter`:

- replica counts + aggregate queue depth (``replica_snapshot`` rows);
- arrival rate and TTFT quantiles from the router's rolling
  ``recent_arrivals`` / ``recent_ttft_ms`` deques (host counters —
  present with the monitor off);
- the /perfz queue-wait component (``timeline.ttft_decomposition`` p50)
  when tracing is on, refreshed at most every ``perf_interval_s``;
- SLO burn state (max fast burn + the alerting series) when the fleet
  wired a tracker;
- the live device memory against a budget via ``hbm_fn`` when provided
  (on the card, e.g. ``device.cuda.memory_allocated()`` against the
  card's memory).

Every value is JSON-able: the snapshot goes into the decision record
verbatim, which is what makes a recorded run replayable offline.

:func:`build_serving_controller` binds the declared knobs to their real
setters (``scale_to``, ``hedge_after_s``, ``set_engine_knobs``) and
assembles the default rule set (``rules.serving_rules``).
"""
from __future__ import annotations

import time

from .controller import Controller
from .knobs import Knob
from .rules import serving_rules

__all__ = ["fleet_telemetry", "build_serving_controller", "quantile"]


def quantile(values, q):
    """Nearest-rank quantile of a sequence (None when empty)."""
    vals = sorted(values)
    if not vals:
        return None
    idx = min(len(vals) - 1, max(0, int(round(q * (len(vals) - 1)))))
    return float(vals[idx])


def fleet_telemetry(fleet, *, window_s=5.0, perf_interval_s=0.5,
                    hbm_fn=None, now_fn=None):
    """Build a ``telemetry_fn`` over ``fleet`` (see module docstring).

    ``hbm_fn`` (optional) returns ``(live_bytes, budget_bytes)`` — e.g.
    the card's allocated bytes against its memory — feeding the
    HBM-pressure guard.
    """
    now = now_fn if now_fn is not None else time.monotonic
    cache = {"perf_t": None, "queue_wait_ms": None}

    def collect():
        t = float(now())
        rows = fleet.replica_snapshot()
        active = fleet.active_replicas()
        depth = sum(int(r["inflight"]) for r in rows)
        arrivals = list(fleet.recent_arrivals)
        horizon = time.monotonic() - float(window_s)
        rate = sum(1 for a in arrivals if a >= horizon) / float(window_s)
        ttfts = list(fleet.recent_ttft_ms)
        snap = {
            "t": t,
            "replicas_total": len(rows),
            "replicas_active": active,
            "queue_depth": depth,
            "arrival_rate_rps": round(rate, 4),
            "ttft_p50_ms": quantile(ttfts, 0.50),
            "ttft_p95_ms": quantile(ttfts, 0.95),
            "queue_wait_ms": cache["queue_wait_ms"],
            "burn_fast_max": None,
            "slo_alerting": [],
            "hbm_live_bytes": None,
            "hbm_budget_bytes": None,
        }
        from ..monitor import timeline as _timeline
        from ..monitor import trace as _trace

        if _trace._state.on and (cache["perf_t"] is None
                                 or t - cache["perf_t"]
                                 >= float(perf_interval_s)):
            cache["perf_t"] = t
            try:
                dec = _timeline.ttft_decomposition(
                    _trace.span_dump(tail=2048)["spans"])
                if dec["requests"]:
                    cache["queue_wait_ms"] = dec["p50_ms"]["queue_wait_ms"]
            except Exception:  # noqa: BLE001 - analytics never fail a tick
                pass
            snap["queue_wait_ms"] = cache["queue_wait_ms"]
        slo = getattr(fleet, "_slo", None)
        if slo is not None:
            scan = slo.scan(min_interval_s=min(1.0, float(window_s)))
            agg = [r["fast_burn"] for r in scan if not r["tenant"]]
            snap["burn_fast_max"] = round(max(agg), 4) if agg else 0.0
            snap["slo_alerting"] = sorted(
                (f'{r["objective"]}/{r["tenant"]}' if r["tenant"]
                 else r["objective"])
                for r in scan if r["alerting"])
        if hbm_fn is not None:
            try:
                live, budget = hbm_fn()
                snap["hbm_live_bytes"] = None if live is None \
                    else int(live)
                snap["hbm_budget_bytes"] = None if budget is None \
                    else int(budget)
            except Exception:  # noqa: BLE001 - a failing estimator
                pass           # holds the guard, never kills the tick
        return snap

    return collect


def build_serving_controller(fleet, *, rules=None, interval_s=0.25,
                             window_s=5.0, perf_interval_s=0.5,
                             hbm_fn=None, replan=None, now_fn=None,
                             drain_timeout=10.0, register=True,
                             **controller_kw):
    """A :class:`~paddle_tpu_torch.control.controller.Controller` actuating a
    live :class:`~paddle_tpu_torch.serving.fleet.FleetRouter`:

    - ``fleet.replicas`` -> :meth:`FleetRouter.scale_to` (lossless
      drain/resume);
    - ``fleet.hedge_after_s`` -> the router's public hedging threshold;
    - ``engine.chunk_size`` / ``engine.decode_burst`` /
      ``engine.max_queue`` -> staged on every replica engine via
      :meth:`FleetRouter.set_engine_knobs`, applied at step boundaries.

    ``replan`` (optional) is the HBM guard's re-plan callable, called with
    the telemetry snapshot (the JAX package passes its budget-remat
    planner's hook, ROADMAP Queue A item 10). The controller is returned
    STOPPED — call ``.start()`` to run the loop, or drive ``.tick()``
    yourself.
    """
    eng = fleet.replicas[0].engine
    hedge0 = fleet.hedge_after_s if fleet.hedge_after_s is not None \
        else 30.0

    def set_hedge(v):
        fleet.hedge_after_s = float(v)

    knobs = [
        Knob("fleet.replicas", fleet.active_replicas(),
             setter=lambda v: fleet.scale_to(v,
                                             drain_timeout=drain_timeout)),
        Knob("fleet.hedge_after_s", hedge0, setter=set_hedge),
        Knob("engine.chunk_size", eng.chunk_size,
             setter=lambda v: fleet.set_engine_knobs(chunk_size=v)),
        Knob("engine.decode_burst", eng.decode_burst,
             setter=lambda v: fleet.set_engine_knobs(decode_burst=v)),
        Knob("engine.max_queue",
             eng.max_queue if eng.max_queue is not None else 4096,
             setter=lambda v: fleet.set_engine_knobs(max_queue=v)),
    ]
    hooks = {} if replan is None else {"replan": replan}
    return Controller(
        rules if rules is not None else serving_rules(),
        knobs,
        telemetry_fn=fleet_telemetry(fleet, window_s=window_s,
                                     perf_interval_s=perf_interval_s,
                                     hbm_fn=hbm_fn, now_fn=now_fn),
        interval_s=interval_s, now_fn=now_fn, hooks=hooks,
        register=register, **controller_kw)

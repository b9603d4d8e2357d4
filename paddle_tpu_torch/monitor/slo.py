"""Rolling multi-window burn-rate SLO tracking — graftscope's alerting
wing.

An SLO here is an :class:`Objective`: "``target`` fraction of events
must be good" — e.g. 99% of requests under the TTFT threshold, 99.9% of
requests completing (goodput), 99% of submissions admitted (shed/error
rate). The error budget is ``1 - target``, and the **burn rate** over a
window is::

    burn = bad_fraction(window) / (1 - target)

(burn 1.0 = spending the budget exactly at the sustainable rate; burn N
exhausts it N× too fast). Alerting follows the classic multi-window
burn-rate rule: fire only when BOTH a fast window (reacts quickly) and
a slow window (filters blips) burn above the threshold — the canonical
page rule is 1h/5m at 14.4x, which are the defaults here; tests inject
``now_fn`` and second-scale windows.

Events aggregate into per-second buckets per (objective, tenant), so
memory is bounded by ``slow_window_s`` regardless of traffic. Every
alert EDGE (not-alerting -> alerting) is cataloged telemetry:
``paddle_tpu_monitor_slo_alerts_total{objective}``, a
``monitor.slo_alert`` span, and a bounded ``alerts`` tail for the
``/statusz`` section — and per-window burn rates land on the
``paddle_tpu_monitor_slo_burn_rate{objective, window}`` gauge when the
monitor is enabled.

The serving fleet (``serving/fleet.py``) wires a tracker into its
result/admission paths and scans it from the health loop. Originally
the verdicts were observational only; they are now DECLARED
control inputs, each individually opt-in: the graftpilot controller
(``paddle_tpu/control/``) reads burn rates/alerts through its telemetry
snapshots, and ``FleetRouter(burn_aware_routing=True)`` deprioritizes a
replica whose per-replica error burn is alerting (queried via
:meth:`SLOTracker.is_alerting`). With both opt-ins off the tracker
remains purely observational — ad-hoc alerting that silently re-routes
traffic is still a bug, not a feature (docs/control.md).
"""
from __future__ import annotations

import collections
import itertools
import time

from ..analysis.sanitizers import new_lock as _new_lock
from ..analysis.sanitizers import race_access as _race_access

__all__ = ["Objective", "SLOTracker", "serving_objectives"]

# per-tracker tag for the graftsan race witness (owner identity)
_SLO_SEQ = itertools.count(1)


class Objective:
    """One service-level objective: ``target`` fraction of events good.

    ``threshold_ns`` makes it a latency objective: ``record(value=...)``
    classifies good as ``value <= threshold_ns``. Without a threshold
    the caller passes ``good=`` explicitly (completion / admission
    objectives).
    """

    __slots__ = ("name", "target", "threshold_ns", "description")

    def __init__(self, name, target, threshold_ns=None, description=""):
        if not 0.0 < float(target) < 1.0:
            raise ValueError(f"target must be in (0, 1), got {target}")
        self.name = str(name)
        self.target = float(target)
        self.threshold_ns = None if threshold_ns is None \
            else int(threshold_ns)
        self.description = description

    @property
    def budget(self):
        """The error budget: the bad fraction the target tolerates."""
        return 1.0 - self.target

    def classify(self, good=None, value=None):
        if good is not None:
            return bool(good)
        if value is None or self.threshold_ns is None:
            raise ValueError(
                f"objective {self.name!r}: pass good= explicitly, or "
                "value= with a threshold_ns objective")
        return value <= self.threshold_ns


def serving_objectives(ttft_p99_ms=500.0, completion_target=0.999,
                       admission_target=0.99):
    """The default serving-fleet objectives: per-tenant TTFT p99
    (latency), request completion (goodput), and admission (shed/error
    rate)."""
    return [
        Objective("ttft", target=0.99,
                  threshold_ns=int(ttft_p99_ms * 1e6),
                  description=f"99% of requests first-token within "
                              f"{ttft_p99_ms}ms"),
        Objective("completion", target=completion_target,
                  description="requests completing with a full result "
                              "(terminated/stranded work is budget "
                              "spend)"),
        Objective("admission", target=admission_target,
                  description="submissions admitted (sheds and typed "
                              "admission errors are budget spend)"),
    ]


class SLOTracker:
    """Rolling multi-window burn-rate tracker over a set of objectives.

    ``record()`` is cheap and thread-safe (one small lock around a
    per-second bucket update); ``scan()`` evaluates every (objective,
    tenant) series against the fast+slow rule and fires edge-triggered
    alert telemetry. ``min_events`` guards the fast window against
    alerting off a handful of samples.
    """

    def __init__(self, objectives, *, fast_window_s=300.0,
                 slow_window_s=3600.0, burn_threshold=14.4,
                 min_events=10, now_fn=None):
        objectives = list(objectives)
        if not objectives:
            raise ValueError("an SLOTracker needs at least one objective")
        self.objectives = {o.name: o for o in objectives}
        if len(self.objectives) != len(objectives):
            raise ValueError("duplicate objective names")
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        if self.fast_window_s >= self.slow_window_s:
            raise ValueError("fast_window_s must be shorter than "
                             "slow_window_s")
        self.burn_threshold = float(burn_threshold)
        self.min_events = int(min_events)
        self._now = now_fn or time.monotonic
        # (objective, tenant) -> deque[[second, good, bad]] (append-only
        # right, pruned left past the slow window — bounded memory)
        self._buckets = {}
        self._alerting = set()          # (objective, tenant) currently firing
        self.alerts = collections.deque(maxlen=256)
        self._lock = _new_lock("monitor.slo.SLOTracker")
        self._san_tag = f"slo{next(_SLO_SEQ)}"
        self._mon = None
        self._last_scan_t = None
        self._last_rows = []

    # -- recording -----------------------------------------------------------
    def record(self, objective, *, good=None, value=None, tenant=""):
        """Record one event against ``objective`` (``value`` for
        latency objectives, ``good=`` otherwise). Unknown objectives
        raise — a typo'd record site would silently never burn."""
        obj = self.objectives.get(objective)
        if obj is None:
            raise ValueError(f"unknown objective {objective!r} "
                             f"(known: {sorted(self.objectives)})")
        ok = obj.classify(good=good, value=value)
        sec = int(self._now())
        key = (objective, str(tenant))
        with self._lock:
            _race_access(self._san_tag, "_buckets", write=True)
            dq = self._buckets.get(key)
            if dq is None:
                dq = self._buckets[key] = collections.deque()
            if dq and dq[-1][0] == sec:
                dq[-1][1 if ok else 2] += 1
            else:
                dq.append([sec, 1 if ok else 0, 0 if ok else 1])
            self._prune_locked(dq, sec)

    def _prune_locked(self, dq, now_sec):
        horizon = now_sec - self.slow_window_s
        while dq and dq[0][0] < horizon:
            dq.popleft()

    # -- window math ---------------------------------------------------------
    def _window_counts_locked(self, dq, window_s, now):
        horizon = now - window_s
        good = bad = 0
        for sec, g, b in reversed(dq):
            if sec < horizon:
                break
            good += g
            bad += b
        return good, bad

    def _both_windows_locked(self, dq, now):
        """(fast_good, fast_bad, slow_good, slow_bad) in ONE reversed
        walk — scan() is polled, so the deque is traversed once, not
        once per window."""
        fast_h = now - self.fast_window_s
        slow_h = now - self.slow_window_s
        fg = fb = sg = sb = 0
        for sec, g, b in reversed(dq):
            if sec < slow_h:
                break
            sg += g
            sb += b
            if sec >= fast_h:
                fg += g
                fb += b
        return fg, fb, sg, sb

    def burn_rate(self, objective, window_s, tenant="", now=None):
        """The burn rate of one (objective, tenant) series over the
        trailing ``window_s`` seconds: bad fraction / error budget
        (0.0 with no events)."""
        obj = self.objectives[objective]
        now = self._now() if now is None else now
        with self._lock:
            _race_access(self._san_tag, "_buckets")
            dq = self._buckets.get((objective, str(tenant)))
            if not dq:
                return 0.0
            good, bad = self._window_counts_locked(dq, window_s, now)
        n = good + bad
        if not n:
            return 0.0
        return (bad / n) / obj.budget

    def is_alerting(self, objective, tenant=""):
        """Whether one (objective, tenant) series is currently firing
        (as of the last :meth:`scan`). This is the DECLARED control
        surface — the burn-aware router and the graftpilot controller
        query it (docs/control.md) instead of reaching into scan rows."""
        with self._lock:
            return (str(objective), str(tenant)) in self._alerting

    # -- scanning / alerting -------------------------------------------------
    def _monitor(self):
        if self._mon is None:
            from .. import monitor as _m

            self._mon = _m
        return self._mon

    def scan(self, min_interval_s=0.0):
        """Evaluate every (objective, tenant) series: burn over the fast
        AND slow windows above ``burn_threshold`` (with at least
        ``min_events`` in the fast window) = alerting. Fires the
        cataloged counter + ``monitor.slo_alert`` span on each alert
        EDGE, refreshes the burn-rate gauges, and returns the rows
        (the fleet's statusz section). ``min_interval_s`` rate-limits a
        polled caller (the fleet health loop ticks at ~50 Hz; burn-rate
        alerting needs ~1 Hz): within the interval the previous scan's
        rows return unchanged without walking any series."""
        now = self._now()
        with self._lock:
            if min_interval_s and self._last_scan_t is not None \
                    and now - self._last_scan_t < min_interval_s:
                return list(self._last_rows)
            _race_access(self._san_tag, "_buckets")
            keys = list(self._buckets)
        rows = []
        edges = []          # (series, fast, slow) export OUTSIDE the lock
        _m = self._monitor()
        for key in keys:
            objective, tenant = key
            obj = self.objectives.get(objective)
            if obj is None:
                continue
            with self._lock:
                _race_access(self._san_tag, "_buckets", write=True)
                dq = self._buckets.get(key)
                if dq is None:
                    # a concurrent scan dropped this series between the
                    # key snapshot and here: emitting a ghost row (or
                    # touching its gauges) would re-create what the
                    # other scan just removed
                    continue
                # a series whose traffic stopped drains past the slow
                # window and is DROPPED — tenant ids are caller-
                # supplied, so the key space must stay bounded by live
                # traffic, not by history
                self._prune_locked(dq, int(now))
                if not dq:
                    del self._buckets[key]
                    self._alerting.discard(key)
                    self._drop_gauges(_m, objective, tenant)
                    continue
                fg, fb, sg, sb = self._both_windows_locked(dq, now)
                fast = ((fb / (fg + fb)) / obj.budget) if fg + fb else 0.0
                slow = ((sb / (sg + sb)) / obj.budget) if sg + sb else 0.0
                firing = (fast >= self.burn_threshold
                          and slow >= self.burn_threshold
                          and fg + fb >= self.min_events)
                # edge detection under the lock: a concurrent scan (the
                # health loop racing a /statusz scrape) must not
                # double-fire one edge
                was = key in self._alerting
                if firing and not was:
                    self._alerting.add(key)
                    self.alerts.append(
                        {"objective": objective, "tenant": tenant,
                         "fast_burn": round(fast, 3),
                         "slow_burn": round(slow, 3),
                         "events_fast": fg + fb, "t": now})
                    edges.append((f"{objective}/{tenant}" if tenant
                                  else objective, fast, slow))
                elif not firing and was:
                    self._alerting.discard(key)
            series = f"{objective}/{tenant}" if tenant else objective
            if _m._state.on:
                g = _m.gauge("paddle_tpu_monitor_slo_burn_rate",
                             labelnames=("objective", "window"))
                g.labels(series, "fast").set(fast)
                g.labels(series, "slow").set(slow)
            rows.append({
                "objective": objective, "tenant": tenant,
                "target": obj.target,
                "fast_burn": round(fast, 4), "slow_burn": round(slow, 4),
                "events_fast": fg + fb, "events_slow": sg + sb,
                "alerting": firing,
            })
        for series, fast, slow in edges:
            self._export_alert(_m, series, fast, slow)
        with self._lock:
            self._last_scan_t = now
            self._last_rows = list(rows)
        return rows

    def _drop_gauges(self, _m, objective, tenant):
        """Remove a dropped series' burn-rate gauge children: a drained
        tenant must neither freeze at its last (possibly alert-level)
        burn value on /metricsz nor grow the registry's label-value set
        with the process's whole tenant history."""
        try:
            g = _m.registry.get("paddle_tpu_monitor_slo_burn_rate")
            if g is not None:
                series = f"{objective}/{tenant}" if tenant else objective
                g.remove(series, "fast")
                g.remove(series, "slow")
        except Exception:  # noqa: BLE001 - cleanup must not fail a scan
            pass

    def _export_alert(self, _m, series, fast, slow):
        """Best-effort alert telemetry (counter + instant span) — the
        alert record itself is the contract, the export documents it."""
        try:
            if _m._state.on:
                _m.counter("paddle_tpu_monitor_slo_alerts_total",
                           labelnames=("objective",)).labels(series).inc()
            t = _m.trace
            if t._state.on:
                now = _m.now_ns()
                t.record_span("monitor.slo_alert", now, now,
                              attrs={"objective": series,
                                     "fast_burn": round(fast, 3),
                                     "slow_burn": round(slow, 3)})
        except Exception:  # noqa: BLE001
            pass

    # -- introspection -------------------------------------------------------
    def statusz(self):
        """The JSON section the debug server / fleet snapshot embeds:
        per-series burn rows plus the bounded recent-alert tail."""
        rows = self.scan()
        with self._lock:
            # a concurrent scan() mutates the alert set/deque under
            # this lock — iterate them under it too
            alerting = sorted(
                f"{o}/{t}" if t else o for o, t in self._alerting)
            recent = list(self.alerts)[-16:]
        return {
            "objectives": [
                {"name": o.name, "target": o.target,
                 "threshold_ns": o.threshold_ns,
                 "description": o.description}
                for o in self.objectives.values()],
            "windows_s": {"fast": self.fast_window_s,
                          "slow": self.slow_window_s},
            "burn_threshold": self.burn_threshold,
            "series": rows,
            "alerting": alerting,
            "recent_alerts": recent,
        }

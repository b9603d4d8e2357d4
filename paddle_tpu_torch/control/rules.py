"""The controller rule catalog (the port of ``paddle_tpu/control/rules.py``).

A rule is a deterministic function of ``(telemetry, knobs)`` — the
telemetry snapshot dict the controller just read, plus the current knob
values — returning a list of *proposals*: ``{"knob", "target", "reason"}``
to move a knob (the controller clamps/slew-limits via the
:class:`~paddle_tpu_torch.control.knobs.Knob`), or ``{"action", "reason"}`` to
fire a named hook (the HBM guard's budget-remat re-plan). Rules never
touch the live system, never read clocks, and never use randomness —
that is what makes a recorded decision log replayable bit-for-bit
(``control.controller.replay``). Internal state (hysteresis counters,
baselines) is allowed because it is a pure function of the snapshot
sequence: a fresh rule instance fed the same snapshots reproduces it.

Telemetry keys rules read (all optional — a missing/None signal holds):

``replicas_total`` / ``replicas_active``, ``queue_depth``,
``arrival_rate_rps``, ``ttft_p95_ms``, ``queue_wait_ms``,
``burn_fast_max``, ``slo_alerting`` (list of alerting series),
``hbm_live_bytes`` / ``hbm_budget_bytes``.
"""
from __future__ import annotations

__all__ = ["Rule", "AutoscaleRule", "HedgeRule", "ChunkRule", "BurstRule",
           "HbmGuardRule", "serving_rules"]


class Rule:
    """Base: ``evaluate(telemetry, knobs) -> [proposal, ...]``."""

    name = "rule"
    knob = None  # the knob this rule actuates (None = hook-only)

    def evaluate(self, telemetry, knobs):  # pragma: no cover - interface
        raise NotImplementedError

    def _value(self, knobs):
        k = knobs.get(self.knob)
        return None if k is None else k.value


class AutoscaleRule(Rule):
    """Fleet autoscaling from SLO burn + aggregate queue depth.

    Scale UP one replica when the per-active-replica queue depth exceeds
    ``queue_high`` or a serving SLO series is burn-alerting; scale DOWN
    one replica only after ``low_for`` consecutive quiet ticks (queue
    below ``queue_low``, nothing alerting) — the fleet's drain/resume
    make the scale-down lossless, hysteresis keeps it from flapping.
    """

    name = "autoscale"
    knob = "fleet.replicas"

    def __init__(self, queue_high=4.0, queue_low=0.5, low_for=3):
        self.queue_high = float(queue_high)
        self.queue_low = float(queue_low)
        self.low_for = int(low_for)
        self._quiet = 0

    def evaluate(self, telemetry, knobs):
        active = telemetry.get("replicas_active")
        total = telemetry.get("replicas_total")
        depth = telemetry.get("queue_depth")
        if active is None or depth is None:
            return []
        alerting = bool(telemetry.get("slo_alerting"))
        per = depth / max(1, active)
        if per > self.queue_high or alerting:
            self._quiet = 0
            target = active + 1
            if total is not None:
                target = min(target, total)
            if target > active:
                why = "slo burn alerting" if alerting else \
                    f"queue depth {per:.1f}/replica > {self.queue_high:g}"
                return [{"knob": self.knob, "target": target,
                         "reason": f"scale up: {why}"}]
            return []
        if per < self.queue_low:
            self._quiet += 1
            if self._quiet >= self.low_for and active > 1:
                self._quiet = 0
                return [{"knob": self.knob, "target": active - 1,
                         "reason": f"scale down: queue {per:.1f}/replica "
                                   f"quiet x{self.low_for}"}]
        else:
            self._quiet = 0
        return []


class HedgeRule(Rule):
    """Hedge threshold from the live TTFT tail: ``factor`` x p95."""

    name = "hedge"
    knob = "fleet.hedge_after_s"

    def __init__(self, factor=3.0, deadband=0.2):
        self.factor = float(factor)
        self.deadband = float(deadband)  # relative; suppresses jitter

    def evaluate(self, telemetry, knobs):
        p95_ms = telemetry.get("ttft_p95_ms")
        cur = self._value(knobs)
        if p95_ms is None or cur is None:
            return []
        target = self.factor * p95_ms / 1000.0
        if abs(target - cur) <= self.deadband * max(cur, 1e-9):
            return []
        return [{"knob": self.knob, "target": target,
                 "reason": f"ttft p95 {p95_ms:.1f}ms x {self.factor:g}"}]


class ChunkRule(Rule):
    """Prefill share from the /perfz queue-wait component: when admitted
    requests sit waiting for prefill (queue-wait dominates TTFT), grow
    ``chunk_size`` so each step drains more prefill backlog; when
    queue-wait is negligible, shrink it back toward decode-friendly
    interleaving."""

    name = "chunk"
    knob = "engine.chunk_size"

    def __init__(self, wait_high_ms=50.0, wait_low_ms=5.0):
        self.wait_high_ms = float(wait_high_ms)
        self.wait_low_ms = float(wait_low_ms)

    def evaluate(self, telemetry, knobs):
        wait = telemetry.get("queue_wait_ms")
        cur = self._value(knobs)
        if wait is None or cur is None:
            return []
        if wait > self.wait_high_ms:
            return [{"knob": self.knob, "target": cur * 2,
                     "reason": f"queue-wait {wait:.1f}ms > "
                               f"{self.wait_high_ms:g}ms: grow prefill share"}]
        if wait < self.wait_low_ms:
            return [{"knob": self.knob, "target": cur // 2,
                     "reason": f"queue-wait {wait:.1f}ms < "
                               f"{self.wait_low_ms:g}ms: shrink prefill share"}]
        return []


class BurstRule(Rule):
    """``decode_burst`` K from the arrival rate: bursts amortize dispatch
    when traffic is sparse; under load K=1 keeps steps short so admission
    and prefill interleave. Changing K captures ONE more burst program on
    the card (a CUDA graph per K) — the knob's slew limit bounds the
    capture rate."""

    name = "burst"
    knob = "engine.decode_burst"

    def __init__(self, rate_high=50.0, rate_low=5.0, k_idle=8):
        self.rate_high = float(rate_high)
        self.rate_low = float(rate_low)
        self.k_idle = int(k_idle)

    def evaluate(self, telemetry, knobs):
        rate = telemetry.get("arrival_rate_rps")
        cur = self._value(knobs)
        if rate is None or cur is None:
            return []
        if rate > self.rate_high and cur > 1:
            return [{"knob": self.knob, "target": 1,
                     "reason": f"arrivals {rate:.1f}/s > {self.rate_high:g}: "
                               "short steps"}]
        if rate < self.rate_low and cur < self.k_idle:
            return [{"knob": self.knob, "target": self.k_idle,
                     "reason": f"arrivals {rate:.1f}/s < {self.rate_low:g}: "
                               "burst decode"}]
        return []


class HbmGuardRule(Rule):
    """Memory-pressure guard (arXiv 2206.14148 direction): when the live
    device-memory reading crosses ``watermark`` x budget, first fire the
    ``replan`` hook once (the callable passed as
    ``build_serving_controller(replan=)``; the JAX package passes its
    budget-remat planner's hook, which comes to the port with the
    distributed slice, ROADMAP Queue A item 10), then shrink admission
    (``max_queue``) each pressured tick; recover admission toward the
    baseline once pressure clears ``clear`` x budget."""

    name = "hbm_guard"
    knob = "engine.max_queue"

    def __init__(self, watermark=0.9, clear=0.6):
        self.watermark = float(watermark)
        self.clear = float(clear)
        self._replanned = False
        self._baseline = None

    def evaluate(self, telemetry, knobs):
        live = telemetry.get("hbm_live_bytes")
        budget = telemetry.get("hbm_budget_bytes")
        cur = self._value(knobs)
        if not budget or live is None or cur is None:
            return []
        if self._baseline is None:
            self._baseline = cur
        frac = live / budget
        if frac >= self.watermark:
            out = []
            if not self._replanned:
                self._replanned = True
                out.append({"action": "replan",
                            "reason": f"hbm {frac:.0%} of budget >= "
                                      f"{self.watermark:.0%}: re-plan remat"})
            out.append({"knob": self.knob, "target": max(1, cur // 2),
                        "reason": f"hbm {frac:.0%} of budget: "
                                  "shrink admission"})
            return out
        if frac < self.clear and cur < self._baseline:
            return [{"knob": self.knob, "target": min(self._baseline, cur * 2),
                     "reason": f"hbm {frac:.0%} of budget < "
                               f"{self.clear:.0%}: restore admission"}]
        return []


def serving_rules(autoscale=None, hedge=None, chunk=None, burst=None,
                  hbm=None):
    """The default serving rule set, in evaluation order. Each kwarg is a
    dict of overrides for that rule's constructor (None = defaults). The
    live side and the replay side of a recorded run MUST build rules
    through the same factory with the same overrides (the replay
    contract)."""
    return [AutoscaleRule(**(autoscale or {})),
            HedgeRule(**(hedge or {})),
            ChunkRule(**(chunk or {})),
            BurstRule(**(burst or {})),
            HbmGuardRule(**(hbm or {}))]

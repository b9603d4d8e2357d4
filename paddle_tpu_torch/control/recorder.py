"""Bounded decision recorder: the controller's flight recorder (the port of
``paddle_tpu/control/recorder.py``).

Every controller tick commits one entry — the injectable-clock timestamp,
the telemetry snapshot the rules read, and the decision rows (rule fired,
knob old -> new, action, reason, outcome). The deque is bounded so an
always-on controller cannot grow memory; the tail is exported via the
``/controlz`` graftscope endpoint, merged into flight dumps, and is the
input to :func:`paddle_tpu_torch.control.controller.replay`.

``decision_sequence`` extracts the *replay-comparable* projection: the
``outcome`` field is excluded on purpose — it reports what the live
actuation did (``ok`` / ``error: ...``), which a shadow replay does not
re-execute; everything the rules decided (tick, rule, knob, old, new,
action, reason) must match bit-for-bit.
"""
from __future__ import annotations

import collections

__all__ = ["DecisionRecorder", "decision_sequence"]


def decision_sequence(record):
    """The replay-comparable decision tuples of a recorder export (or of
    a :class:`DecisionRecorder`)."""
    if isinstance(record, DecisionRecorder):
        record = record.export()
    out = []
    for entry in record["ticks"]:
        for d in entry["decisions"]:
            out.append((entry["tick"], d["rule"], d["knob"], d["old"],
                        d["new"], d["action"], d["reason"]))
    return out


class DecisionRecorder:
    """Bounded per-tick decision log. NOT thread-safe on its own: the
    owning controller serializes access under its lock."""

    def __init__(self, maxlen=1024):
        self.maxlen = int(maxlen)
        self._ticks = collections.deque(maxlen=self.maxlen)
        self._open = None
        self.initial_knobs = {}
        self.ticks_total = 0
        self.decisions_total = 0

    def set_initial(self, knobs):
        """Stamp the knob values at controller start — replay seeds its
        shadow knobs from these."""
        self.initial_knobs = dict(knobs)

    def begin(self, tick, t, telemetry):
        self._open = {"tick": int(tick), "t": t, "telemetry": telemetry,
                      "decisions": []}

    def decide(self, rule, knob, old, new, action, reason, outcome="ok"):
        d = {"rule": rule, "knob": knob, "old": old, "new": new,
             "action": action, "reason": reason, "outcome": outcome}
        if self._open is None:  # decision outside a tick (degrade path)
            self.begin(-1, None, None)
        self._open["decisions"].append(d)
        self.decisions_total += 1
        return d

    def end(self):
        if self._open is not None:
            self._ticks.append(self._open)
            self._open = None
            self.ticks_total += 1

    def export(self, tail=None):
        """JSON-able record: ``{"initial_knobs", "ticks"}`` (newest-last;
        ``tail`` limits to the newest N entries)."""
        ticks = list(self._ticks)
        if tail is not None:
            ticks = ticks[-int(tail):]
        return {"initial_knobs": dict(self.initial_knobs), "ticks": ticks}

    def last_decision_t(self):
        """The recorded clock of the newest non-empty tick (None if no
        decision was ever recorded)."""
        for entry in reversed(self._ticks):
            if entry["decisions"]:
                return entry["t"]
        return None

"""graftpilot: the closed-loop control plane over graftscope telemetry, the
port of ``paddle_tpu/control/``.

The observability tier (``paddle_tpu_torch/monitor/``) watches the serving
stack; this package closes the loop. A
:class:`~paddle_tpu_torch.control.controller.Controller` periodically reads
one telemetry snapshot, runs a set of deterministic
:mod:`~paddle_tpu_torch.control.rules`, and actuates declared
:class:`~paddle_tpu_torch.control.knobs.Knob` objects — every knob bounded by
``KNOB_BOUNDS`` (min / max / per-tick slew), every decision appended to
a bounded :class:`~paddle_tpu_torch.control.recorder.DecisionRecorder` and
exported via the graftscope ``/controlz`` endpoint and flight dumps.

Design rules (the replay contract):

- rules are pure functions of the telemetry snapshot sequence — no
  wall-clock reads, no randomness.  Feeding a recorded run back through
  :func:`~paddle_tpu_torch.control.controller.replay` reproduces the
  *identical* decision sequence.
- actuation is fail-static: a failing telemetry read or setter records
  an ``error`` decision and holds the old value; ``max_failures``
  consecutive tick failures degrade the controller to static
  configuration while serving keeps running.
- everything a rule can touch is declared up front in ``KNOB_BOUNDS``
  (the JAX package's literal table, equal in both packages).

:func:`~paddle_tpu_torch.control.serving.build_serving_controller` wires the
whole thing over a live :class:`~paddle_tpu_torch.serving.fleet.FleetRouter`.
"""
from __future__ import annotations

from .controller import Controller, replay
from .knobs import KNOB_BOUNDS, Knob
from .recorder import DecisionRecorder, decision_sequence
from .rules import (AutoscaleRule, BurstRule, ChunkRule, HbmGuardRule,
                    HedgeRule, Rule, serving_rules)
from .serving import build_serving_controller, fleet_telemetry

__all__ = [
    "Controller",
    "replay",
    "KNOB_BOUNDS",
    "Knob",
    "DecisionRecorder",
    "decision_sequence",
    "Rule",
    "AutoscaleRule",
    "HedgeRule",
    "ChunkRule",
    "BurstRule",
    "HbmGuardRule",
    "serving_rules",
    "fleet_telemetry",
    "build_serving_controller",
]

"""The closed-loop controller of the port (paddle_tpu_torch/control/) against
the JAX package's (paddle_tpu/control/), on the CPU.

The classes of tests/test_control.py (knobs, rules, decision replay,
fail-static, observability, burn-aware routing, knob staging, the serving
wiring), each run through both packages with the results compared, and the
cross-package checks: ``KNOB_BOUNDS`` and ``__all__`` are JAX's; one scripted
telemetry stream through both packages' ``serving_rules()`` and
``Controller`` on shadow knobs gives one decision sequence, the failing
ticks of the ``control.tick``/``control.actuate`` drills included; a record
of either package replays through the other's fresh rules to the same
decisions; the threaded loop runs under one hand-moved clock patched into
both controller modules; and ``fleet_telemetry`` of the port's fleet after a
fixed schedule equals JAX's, with engine tags renamed to replica indices and
lists sorted after the renaming (tests/test_torch_fleet_slo.py ``_renamed``).
The JAX package's re-plan hook is its remat planner's (not ported); both
packages are given the same plain callable here.
"""
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from paddle_tpu import control as jc
from paddle_tpu import monitor as jmon
from paddle_tpu.analysis import faultinject as jfi
from paddle_tpu.control import controller as jctl_mod
from paddle_tpu.control import serving as jcs_mod
from paddle_tpu.models import serving as jserving
from paddle_tpu.monitor import server as jobs
from paddle_tpu.monitor import slo as jslo
from paddle_tpu.serving import FleetRouter as JaxFleetRouter
from paddle_tpu.serving import fleet as jfleet_mod
from paddle_tpu_torch import control as tc
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch.analysis import faultinject as tfi
from paddle_tpu_torch.control import controller as tctl_mod
from paddle_tpu_torch.control import serving as tcs_mod
from paddle_tpu_torch.models import serving as tserving
from paddle_tpu_torch.monitor import server as tobs
from paddle_tpu_torch.monitor import slo as tslo
from paddle_tpu_torch.serving import FleetRouter
from paddle_tpu_torch.serving import fleet as fleet_mod
from test_torch_fleet import ENGINE, _Clock, _models, _prompts
from test_torch_fleet_slo import _renamed, _steps

ROOT = Path(__file__).resolve().parents[1]
# per package: (control, fault harness, monitor, server, slo module)
SIDES = ((jc, jfi, jmon, jobs, jslo), (tc, tfi, tmon, tobs, tslo))


@pytest.fixture(autouse=True)
def _clean():
    for _, fi, mon, obs, _ in SIDES:
        fi.reset()
    yield
    for _, fi, mon, obs, _ in SIDES:
        obs.shutdown()
        fi.reset()
        mon.disable()
        mon.reset()
        mon.trace.disable()
        mon.trace.reset()


def _both(fn):
    """fn(side) for the JAX side and the port's; asserts equal results and
    returns the port's."""
    got = [fn(side) for side in SIDES]
    assert got[1] == got[0]
    return got[1]


def _shadow(C, **values):
    return {n: C.Knob(n, v) for n, v in values.items()}


def _serving_knobs(C):
    return _shadow(C, **{"fleet.replicas": 1, "fleet.hedge_after_s": 0.5,
                         "engine.chunk_size": 16, "engine.decode_burst": 2,
                         "engine.max_queue": 64})


# -- knobs ----------------------------------------------------------------------

def test_knob_bounds_and_all_are_jax():
    assert tc.KNOB_BOUNDS == jc.KNOB_BOUNDS
    assert tc.__all__ == jc.__all__
    for name, spec in tc.KNOB_BOUNDS.items():
        assert spec["min"] < spec["max"] and spec["slew"] > 0, name


class TestKnobs:
    def test_undeclared_name_is_a_constructor_error(self):
        for C, *_ in SIDES:
            with pytest.raises(ValueError, match="undeclared knob"):
                C.Knob("fleet.bogus", 1)

    def test_set_clamps_then_slew_limits(self):
        def run(side):
            k = side[0].Knob("engine.chunk_size", 16)
            return [k.set(10_000), k.value, k.set(0)]

        assert _both(run) == [(16, 272), 272, (272, 16)]

    def test_integer_knob_quantizes_and_floats_stay_floats(self):
        def run(side):
            r = side[0].Knob("fleet.replicas", 2)
            h = side[0].Knob("fleet.hedge_after_s", 0.5)
            return [r.set(2.6), type(r.value), h.set(0.6), type(h.value)]

        out = _both(run)
        assert out[0] == (2, 3) and out[1] is int and out[3] is float
        assert out[2][1] == pytest.approx(0.6)

    def test_noop_decision_does_not_call_the_setter(self):
        def run(side):
            calls = []
            k = side[0].Knob("engine.max_queue", 64, setter=calls.append)
            return [k.set(64), side[0].Knob("fleet.replicas", 2).propose(2.4), calls]

        assert _both(run) == [(64, 64), 2, []]

    def test_raising_setter_holds_the_tracked_value(self):
        def run(side):
            def boom(v):
                raise RuntimeError("actuator offline")
            k = side[0].Knob("engine.max_queue", 64, setter=boom)
            with pytest.raises(RuntimeError):
                k.set(32)
            return k.value

        assert _both(run) == 64

    def test_propose_predicts_set(self):
        def run(side):
            k = side[0].Knob("engine.decode_burst", 2)
            out = []
            for target in (0, 1, 3, 5, 9, 100):
                want = k.propose(target)
                out.append((want, k.set(target)[1]))
            return out

        assert all(a == b for a, b in _both(run))


# -- rules ----------------------------------------------------------------------

_RULE_CASES = {
    "autoscale_up_queue": ("AutoscaleRule", {}, [({"replicas_active": 2, "replicas_total": 4,
                                                   "queue_depth": 20}, {})]),
    "autoscale_up_burn": ("AutoscaleRule", {}, [({"replicas_active": 1, "replicas_total": 3,
                                                  "queue_depth": 0, "slo_alerting": ["ttft"]},
                                                 {})]),
    "autoscale_capped": ("AutoscaleRule", {}, [({"replicas_active": 3, "replicas_total": 3,
                                                 "queue_depth": 99}, {})]),
    "autoscale_hysteresis": ("AutoscaleRule", {"low_for": 2}, [
        ({"replicas_active": 2, "replicas_total": 2, "queue_depth": 0}, {}),
        ({"replicas_active": 2, "replicas_total": 2, "queue_depth": 4}, {}),
        ({"replicas_active": 2, "replicas_total": 2, "queue_depth": 0}, {}),
        ({"replicas_active": 2, "replicas_total": 2, "queue_depth": 0}, {})]),
    "autoscale_floor": ("AutoscaleRule", {"low_for": 1}, [
        ({"replicas_active": 1, "replicas_total": 2, "queue_depth": 0}, {})]),
    "hedge_deadband": ("HedgeRule", {"factor": 3.0, "deadband": 0.2}, [
        ({"ttft_p95_ms": 350.0}, {"fleet.hedge_after_s": 1.0}),
        ({"ttft_p95_ms": 2000.0}, {"fleet.hedge_after_s": 1.0})]),
    "chunk": ("ChunkRule", {"wait_high_ms": 50.0, "wait_low_ms": 5.0}, [
        ({"queue_wait_ms": 100.0}, {"engine.chunk_size": 64}),
        ({"queue_wait_ms": 1.0}, {"engine.chunk_size": 64}),
        ({"queue_wait_ms": 20.0}, {"engine.chunk_size": 64}),
        ({}, {"engine.chunk_size": 64})]),
    "burst": ("BurstRule", {"rate_high": 50.0, "rate_low": 5.0, "k_idle": 8}, [
        ({"arrival_rate_rps": 100.0}, {"engine.decode_burst": 4}),
        ({"arrival_rate_rps": 1.0}, {"engine.decode_burst": 4}),
        ({"arrival_rate_rps": 20.0}, {"engine.decode_burst": 4})]),
}


@pytest.mark.parametrize("case", sorted(_RULE_CASES))
def test_rule_proposals_equal_jax(case):
    cls, kw, steps = _RULE_CASES[case]

    def run(side):
        rule = getattr(side[0], cls)(**kw)
        return [rule.evaluate(tel, _shadow(side[0], **knobs)) for tel, knobs in steps]

    out = _both(run)
    assert any(out) or case in ("autoscale_capped", "autoscale_floor")


def test_hbm_guard_replans_once_then_shrinks_then_recovers():
    def run(side):
        C = side[0]
        r = C.HbmGuardRule(watermark=0.9, clear=0.6)
        knobs = _shadow(C, **{"engine.max_queue": 64})
        hot = {"hbm_live_bytes": 95, "hbm_budget_bytes": 100}
        cool = {"hbm_live_bytes": 10, "hbm_budget_bytes": 100}
        out = []
        for tel in (hot, hot, cool, cool, cool):
            props = r.evaluate(tel, knobs)
            out.append([p.get("action") or p["target"] for p in props])
            for p in props:
                if "knob" in p:
                    knobs[p["knob"]].set(p["target"])
        return out

    assert _both(run) == [["replan", 32], [16], [32], [64], []]


# -- the controller and replay ----------------------------------------------------

# the scripted trace of tests/test_control.py, one failed tick (None) in it
_TRACE = [
    {"replicas_active": 1, "replicas_total": 3, "queue_depth": 0,
     "arrival_rate_rps": 1.0, "ttft_p95_ms": 100.0, "queue_wait_ms": 2.0,
     "slo_alerting": []},
    {"replicas_active": 1, "replicas_total": 3, "queue_depth": 12,
     "arrival_rate_rps": 80.0, "ttft_p95_ms": 400.0, "queue_wait_ms": 60.0,
     "slo_alerting": ["ttft"]},
    None,
    {"replicas_active": 2, "replicas_total": 3, "queue_depth": 12,
     "arrival_rate_rps": 80.0, "ttft_p95_ms": 400.0, "queue_wait_ms": 60.0,
     "slo_alerting": ["ttft"], "hbm_live_bytes": 95, "hbm_budget_bytes": 100},
    {"replicas_active": 3, "replicas_total": 3, "queue_depth": 0,
     "arrival_rate_rps": 2.0, "ttft_p95_ms": 120.0, "queue_wait_ms": 1.0,
     "slo_alerting": [], "hbm_live_bytes": 10, "hbm_budget_bytes": 100},
    {"replicas_active": 3, "replicas_total": 3, "queue_depth": 0,
     "arrival_rate_rps": 2.0, "ttft_p95_ms": 120.0, "queue_wait_ms": 1.0,
     "slo_alerting": []},
    {"replicas_active": 3, "replicas_total": 3, "queue_depth": 0,
     "arrival_rate_rps": 2.0, "ttft_p95_ms": 120.0, "queue_wait_ms": 1.0,
     "slo_alerting": []},
]


def _record(side, rules=None, drills=()):
    """The scripted trace through ``side``'s ``serving_rules()`` and
    ``Controller`` on shadow knobs, the given fault drills armed."""
    C, fi = side[0], side[1]
    for point, kw in drills:
        fi.arm(point, action="raise", **kw)
    ctl = C.Controller(rules if rules is not None else C.serving_rules(),
                       _serving_knobs(C), register=False, now_fn=lambda: 0.0,
                       max_failures=10)
    try:
        for i, snap in enumerate(_TRACE):
            ctl.tick(now=i * 0.25, telemetry=snap)
    finally:
        fi.reset()
    return ctl.recorder.export()


def _rows(record):
    """Every decision with its outcome, tick by tick."""
    return [(t["tick"], t["t"], d["rule"], d["knob"], d["old"], d["new"], d["action"],
             d["reason"], d["outcome"]) for t in record["ticks"] for d in t["decisions"]]


_DRILLS = {
    "none": (),
    "tick": (("control.tick", dict(nth=2, times=2)),),
    "actuate": (("control.actuate", dict(nth=3, times=2)),),
    "both": (("control.tick", dict(nth=4, times=1)), ("control.actuate", dict(nth=1, times=1))),
}


@pytest.mark.parametrize("drill", sorted(_DRILLS))
def test_one_telemetry_stream_gives_one_decision_sequence(drill):
    """The same stream through both packages: the identical decisions, knob
    values and outcomes (the drills' error decisions included)."""
    records = [_record(side, drills=_DRILLS[drill]) for side in SIDES]
    assert _rows(records[1]) == _rows(records[0])
    assert records[1] == records[0]
    seq = tc.decision_sequence(records[1])
    assert seq
    if drill != "none":
        assert any("InjectedFault" in r[-1] for r in _rows(records[1]))


def test_scripted_trace_records_bounded_decisions():
    record = _record(SIDES[1])
    assert len(record["ticks"]) == len(_TRACE)
    sets = [d for t in record["ticks"] for d in t["decisions"] if d["action"] == "set"]
    assert len(sets) >= 6
    for d in sets:
        spec = tc.KNOB_BOUNDS[d["knob"]]
        assert spec["min"] <= d["new"] <= spec["max"]
        assert abs(d["new"] - d["old"]) <= spec["slew"] + 1e-9
    tick = record["ticks"][_TRACE.index(None)]
    assert tick["telemetry"] is None and tick["decisions"][0]["action"] == "error"
    assert any(d["knob"] == "fleet.replicas" and d["new"] == 2
               for d in record["ticks"][-1]["decisions"])


@pytest.mark.parametrize("src,dst", [(0, 1), (1, 0), (1, 1)], ids=["jax->port", "port->jax",
                                                                   "port->port"])
def test_replay_across_packages_reproduces_the_decisions(src, dst):
    record = _record(SIDES[src])
    shadow = SIDES[dst][0].replay(record, SIDES[dst][0].serving_rules())
    assert tc.decision_sequence(record) != []
    assert tc.decision_sequence(shadow) == jc.decision_sequence(record)
    # replaying the replay is the same again
    again = SIDES[src][0].replay(shadow, SIDES[src][0].serving_rules())
    assert tc.decision_sequence(again) == tc.decision_sequence(record)


def test_replay_with_tampered_rules_diverges():
    record = _record(SIDES[1])
    shadow = tc.replay(record, tc.serving_rules(hedge={"factor": 10.0}))
    assert tc.decision_sequence(shadow) != tc.decision_sequence(record)


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    for mod in (jctl_mod, tctl_mod, jcs_mod, tcs_mod, jfleet_mod, fleet_mod, jslo, tslo):
        monkeypatch.setattr(mod, "time", c)
    return c


def test_threaded_loop_under_one_clock_equals_jax(clock):
    """``start()``: each package's tick thread reads the scripted stream,
    one snapshot a tick, the hand-moved clock stepping 0.25 s a read; the
    records (times included) are equal."""
    records = []
    for side in SIDES:
        C = side[0]
        clock.t = 100.0
        feed = iter(_TRACE)
        done = threading.Event()

        def telemetry(feed=feed, done=done):
            clock.t += 0.25
            snap = next(feed, StopIteration)
            if snap is StopIteration:
                done.set()
                raise RuntimeError("stream over")
            if snap is None:
                raise RuntimeError("telemetry plane down")
            return snap

        ctl = C.Controller(C.serving_rules(), _serving_knobs(C), telemetry_fn=telemetry,
                           interval_s=0.001, register=False, max_failures=10)
        ctl.start()
        assert done.wait(30.0)
        ctl.stop()
        rec = ctl.recorder.export()
        rec["ticks"] = rec["ticks"][:len(_TRACE)]
        records.append(rec)
    assert _rows(records[1]) == _rows(records[0])
    assert [t["t"] for t in records[1]["ticks"]] == [100.0 + 0.25 * i for i in range(7)]


# -- fail-static ---------------------------------------------------------------------

class TestFailStatic:
    def test_consecutive_failures_degrade_to_static(self):
        def run(side):
            C = side[0]

            def boom():
                raise RuntimeError("telemetry plane down")
            ctl = C.Controller([C.AutoscaleRule()], _serving_knobs(C), telemetry_fn=boom,
                               register=False, now_fn=lambda: 0.0, max_failures=3)
            flags = []
            for i in range(3):
                ctl.tick(now=float(i))
                flags.append((ctl.enabled, ctl.degraded))
            held = (ctl.tick(now=9.0), ctl.knobs["fleet.replicas"].value)
            seq = C.decision_sequence(ctl.recorder.export())
            ctl.enable()
            after = ctl.tick(now=10.0, telemetry=_TRACE[1])
            return flags, held, seq, [d["new"] for d in after]

        flags, held, seq, after = _both(run)
        assert flags[-1] == (False, True) and held == ([], 1)
        assert any(row[5] == "degrade" for row in seq) and after == [2]

    def test_tick_fault_drill_never_raises_and_degrades(self):
        def run(side):
            C, fi = side[0], side[1]
            fi.arm("control.tick", action="raise", nth=1, times=3)
            ctl = C.Controller([C.AutoscaleRule()], _serving_knobs(C),
                               telemetry_fn=lambda: _TRACE[1], register=False,
                               now_fn=lambda: 0.0, max_failures=3)
            for i in range(3):
                ctl.tick(now=float(i))
            degraded = ctl.degraded
            fi.reset()
            ctl.enable()
            return degraded, [d["action"] for d in ctl.tick(now=5.0)]

        assert _both(run) == (True, ["set"])

    def test_actuate_fault_drill_holds_the_knob(self):
        def run(side):
            C, fi = side[0], side[1]
            fi.arm("control.actuate", action="raise", nth=1)
            ctl = C.Controller([C.HedgeRule()], _serving_knobs(C), register=False,
                               now_fn=lambda: 0.0)
            ctl.tick(now=0.0, telemetry={"ttft_p95_ms": 2000.0})
            d = ctl.recorder.export()["ticks"][0]["decisions"][0]
            return ctl.knobs["fleet.hedge_after_s"].value, d["old"], d["new"], d["outcome"]

        value, old, new, outcome = _both(run)
        assert value == old == new == 0.5 and outcome.startswith("error")

    def test_raising_setter_is_an_error_decision_value_held(self):
        def run(side):
            C = side[0]

            def boom(v):
                raise RuntimeError("scale_to failed")
            knobs = _serving_knobs(C)
            knobs["fleet.replicas"] = C.Knob("fleet.replicas", 1, setter=boom)
            ctl = C.Controller([C.AutoscaleRule()], knobs, register=False,
                               now_fn=lambda: 0.0)
            ctl.tick(now=0.0, telemetry=_TRACE[1])
            d = ctl.recorder.export()["ticks"][0]["decisions"][0]
            return ctl.knobs["fleet.replicas"].value, d["new"], d["outcome"]

        value, new, outcome = _both(run)
        assert value == new == 1 and outcome.startswith("error")


# -- observability ---------------------------------------------------------------------

def _get(port, path):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


class TestObservability:
    def test_controlz_and_statusz_documents_equal_jax(self):
        docs = []
        for C, _, _, obs, _ in SIDES:
            port = obs.serve(port=0)
            ctl = C.Controller([C.HedgeRule()], _serving_knobs(C), now_fn=lambda: 0.0)
            try:
                ctl.tick(now=0.0, telemetry={"ttft_p95_ms": 2000.0})
                code, doc = _get(port, "/controlz")
                assert code == 200
                _, st = _get(port, "/statusz")
                docs.append((doc["controllers"]["control"], st["providers"]["control"]))
            finally:
                ctl.close()
            code, doc = _get(port, "/controlz")
            assert code == 200 and doc["controllers"] == {}
        assert docs[1] == docs[0]
        sec = docs[1][0]
        assert sec["ticks"] == 1 and sec["decisions"] == 1
        assert sec["record"]["ticks"][0]["decisions"][0]["knob"] == "fleet.hedge_after_s"
        assert docs[1][1]["rules"] == ["hedge"]

    def test_obs_probe_reports_the_port_controller(self):
        port = tobs.serve(port=0)
        ctl = tc.Controller([tc.HedgeRule()], _serving_knobs(tc), now_fn=lambda: 0.0)
        try:
            ctl.tick(now=0.0, telemetry={"ttft_p95_ms": 2000.0})
            out = subprocess.run([sys.executable, str(ROOT / "tools" / "obs_probe.py"),
                                  "--port", str(port)], capture_output=True, text=True,
                                 timeout=60)
            assert out.returncode == 0, out.stdout + out.stderr
            assert "controller control:" in out.stdout
            assert "1 ticks, 1 decisions" in out.stdout
        finally:
            ctl.close()

    def test_flight_dump_carries_the_controller_section(self, tmp_path):
        secs = []
        for C, _, mon, _, _ in SIDES:
            ctl = C.Controller(C.serving_rules(), _serving_knobs(C), now_fn=lambda: 0.0)
            try:
                ctl.tick(now=0.0, telemetry=_TRACE[1])
                path = str(tmp_path / f"flight_{len(secs)}.json")
                assert mon.trace.flight_dump(path=path, reason="test", coalesce_s=0) == path
                with open(path) as f:
                    secs.append(json.load(f)["sections"]["control"])
            finally:
                ctl.close()
        assert secs[1] == secs[0]
        assert secs[1]["ticks"] == 1 and secs[1]["decisions"]
        assert secs[1]["knobs"]["fleet.replicas"] == 2

    def test_controller_exports_cataloged_metrics(self):
        texts = []
        for C, _, mon, _, _ in SIDES:
            mon.enable()
            ctl = C.Controller([C.HedgeRule()], _serving_knobs(C), now_fn=lambda: 0.0)
            try:
                ctl.tick(now=0.0, telemetry={"ttft_p95_ms": 2000.0})
                texts.append(sorted(line for line in mon.prometheus_text().splitlines()
                                    if line.startswith("paddle_tpu_control_")))
            finally:
                ctl.close()
        assert texts[1] == texts[0]
        assert "paddle_tpu_control_ticks_total 1" in texts[1]
        assert 'paddle_tpu_control_decisions_total{rule="hedge"} 1' in texts[1]
        assert any(line.startswith('paddle_tpu_control_knob_value{knob="fleet.hedge_after_s"}')
                   for line in texts[1])

    def test_traced_tick_is_a_span(self):
        tmon.trace.enable()
        ctl = tc.Controller([tc.HedgeRule()], _serving_knobs(tc), now_fn=lambda: 0.0)
        try:
            ctl.tick(now=0.0, telemetry={"ttft_p95_ms": 2000.0})
        finally:
            ctl.close()
        spans = [s for s in tmon.trace.spans() if s.name == "control.tick"]
        assert len(spans) == 1 and spans[0].attrs["decisions"] == 1


# -- the serving wiring ----------------------------------------------------------------

def _pair(replicas=2, **kw):
    jm, tm = _models()
    kw.setdefault("max_new_tokens", 6)
    return (JaxFleetRouter(jm, replicas=replicas, engine_kwargs=dict(ENGINE), start=False,
                           **kw),
            FleetRouter(tm, replicas=replicas, engine_kwargs=dict(ENGINE), start=False, **kw))


def _alerting(slo_mod, clock):
    return slo_mod.SLOTracker(slo_mod.serving_objectives(), fast_window_s=5.0,
                              slow_window_s=60.0, min_events=1, now_fn=clock.monotonic)


def _make_alerting(trk, tag):
    for _ in range(5):
        trk.record("completion", good=False, tenant=f"replica:{tag}")
    trk.scan()
    assert trk.is_alerting("completion", f"replica:{tag}")


class TestBurnAwareRouting:
    @pytest.mark.parametrize("aware", [False, True], ids=["flag_off", "flag_on"])
    def test_routing_equals_jax(self, clock, aware):
        """Off: an alerting replica changes nothing (least in flight); on:
        it is deprioritized, never excluded."""
        got = []
        for fl, slo_mod in zip(_pair(slo=None, burn_aware_routing=aware), (jslo, tslo)):
            trk = _alerting(slo_mod, clock)
            fl._slo = trk
            p = np.arange(6, dtype=np.int32)
            fl.submit(p, max_new_tokens=4)
            steps = [[r.inflight for r in fl.replicas]]
            _make_alerting(trk, fl.replicas[1].tag)
            fl.submit(p, max_new_tokens=4)
            steps.append([r.inflight for r in fl.replicas])
            _make_alerting(trk, fl.replicas[0].tag)
            fl.submit(p, max_new_tokens=4)
            steps.append([r.inflight for r in fl.replicas])
            got.append(steps)
        assert got[1] == got[0]
        assert got[1] == ([[1, 0], [1, 1], [2, 1]] if not aware else [[1, 0], [2, 0], [2, 1]])


class TestEngineKnobStaging:
    def test_unknown_knob_fails_at_the_actuation_site(self):
        eng = tserving.ContinuousBatchingEngine(_models()[1], **ENGINE)
        with pytest.raises(ValueError, match="unknown serving knob"):
            eng.request_knobs(bogus=1)

    def test_staged_knobs_apply_at_the_step_boundary(self):
        got = []
        for mod, model in zip((jserving, tserving), _models()):
            eng = mod.ContinuousBatchingEngine(model, **ENGINE)
            eng.submit(np.arange(6, dtype=np.int32), max_new_tokens=3)
            eng.request_knobs(chunk_size=32, decode_burst=2, max_queue=7)
            staged = (eng.chunk_size, eng.decode_burst)
            out = {}
            while eng.num_active or eng.num_pending:
                for rid, toks in eng.step():
                    out[rid] = [int(t) for t in toks]
            got.append((staged, eng.chunk_size, eng.decode_burst, eng.max_queue, out))
        assert got[1] == got[0]
        assert got[1][:4] == ((16, 1), 32, 2, 7) and len(got[1][4]) == 1


class TestServingControllerWiring:
    def test_build_binds_real_setters_threadless(self):
        got = []
        for C, fl in zip((jc, tc), _pair(hedge_after_s=0.5)):
            ctl = C.build_serving_controller(fl, rules=[C.HedgeRule(), C.ChunkRule()],
                                             register=False)
            try:
                init = {k: v.value for k, v in ctl.knobs.items()}
                out = ctl.tick(now=0.0, telemetry={"ttft_p95_ms": 2000.0,
                                                   "queue_wait_ms": 100.0})
                got.append((init, [(d["knob"], d["old"], d["new"]) for d in out],
                            fl.hedge_after_s,
                            [(r.engine.chunk_size, dict(r.engine._pending_knobs))
                             for r in fl.replicas]))
            finally:
                ctl.close()
        assert got[1] == got[0]
        init, decisions, hedge, engines = got[1]
        assert init["fleet.replicas"] == 2 and init["engine.chunk_size"] == 16
        assert hedge == pytest.approx(0.75) and len(decisions) == 2
        assert engines == [(16, {"chunk_size": 32})] * 2

    def test_scale_knob_drains_and_resumes_a_replica(self, clock):
        """The replicas knob over the port's fleet: one scale-down decision
        parks a replica, one scale-up resumes it, as in JAX's."""
        got = []
        for C, fl in zip((jc, tc), _pair(replicas=3)):
            ctl = C.build_serving_controller(fl, rules=[C.AutoscaleRule(low_for=1)],
                                             register=False, now_fn=clock.monotonic)
            quiet = {"replicas_active": 3, "replicas_total": 3, "queue_depth": 0}
            busy = {"replicas_active": 2, "replicas_total": 3, "queue_depth": 20}
            rows = []
            for tel in (quiet, busy):
                out = ctl.tick(now=clock.t, telemetry=tel)
                rows.append(([(d["old"], d["new"]) for d in out], fl.active_replicas()))
            got.append(rows)
            ctl.close()
        assert got[1] == got[0] == [([(3, 2)], 2), ([(2, 3)], 3)]

    def test_fleet_telemetry_after_a_schedule_equals_jax(self, clock):
        """Submissions, steps, a failure and a resume on both fleets
        (burn-aware, with SLOs): every snapshot key equal, TTFT quantiles
        (host-timed) by presence, the alerting series with tags renamed
        to replica indices and sorted."""
        snaps = []
        for C, fl, slo_mod in zip((jc, tc), _pair(slo=None, burn_aware_routing=True),
                                  (jslo, tslo)):
            fl._slo = _alerting(slo_mod, clock)
            clock.t = 100.0
            hbm = iter([(95, 100), (10, 100), (10, 100)])
            collect = C.fleet_telemetry(fl, hbm_fn=lambda: next(hbm), now_fn=clock.monotonic)
            rows = [collect()]
            for p in _prompts(40, 4, 8):
                fl.submit(p, max_new_tokens=4)
            _steps(fl, 2)
            rows.append(collect())
            fl._fail_replica(fl.replicas[0], "drill")
            fl.resume(0)
            _make_alerting(fl._slo, fl.replicas[1].tag)
            clock.t = 101.0
            rows.append(collect())
            tags = {rep.tag: f"r{rep.idx}" for rep in fl.replicas}
            for r in rows:
                json.dumps(r)
                for k in ("ttft_p50_ms", "ttft_p95_ms"):
                    r[k] = r[k] is not None
            snaps.append(_renamed(rows, tags))
        assert snaps[1] == snaps[0]
        first, busy, failed = snaps[1]
        assert first["replicas_total"] == 2 and first["queue_depth"] == 0
        assert first["hbm_live_bytes"] == 95 and busy["hbm_budget_bytes"] == 100
        assert busy["queue_depth"] == 4 and busy["arrival_rate_rps"] > 0
        assert "completion/replica:r1" in failed["slo_alerting"]
        assert failed["slo_alerting"] == sorted(failed["slo_alerting"])

    def test_digit_boundary_tags_still_compare(self, clock, monkeypatch):
        """With the port's replica tags across a digit boundary and JAX's
        not (tests/test_torch_fleet_slo.py ``cross_a_digit_boundary``), the
        renamed, sorted alerting series still equal JAX's."""
        from test_torch_fleet_slo import cross_a_digit_boundary

        cross_a_digit_boundary(monkeypatch)
        got = []
        for C, fl, slo_mod in zip((jc, tc), _pair(slo=None), (jslo, tslo)):
            fl._slo = _alerting(slo_mod, clock)
            for rep in fl.replicas:
                _make_alerting(fl._slo, rep.tag)
            snap = C.fleet_telemetry(fl, now_fn=clock.monotonic)()
            got.append(_renamed(snap["slo_alerting"],
                                {rep.tag: f"r{rep.idx}" for rep in fl.replicas}))
        assert got[1] == got[0] == ["completion/replica:r0", "completion/replica:r1"]

    def test_replan_callable_fires_once_and_admission_shrinks(self):
        def run(side):
            C = side[0]
            plans = []
            ctl = C.Controller([C.HbmGuardRule()], _shadow(C, **{"engine.max_queue": 64}),
                               hooks={"replan": lambda snap: plans.append(
                                   snap["hbm_budget_bytes"])},
                               register=False, now_fn=lambda: 0.0)
            hot = {"hbm_live_bytes": 95, "hbm_budget_bytes": 100}
            ctl.tick(now=0.0, telemetry=hot)
            ctl.tick(now=1.0, telemetry=hot)
            seq = C.decision_sequence(ctl.recorder.export())
            return plans, ctl.knobs["engine.max_queue"].value, [r[5] for r in seq]

        plans, value, actions = _both(run)
        assert plans == [100] and value == 16 and actions.count("replan") == 1

    def test_raising_replan_still_shrinks_admission(self):
        def run(side):
            C = side[0]

            def bad_plan(snap):
                raise RuntimeError("unsatisfiable budget")
            ctl = C.Controller([C.HbmGuardRule()], _shadow(C, **{"engine.max_queue": 64}),
                               hooks={"replan": bad_plan}, register=False,
                               now_fn=lambda: 0.0)
            ctl.tick(now=0.0, telemetry={"hbm_live_bytes": 95, "hbm_budget_bytes": 100})
            d = ctl.recorder.export()["ticks"][0]["decisions"]
            return d[0]["action"], d[0]["outcome"], ctl.knobs["engine.max_queue"].value

        action, outcome, value = _both(run)
        assert action == "replan" and outcome.startswith("error") and value == 32

    def test_live_fleet_controller_serves_the_jax_tokens(self):
        """A started port fleet under its started controller (real clock):
        every request returns the JAX engine's tokens, and every recorded
        decision lies inside KNOB_BOUNDS and replays to itself."""
        from test_torch_fleet import _collect, _jax_streams

        prompts = _prompts(41, 6, 10)
        want = _jax_streams(prompts, 6)
        fl = FleetRouter(_models()[1], replicas=2, engine_kwargs=dict(ENGINE),
                         max_new_tokens=6)
        ctl = tc.build_serving_controller(fl, interval_s=0.01)
        try:
            fl.scale_to(1)
            ctl.start()
            frids = [fl.submit(p, max_new_tokens=6) for p in prompts]
            assert _collect(fl, frids) == want
            t0 = time.monotonic()
            while ctl.recorder.ticks_total < 5 and time.monotonic() - t0 < 30:
                time.sleep(0.01)
        finally:
            ctl.close()
            fl.stop()
        rec = ctl.recorder.export()
        assert rec["ticks"]
        for t in rec["ticks"]:
            for d in t["decisions"]:
                if d["action"] == "set":
                    spec = tc.KNOB_BOUNDS[d["knob"]]
                    assert spec["min"] <= d["new"] <= spec["max"]
        assert tc.decision_sequence(tc.replay(rec, tc.serving_rules())) == \
            tc.decision_sequence(rec)

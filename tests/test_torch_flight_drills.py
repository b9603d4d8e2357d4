"""The serving drills of tests/test_torch_faultinject.py with tracing on: the
killed driving thread's recovery and the watchdog-recovered hang write their
flight dumps where the JAX engine writes them (``recovery_stats[i]["dump"]``,
``last_recovery_dump``, the watchdog's ``last_flight_dump``; one file per
engine, the watchdog's and the recovery's reasons merged in it), the hang's
dump lists the open ``serving.step`` span (in a fleet, the one whose engine
attribute is the recovered replica's tag), and the streams stay the JAX
engine's undisturbed ones. With tracing off and no flight directory the dumps
stay ``None`` (test_torch_faultinject.py)."""
import json

import pytest

from paddle_tpu import monitor as jmon
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch.analysis import faultinject as tfi
from test_torch_faultinject import _collect, _engine, _prompt, _reference, _run_all
from test_torch_fleet import _collect as _fleet_collect
from test_torch_fleet import _fleet, _jax_streams, _prompts


@pytest.fixture(autouse=True)
def _traced(monkeypatch, tmp_path):
    monkeypatch.delenv("PADDLE_TPU_FLIGHT_DIR", raising=False)
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    tfi.reset()
    for m in (jmon, tmon):
        m.trace.reset()
    tmon.trace.enable()
    yield tmp_path
    tmon.trace.disable()
    tmon.trace.reset()
    tfi.reset()


def test_killed_driver_dump_with_tracing_on(_traced):
    prompts = [_prompt(10 + i, 12) for i in range(4)]
    want = _reference(prompts, 8)
    eng = _engine("torch")
    tfi.arm("serving.drive", action="raise", nth=4)
    eng.start_driver()
    try:
        out, aborted = _collect(eng, prompts, 8)
    finally:
        eng.stop_driver()
    assert out == want and aborted >= 1
    (rec,) = eng.recovery_stats
    assert rec["dump"] and rec["dump"] == eng.last_recovery_dump
    assert rec["dump"].startswith(str(_traced)) and rec["dump"].endswith(f"_{eng._tag}.json")
    doc = json.load(open(rec["dump"]))
    assert doc["reason"].startswith(f"serving recovery ({eng._tag}): driving thread died")
    assert "stuck span: serving.drive" in doc["reason"]
    assert doc["extra"]["engine"] == eng._tag and doc["tracing_enabled"] is True
    assert {"serving.recover", "serving.step"} <= {s.name for s in tmon.trace.spans()}


def test_watchdog_hang_dump_lists_the_open_step(_traced):
    prompts = [_prompt(20 + i, 9) for i in range(3)]
    want = _reference(prompts, 6)
    eng = _engine("torch")
    eng.add_request(_prompt(19, 9), max_new_tokens=6)
    _run_all(eng)
    tfi.arm("serving.step", action="delay", delay_s=1.0, nth=2)
    eng.start_driver(hang_timeout=0.2)
    dog = eng._dog
    try:
        out, _aborted = _collect(eng, prompts, 6)
    finally:
        eng.stop_driver()
    assert out == want
    rec = next(r for r in eng.recovery_stats if "hang" in r["reason"])
    assert rec["dump"] and dog.last_flight_dump == rec["dump"]
    doc = json.load(open(rec["dump"]))
    # the watchdog's dump and the recovery's merged into the engine's file
    assert doc["reasons"][0].startswith("watchdog timeout: serving.step exceeded")
    assert doc["reasons"][1].startswith(f"serving recovery ({eng._tag}): watchdog-detected hang")
    open_names = [s["name"] for s in doc["open_spans"]]
    assert "serving.step" in open_names and "comm.wait" in open_names
    step = next(s for s in doc["open_spans"] if s["name"] == "serving.step")
    assert step["attrs"] == {"engine": eng._tag}
    assert "serving.step" in doc["extras"][1]["open_serving_spans"]


def test_fleet_hang_dump_holds_the_recovered_replicas_step(_traced):
    # three replicas serve at once, so other replicas' serving.step spans may
    # be open in the dump too: the hung one is told by its engine attribute
    prompts = _prompts(3, 6, 10)
    want = _jax_streams(prompts, 6)
    fl = _fleet(replicas=3, hang_timeout=0.2)
    try:
        assert fl.warmup(prompts[0][:6])
        tfi.arm("serving.step", action="delay", delay_s=1.0, nth=4)
        out = _fleet_collect(fl, [fl.submit(p, max_new_tokens=6) for p in prompts])
        trips = tfi.trips()
    finally:
        fl.stop()
    assert out == want and trips == [("serving.step", "delay")]
    recs = [(rep.tag, r) for rep in fl.replicas for r in rep.engine.recovery_stats]
    assert recs
    for tag, rec in recs:
        assert "hang" in rec["reason"] and rec["dump"].endswith(f"_{tag}.json")
        doc = json.load(open(rec["dump"]))
        steps = [s.get("attrs", {}).get("engine") for s in doc["open_spans"]
                 if s["name"] == "serving.step"]
        assert tag in steps
        assert doc["extras"][-1]["engine"] == tag


def test_dump_with_a_flight_dir_and_tracing_off(monkeypatch, tmp_path):
    tmon.trace.disable()
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path / "fd"))
    eng = _engine("torch")
    eng.add_request(_prompt(3, 9), max_new_tokens=4)
    eng.step()
    assert eng.recover("drill") == 1
    path = eng.last_recovery_dump
    assert path and path.startswith(str(tmp_path / "fd"))
    doc = json.load(open(path))
    assert doc["tracing_enabled"] is False and doc["extra"]["active"] == 1
    assert eng.pop_aborted()[0].rid == 0

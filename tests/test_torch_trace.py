"""The port's span tracing and flight recorder (``paddle_tpu_torch/monitor/
trace.py``) against the JAX package's: the same span script gives the same
span trees (names, parents, trace ids, attributes) on both; the ring, the
chrome export, ``span_dump``, flight dumps with their sections, coalescing
and default paths; the sampled ``dispatch.op`` spans of the port's op
dispatch; the watchdog's ``comm.wait`` span and timeout dump."""
import json
import os
import threading
import time

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu import monitor as jmon
from paddle_tpu.distributed.watchdog import CommWatchdog as JDog
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch.device import _CURRENT
from paddle_tpu_torch.distributed.watchdog import CommWatchdog as TDog

MONS = {"jax": jmon, "torch": tmon}
PKGS = {"jax": J, "torch": T}
BOTH = pytest.mark.parametrize("pkg", ["jax", "torch"])


@pytest.fixture(autouse=True)
def _clean():
    before = _CURRENT[0]
    T.set_device("cpu")
    for m in MONS.values():
        m.disable()
        m.trace.disable()
        m.reset()
        m.trace.set_dispatch_sampling(64)
    yield
    _CURRENT[0] = before
    for m in MONS.values():
        m.disable()
        m.trace.disable()
        m.reset()
        m.trace.set_dispatch_sampling(64)


def _script(trace):
    """One span script: explicit request roots across a 'step', implicit
    nesting, a training step with stages, a recorded span, a dropped span
    and one left open."""
    trace.enable()
    root = trace.start_span("serving.request", attrs={"rid": 7})
    qw = trace.start_span("serving.queue_wait", parent=root)
    trace.end_span(qw)
    with trace.span("serving.prefill", parent=root, attrs={"slot": 0}):
        with trace.span("dispatch.op", attrs={"op": "matmul"}):
            trace.record_span("serving.pack_tokens", 1, 2, attrs={"n_decode": 3})
    with trace.training_step(step=3) as ts:
        with ts.stage("dataload"):
            pass
        with ts.stage("forward"):
            with trace.span("jit.compile", attrs={"function": "f"}):
                pass
    dropped = trace.start_span("serving.request", attrs={"rid": 8})
    trace.drop(dropped)
    trace.end_span(root)
    trace.end_span(root)               # double close: no second record
    trace.end_span(None)
    return trace.start_span("comm.wait", attrs={"desc": "allreduce#3"})


def _shape(spans, open_spans):
    """The tree without times or absolute ids: names, parent names, trace
    roots' names, attributes, in recording order."""
    by_id = {s.span_id: s for s in list(spans) + list(open_spans)}

    def name(i):
        return None if i is None else by_id[i].name if i in by_id else "?"

    return ([(s.name, name(s.parent_id), name(s.trace_id), s.attrs) for s in spans],
            [(s.name, s.attrs) for s in open_spans])


def test_span_script_gives_the_jax_tree():
    got = {}
    for pkg, m in MONS.items():
        hung = _script(m.trace)
        got[pkg] = _shape(m.trace.spans(), m.trace.open_spans())
        m.trace.end_span(hung)
    assert got["torch"] == got["jax"]
    names = [n for n, _p, _t, _a in got["torch"][0]]
    assert names == ["serving.queue_wait", "serving.pack_tokens", "dispatch.op",
                     "serving.prefill", "train.dataload", "jit.compile", "train.forward",
                     "train.step", "serving.request"]
    assert got["torch"][1] == [("comm.wait", {"desc": "allreduce#3"})]


@BOTH
def test_ids_parents_and_implicit_nesting(pkg):
    trace = MONS[pkg].trace
    trace.enable()
    root = trace.start_span("serving.request", attrs={"rid": 7})
    assert root.trace_id == root.span_id and root.parent_id is None
    with trace.span("serving.prefill", parent=root) as outer:
        assert outer.parent_id == root.span_id and outer.trace_id == root.trace_id
        with trace.span("dispatch.op") as inner:
            assert inner.parent_id == outer.span_id and inner.trace_id == root.trace_id
            assert trace.current_span() is inner
            assert [s.name for s in trace.thread_span_stack()] == [
                "serving.prefill", "dispatch.op"]
    assert trace.open_spans() == [root]
    trace.end_span(root)
    assert not trace.open_spans() and trace.current_span() is None


@BOTH
def test_ring_wraps_keeping_the_newest(pkg):
    trace = MONS[pkg].trace
    trace.enable()
    trace.reset(capacity=8)
    for i in range(20):
        trace.record_span("dispatch.op", i, i + 1, attrs={"op": "add"})
    assert [s.t0_ns for s in trace.spans()] == list(range(12, 20))
    assert [s.t0_ns for s in trace.spans(limit=3)] == [17, 18, 19]
    trace.reset(capacity=4096)


@BOTH
def test_concurrent_emission_from_threads(pkg):
    trace = MONS[pkg].trace
    trace.enable()
    trace.reset(capacity=256)
    errs = []

    def work():
        try:
            for i in range(100):
                with trace.span("train.forward", attrs={"step": i}):
                    trace.record_span("dispatch.op", i, i + 1)
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=work) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    got = trace.spans()
    assert not errs and len(got) == 256 == len({s.span_id for s in got})
    assert all(s.t1_ns is not None for s in got) and not trace.open_spans()
    trace.reset(capacity=4096)


@BOTH
def test_disabled_records_nothing(pkg):
    trace = MONS[pkg].trace
    assert trace.span("train.step").__enter__() is None
    assert trace.start_span("x") is None and trace.record_span("x", 0, 1) is None
    P = PKGS[pkg]
    x = P.to_tensor(np.ones(3, "float32"))
    for _ in range(70):
        P.add(x, x)
    assert trace.spans() == [] and trace.open_spans() == []


def test_dispatch_spans_sampled_as_jax():
    """One op call in ``dispatch_sample_every()`` is a ``dispatch.op`` span,
    with the op's name and the rate in its attributes, in both packages."""
    got = {}
    for pkg, m in MONS.items():
        P = PKGS[pkg]
        m.trace.enable()
        m.trace.set_dispatch_sampling(4)
        x = P.to_tensor(np.ones(3, "float32"))
        for _ in range(9):
            P.add(x, x)
        P.matmul(x, x)
        got[pkg] = [(s.name, s.attrs) for s in m.trace.spans()]
        with pytest.raises(ValueError):
            m.trace.set_dispatch_sampling(0)
    assert got["torch"] == got["jax"] == [
        ("dispatch.op", {"op": "add", "sample_every": 4})] * 3


def test_to_static_compile_span_as_jax():
    import torch

    torch._dynamo.reset()
    got = {}
    for pkg, m in MONS.items():
        P = PKGS[pkg]
        m.trace.enable()

        def g(a):
            return a * 3

        kw = {"backend": "aot_eager"} if pkg == "torch" else {}
        f = P.jit.to_static(g, **kw)
        x = P.to_tensor(np.ones((2, 2), "float32"))
        f(x)
        f(x)
        got[pkg] = [(s.name, s.attrs) for s in m.trace.spans() if s.name == "jit.compile"]
    torch._dynamo.reset()
    assert got["torch"] == got["jax"] == [("jit.compile", {"function": "g"})]


# -- exporters ---------------------------------------------------------------------

def test_chrome_span_events_and_span_dump_as_jax():
    got = {}
    for pkg, m in MONS.items():
        hung = _script(m.trace)
        ev = m.trace.chrome_span_events(include_open=True)
        json.dumps(ev)
        got[pkg] = [(e["name"], e["cat"], e["ph"], e["pid"], sorted(e["args"])) for e in ev]
        assert all(e["dur"] > 0 for e in ev)
        doc = m.trace.span_dump(tail=3)
        assert len(doc["spans"]) == 3 and doc["clock"] == "perf_counter_ns"
        assert [s["name"] for s in doc["open_spans"]] == ["comm.wait"]
        assert m.validate_provenance(doc["provenance"]) == []
        m.trace.end_span(hung)
    assert got["torch"] == got["jax"]


# -- the flight recorder -----------------------------------------------------------

def _dump_view(doc):
    return {"reason": doc["reason"], "reasons": doc["reasons"],
            "spans": [(s["name"], s.get("attrs")) for s in doc["spans"]],
            "open": [(s["name"], s.get("attrs")) for s in doc["open_spans"]],
            "extra": doc.get("extra"), "extras": doc.get("extras"),
            "sections": doc.get("sections"), "tracing": doc["tracing_enabled"],
            "requests": doc["monitor"]["metrics"]["paddle_tpu_fleet_requests_total"],
            "keys": sorted(doc)}


def test_flight_dump_contents_sections_and_coalescing_as_jax(tmp_path):
    views = {}
    for pkg, m in MONS.items():
        d = tmp_path / pkg
        m.enable()
        m.counter("paddle_tpu_fleet_requests_total").inc()
        hung = _script(m.trace)

        class Owner:
            def section(self):
                return {"decisions": [1, 2]}

        owner = Owner()
        m.trace.register_flight_section("controller", owner.section)
        m.trace.register_flight_section("broken", lambda: 1 / 0)
        p1 = m.trace.flight_dump(path=str(d / "a.json"), reason="watchdog timeout: x",
                                 extra={"watchdog": "tbl"}, tail=4)
        p2 = m.trace.flight_dump(path=str(d / "a.json"), reason="serving recovery",
                                 extra={"engine": "e0"})
        assert p1 == p2
        views[pkg] = _dump_view(json.load(open(p2)))
        del owner                       # a dead section's owner drops it
        p3 = m.trace.flight_dump(path=str(d / "b.json"), reason="later")
        assert "sections" not in json.load(open(p3))
        m.trace.unregister_flight_section("broken")
        m.trace.end_span(hung)
    assert views["torch"] == views["jax"]
    v = views["torch"]
    assert v["reasons"] == ["watchdog timeout: x", "serving recovery"]
    assert v["extras"] == [{"watchdog": "tbl"}, {"engine": "e0"}]
    assert v["sections"] == {"controller": {"decisions": [1, 2]}}
    assert v["open"] == [("comm.wait", {"desc": "allreduce#3"})]


def test_default_paths_and_per_key_coalescing(monkeypatch, tmp_path):
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
    for m in MONS.values():
        assert m.trace.default_flight_path() == jmon.trace.default_flight_path()
        assert m.trace.default_flight_path(key="e7").endswith(f"rank3_pid{os.getpid()}_e7.json")
    tmon.trace.enable()
    pa1 = tmon.trace.flight_dump(reason="watchdog: eA", key="eA")
    pb = tmon.trace.flight_dump(reason="recovery: eB", key="eB")
    pa2 = tmon.trace.flight_dump(reason="recovery: eA", key="eA")
    assert pa1 == pa2 != pb and len(list(tmp_path.glob("*.json"))) == 2
    assert json.load(open(pa1))["reasons"] == ["watchdog: eA", "recovery: eA"]
    p1 = tmon.trace.flight_dump(reason="first", key="eC", coalesce_s=0.05)
    time.sleep(0.08)
    p2 = tmon.trace.flight_dump(reason="second", key="eC", coalesce_s=0.05)
    assert p1 == p2 and json.load(open(p2))["reasons"] == ["second"]


def test_default_dir_is_the_temporary_directory(monkeypatch, tmp_path):
    import tempfile

    monkeypatch.delenv("PADDLE_TPU_FLIGHT_DIR", raising=False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert tmon.trace.default_flight_path().startswith(str(tmp_path))


@pytest.mark.parametrize("dog_cls", [JDog, TDog], ids=["jax", "torch"])
def test_watchdog_timeout_writes_the_flight_dump(dog_cls, monkeypatch, tmp_path):
    m = jmon if dog_cls is JDog else tmon
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path))
    m.trace.enable()
    fired = []
    dog = dog_cls(timeout=0.05, on_timeout=lambda desc, dump: fired.append(desc),
                  flight_key="e9")
    try:
        with dog.watch("allreduce#hung"):
            deadline = time.time() + 5
            while not fired and time.time() < deadline:
                time.sleep(0.01)
    finally:
        dog.stop()
    assert fired == ["allreduce#hung"]
    assert dog.last_flight_dump and dog.last_flight_dump.endswith("_e9.json")
    doc = json.load(open(dog.last_flight_dump))
    assert "watchdog timeout" in doc["reason"]
    hung = [s for s in doc["open_spans"] if s["name"] == "comm.wait"]
    assert hung and hung[0]["attrs"]["desc"] == "allreduce#hung"
    assert "allreduce#hung" in doc["extra"]["watchdog"]
    assert [s.name for s in m.trace.spans()] == ["comm.wait"]


def test_watchdog_dump_stays_off_without_tracing_or_flight_dir(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_FLIGHT_DIR", raising=False)
    fired = []
    dog = TDog(timeout=0.03, on_timeout=lambda d, s: fired.append(d))
    try:
        with dog.watch("stuck"):
            deadline = time.time() + 5
            while not fired and time.time() < deadline:
                time.sleep(0.01)
    finally:
        dog.stop()
    assert fired == ["stuck"] and dog.last_flight_dump is None
    assert tmon.trace.spans() == []

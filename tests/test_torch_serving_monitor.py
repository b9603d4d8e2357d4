"""The serving engine's telemetry in the port against the JAX engine's: with
the monitor, tracing and every sanitizer on, schedules of
tests/test_torch_serving.py (chunked prefill with prefix hits, speculation,
int8 pools, preemption to host RAM, a radix chain spilled and restored,
shedding, cancellation, recovery) go through both packages' engines, and
after every step every counter and gauge, every histogram's count (its
buckets too where they hold no time) and the shape of the span trees equal
the JAX engine's. No sanitizer trips on either side; the recovery writes its
flight dump in both."""
import json
import re

import pytest

from paddle_tpu import monitor as jmon
from paddle_tpu.analysis import faultinject as jfi
from paddle_tpu.analysis import sanitizers as jsan
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch.analysis import faultinject as tfi
from paddle_tpu_torch.analysis import sanitizers as tsan
from test_torch_serving import SCENARIOS, _call, _engine, _models

SIDES = {"jax": (jmon, jfi, jsan), "torch": (tmon, tfi, tsan)}
CHOSEN = ["staggered_chunked", "spec", "int8_spec", "tenants_shedding", "preempt_spill",
          "radix_spill", "cancel", "recover", "static_waves"]
# histograms whose values are times (compared by count only)
_TIMED = re.compile(r"_(ns|seconds)$")
_RUNS = {}


def _metrics(m):
    """Every counter and gauge value, and every histogram's count (and its
    buckets where they are not times), from the snapshot. A series at 0 is
    left out: the registry also holds, at 0, what earlier code of the
    process registered."""
    out = {}
    for name, doc in m.snapshot()["metrics"].items():
        if name.startswith("paddle_tpu_dispatch_"):
            continue    # the op dispatch, not the engine (test_torch_monitor.py)
        if doc["type"] == "histogram":
            for series, v in doc["values"].items():
                if v["count"]:
                    out[(name, series)] = (v["count"],) if _TIMED.search(name) else (
                        v["count"], v["sum"], tuple(map(tuple, v["buckets"])))
        else:
            for series, v in doc["values"].items():
                if v:
                    out[(name, series)] = v
    return out


def _norm_attrs(a):
    return None if a is None else {k: v for k, v in a.items() if k != "engine"}


def _spans(m):
    """The span trees without times or ids: name, parent's name, the trace
    root's name and the attributes (the engine tag dropped). The op
    dispatch's sampled spans are left out, as its metrics are: the port's
    CPU programs run their ops eagerly, the JAX engine's are compiled."""
    spans = [s for s in m.trace.spans() if s.name != "dispatch.op"]
    opened = m.trace.open_spans()
    by_id = {s.span_id: s for s in spans + opened}

    def name(i):
        return None if i is None else by_id[i].name if i in by_id else "?"

    return ([(s.name, name(s.parent_id), name(s.trace_id), _norm_attrs(s.attrs))
             for s in spans],
            sorted((s.name, repr(_norm_attrs(s.attrs))) for s in opened))


def _run(name, flight_dir):
    if name in _RUNS:
        return _RUNS[name]
    kind, kw, schedule, step_kw = SCENARIOS[name]
    step_kw = step_kw or {}
    jm, tm = _models()
    got = {}
    for pkg, model in (("jax", jm), ("torch", tm)):
        m, fi, san = SIDES[pkg]
        fi.reset()
        san.disable()
        san.reset()
        m.reset()
        m.trace.reset()
        m.enable()
        m.trace.enable()
        san.enable()             # every sanitizer, before the engine's locks exist
        views = []
        try:
            eng = _engine(pkg, kind, kw, model)
            sched = schedule()
            for s in range(200):
                for call, args, ckw in sched.get(s, ()):
                    try:
                        _call(eng, call, args, ckw)
                    except (ValueError, RuntimeError):
                        pass
                res = eng.step(**step_kw)
                views.append((s, sorted((rid, list(map(int, t))) for rid, t in res),
                              _metrics(m), _spans(m)))
                if s > max(sched) and not (eng.num_active or eng.num_pending):
                    break
            got[pkg] = dict(views=views, trips=san.trips(), faults=fi.trips(),
                            dumps=[r.get("dump") for r in getattr(eng, "recovery_stats", ())])
        finally:
            san.disable()
            san.reset()
            fi.reset()
            m.disable()
            m.trace.disable()
    _RUNS[name] = got
    return got


@pytest.fixture
def flight_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("name", CHOSEN)
def test_metrics_and_span_trees_equal_jax_after_every_step(name, flight_dir):
    run = _run(name, flight_dir)
    jv, tv = run["jax"]["views"], run["torch"]["views"]
    assert len(tv) == len(jv)
    for (s, jres, jmet, jsp), (_s, tres, tmet, tsp) in zip(jv, tv):
        assert tres == jres, s
        assert tmet == jmet, s
        assert tsp == jsp, s
    assert run["torch"]["trips"] == run["jax"]["trips"] == []
    assert run["torch"]["faults"] == run["jax"]["faults"]
    if name != "static_waves":      # the static engine records no serving metric
        assert tv[-1][2][("paddle_tpu_serving_generated_tokens_total", "")] > 0


def test_the_chosen_schedules_reach_their_metrics(flight_dir):
    """Each of spec, int8, spill, shedding, cancellation and recovery moved
    the counters that show it."""
    def last(name, key):
        return _run(name, flight_dir)["torch"]["views"][-1][2].get((key, ""), 0)

    assert last("spec", "paddle_tpu_serving_spec_draft_tokens_total") > 0
    assert last("int8_spec", "paddle_tpu_serving_spec_accepted_tokens_total") > 0
    assert last("preempt_spill", "paddle_tpu_serving_preemptions_total") == 1
    assert last("radix_spill", "paddle_tpu_kv_spill_restores_total") > 0
    assert last("cancel", "paddle_tpu_serving_cancelled_total") > 0
    assert last("recover", "paddle_tpu_serving_recoveries_total") == 1
    assert last("recover", "paddle_tpu_serving_aborted_total") == 3
    assert last("staggered_chunked", "paddle_tpu_serving_prefix_cache_hits_total") > 0
    shed = _run("tenants_shedding", flight_dir)["torch"]["views"][-1][2]
    assert any(k[0] == "paddle_tpu_serving_shed_total" and v > 0 for k, v in shed.items())
    assert _run("staggered_chunked", flight_dir)["torch"]["views"][-1][2][
        ("paddle_tpu_jit_compiles_total", "function=serving.step")] == 2


def test_recovery_writes_its_flight_dump_as_jax(flight_dir):
    run = _run("recover", flight_dir)
    jd, td = run["jax"]["dumps"], run["torch"]["dumps"]
    assert len(td) == len(jd) == 1 and td[0] and jd[0]
    doc = json.load(open(td[0]))
    jdoc = json.load(open(jd[0]))
    assert doc["reason"].split(":", 1)[1] == jdoc["reason"].split(":", 1)[1]
    assert {k: v for k, v in doc["extra"].items() if k != "engine"} == \
        {k: v for k, v in jdoc["extra"].items() if k != "engine"}
    assert sorted(s["name"] for s in doc["open_spans"]) == \
        sorted(s["name"] for s in jdoc["open_spans"])

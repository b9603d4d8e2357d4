"""The port's metrics registry (``paddle_tpu_torch/monitor``) against the JAX
package's (``paddle_tpu/monitor``): tests/test_monitor.py's cases on both
packages, the catalog's names, kinds and labels equal, one recorded sequence
giving the same Prometheus text and snapshot (but for provenance), the
instrumented dispatch, AMP, to_static and paged-KV sites recording what the
JAX sites record for the same calls, and the counter tracks merged into the
profiler's chrome trace."""
import importlib
import json
import math
import re
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu import monitor as jmon
from paddle_tpu.monitor import catalog as jcat
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch.device import _CURRENT
from paddle_tpu_torch.monitor import catalog as tcat

# ``monitor.registry`` is the default Registry: the modules by their names
jreg = importlib.import_module("paddle_tpu.monitor.registry")
treg = importlib.import_module("paddle_tpu_torch.monitor.registry")

ROOT = Path(__file__).resolve().parents[1]
REGS = {"jax": jreg, "torch": treg}
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
    yield
    _CURRENT[0] = before
    for m in MONS.values():
        m.disable()
        m.trace.disable()
        m.reset()


def _tensor(pkg, a):
    return PKGS[pkg].to_tensor(np.asarray(a, "float32"))


# -- registry primitives, on both packages --------------------------------------

@BOTH
def test_counter_inc_and_negative_rejected(pkg):
    c = REGS[pkg].Registry().counter("test_counter_total")
    c.inc()
    c.inc(4)
    assert c.value == 5
    with pytest.raises(ValueError, match="only go up"):
        c.inc(-1)


@BOTH
def test_labeled_counter_children(pkg):
    c = REGS[pkg].Registry().counter("test_ops_total", labelnames=("op",))
    c.labels("add").inc(2)
    c.labels(op="mul").inc()
    assert dict((lv, ch.value) for lv, ch in c.children()) == {("add",): 2, ("mul",): 1}
    with pytest.raises(ValueError, match="labeled"):
        c.inc()
    c.remove("add")
    assert [lv for lv, _ in c.children()] == [("mul",)]


@BOTH
def test_gauge_set_inc_dec(pkg):
    g = REGS[pkg].Registry().gauge("test_gauge")
    g.set(10)
    g.inc(5)
    g.dec(3)
    assert g.value == 12.0


@BOTH
def test_histogram_buckets_reservoir_and_timer(pkg):
    r = REGS[pkg].Registry()
    h = r.histogram("test_hist", buckets=(100, 10, 1000))
    assert h.buckets == (10, 100, 1000)
    for v in (5, 10, 11, 100, 500, 5000):
        h.observe(v)
    cum = dict(h.cumulative_buckets())
    assert (cum[10], cum[100], cum[1000], cum[math.inf]) == (2, 4, 5, 6) and h.count == 6
    res = r.histogram("test_res", buckets=(1e9,))
    for v in range(REGS[pkg]._RESERVOIR_SIZE * 4):
        res.observe(v)
    assert len(res._reservoir) == REGS[pkg]._RESERVOIR_SIZE
    assert res.percentile(50) <= res.percentile(99)
    t = r.histogram("test_span")
    with t.time():
        time.sleep(0.01)
    assert t.count == 1 and t.sum >= 5e6


@BOTH
def test_registration_conflicts_rejected(pkg):
    r = REGS[pkg].Registry()
    r.counter("test_conflict_total")
    with pytest.raises(ValueError, match="already registered"):
        r.gauge("test_conflict_total")
    with pytest.raises(ValueError, match="already registered"):
        r.counter("test_conflict_total", labelnames=("x",))
    r.histogram("test_grid", buckets=(1, 2, 3))
    r.histogram("test_grid", buckets=(3, 2, 1))
    with pytest.raises(ValueError, match="buckets"):
        r.histogram("test_grid", buckets=(10, 20))
    with pytest.raises(ValueError, match="invalid metric name"):
        r.counter("9starts_with_digit")
    with pytest.raises(ValueError, match="invalid label name"):
        r.counter("test_total", labelnames=("bad-label",))
    with pytest.raises(ValueError, match="not both"):
        r.histogram("test_label_conflict", labelnames=("op",)).labels("add", op="mul")
    with pytest.raises(ValueError, match="cataloged"):
        MONS[pkg].gauge("paddle_tpu_dispatch_op_calls_total")


@BOTH
def test_concurrent_increments_exact(pkg):
    r = REGS[pkg].Registry()
    c = r.counter("test_mt_total", labelnames=("who",))
    h = r.histogram("test_mt_hist", buckets=(10, 1000))
    start = threading.Barrier(6)

    def work(i):
        child = c.labels(f"t{i % 2}")
        start.wait()
        for k in range(1000):
            child.inc()
            h.observe(k % 20)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sum(ch.value for _, ch in c.children()) == 6000 == h.count
    assert dict(h.cumulative_buckets())[math.inf] == h.count


# -- the catalog: one contract for both packages ---------------------------------

def test_catalog_names_kinds_and_labels_equal_jax():
    assert tcat.SUBSYSTEMS == jcat.SUBSYSTEMS and tcat.NAME_PATTERN == jcat.NAME_PATTERN
    assert len(tcat.METRICS) == len(jcat.METRICS) == 72
    assert {k: v[:2] for k, v in tcat.METRICS.items()} == \
        {k: v[:2] for k, v in jcat.METRICS.items()}
    assert set(tcat.SPANS) == set(jcat.SPANS)
    for name in jcat.METRICS:
        assert tcat.spec(name)[:2] == jcat.spec(name)[:2]
    # only the two help strings that spoke of jax.lax are reworded
    differ = sorted(k for k in jcat.METRICS if tcat.METRICS[k][2] != jcat.METRICS[k][2])
    assert differ == ["paddle_tpu_comm_collectives_total"]
    assert "jax.lax" not in " ".join(v[2] for v in tcat.METRICS.values()).replace(
        "jax.lax in the JAX package", "")


def test_catalog_names_follow_the_pattern():
    pat = re.compile(tcat.NAME_PATTERN)
    for name, (kind, _labels, help_) in tcat.METRICS.items():
        assert pat.match(name), name
        assert help_, name
        if kind == "counter":
            assert name.endswith("_total"), name


# -- one recorded sequence, the same exposition ----------------------------------

def _record(m, reg):
    """One recorded sequence into ``reg`` (a fresh Registry: the default one
    holds whatever earlier code of the process registered)."""
    reg.counter("paddle_tpu_dispatch_op_calls_total", labelnames=("op",)).labels("add").inc(3)
    reg.counter("paddle_tpu_dispatch_op_calls_total", labelnames=("op",)).labels("matmul").inc()
    reg.gauge("paddle_tpu_kv_free_blocks").set(17)
    reg.gauge("paddle_tpu_serving_tenant_queue_depth", labelnames=("tenant",)).labels("a").set(2)
    h = reg.histogram("paddle_tpu_dispatch_latency_ns")
    for v in (900, 4_000, 30_000, 2e9):
        h.observe(v)
    s = reg.histogram("paddle_tpu_jit_trace_compile_seconds", buckets=m.DEFAULT_SECONDS_BUCKETS)
    s.observe(0.3)
    reg.counter("paddle_tpu_monitor_sanitizer_trips_total", labelnames=("sanitizer",)) \
        .labels("hostsync").inc()
    return reg


EXPORT = {"jax": importlib.import_module("paddle_tpu.monitor.export"),
          "torch": importlib.import_module("paddle_tpu_torch.monitor.export")}


def test_same_sequence_same_prometheus_text_and_snapshot():
    regs = {pkg: _record(MONS[pkg], REGS[pkg].Registry()) for pkg in MONS}
    assert EXPORT["torch"].prometheus_text(regs["torch"]) == \
        EXPORT["jax"].prometheus_text(regs["jax"])
    js, ts = (EXPORT[p].snapshot(regs[p]) for p in ("jax", "torch"))
    assert set(js) == set(ts)
    js.pop("provenance"), ts.pop("provenance")
    assert ts == js
    samples = [(123_000, {"paddle_tpu_kv_free_blocks": 17.0}), (125_000, {"x": 1.0})]
    assert EXPORT["torch"].chrome_counter_events(samples) == \
        EXPORT["jax"].chrome_counter_events(samples)


@BOTH
def test_prometheus_text_parses_with_histogram_invariants(pkg):
    m = MONS[pkg]
    reg = _record(m, REGS[pkg].Registry())
    series, types = _parse_prometheus(EXPORT[pkg].prometheus_text(reg))
    assert types["paddle_tpu_dispatch_op_calls_total"] == "counter"
    assert types["paddle_tpu_dispatch_latency_ns"] == "histogram"
    assert series['paddle_tpu_dispatch_op_calls_total{op="add"}'] == 3.0
    buckets = sorted((float(re.search(r'le="([^"]+)"', k).group(1).replace("+Inf", "inf")), v)
                     for k, v in series.items()
                     if k.startswith("paddle_tpu_dispatch_latency_ns_bucket"))
    counts = [v for _, v in buckets]
    assert counts == sorted(counts) and buckets[-1][0] == math.inf
    assert buckets[-1][1] == series["paddle_tpu_dispatch_latency_ns_count"] == 4
    json.dumps(EXPORT[pkg].snapshot(reg))


def _parse_prometheus(text):
    series, types = {}, {}
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            types[name] = kind
            continue
        if line.startswith("#"):
            continue
        key, val = line.rsplit(" ", 1)
        series[key] = float(val.replace("+Inf", "inf"))
    return series, types


# -- provenance -------------------------------------------------------------------

def test_provenance_real_valid_and_validated_as_jax():
    prov = tmon.snapshot()["provenance"]
    real = subprocess.run(["git", "rev-parse", "--short", "HEAD"], capture_output=True,
                          text=True, cwd=ROOT).stdout.strip()
    assert prov["git_rev"] == real
    # torch is imported and CUDA never started here: the port says "cpu"
    assert prov["platform"] == ("gpu" if torch.cuda.is_initialized() else "cpu")
    assert prov["monotonic_start_ns"] <= prov["monotonic_ns"]
    assert set(prov) == set(jmon.provenance())
    now = time.time()
    cases = [prov, {"git_rev": "deadbee", "wall_time": "2030-01-01T00:00:00Z"},
             {"wall_time": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())},
             {"git_rev": "0000000"}, {"git_rev": "xyz"}, {"wall_time": "garbage"},
             "not a dict", {"wall_time_unix": now + 10_000}]
    for c in cases:
        assert tmon.validate_provenance(c, now=now) == jmon.validate_provenance(c, now=now), c
    assert len(tmon.validate_provenance(cases[1])) == 2


def test_provenance_never_starts_cuda(monkeypatch):
    provenance = importlib.import_module("paddle_tpu_torch.monitor.provenance")

    def boom(*a, **k):
        raise AssertionError("provenance must not touch the card")

    monkeypatch.setattr(torch.cuda, "init", boom)
    monkeypatch.setattr(torch.cuda, "current_device", boom)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert provenance._platform() == "cpu"
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert provenance._platform() == "gpu"


# -- disabled mode ----------------------------------------------------------------

@BOTH
def test_disabled_dispatch_records_nothing(pkg):
    P = PKGS[pkg]
    x = _tensor(pkg, np.ones((2, 2)))
    P.matmul(P.add(x, x), x)
    calls = MONS[pkg].snapshot()["metrics"].get(
        "paddle_tpu_dispatch_op_calls_total", {"values": {}})["values"]
    assert all(v == 0 for v in calls.values())
    MONS[pkg].sample()
    assert MONS[pkg].chrome_counter_events() == []


def test_disabled_port_dispatch_costs_one_slot_load_a_check():
    """With the monitor, tracing and the profiler off, ``apply`` reads three
    slots and calls the dispatch: the monitor adds no call of its own."""
    from paddle_tpu_torch.ops import _apply

    called = []
    orig = _apply._observed
    _apply._observed = lambda *a: called.append(a) or orig(*a)
    try:
        T.add(_tensor("torch", [1.0]), _tensor("torch", [2.0]))
        assert called == []
        tmon.enable()
        T.add(_tensor("torch", [1.0]), _tensor("torch", [2.0]))
        assert len(called) == 1
    finally:
        _apply._observed = orig


# -- instrumented sites: the port records what the JAX sites record --------------

def _metric_values(m, name):
    doc = m.snapshot()["metrics"].get(name)
    return None if doc is None else doc["values"]


def test_dispatch_counts_and_latency_equal_jax():
    for pkg, m in MONS.items():
        P = PKGS[pkg]
        m.enable()
        x, y = _tensor(pkg, np.ones((2, 2))), _tensor(pkg, np.ones((2, 2)))
        P.add(x, y)
        P.add(x, y)
        P.matmul(x, y)
        P.exp(P.sum(x))
    calls = {p: _metric_values(m, "paddle_tpu_dispatch_op_calls_total") for p, m in MONS.items()}
    assert calls["torch"] == calls["jax"]
    assert calls["torch"]["op=add"] == 2 and calls["torch"]["op=matmul"] == 1
    lat = {p: _metric_values(m, "paddle_tpu_dispatch_latency_ns")[""] for p, m in MONS.items()}
    assert lat["torch"]["count"] == lat["jax"]["count"] == 5 and lat["torch"]["sum"] > 0


def test_amp_cast_counter_equals_jax():
    for pkg, m in MONS.items():
        P = PKGS[pkg]
        m.enable()
        x, y = _tensor(pkg, np.ones((2, 2))), _tensor(pkg, np.ones((2, 2)))
        with P.amp.auto_cast(level="O1", dtype="bfloat16"):
            P.matmul(x, y)
            P.add(x, y)
        with P.amp.auto_cast(level="O2", dtype="bfloat16"):
            P.add(x, y)
    got = {p: m.registry.get("paddle_tpu_dispatch_amp_casts_total").value
           for p, m in MONS.items()}
    assert got["torch"] == got["jax"] == 4


def test_to_static_compiles_hits_signatures_equal_jax():
    torch._dynamo.reset()
    for pkg, m in MONS.items():
        P = PKGS[pkg]
        m.enable()

        def f(a):
            return a * 2 + 1

        kw = {"backend": "aot_eager"} if pkg == "torch" else {}
        g = P.jit.to_static(f, **kw)
        x = _tensor(pkg, np.ones((2, 2)))
        g(x)
        g(x)
        g(x)
        g(_tensor(pkg, np.ones((3, 3))))
    torch._dynamo.reset()
    for name in ("paddle_tpu_jit_compiles_total", "paddle_tpu_jit_cache_hits_total",
                 "paddle_tpu_jit_cached_signatures"):
        assert _metric_values(tmon, name) == _metric_values(jmon, name) == {"function=f": 2}
    tc = {p: _metric_values(m, "paddle_tpu_jit_trace_compile_seconds")[""]
          for p, m in MONS.items()}
    assert tc["torch"]["count"] == tc["jax"]["count"] == 2 and tc["torch"]["sum"] > 0


def _pools():
    from paddle_tpu.models.paged_kv import PagedKVCache as JP
    from paddle_tpu_torch.models.paged_kv import PagedKVCache as TP

    kw = dict(num_layers=1, num_blocks=9, block_size=4, kv_heads=1, head_dim=4, batch=2,
              max_blocks_per_seq=4)
    return {"jax": JP(**kw), "torch": TP(**kw, device="cpu")}


def _kv_metrics(m):
    return {n: _metric_values(m, n) for n in (
        "paddle_tpu_kv_free_blocks", "paddle_tpu_kv_cow_copies_total",
        "paddle_tpu_kv_pool_exhausted_total")}


def test_paged_kv_gauges_and_counters_equal_jax_after_every_call():
    pks = _pools()
    for m in MONS.values():
        m.enable()
    script = [
        lambda pk, pools: pk.ensure_capacity([8, 4]),
        lambda pk, pools: pk.ensure_capacity([8, 4]),        # nothing granted
        lambda pk, pools: pk.fork_rows([0, 0]),
        lambda pk, pools: pk.make_tail_exclusive(4, pools),
        lambda pk, pools: pk.free_sequence(1),
        lambda pk, pools: pk.retain_blocks([int(pk._tables_np[0][0])]),
        lambda pk, pools: pk.release_blocks([int(pk._tables_np[0][0])]),
        lambda pk, pools: pk.take_blocks(2),
        lambda pk, pools: pk.ensure_capacity([16, 16]),      # exhausted
    ]
    for step in script:
        for pkg, pk in pks.items():
            pools = [(pk.k[0], pk.v[0])]
            try:
                step(pk, pools)
            except RuntimeError as e:
                assert "exhausted" in str(e)
        assert _kv_metrics(tmon) == _kv_metrics(jmon)
        assert len(pks["torch"]._free) == len(pks["jax"]._free)
    assert _kv_metrics(tmon)["paddle_tpu_kv_pool_exhausted_total"] == {"": 1.0}
    assert _kv_metrics(tmon)["paddle_tpu_kv_cow_copies_total"] == {"": 1.0}


def test_counter_tracks_merge_into_the_profiler_trace(tmp_path):
    from paddle_tpu_torch import profiler

    tmon.enable()
    x = _tensor("torch", np.ones((2, 2)))
    with profiler.Profiler(targets=[profiler.ProfilerTarget.CPU]) as p:
        T.add(x, x)
        p.step()
        T.matmul(x, x)
        p.step()
    path = tmp_path / "trace.json"
    p.export(str(path))
    doc = json.loads(path.read_text())
    counters = [e for e in doc["traceEvents"] if e.get("ph") == "C"]
    assert {e["name"].split("{")[0] for e in counters} >= {
        "paddle_tpu_dispatch_op_calls_total", "paddle_tpu_monitor_samples_total"}
    assert [e for e in doc["traceEvents"] if e.get("ph") == "X"]


def test_reset_drops_samples_and_spans():
    tmon.enable()
    tmon.trace.enable()
    with tmon.trace.span("train.step"):
        pass
    tmon.counter("paddle_tpu_fleet_requests_total").inc()
    tmon.sample()
    assert tmon.chrome_counter_events() and tmon.trace.spans()
    tmon.reset()
    assert tmon.chrome_counter_events() == [] and tmon.trace.spans() == []
    assert tmon.registry.get("paddle_tpu_fleet_requests_total").value == 0

"""The port's span-timeline analytics and SLO tracker
(``paddle_tpu_torch/monitor/{timeline,slo}.py``) against the JAX package's:
every timeline function on the same span dicts gives the JAX result
(hand-built sets with hand-computed answers, and span sets drawn from a
seed), the modeled mesh-step pair raises naming ROADMAP Queue A item 10,
and the same SLO events under the same injected clock give the same burn
rates, alerts, scan rows, status sections and telemetry."""
import numpy as np
import pytest

import paddle_tpu  # noqa: F401 - initializes the JAX package
import paddle_tpu_torch  # noqa: F401
from paddle_tpu import monitor as jmon
from paddle_tpu.monitor import slo as jslo
from paddle_tpu.monitor import timeline as jtl
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch.monitor import slo as tslo
from paddle_tpu_torch.monitor import timeline as ttl

MONS = (jmon, tmon)
FUNCS = ("comm_overlap", "step_phases", "bubble_fraction", "ttft_decomposition")


@pytest.fixture(autouse=True)
def _clean():
    for m in MONS:
        m.disable()
        m.trace.disable()
        m.reset()
    yield
    for m in MONS:
        m.disable()
        m.trace.disable()
        m.reset()


def _span(name, t0, t1, span_id, parent_id=None, trace_id=0, attrs=None):
    d = {"name": name, "t0_ns": t0, "t1_ns": t1, "span_id": span_id,
         "trace_id": trace_id, "parent_id": parent_id}
    if attrs:
        d["attrs"] = attrs
    return d


def _train_steps(rng, n_steps=3):
    spans, sid, t = [], 1, 0
    for _ in range(n_steps):
        root = sid
        t_end = t + int(rng.integers(500, 1000))
        spans.append(_span("train.step", t, t_end, root))
        sid += 1
        c = t + int(rng.integers(0, 50))
        for stage in ("dataload", "forward", "backward", "optimizer"):
            d = int(rng.integers(20, 150))
            spans.append(_span(f"train.{stage}", c, min(c + d, t_end), sid, parent_id=root))
            sid += 1
            c += d + int(rng.integers(0, 30))
        for _ in range(int(rng.integers(0, 3))):
            a = t + int(rng.integers(0, 900))
            spans.append(_span("comm.all_reduce", a, a + int(rng.integers(10, 200)), sid))
            sid += 1
        t = t_end + int(rng.integers(0, 100))
    return spans


def _request_trees(rng, n=5):
    spans, sid = [], 1000
    for i in range(n):
        t0 = int(rng.integers(0, 10_000))
        qw, gap, pf = (int(v) for v in rng.integers(1, 500, size=3))
        root = sid
        spans.append(_span("serving.request", t0, t0 + qw + gap + pf + 90, root,
                           trace_id=root, attrs={"rid": i}))
        spans.append(_span("serving.queue_wait", t0, t0 + qw, root + 1, root, root))
        spans.append(_span("serving.prefill", t0 + qw + gap, t0 + qw + gap + pf, root + 2,
                           root, root))
        for k in range(int(rng.integers(0, 3))):
            a = t0 + qw + gap + pf + 30 * k
            spans.append(_span("serving.decode_step", a, a + 25, root + 3 + k, root, root))
        sid += 10
    # a request still in queue (no prefill) and an open span
    spans.append(_span("serving.request", 5, None, 99_999, trace_id=99_999))
    return spans


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("func", FUNCS)
def test_timeline_function_equals_jax_on_drawn_spans(func, seed):
    rng = np.random.default_rng(seed)
    spans = _train_steps(rng) + _request_trees(rng)
    rng.shuffle(spans)
    assert getattr(ttl, func)(spans) == getattr(jtl, func)(spans)


HAND = {
    "overlap": [_span("comm.all_reduce", 0, 100, 1), _span("train.backward", 50, 150, 2)],
    "unions": [_span("comm.all_reduce", 0, 60, 1), _span("comm.all_gather", 40, 100, 2),
               _span("train.forward", 20, 30, 3), _span("train.backward", 25, 80, 4)],
    "step": [_span("train.step", 0, 100, 1), _span("train.forward", 10, 40, 2, 1),
             _span("train.backward", 40, 70, 3, 1), _span("comm.mesh_step", 90, 130, 4),
             _span("comm.collective", 75, 95, 5)],
    "ttft": [_span("serving.request", 1000, 1957, 100, trace_id=1, attrs={"rid": 42}),
             _span("serving.queue_wait", 1000, 1300, 101, 100, 1),
             _span("serving.prefill", 1307, 1907, 102, 100, 1),
             _span("serving.decode_step", 1907, 1947, 103, 100, 1)],
    "empty": [],
}


@pytest.mark.parametrize("case", sorted(HAND))
@pytest.mark.parametrize("func", FUNCS)
def test_timeline_function_equals_jax_on_hand_spans(func, case):
    assert getattr(ttl, func)(HAND[case]) == getattr(jtl, func)(HAND[case])


def test_hand_computed_answers():
    assert ttl.comm_overlap(HAND["overlap"]) == {
        "comm_ns": 100, "compute_ns": 100, "overlapped_ns": 50, "overlap_fraction": 0.5}
    assert ttl.bubble_fraction(HAND["step"][:3])["bubble_fraction"] == 0.4
    assert ttl.step_phases(HAND["step"])["rows"][0]["phases"] == {
        "forward": 30, "backward": 30, "comm": 25}
    row = ttl.ttft_decomposition(HAND["ttft"])["rows"][0]
    assert (row["rid"], row["ttft_ns"], row["queue_wait_ns"], row["prefill_ns"],
            row["gap_ns"], row["decode_ns"]) == (42, 907, 300, 600, 7, 40)


def test_mfu_and_flops_equal_jax():
    for args in ((1000,), (1000, 2, 8, 10), (7_000_000_000, 32, 4096, 2048)):
        assert ttl.transformer_flops_per_token(*args) == jtl.transformer_flops_per_token(*args)
    for args in ((100, 1.0, 5e9, 1e12), (100, 0.0, 5e9, 1e12), (16384, 0.35, 4.2e10, 989e12)):
        assert ttl.mfu(*args) == jtl.mfu(*args)
    assert ttl.COMPUTE_SPAN_NAMES == jtl.COMPUTE_SPAN_NAMES
    assert ttl.TRAIN_STAGES == jtl.TRAIN_STAGES


def test_perf_report_over_the_live_ring_equals_jax():
    for m in MONS:
        m.trace.enable()
        with m.trace.training_step(step=0) as ts:
            with ts.stage("forward"):
                pass
            with ts.stage("backward"):
                pass
    spans = [sp.to_dict() for sp in tmon.trace.spans()]
    got, want = ttl.perf_report(spans), jtl.perf_report(spans)
    got.pop("provenance"), want.pop("provenance")
    assert got == want
    live = ttl.perf_report()
    assert live["train"]["phases"]["steps"] == 1 and "serving" not in live
    assert live["provenance"]["platform"] in ("cpu", "gpu")


@pytest.mark.parametrize("name", ["modeled_step_timeline", "modeled_overlap_report"])
def test_modeled_schedule_raises_naming_item_10(name):
    with pytest.raises(NotImplementedError, match="Queue A item 10"):
        getattr(ttl, name)(object())


# -- SLO burn rates and alerts ---------------------------------------------------

class _Clock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t


def _pair(clock, **kw):
    kw.setdefault("fast_window_s", 10.0)
    kw.setdefault("slow_window_s", 100.0)
    kw.setdefault("burn_threshold", 2.0)
    kw.setdefault("min_events", 5)
    out = []
    for mod in (jslo, tslo):
        objs = [mod.Objective("avail", target=0.99),
                mod.Objective("ttft", target=0.95, threshold_ns=1_000_000)]
        out.append(mod.SLOTracker(objs, now_fn=clock, **kw))
    return out


def _rows(rows):
    return [{k: v for k, v in r.items()} for r in rows]


def _slo_metrics(m):
    doc = m.snapshot()["metrics"]
    return {k: doc[k]["values"] for k in ("paddle_tpu_monitor_slo_alerts_total",
                                          "paddle_tpu_monitor_slo_burn_rate") if k in doc}


@pytest.mark.parametrize("seed", range(4))
def test_tracker_equals_jax_under_one_clock(seed):
    """A drawn event stream (good and bad completions, latencies, tenants)
    over 300 s of a hand-moved clock: every burn rate, alert edge, scan row
    and status section equal JAX's, and so do the exported series."""
    rng = np.random.default_rng(seed)
    clock = _Clock(1000.0)
    pair = _pair(clock)
    for m in MONS:
        m.enable()
        m.trace.enable()
    for tick in range(60):
        clock.t = 1000.0 + 5.0 * tick
        burst = tick % 20 in (7, 8, 9)
        for _ in range(int(rng.integers(1, 12))):
            tenant = ["", "gold", "bronze"][int(rng.integers(0, 3))]
            good = bool(rng.random() > (0.6 if burst else 0.002))
            lat = int(rng.integers(100_000, 3_000_000 if burst else 1_050_000))
            for t in pair:
                t.record("avail", good=good, tenant=tenant)
                t.record("ttft", value=lat, tenant=tenant)
        rows = [_rows(t.scan()) for t in pair]
        assert rows[1] == rows[0]
        for obj in ("avail", "ttft"):
            for tenant in ("", "gold", "bronze"):
                for w in (10.0, 100.0):
                    assert pair[1].burn_rate(obj, w, tenant) == \
                        pair[0].burn_rate(obj, w, tenant)
                assert pair[1].is_alerting(obj, tenant) == pair[0].is_alerting(obj, tenant)
    assert pair[1].statusz() == pair[0].statusz()
    assert list(pair[1].alerts) == list(pair[0].alerts) and pair[1].alerts
    assert _slo_metrics(tmon) == _slo_metrics(jmon)
    names = [sp.name for sp in tmon.trace.spans()]
    assert names.count("monitor.slo_alert") == len(pair[1].alerts)


def test_objective_and_tracker_contract_equal_jax():
    for mod in (jslo, tslo):
        o = mod.Objective("ttft", target=0.99, threshold_ns=1000)
        assert o.classify(value=1000) is True and o.classify(value=1001) is False
        assert o.budget == pytest.approx(0.01)
        with pytest.raises(ValueError):
            mod.Objective("x", target=1.0)
        with pytest.raises(ValueError):
            mod.Objective("x", target=0.9).classify(value=5)
    j = [(o.name, o.target, o.threshold_ns) for o in jslo.serving_objectives()]
    t = [(o.name, o.target, o.threshold_ns) for o in tslo.serving_objectives()]
    assert t == j and len(t) == 3
    clock = _Clock(0.0)
    for trk in _pair(clock):
        with pytest.raises(ValueError):
            trk.record("nope", good=True)


def test_stale_series_dropped_with_their_gauges_as_jax():
    clock = _Clock(0.0)
    pair = _pair(clock)
    for m in MONS:
        m.enable()
    for i in range(12):
        for t in pair:
            t.record("avail", good=True, tenant=f"t{i}")
    for t in pair:
        t.scan()
    assert _slo_metrics(tmon) == _slo_metrics(jmon)
    g = tmon.registry.get("paddle_tpu_monitor_slo_burn_rate")
    assert len(g.children()) == 24
    clock.t = 500.0
    assert [t.scan() for t in pair] == [[], []]
    assert g.children() == [] and pair[1]._buckets == {}

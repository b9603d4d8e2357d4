"""The serving fleet's SLO tracking, burn-aware routing and fleet metrics in
the port (``FleetRouter(slo=..., burn_aware_routing=True)``,
``fleet_prometheus_text``, ``fleet_snapshot``, the ``/statusz`` and
``/metricsz`` providers, the rolling TTFT window) against the JAX package's:
both routers, neither started, under the hand-moved clock of
tests/test_torch_fleet.py (patched into both fleet modules and both SLO
modules), take the same submissions, steps, failures and scans; burn rates,
alerts, routing, the status section, the snapshot and the Prometheus
document (but for times, and with replica tags replaced by their indices)
equal JAX's after each phase."""
import re

import pytest

from paddle_tpu import monitor as jmon
from paddle_tpu.monitor import server as jobs
from paddle_tpu.monitor import slo as jslo
from paddle_tpu.serving import FleetRouter as JaxFleetRouter
from paddle_tpu.serving import fleet as jfleet_mod
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch.monitor import server as tobs
from paddle_tpu_torch.monitor import slo as tslo
from paddle_tpu_torch.serving import DOWN, FleetRouter
from paddle_tpu_torch.serving import fleet as fleet_mod
from test_torch_fleet import ENGINE, _Clock, _models, _prompts, _view

MONS = (jmon, tmon)


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


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    for mod in (jfleet_mod, fleet_mod, jslo, tslo):
        monkeypatch.setattr(mod, "time", c)
    return c


def _pair(clock, slo="custom", replicas=2, **kw):
    jm, tm = _models()
    out = []
    for cls, mod, model in ((JaxFleetRouter, jslo, jm), (FleetRouter, tslo, tm)):
        tracker = slo
        if slo == "custom":
            tracker = mod.SLOTracker(mod.serving_objectives(ttft_p99_ms=600_000.0),
                                     fast_window_s=10.0, slow_window_s=100.0,
                                     burn_threshold=2.0, min_events=2,
                                     now_fn=clock.monotonic)
        out.append(cls(model, replicas=replicas, engine_kwargs=dict(ENGINE), start=False,
                       max_new_tokens=5, slo=tracker, **kw))
    return out


def _steps(fl, n=1):
    """What the replica driver loops do, by hand on this thread."""
    # the JAX router threads its monitor handles through; the port's looks
    # them up
    extra = (jfleet_mod._mon(),) if isinstance(fl, JaxFleetRouter) else ()
    for _ in range(n):
        for rep in fl.replicas:
            if rep.state == DOWN:
                continue
            finished = rep.engine.step(fl._eos, fl._max_new)
            rep.steps += 1
            if finished:
                with fl._lock:
                    for rid, toks in finished:
                        fl._complete_locked(rep, rid, toks, *extra)


def _beat(fl):
    """Every replica heartbeats now (what its driver loop does each turn)."""
    for rep in fl.replicas:
        rep.heartbeat = fleet_mod.time.monotonic()


def _drain_all(fl, limit=60):
    for _ in range(limit):
        if not fl.num_inflight:
            return
        _steps(fl)
    raise AssertionError("fleet did not drain")


def _untimed(view):
    """_view with the measured TTFTs of aborted attempts and the recoveries'
    flight-dump paths (they hold the engine's tag and the process id)
    reduced to their presence."""
    view["ledger"] = {k: v[:3] + ({**v[3], "ttft_ns": "ttft_ns" in v[3]},) + v[4:]
                      for k, v in view["ledger"].items()}
    for eng in view["status"]["engines"]:
        if "last_recovery" in eng:
            eng["last_recovery"]["dump"] = bool(eng["last_recovery"]["dump"])
    return view


def _state(fl):
    """The router's whole state (test_torch_fleet.py's ``_view``), untimed,
    with the replica tags the SLO section holds as tenants replaced by their
    indices."""
    return _sub_tags(repr(_untimed(_view(fl))), _tags(fl))


def _tags(fl):
    return {rep.tag: f"r{rep.idx}" for rep in fl.replicas}


def _sub_tags(s, tags):
    for t, r in tags.items():
        s = re.sub(rf"\b{t}\b", r, s)
    return s


def _slo_view(fl):
    slo = fl._slo
    tags = _tags(fl)
    rows = [{k: (_sub_tags(v, tags) if isinstance(v, str) else v) for k, v in r.items()}
            for r in slo.scan()]
    series = sorted({(o, t) for o, t in slo._buckets})
    burns = {(o, _sub_tags(t, tags)): (slo.burn_rate(o, slo.fast_window_s, t),
                                       slo.burn_rate(o, slo.slow_window_s, t),
                                       slo.is_alerting(o, t))
             for o, t in series}
    st = slo.statusz()
    return dict(rows=rows, burns=burns,
                status=_sub_tags(repr(st), tags), alerts=_sub_tags(repr(list(slo.alerts)), tags))


_TIMED = re.compile(r"^paddle_tpu_\w+_(ns|seconds)(_bucket|_sum)")


def _prom(fl):
    """fleet_prometheus_text()'s sample lines without the op dispatch's series
    (the port's CPU programs run their ops eagerly, the JAX engine's are
    compiled), the time-valued histogram lines or the series at 0 (the
    registry also holds, at 0, what earlier code of the process registered),
    replica tags as indices."""
    tags = _tags(fl)
    keep = [line for line in fl.fleet_prometheus_text().splitlines()
            if line and not line.startswith("#") and "paddle_tpu_dispatch_" not in line
            and not _TIMED.match(line) and float(line.rsplit(" ", 1)[1]) != 0]
    return _sub_tags("\n".join(keep), tags)


def _snapshot(fl):
    doc = fl.fleet_snapshot()
    prov = doc.pop("provenance")
    assert prov["platform"] in ("cpu", "gpu", "uninitialized") or prov["platform"]
    fleet = doc.pop("fleet")
    metrics = {}
    for name, m in doc.pop("metrics").items():
        if name.startswith("paddle_tpu_dispatch_"):
            continue
        if m["type"] == "histogram":
            timed = re.search(r"_(ns|seconds)$", name)
            vals = {k: (v["count"] if timed else v) for k, v in m["values"].items()
                    if v["count"]}
        else:
            vals = {k: v for k, v in m["values"].items() if v}
        if vals:
            metrics[name] = vals
    return _sub_tags(repr((metrics, sorted(doc))), _tags(fl)), fleet


def test_burn_aware_routing_alerts_and_documents_equal_jax(clock):
    """Two replicas; replica 0 fails twice with its requests in flight (its
    per-replica completion burn alerts), the work fails over, replica 0 is
    resumed and the burn-aware router sends new work to replica 1 while
    replica 0 alerts; after each phase the SLO state, the router's state
    and the fleet's documents equal JAX's."""
    for m in MONS:
        m.enable()
        m.trace.enable()
    pair = _pair(clock, burn_aware_routing=True)
    phases = []

    def snap(label):
        got = []
        for fl in pair:
            doc, fleet = _snapshot(fl)
            got.append(dict(slo=_slo_view(fl), view=_state(fl), prom=_prom(fl), doc=doc,
                            inflight=[r.inflight for r in fl.replicas],
                            ttft=len(fl.recent_ttft_ms), arrivals=len(fl.recent_arrivals)))
        assert got[1] == got[0], label
        phases.append((label, got[1]))

    prompts = _prompts(31, 6, 9)
    for fl in pair:
        clock.t = 100.0
        for p in prompts[:4]:
            fl.submit(p, max_new_tokens=5)
        _steps(fl, 1)
    snap("routed")
    for fl in pair:
        clock.t = 100.0
        fl._fail_replica(fl.replicas[0], "drill one")
        fl.resume(0)
        for p in prompts[4:]:
            fl.submit(p, max_new_tokens=5)
        fl._fail_replica(fl.replicas[0], "drill two")
        clock.t = 101.5
        _beat(fl)
        fl._health_scan()
    snap("failed")
    r0 = pair[1].replicas[0].tag
    assert pair[1]._slo.is_alerting("completion", f"replica:{r0}")
    for fl in pair:
        clock.t = 101.5
        fl.resume(0)
        for p in prompts[:2]:
            fl.submit(p, max_new_tokens=5)
    snap("deprioritized")
    assert phases[-1][1]["inflight"][0] == 0
    for fl in pair:
        clock.t = 101.5
        _drain_all(fl)
        clock.t = 103.0
        _beat(fl)
        fl._health_scan()
    snap("drained")
    last = phases[-1][1]
    assert last["ttft"] == 8 and last["arrivals"] == 8
    assert any(a for a in last["slo"]["alerts"])
    assert "paddle_tpu_fleet_failovers_total" in last["prom"]
    assert 'replica="r0"' in last["prom"] and "paddle_tpu_monitor_slo_burn_rate" in last["prom"]
    assert tmon.trace.spans() and {"fleet.route", "fleet.failover", "fleet.health"} <= {
        s.name for s in tmon.trace.spans()}


def test_routing_without_burn_awareness_stays_least_depth(clock):
    pair = _pair(clock)
    got = []
    for fl in pair:
        assert fl.burn_aware_routing is False and fl._slo is not None
        for p in _prompts(32, 4, 8):
            fl.submit(p, max_new_tokens=4)
        fl._fail_replica(fl.replicas[0], "drill")
        fl.resume(0)
        fl.submit(_prompts(33, 1, 8)[0], max_new_tokens=4)
        got.append((_state(fl), _slo_view(fl)))
    assert got[1] == got[0]
    # without burn awareness no per-replica series is recorded at all
    assert not [k for k in got[1][1]["burns"] if k[1].startswith("replica:")]


def test_slo_true_builds_the_default_objectives(clock):
    pair = _pair(clock, slo=True)
    got = []
    for fl in pair:
        objs = [(o.name, o.target, o.threshold_ns) for o in fl._slo.objectives.values()]
        for p in _prompts(34, 3, 8):
            fl.submit(p, max_new_tokens=3)
        _drain_all(fl)
        st = fl.status()["slo"]
        burns = {o: fl._slo.burn_rate(o, fl._slo.slow_window_s)
                 for o in ("completion", "admission")}
        got.append((objs, sorted(st), burns, fl.status()["burn_aware_routing"]))
    assert got[1] == got[0]
    assert got[1][2] == {"completion": 0.0, "admission": 0.0}


def test_providers_register_and_documents_parse(clock):
    for m in MONS:
        m.enable()
    j, t = _pair(clock)
    for p in _prompts(35, 3, 8):
        t.submit(p, max_new_tokens=3)
    _drain_all(t)
    st = tobs.status_document()["providers"]["fleet"]
    assert st["requests_total"] == 3 and st["health"] == "ok" and "slo" in st
    text = tobs.metrics_text()
    for line in t.fleet_prometheus_text().splitlines():
        if line.startswith("#") or not line:
            continue
        name, val = line.rsplit(" ", 1)
        float(val.replace("+Inf", "inf"))
        assert re.match(r"^[a-z_][a-z0-9_]*(\{.*\})?$", name), line
    for rep in t.replicas:
        assert f'paddle_tpu_fleet_replica_steps_total{{replica="{rep.tag}"}}' in text
    assert t.fleet_snapshot()["fleet"]["requests_total"] == 3
    t.stop()
    assert "fleet" not in tobs.status_document()["providers"]
    t.start()
    try:
        assert "fleet" in tobs.status_document()["providers"]
    finally:
        t.stop()
    jobs.unregister_status_provider("fleet")
    jobs.unregister_metrics_provider("fleet")


def test_router_lock_and_ledger_are_witnessed(clock):
    from paddle_tpu_torch.analysis import sanitizers as tsan

    tsan.enable("race", "lock")
    try:
        fl = _pair(clock)[1]
        assert isinstance(fl._lock, tsan.SanitizedLock)
        fl.submit(_prompts(36, 1, 8)[0], max_new_tokens=2)
        _drain_all(fl)
        assert ("fleet" + fl._san_tag[5:], "_requests") in tsan.race_fields()
        assert tsan.trips() == []
    finally:
        tsan.disable()
        tsan.reset()

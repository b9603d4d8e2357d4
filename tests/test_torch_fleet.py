"""The serving fleet of the PyTorch port (paddle_tpu_torch/serving/fleet.py)
and the engine surface it drives, on the CPU, against the JAX package.

The cases of tests/test_serving_fleet.py: routing, the health state machine
and breaker, failover, hedging, drain and resume, scale_to, the engine knobs
and status, engine cancel, the abort-stats carry and the submit/recover/
withdraw races. The cases that run no thread build the JAX router and the
port's side by side (neither started), make the same calls on both under one
hand-moved clock, and compare the whole control state: status() (each
engine's without its tag), the transition log, the breaker's deadlines, the
ledger and every replica's books. The replica threads' timing is not
deterministic, so what a threaded case compares with the JAX package is the
final token streams: the JAX engine's undisturbed streams for the same
prompts (greedy streams do not depend on batching or placement). No case has
a speed floor; every wait has its own deadline.
"""
import time

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.analysis import faultinject as jfi
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import serving as jserving
from paddle_tpu.serving import FleetRouter as JaxFleetRouter
from paddle_tpu.serving import FleetUnavailable as JaxFleetUnavailable
from paddle_tpu.serving import fleet as jfleet_mod
from paddle_tpu_torch.analysis import faultinject as tfi
from paddle_tpu_torch.models import LlamaConfig, llama_from_numpy
from paddle_tpu_torch.models import serving as tserving
from paddle_tpu_torch.serving import (DOWN, HEALTHY, PARKED, SUSPECT, FleetRouter,
                                      FleetUnavailable)
from paddle_tpu_torch.serving import fleet as fleet_mod

KW = dict(vocab_size=96, hidden_size=64, intermediate_size=176, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)
ENGINE = dict(max_batch=2, block_size=8, chunk_size=16, decode_burst=1)
_MODELS = {}


@pytest.fixture(autouse=True)
def _clean_faults():
    jfi.reset()
    tfi.reset()
    yield
    jfi.reset()
    tfi.reset()


def _models():
    if not _MODELS:
        paddle.seed(0)
        jm = JaxLlama(JaxConfig(**KW))
        jm.eval()
        state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
        _MODELS["pair"] = (jm, llama_from_numpy(state, LlamaConfig(**KW), device="cpu"))
    return _MODELS["pair"]


def _prompts(seed, n, length):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, KW["vocab_size"], (length,)).astype(np.int32) for _ in range(n)]


def _fleet(replicas=2, start=True, engine_kwargs=None, **kw):
    kw.setdefault("max_new_tokens", 6)
    return FleetRouter(_models()[1], replicas=replicas,
                       engine_kwargs=dict(ENGINE, **(engine_kwargs or {})), start=start, **kw)


def _jax_streams(prompts, max_new):
    """The JAX engine's undisturbed greedy streams, stepped on this thread."""
    eng = jserving.ContinuousBatchingEngine(_models()[0], **ENGINE)
    rids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    done = {}
    for _ in range(500):
        for rid, toks in eng.step():
            done[rid] = [int(t) for t in toks]
        if not (eng.num_active or eng.num_pending):
            break
    return [done[r] for r in rids]


def _collect(fl, frids, deadline_s=60.0):
    got = {}
    t0 = time.monotonic()
    while len(got) < len(frids) and time.monotonic() - t0 < deadline_s:
        for frid, toks in fl.pop_results():
            got[frid] = [int(t) for t in toks]
        time.sleep(0.001)
    return [got.get(f) for f in frids]


# -- the JAX router beside the port's, no threads -------------------------------

class _Clock:
    """A monotonic clock that moves only when set or slept on. It stands in
    for ``time`` in both fleet modules, so the two routers read the same
    instants and a bounded wait (drain) ends without real sleeping."""

    def __init__(self, t=100.0):
        self.t = t

    def monotonic(self):
        return self.t

    def sleep(self, s):
        self.t += s

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(jfleet_mod, "time", c)
    monkeypatch.setattr(fleet_mod, "time", c)
    return c


# per package: (fault harness, typed outage, fleet module)
_SIDES = ((jfi, JaxFleetUnavailable, jfleet_mod), (tfi, FleetUnavailable, fleet_mod))


def _pair(replicas=2, engine_kwargs=None, **kw):
    """The JAX router and the port's over the same weights, neither started."""
    kw.setdefault("max_new_tokens", 6)
    ekw = dict(ENGINE, **(engine_kwargs or {}))
    jm, tm = _models()
    return (JaxFleetRouter(jm, replicas=replicas, engine_kwargs=ekw, start=False, **kw),
            FleetRouter(tm, replicas=replicas, engine_kwargs=ekw, start=False, **kw))


def _toks(x):
    return None if x is None else [int(t) for t in x]


def _engine_status(st):
    st = {k: v for k, v in st.items() if k != "engine"}
    if "last_recovery" in st:
        st["last_recovery"] = {k: v for k, v in st["last_recovery"].items() if k != "ms"}
    return st


def _att(a):
    return None if a is None else (None if a.rep is None else a.rep.idx, a.rid,
                                   _toks(a.prefix), a.hedge)


def _view(fl):
    """The router's whole control state, replica tags replaced by indices."""
    idx = {rep.tag: rep.idx for rep in fl.replicas}
    st = fl.status()
    for row in st["replicas"]:
        row["replica"] = idx[row["replica"]]
    st["engines"] = [_engine_status(st["engines"][rep.tag]) for rep in fl.replicas]
    return dict(
        status=st,
        log=[(idx[t], old, new, why) for t, old, new, why in fl.state_log],
        replicas=[dict(backoff_until=r.backoff_until, heartbeat=r.heartbeat,
                       rids=sorted(r.rid2att), cancelled=sorted(r.cancelled_rids),
                       unclaimed=[(rid, _toks(t)) for rid, t in r.unclaimed],
                       unclaimed_aborts=[(rid, _toks(t), s) for rid, t, s in r.unclaimed_aborts])
                  for r in fl.replicas],
        ledger={frid: (fr.done, _toks(fr.tokens), fr.failovers, dict(fr.stats_base),
                       _att(fr.primary), _att(fr.hedge)) for frid, fr in fl._requests.items()},
        results=[(frid, _toks(t)) for frid, t in fl._results],
        stranded=[_att(a) for a in fl._stranded])


def test_least_depth_round_robins_an_idle_fleet(clock):
    got = []
    for fl in _pair(replicas=3):
        frids = [fl.submit(p, max_new_tokens=4) for p in _prompts(0, 6, 8)]
        got.append((frids, _view(fl)))
    assert got[1] == got[0]
    assert [r["inflight"] for r in got[1][1]["status"]["replicas"]] == [2, 2, 2]
    assert [r["pending"] for r in got[1][1]["status"]["replicas"]] == [2, 2, 2]


def test_unavailable_when_nothing_admits_is_typed(clock):
    got = []
    for fl, (_fi, unavailable, _mod) in zip(_pair(), _SIDES):
        for rep in fl.replicas:
            rep.state = DOWN
        with pytest.raises(unavailable):
            fl.submit(np.arange(6, dtype=np.int32), max_new_tokens=4)
        got.append(_view(fl))
    assert got[1] == got[0]
    assert got[1]["status"]["health"] == "degraded"


def test_half_open_suspect_admits_exactly_one_probe(clock):
    got = []
    for fl, (_fi, unavailable, _mod) in zip(_pair(), _SIDES):
        fl.replicas[0].state = DOWN
        fl.replicas[1].state = SUSPECT
        p = np.arange(6, dtype=np.int32)
        fl.submit(p, max_new_tokens=4)
        with pytest.raises(unavailable):
            fl.submit(p, max_new_tokens=4)
        got.append(_view(fl))
    assert got[1] == got[0]
    assert [r["inflight"] for r in got[1]["status"]["replicas"]] == [0, 1]


def test_route_fault_surfaces_typed_then_routes(clock):
    got = []
    for fl, (fi, _unavailable, _mod) in zip(_pair(), _SIDES):
        fi.arm("fleet.route", action="raise", nth=1)
        with pytest.raises(fi.InjectedFault):
            fl.submit(np.arange(6, dtype=np.int32), max_new_tokens=4)
        frid = fl.submit(np.arange(6, dtype=np.int32), max_new_tokens=4)
        got.append((frid, fi.trips(), fl._affinity_hint(np.arange(4), fl.replicas),
                    _view(fl)))
    assert got[1] == got[0]
    assert got[1][:3] == (0, [("fleet.route", "raise")], None)


# -- the health state machine (scans by hand, on both routers) ------------------

def test_stale_heartbeat_suspects_then_heals(clock):
    got = []
    for fl in _pair(suspect_after_s=0.5):
        clock.t = 100.0
        rep = fl.replicas[0]
        fl.replicas[1].heartbeat = 109.9
        clock.t = 110.0
        fl._health_scan()
        mid = _view(fl)
        rep.heartbeat = clock.t
        fl._health_scan()
        got.append((mid, _view(fl)))
    assert got[1] == got[0]
    assert [(o, n) for t, o, n, _r in got[1][1]["log"] if t == 0] == [
        (HEALTHY, SUSPECT), (SUSPECT, HEALTHY)]
    assert got[1][0]["status"]["replicas"][0]["suspect_reason"] == "stale"


def test_backoff_elapse_opens_half_open_window(clock):
    got = []
    for fl in _pair():
        clock.t = 100.0
        rep = fl.replicas[1]
        rep.state, rep.failures, rep.backoff_until = DOWN, 1, 99.99
        fl._health_scan()
        got.append(_view(fl))
    assert got[1] == got[0]
    row = got[1]["status"]["replicas"][1]
    assert (row["state"], row["suspect_reason"]) == (SUSPECT, "probe")


def test_health_fault_trips_and_scanning_continues(clock):
    got = []
    for fl, (fi, _unavailable, _mod) in zip(_pair(), _SIDES):
        fi.arm("fleet.health", action="raise", nth=1)
        with pytest.raises(fi.InjectedFault):
            fl._health_scan()
        fl._health_scan()
        got.append((fi.trips(), _view(fl)))
    assert got[1] == got[0]
    assert got[1][0] == [("fleet.health", "raise")]


def test_breaker_backoff_is_capped_and_doubles(clock):
    got = []
    for fl in _pair(backoff_base_s=0.1, backoff_cap_s=0.3):
        clock.t = 100.0
        rep = fl.replicas[0]
        waits = []
        for _ in range(4):
            fl._fail_replica(rep, "drill")
            waits.append(rep.backoff_until - 100.0)
        down = _view(fl)
        fl.resume(0)
        got.append((waits, down, _view(fl)))
    assert got[1] == got[0]
    waits, down, resumed = got[1]
    assert waits == pytest.approx([0.1, 0.2, 0.3, 0.3])
    assert down["status"]["replicas"][0]["failures"] == 4
    assert down["status"]["engines"][0]["recoveries"] == 4
    assert resumed["status"]["replicas"][0]["state"] == HEALTHY


def test_hedge_budget_bounds_concurrent_duplicates(clock):
    got = []
    for fl, (_fi, _unavailable, mod) in zip(_pair(max_hedges=1), _SIDES):
        fl.hedge_after_s = 0.0
        for p in _prompts(6, 3, 8):
            fl.submit(p, max_new_tokens=4)
        if mod is jfleet_mod:
            fl._maybe_hedge(jfleet_mod._mon(), clock.t)
        else:
            fl._maybe_hedge(clock.t)
        got.append(_view(fl))
    assert got[1] == got[0]
    assert got[1]["status"]["hedges"] == 1


def test_cancel_bookkeeping_is_bounded_and_idempotent(clock):
    got = []
    for fl in _pair(replicas=1):
        rep = fl.replicas[0]
        for i in range(2000):
            rep.mark_cancelled(i)
        frid = fl.submit(np.arange(6, dtype=np.int32), max_new_tokens=2)
        att = fl._requests[frid].primary
        with fl._lock:
            twice = [fl._cancel_attempt_locked(rep, att.rid) for _ in range(2)]
        got.append((twice, len(rep.cancelled_rids), rep.engine._cancel_q and
                    list(rep.engine._cancel_q), _view(fl)))
    assert got[1] == got[0]
    assert got[1][:2] == ([True, False], 1024)
    assert got[1][3]["status"]["replicas"][0]["inflight"] == 0


def test_drain_and_scale_to_as_in_jax(clock):
    """drain() moves the queued work to the peer and parks the replica;
    scale_to() drains the highest-index replicas and resumes parked ones,
    clamped to [1, replicas]."""
    got = []
    for fl in _pair(replicas=3, engine_kwargs=dict(max_batch=1)):
        clock.t = 100.0
        for p in _prompts(7, 6, 10):
            fl.submit(p, max_new_tokens=6)
        res = fl.drain(0)
        drained = _view(fl)
        scaled = [fl.scale_to(n) for n in (3, 5, 2, 0, 2, 3)]
        res["replica"] = [rep.tag for rep in fl.replicas].index(res["replica"])
        got.append((res, drained, scaled, _view(fl)))
    assert got[1] == got[0]
    res, drained, scaled, final = got[1]
    assert res == {"replica": 0, "migrated": 2, "parked": True}
    assert [r["inflight"] for r in drained["status"]["replicas"]] == [0, 3, 3]
    assert scaled == [3, 3, 2, 1, 2, 3]
    assert final["status"]["drains"] == 3


def test_set_engine_knobs_and_status(clock):
    got = []
    for fl in _pair():
        fl.set_engine_knobs(decode_burst=3, max_queue=7)
        with pytest.raises(ValueError, match="unknown serving knob"):
            fl.set_engine_knobs(nope=1)
        staged = [dict(rep.engine._pending_knobs) for rep in fl.replicas]
        for rep in fl.replicas:
            rep.engine.step()                   # applied at the step boundary
        got.append((staged, _view(fl)))
    assert got[1] == got[0]
    staged, view = got[1]
    assert staged == [{"decode_burst": 3, "max_queue": 7}] * 2
    st = view["status"]
    assert st["health"] == "ok" and [r["state"] for r in st["replicas"]] == [HEALTHY] * 2
    assert [e["knobs"]["decode_burst"] for e in st["engines"]] == [3, 3]
    assert [e["knobs"]["max_queue"] for e in st["engines"]] == [7, 7]
    assert st["burn_aware_routing"] is False and st["inflight"] == 0


# -- failover, hedging, drain: the streams against the JAX engine's ------------

def test_killed_replica_fails_over_to_the_jax_streams_then_heals():
    prompts = _prompts(0, 9, 12)
    want = _jax_streams(prompts, 8)
    fl = _fleet(replicas=3, max_new_tokens=8, backoff_base_s=0.05)
    try:
        assert fl.warmup(prompts[0][:6])
        tfi.arm("fleet.replica_step", action="raise", nth=6)
        frids = [fl.submit(p, max_new_tokens=8) for p in prompts]
        out = _collect(fl, frids)
        stats = [fl.pop_stats(f) for f in frids]
        assert tfi.trips() == [("fleet.replica_step", "raise")]
        assert out == want
        assert fl.failovers >= 1
        moved = [s for s in stats if s and s["failovers"] >= 1]
        assert moved and all(s.get("ttft_ns", 0) > 0 for s in moved)
        dead = [rep for rep in fl.replicas if rep.engine.recovery_stats]
        assert len(dead) == 1
        assert (HEALTHY, DOWN) in [(o, n) for t, o, n, _r in fl.state_log if t == dead[0].tag]
        # the breaker: backoff elapses, a probe closes it, and a second wave
        # gives the same streams on the whole fleet
        t0 = time.monotonic()
        while dead[0].state == DOWN and time.monotonic() - t0 < 10:
            time.sleep(0.01)
        assert dead[0].state in (SUSPECT, HEALTHY)
        assert _collect(fl, [fl.submit(p, max_new_tokens=8) for p in prompts]) == want
        t0 = time.monotonic()
        while dead[0].state != HEALTHY and time.monotonic() - t0 < 10:
            _collect(fl, [fl.submit(prompts[0], max_new_tokens=4)], deadline_s=20)
        assert dead[0].state == HEALTHY
        assert (DOWN, SUSPECT) in [(o, n) for _t, o, n, _r in fl.state_log]
        # the warm restart kept the dead replica's programs
        assert dead[0].engine.status()["compiled_programs"] == 1
    finally:
        fl.stop()


def test_replica_hang_recovered_by_its_watchdog():
    prompts = _prompts(1, 4, 10)
    want = _jax_streams(prompts, 6)
    fl = _fleet(replicas=2, hang_timeout=0.2)
    try:
        assert fl.warmup(prompts[0][:6])
        tfi.arm("serving.step", action="delay", delay_s=1.0, nth=3)
        out = _collect(fl, [fl.submit(p, max_new_tokens=6) for p in prompts])
        assert out == want
        recs = [r for rep in fl.replicas for r in rep.engine.recovery_stats]
        assert any("hang" in r["reason"] for r in recs)
    finally:
        fl.stop()


def test_slow_primary_hedges_first_finisher_wins_loser_cancelled():
    prompt = _prompts(5, 1, 10)[0]
    want = _jax_streams([prompt], 6)[0]
    fl = _fleet(replicas=2, health_poll_s=0.01)
    try:
        fl.warmup(prompt[:6])
        assert _collect(fl, [fl.submit(prompt, max_new_tokens=6)]) == [want]
        fl.hedge_after_s = 0.05
        # one step of one attempt is delayed: the primary's second step, or
        # the hedge's first when the primary's prefill outlasts hedge_after_s.
        # The other attempt wins by the whole delay, so the loser is always
        # still running when its cancel lands (two delayed attempts can end
        # in the same step, and a finished loser has nothing to cancel)
        tfi.arm("serving.step", action="delay", delay_s=0.8, nth=2)
        frid = fl.submit(prompt, max_new_tokens=6)
        assert _collect(fl, [frid]) == [want]
        assert fl.hedges >= 1 and fl.pop_stats(frid)["hedged"] is True
        t0 = time.monotonic()
        while sum(r.engine.cancelled for r in fl.replicas) < 1 and time.monotonic() - t0 < 10:
            time.sleep(0.01)
        assert sum(r.engine.cancelled for r in fl.replicas) >= 1
        with fl._lock:
            assert not fl._requests
    finally:
        fl.stop()


def test_drain_migrates_queued_finishes_active_zero_lost():
    prompts = _prompts(7, 6, 10)
    want = _jax_streams(prompts, 6)
    fl = _fleet(start=False, engine_kwargs=dict(max_batch=1))
    try:
        frids = [fl.submit(p, max_new_tokens=6) for p in prompts]
        assert fl.replicas[0].inflight == 3
        res = fl.drain(0)
        assert res["parked"] is True and res["migrated"] == 3
        assert [r.inflight for r in fl.replicas] == [0, 6]
        assert fl.states()[fl.replicas[0].tag] == PARKED
        fl.start()
        assert _collect(fl, frids) == want
        fl.resume(0)
        assert fl.states()[fl.replicas[0].tag] == HEALTHY
        assert _collect(fl, [fl.submit(prompts[0], max_new_tokens=6)]) == want[:1]
    finally:
        fl.stop()


def test_drain_mid_decode_and_scale_to():
    prompts = _prompts(8, 4, 10)
    want = _jax_streams(prompts, 10)
    fl = _fleet(max_new_tokens=10)
    try:
        fl.warmup(prompts[0][:6])
        frids = [fl.submit(p, max_new_tokens=10) for p in prompts]
        res = fl.drain(1, timeout=30.0)
        assert res["parked"] is True
        assert _collect(fl, frids) == want
        assert fl.drains == 1 and fl.active_replicas() == 1
        assert fl.scale_to(2) == 2 and fl.scale_to(5) == 2
        assert fl.scale_to(1) == 1 and fl.states()[fl.replicas[1].tag] == PARKED
        assert fl.scale_to(2) == 2
    finally:
        fl.stop()


# -- engine-level satellites: cancel, the abort stats ---------------------------

def _both_engines(**kw):
    jm, tm = _models()
    kw = dict(dict(max_batch=1, block_size=8, chunk_size=16, decode_burst=1), **kw)
    return (jserving.ContinuousBatchingEngine(jm, **kw),
            tserving.ContinuousBatchingEngine(tm, **kw))


def _run(eng, max_steps=60):
    done = {}
    for _ in range(max_steps):
        for rid, toks in eng.step():
            done[rid] = [int(t) for t in toks]
        if not (eng.num_active or eng.num_pending):
            break
    return done


def test_cancel_queued_active_and_unknown_as_in_jax():
    got = []
    for eng in _both_engines(max_batch=2, prefix_cache=False):
        free0 = len(eng._pager._free)
        p = np.arange(9, dtype=np.int32)
        rids = [eng.submit(p, max_new_tokens=3), eng.add_request(p, max_new_tokens=50),
                eng.submit(p, max_new_tokens=3)]
        eng.cancel(rids[2])                    # queued
        eng.step()
        eng.step()
        eng.cancel(rids[1])                    # active
        eng.cancel(12345)                      # unknown
        done = _run(eng)
        eng.cancel(rids[0])                    # finished: its result stands
        assert eng.step() == []
        got.append((done, eng.cancelled, eng.num_active, eng.num_pending,
                    len(eng._pager._free) == free0))
    assert got[1] == got[0]
    assert got[1][0].keys() == {0} and got[1][1] == 2 and got[1][4]


@pytest.mark.parametrize("steps,chunk", [(4, 16), (1, 4)], ids=["after_first_token", "mid_prefill"])
def test_request_aborted_carries_partial_stats_as_in_jax(steps, chunk):
    got = []
    for eng in _both_engines(max_batch=2, chunk_size=chunk):
        rid = eng.add_request(np.arange(20 if chunk == 4 else 10, dtype=np.int32),
                              max_new_tokens=20)
        for _ in range(steps):
            eng.step()
        assert eng.recover("drill") == 1
        (err,) = eng.pop_aborted()
        st = {k: v for k, v in err.stats.items() if k not in ("submit_ns", "ttft_ns")}
        got.append((err.rid == rid, list(err.tokens), err.tenant, st, "ttft_ns" in err.stats,
                    eng.pop_stats(rid), eng.num_active, str(err).split(":")[0]))
    assert got[1] == got[0]


# -- the submit/withdraw races, deterministically --------------------------------

def test_unrecorded_abort_claimed_and_reseeded(clock):
    got = []
    for fl, (_fi, _unavailable, mod) in zip(_pair(), _SIDES):
        rep0 = fl.replicas[0]
        with fl._lock:
            absorbed = fl._absorb_abort_locked(rep0, 7, [5, 6], None)
        parked = _view(fl)
        fr = mod._FleetRequest(0, np.arange(4, dtype=np.int32), 6, "", 0)
        att = mod._Attempt(fr, prefix=(), hedge=False)
        fr.primary = att
        orig = rep0.engine.submit
        rep0.engine.submit = lambda *a, **k: 7
        try:
            fl._submit_attempt(att, rep=rep0)
        finally:
            rep0.engine.submit = orig
        new = fr.primary
        got.append((absorbed, parked, new is not att, _att(new), fr.failovers,
                    new.rep.rid2att[new.rid] is new, _view(fl)))
    assert got[1] == got[0]
    absorbed, parked, moved, new, failovers, mapped, view = got[1]
    assert absorbed == [] and parked["replicas"][0]["unclaimed_aborts"] == [(7, [5, 6], None)]
    assert moved and new[2] == [5, 6] and failovers == 1 and mapped
    assert not view["replicas"][0]["unclaimed_aborts"]
    assert view["status"]["failovers"] == 1
    assert sum(r["inflight"] for r in view["status"]["replicas"]) == 1


def test_unrecorded_abort_of_cancelled_rid_dropped(clock):
    got = []
    for fl in _pair(replicas=1):
        rep = fl.replicas[0]
        rep.mark_cancelled(9)
        with fl._lock:
            absorbed = fl._absorb_abort_locked(rep, 9, [1], None)
        got.append((absorbed, _view(fl)))
    assert got[1] == got[0]
    assert got[1][0] == [] and got[1][1]["replicas"][0]["unclaimed_aborts"] == []
    assert got[1][1]["replicas"][0]["cancelled"] == []


def test_done_request_not_reinserted_into_ledger(clock):
    got = []
    for fl in _pair(replicas=1):
        rep = fl.replicas[0]
        rep.unclaimed.append((3, [9, 9]))
        orig = rep.engine.submit
        rep.engine.submit = lambda *a, **k: 3
        try:
            frid = fl.submit(np.arange(4, dtype=np.int32))
        finally:
            rep.engine.submit = orig
        got.append((frid, _view(fl), [(f, _toks(t)) for f, t in fl.pop_results()],
                    fl.num_inflight))
    assert got[1] == got[0]
    frid, view, results, inflight = got[1]
    assert results == [(frid, [9, 9])] and inflight == 0 and view["ledger"] == {}

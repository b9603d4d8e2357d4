"""Fault injection and the hang watchdog of the PyTorch port
(paddle_tpu_torch/analysis/faultinject.py, distributed/watchdog.py) against
the JAX package's, on the CPU, and the serving drills they exist for.

- The harness: the same arm/fire scripts on both modules give the same
  returns, exceptions and ``trips()``; environment specs parse alike.
- The watchdog: one timeout callback per stuck section, a bounded history.
- The drills, at every fault point the engine fires: the same injected fault
  in the same schedule through both packages' engines gives the same
  finished token streams (and the typed error where JAX raises one).
- The threaded drills (the killed driving thread, the hang recovered by the
  watchdog): their timing is not deterministic, so their final token
  streams are compared to the JAX engine's undisturbed streams.

The model is tests/test_serving.py's (vocab 96, hidden 64, 2 layers), its
weights carried to the port by ``llama_from_numpy``.
"""
import threading
import time
import warnings

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.analysis import faultinject as jfi
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import serving as jserving
from paddle_tpu_torch.analysis import faultinject as tfi
from paddle_tpu_torch.distributed.watchdog import CommWatchdog
from paddle_tpu_torch.models import LlamaConfig, llama_from_numpy
from paddle_tpu_torch.models import serving as tserving

KW = dict(vocab_size=96, hidden_size=64, intermediate_size=176, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)
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


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, KW["vocab_size"], n).astype(np.int32)


# -- the harness --------------------------------------------------------------

def _fires(fi, point, n):
    out = []
    for _ in range(n):
        try:
            sp = fi.fire(point)
            out.append(None if sp is None else sp.action)
        except Exception as e:   # noqa: BLE001 - compared across packages
            out.append((type(e).__name__, getattr(e, "point", None)))
    return out


def _nth(fi):
    fi.arm("serving.step", action="flag", nth=3)
    return _fires(fi, "serving.step", 5)


def _times(fi):
    fi.arm("paged_kv.ensure", action="flag", nth=2, times=2)
    return _fires(fi, "paged_kv.ensure", 6)


def _prob(fi):
    fi.arm("radix.digest", action="flag", prob=0.5, seed=7)
    return _fires(fi, "radix.digest", 32)


def _raise_and_delay(fi):
    fi.arm("serving.drive", action="raise", nth=2)
    fi.arm("serving.admission", action="delay", delay_s=0.001)
    out = _fires(fi, "serving.drive", 3) + _fires(fi, "serving.admission", 2)
    return out + [sorted(fi.armed().items())]


def _disarm(fi):
    fi.arm("serving.step", action="flag")
    fi.arm("fleet.route", action="raise")
    fi.disarm("serving.step")
    out = [fi.enabled(), _fires(fi, "serving.step", 1), _fires(fi, "fleet.route", 1)]
    fi.disarm("fleet.route")
    return out + [fi.enabled(), fi.armed(), _fires(fi, "fleet.route", 1)]


def _off(fi):
    return [fi.enabled(), _fires(fi, "serving.step", 2)]


@pytest.mark.parametrize("script", [_nth, _times, _prob, _raise_and_delay, _disarm, _off],
                         ids=lambda f: f.__name__.strip("_"))
def test_same_script_same_trips(script):
    assert script(tfi) == script(jfi)
    assert tfi.trips() == jfi.trips()


def test_unknown_point_and_action_raise_alike():
    for fi in (jfi, tfi):
        with pytest.raises(ValueError, match="unknown fault point"):
            fi.arm("serving.nope")
        with pytest.raises(ValueError, match="unknown action"):
            fi.arm("serving.step", action="explode")


def test_port_points_are_jax_points():
    assert set(tfi.POINTS) <= set(jfi.POINTS) and tfi.ACTIONS == jfi.ACTIONS


@pytest.mark.parametrize("spec", [
    "serving.drive:raise:nth=12;paged_kv.cow:flag:prob=0.5,seed=7",
    "serving.nope:raise;serving.step:frobnicate;serving.step:raise:nth=x;"
    "serving.step:delay:delay_s=0.01",
    "",
], ids=["good", "bad_parts", "empty"])
def test_install_from_env_alike(spec):
    got = {}
    for name, fi in (("jax", jfi), ("torch", tfi)):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            points = fi.install_from_env(spec)
        got[name] = (points, fi.armed(), fi.enabled(), len(w))
        fi.reset()
    assert got["torch"] == got["jax"]


def test_install_from_env_reads_the_variable(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FAULTS", "fleet.health:delay:delay_s=0.5")
    assert tfi.install_from_env() == ("fleet.health",)
    assert tfi.armed() == {"fleet.health": ("delay", 0)}


# -- the watchdog --------------------------------------------------------------

def test_watchdog_fires_once_per_stuck_section():
    seen = []
    dog = CommWatchdog(timeout=0.05, on_timeout=lambda desc, dump: seen.append((desc, dump)),
                       max_history=2)
    try:
        with dog.watch("stuck"):
            deadline = time.monotonic() + 5.0
            while not seen and time.monotonic() < deadline:
                time.sleep(0.01)
            time.sleep(0.2)              # several more ticks: still one call
        assert [d for d, _ in seen] == ["stuck"] and "(IN FLIGHT)" in seen[0][1]
        for i in range(3):
            with dog.watch(f"quick{i}"):
                pass
        assert [d for d, _s, _e in dog.events] == ["quick1", "quick2"]
        assert dog.timed_out == ["stuck"] and dog.last_flight_dump is None
        assert "(done)" in dog.dump() and "IN FLIGHT" not in dog.dump()
    finally:
        dog.stop()
    assert not dog._scanner.is_alive()


def test_watchdog_survives_a_failing_callback(capsys):
    calls = []

    def boom(desc, dump):
        calls.append(desc)
        raise RuntimeError("callback failed")

    dog = CommWatchdog(timeout=0.03, on_timeout=boom)
    try:
        for name in ("a", "b"):
            with dog.watch(name):
                deadline = time.monotonic() + 5.0
                while name not in calls and time.monotonic() < deadline:
                    time.sleep(0.01)
        assert calls == ["a", "b"]      # the scanner outlived the first raise
    finally:
        dog.stop()
    assert "callback failed" in capsys.readouterr().err


# -- the drills, step by step against JAX --------------------------------------

def _engine(pkg, **kw):
    jm, tm = _models()
    kw = dict(dict(max_batch=4, block_size=8, chunk_size=16), **kw)
    mod = jserving if pkg == "jax" else tserving
    return mod.ContinuousBatchingEngine(jm if pkg == "jax" else tm, **kw)


def _run_all(eng, max_steps=200, **step_kw):
    done = {}
    for _ in range(max_steps):
        for rid, toks in eng.step(**step_kw):
            done[rid] = [int(t) for t in toks]
        if not (eng.num_active or eng.num_pending):
            break
    return done


def _drill_step_raise(pkg, fi):
    eng = _engine(pkg)
    prompt = _prompt(2, 11)
    rid = eng.add_request(prompt, max_new_tokens=5)
    ref = _run_all(eng)[rid]
    fi.arm("serving.step", action="raise", nth=2)
    rid = eng.add_request(prompt, max_new_tokens=5)
    with pytest.raises(fi.InjectedFault):
        _run_all(eng)
    hits = eng.prefix_cache.hits
    assert eng.recover("step drill") == 1
    (err,) = eng.pop_aborted()
    rid2 = eng.add_request(prompt, max_new_tokens=5)
    out = _run_all(eng)[rid2]
    return ref, out, err.rid == rid, list(err.tokens), eng.prefix_cache.hits > hits


def _drill_cow(pkg, fi):
    eng = _engine(pkg)
    prompt = _prompt(3, 16)               # block-aligned: the repeat full-hits
    rid = eng.add_request(prompt, max_new_tokens=4)
    ref = _run_all(eng)[rid]
    fi.arm("paged_kv.cow", action="flag", nth=1)
    rid = eng.add_request(prompt, max_new_tokens=4)
    return ref, _run_all(eng)[rid]


def _drill_ensure_relief(pkg, fi):
    eng = _engine(pkg)
    prompt = _prompt(4, 11)
    rid = eng.add_request(prompt, max_new_tokens=5)
    ref = _run_all(eng)[rid]
    fi.arm("paged_kv.ensure", action="flag", nth=1)
    rid = eng.add_request(prompt, max_new_tokens=5)
    return ref, _run_all(eng)[rid], len(eng.prefix_cache)


def _drill_ensure_no_cache(pkg, fi):
    eng = _engine(pkg, prefix_cache=False)
    fi.arm("paged_kv.ensure", action="flag", nth=1)
    eng.add_request(np.arange(9, dtype=np.int32), max_new_tokens=4)
    with pytest.raises(RuntimeError, match="injected fault") as ei:
        _run_all(eng)
    return type(ei.value).__name__, list(eng._pager._free)


def _drill_digest(pkg, fi):
    eng = _engine(pkg)
    prompt = _prompt(5, 17)
    rid = eng.add_request(prompt, max_new_tokens=5)
    ref = _run_all(eng)[rid]
    c0 = eng.prefix_cache.collisions
    fi.arm("radix.digest", action="flag", nth=1)
    rid = eng.add_request(prompt, max_new_tokens=5)
    return ref, _run_all(eng)[rid], eng.prefix_cache.collisions - c0


def _drill_admission(pkg, fi):
    eng = _engine(pkg)
    fi.arm("serving.admission", action="delay", delay_s=0.01, nth=1)
    rid = eng.add_request(_prompt(6, 11), max_new_tokens=5)
    return _run_all(eng)[rid]


def _drill_spec_verify(pkg, fi):
    eng = _engine(pkg, max_batch=2, max_step_tokens=12, spec_lookahead=4, pool_blocks=40)
    prompt = np.tile(_prompt(7, 5), 4)
    fi.arm("serving.spec_verify", action="flag", prob=0.5, seed=3)
    rids = [eng.add_request(prompt, max_new_tokens=12) for _ in range(2)]
    out = _run_all(eng)
    return [out[r] for r in rids], eng.spec_drafted, eng.spec_accepted


@pytest.mark.parametrize("drill", [
    _drill_step_raise, _drill_cow, _drill_ensure_relief, _drill_ensure_no_cache,
    _drill_digest, _drill_admission, _drill_spec_verify,
], ids=lambda f: f.__name__[len("_drill_"):])
def test_drill_matches_jax(drill):
    want = drill("jax", jfi)
    jtrips = jfi.trips()
    got = drill("torch", tfi)
    assert got == want
    assert tfi.trips() == jtrips and jtrips


def test_drills_reach_their_paths():
    """What each drill is named for, on the port: the recovery hit the warm
    cache, the spec fault left drafting on the other steps, the digest
    corruption counted one collision."""
    ref, out, same_rid, partial, warm = _drill_step_raise("torch", tfi)
    assert out == ref and same_rid and warm
    tfi.reset()
    _ref, _out, collisions = _drill_digest("torch", tfi)
    assert collisions == 1
    tfi.reset()
    _outs, drafted, accepted = _drill_spec_verify("torch", tfi)
    assert drafted > 0 and accepted > 0


# -- the threaded drills ---------------------------------------------------------

def _reference(prompts, max_new, **kw):
    """The JAX engine's undisturbed streams, stepped on this thread."""
    eng = _engine("jax", **kw)
    rids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    done = _run_all(eng)
    return [done[r] for r in rids]


def _collect(eng, prompts, max_new, deadline_s=60.0):
    """Driver-mode collector: resubmit each aborted request; the streams in
    prompt order and the number of aborts."""
    cur = {eng.submit(p, max_new_tokens=max_new, timeout=10.0): i for i, p in enumerate(prompts)}
    out, aborted = {}, 0
    t0 = time.monotonic()
    while len(out) < len(prompts) and time.monotonic() - t0 < deadline_s:
        for rid, toks in eng.pop_results():
            if rid in cur:
                out[cur.pop(rid)] = [int(t) for t in toks]
        for err in eng.pop_aborted():
            i = cur.pop(err.rid)
            aborted += 1
            cur[eng.submit(prompts[i], max_new_tokens=max_new, timeout=10.0)] = i
        time.sleep(0.001)
    return [out.get(i) for i in range(len(prompts))], aborted


def test_killed_driver_recovers_warm_with_the_jax_streams():
    prompts = [_prompt(10 + i, 12) for i in range(4)]
    want = _reference(prompts, 8)
    eng = _engine("torch")
    pc = eng.prefix_cache
    tfi.arm("serving.drive", action="raise", nth=4)
    eng.start_driver()
    try:
        hits0 = pc.hits
        out, aborted = _collect(eng, prompts, 8)
    finally:
        eng.stop_driver()
    assert tfi.trips() == [("serving.drive", "raise")]
    assert out == want
    assert aborted >= 1 and len(eng.recovery_stats) == 1
    rec = eng.recovery_stats[0]
    assert "serving.drive" in rec["reason"] and not rec["cold"] and rec["dump"] is None
    assert pc.hits > hits0                # the resubmissions hit the warm cache
    assert eng.status()["recoveries"] == 1 and not eng.status()["driver_alive"]


def test_hang_recovered_by_the_watchdog_with_the_jax_streams():
    prompts = [_prompt(20 + i, 9) for i in range(3)]
    want = _reference(prompts, 6)
    eng = _engine("torch")
    eng.add_request(_prompt(19, 9), max_new_tokens=6)   # both programs built first
    _run_all(eng)
    tfi.arm("serving.step", action="delay", delay_s=1.0, nth=2)
    eng.start_driver(hang_timeout=0.2)
    try:
        out, _aborted = _collect(eng, prompts, 6)
    finally:
        eng.stop_driver()
    assert out == want
    assert any("hang" in rec["reason"] for rec in eng.recovery_stats)
    assert eng._dog is None and eng._epoch >= 1


def test_start_driver_is_idempotent_and_stops_clean():
    eng = _engine("torch", max_batch=2, max_len=32)
    eng.start_driver(max_new_tokens=3)
    first = eng._driver
    eng.start_driver(max_new_tokens=3)
    assert eng._driver is first
    try:
        out, _ = _collect(eng, [np.arange(5, dtype=np.int32)], 3)
    finally:
        eng.stop_driver()
    assert len(out[0]) == 3 and eng._driver is None and not first.is_alive()


def test_blocked_submitter_survives_recovery():
    """A caller blocked in submit()'s bounded queue while the driving thread
    dies and recovers gets admitted on the warm restart (or a typed error),
    never a leaked slot or a hung caller (tests/test_serving_fleet.py:493)."""
    eng = _engine("torch", max_batch=1, decode_burst=1, max_queue=1, prefix_cache=False)
    free0 = len(eng._pager._free)
    p = np.arange(9, dtype=np.int32)
    eng.start_driver()
    out = {}
    try:
        rid1 = eng.submit(p, max_new_tokens=6, timeout=10.0)
        t0 = time.monotonic()
        while eng.num_pending and time.monotonic() - t0 < 10:
            time.sleep(0.001)
        rid2 = eng.submit(p, max_new_tokens=6, timeout=10.0)

        def blocked():
            try:
                out["rid"] = eng.submit(p, max_new_tokens=6, timeout=20.0)
            except tserving.AdmissionTimeout as e:
                out["err"] = e

        th = threading.Thread(target=blocked)
        th.start()
        tfi.arm("serving.drive", action="raise", nth=3)
        tracked = {rid1: None, rid2: None}
        t0 = time.monotonic()
        while time.monotonic() - t0 < 30:
            for rid, toks in eng.pop_results():
                if rid in tracked:
                    tracked[rid] = toks
            for err in eng.pop_aborted():
                if err.rid in tracked and tracked[err.rid] is None:
                    del tracked[err.rid]
                    tracked[eng.submit(p, max_new_tokens=6, timeout=10.0)] = None
            if "rid" in out and out["rid"] not in tracked:
                tracked[out["rid"]] = None
            if all(v is not None for v in tracked.values()) and ("rid" in out or "err" in out):
                break
            time.sleep(0.001)
        th.join(timeout=30)
        assert not th.is_alive() and ("rid" in out or "err" in out)
        assert len(eng.recovery_stats) == 1
        assert all(v is not None for v in tracked.values())
    finally:
        eng.stop_driver()
    assert eng.num_active == 0 and eng.num_pending == 0
    assert len(eng._pager._free) == free0

"""The port's runtime sanitizers (``paddle_tpu_torch/analysis/sanitizers.py``,
``numerics.py``) against the JAX package's: tests/test_sanitizers.py's
scripts run on both packages give the same trips (lock-order inversion, a
blocked wait under a lock, a recompile storm through ``to_static``, the race
witness, numsan with the drill naming the same region), with the same
telemetry (counter, span, flight dump). The port's host-sync tripwire is a
``TorchDispatchMode`` pushed only while a protected region or a ``train.``/
``serving.`` span is open: ``.item()``, ``float()``, ``int()`` and ``bool()``
inside one trip, ``allow_host_sync()`` passes, and with the sanitizer off no
mode is ever pushed."""
import glob
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu import monitor as jmon
from paddle_tpu.analysis import faultinject as jfi
from paddle_tpu.analysis import numerics as jnum
from paddle_tpu.analysis import sanitizers as jsan
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch.analysis import faultinject as tfi
from paddle_tpu_torch.analysis import numerics as tnum
from paddle_tpu_torch.analysis import sanitizers as tsan
from paddle_tpu_torch.device import _CURRENT

SIDES = {"jax": (jsan, jmon, jfi, J), "torch": (tsan, tmon, tfi, T)}
BOTH = pytest.mark.parametrize("pkg", ["jax", "torch"])


@pytest.fixture(autouse=True)
def _clean():
    before = _CURRENT[0]
    T.set_device("cpu")
    for san, mon, fi, _p in SIDES.values():
        san.disable()
        san.reset()
        san.set_recompile_threshold(8)
        mon.disable()
        mon.trace.disable()
        mon.reset()
        fi.reset()
    yield
    _CURRENT[0] = before
    for san, mon, fi, _p in SIDES.values():
        san.disable()
        san.reset()
        san.set_recompile_threshold(8)
        mon.disable()
        mon.trace.disable()
        mon.reset()
        fi.reset()
    assert torch._C._len_torch_dispatch_stack() == 0


def _kinds(san):
    return [k for k, _m in san.trips()]


# -- enable plumbing ---------------------------------------------------------------

@pytest.mark.parametrize("spec", ["", "all", "1", "lock,race", "hostsync, numerics",
                                  "recompile"])
def test_install_from_env_as_jax(spec):
    got = []
    for san in (jsan, tsan):
        san.disable()
        kinds = san.install_from_env(spec)
        got.append((kinds, san.enabled(), [san.enabled(k) for k in san._KINDS]))
        san.disable()
    assert got[1] == got[0]


def test_unknown_kinds_warn_or_raise_as_jax():
    for san in (jsan, tsan):
        with pytest.warns(UserWarning, match="unknown sanitizer"):
            assert san.install_from_env("lock,bogus") == ("lock",)
        san.disable()
        with pytest.raises(ValueError):
            san.enable("bogus")
        with pytest.raises(ValueError):
            san.enabled("bogus")
    assert tsan._KINDS == jsan._KINDS


# -- the lock-order witness ---------------------------------------------------------

def _inversion(san):
    san.enable("lock")
    a = san.new_lock("engine_lock")
    b = san.new_lock("pager_lock")
    with a:
        with b:
            pass
    with pytest.raises(san.LockOrderInversion) as ei:
        with b:
            with a:
                pass
    return str(ei.value)


def test_lock_inversion_trips_as_jax():
    msgs = {pkg: _inversion(SIDES[pkg][0]) for pkg in SIDES}
    for pkg, msg in msgs.items():
        san = SIDES[pkg][0]
        assert "engine_lock" in msg and "pager_lock" in msg
        assert msg.count("_inversion") >= 2
        assert _kinds(san) == ["lock"]
    assert msgs["torch"].splitlines()[0] == msgs["jax"].splitlines()[0]


@BOTH
def test_consistent_order_silent_and_wait_under_lock_trips(pkg):
    san = SIDES[pkg][0]
    san.enable("lock")
    a, b = san.new_lock("outer_lock"), san.new_lock("inner_lock")
    for _ in range(20):
        with a:
            with b:
                pass
    assert ("outer_lock", "inner_lock") in san.lock_order_edges() and san.trips() == []
    san.check_wait("queue_get")
    with pytest.raises(san.BlockingWaitUnderLock, match="queue_get"):
        with a:
            san.check_wait("queue_get")


def test_witness_raises_instead_of_deadlocking():
    tsan.enable("lock")
    a = tsan.new_lock("held_lock")
    b = tsan.new_lock("wanted_lock")
    with a:
        with b:
            pass
    holding, release = threading.Event(), threading.Event()

    def hog():
        with a:
            holding.set()
            release.wait(5)

    t = threading.Thread(target=hog, daemon=True)
    t.start()
    assert holding.wait(5)
    t0 = time.monotonic()
    try:
        with pytest.raises(tsan.LockOrderInversion):
            with b:
                a.acquire()
    finally:
        release.set()
        t.join(5)
    assert time.monotonic() - t0 < 2.0


def test_new_lock_plain_when_off_and_known_locks_wrapped():
    from paddle_tpu_torch.monitor import server, trace

    assert not isinstance(tsan.new_lock("x"), tsan.SanitizedLock)
    tsan.enable("lock")
    lk = tsan.new_lock("x")
    assert isinstance(lk, tsan.SanitizedLock) and lk.acquire() and lk.locked()
    lk.release()
    assert not lk.locked() and lk.acquire(False)
    lk.release()
    for lock in (tmon._sample_lock, trace._open_lock, server._lock, tfi._lock,
                 tmon.registry._lock):
        assert isinstance(lock, tsan.SanitizedLock), lock


# -- the recompile sentinel -----------------------------------------------------------

def _storm(pkg):
    san, _mon, _fi, P = SIDES[pkg]
    san.enable("recompile")
    san.set_recompile_threshold(4)

    def f(x):
        return x * 2

    kw = {"backend": "aot_eager"} if pkg == "torch" else {}
    g = P.jit.to_static(f, **kw)
    with pytest.raises(san.RecompileStorm) as ei:
        for n in range(2, 12):
            g(P.to_tensor(np.ones(n, "float32")))
    return str(ei.value), san.compile_counts()


def test_recompile_storm_through_to_static_as_jax():
    torch._dynamo.reset()
    got = {pkg: _storm(pkg) for pkg in SIDES}
    torch._dynamo.reset()
    for pkg, (msg, counts) in got.items():
        assert "to_static.f" in msg and "compiled 5 times" in msg
        assert "Recent signatures" in msg
        assert _kinds(SIDES[pkg][0]) == ["recompile"]
    assert got["torch"][1] == got["jax"][1] == {"to_static.f": 5}


def test_stable_loop_silent_and_disabled_counts_nothing_as_jax():
    torch._dynamo.reset()
    counts = {}
    for pkg, (san, _mon, _fi, P) in SIDES.items():
        kw = {"backend": "aot_eager"} if pkg == "torch" else {}

        def g(x):
            return x + 1

        h = P.jit.to_static(g, **kw)
        for n in range(2, 4):
            h(P.to_tensor(np.ones(n, "float32")))       # off: nothing counted
        assert san.compile_counts() == {}
        san.enable("recompile")
        for _ in range(10):
            h(P.to_tensor(np.ones(7, "float32")))
        counts[pkg] = san.compile_counts()
        assert san.trips() == []
    torch._dynamo.reset()
    assert counts["torch"] == counts["jax"] == {"to_static.g": 1}


def test_graph_broken_captures_are_counted():
    """A ``full_graph=False`` signature's captured graphs count under
    ``sot.<name>`` (the JAX package counts its segment variants there)."""
    torch._dynamo.reset()
    tsan.enable("recompile")

    def h(x):
        if float(x.sum()) > 100.0:
            return x * 2
        return x - 1

    f = T.jit.to_static(h, full_graph=False, backend="aot_eager")
    with pytest.warns(UserWarning, match="graph break"):
        f(T.to_tensor(np.full(3, 1.0, "float32")))
    counts = tsan.compile_counts()
    torch._dynamo.reset()
    assert counts["to_static.h"] == 1 and counts["sot.h"] >= 2


def test_threshold_validation_as_jax():
    for san in (jsan, tsan):
        with pytest.raises(ValueError):
            san.set_recompile_threshold(0)
        san.set_recompile_threshold(2)
        assert san.recompile_threshold() == 2


# -- the race witness ---------------------------------------------------------------

def _on_thread(san, fn):
    box = {}

    def body():
        try:
            fn()
        except san.DataRace as e:
            box["err"] = e

    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(5)
    return box.get("err")


def _race_script(san):
    san.enable("race")
    route_lock = san.new_lock("route_lock")
    stats_lock = san.new_lock("stats_lock")

    def write():
        with route_lock:
            san.race_access("eng1", "_stats", write=True)

    assert _on_thread(san, write) is None

    def read():
        with stats_lock:
            san.race_access("eng1", "_stats")

    read()
    err = _on_thread(san, write)
    san.race_access("eng1", "_stats", write=True)      # one report, no cascade
    lk = san.new_lock("shared_lock")
    # all three alive at once: a thread that ended may hand its ident to the
    # next one, which the witness would take for the same thread
    together = threading.Barrier(3)

    def disciplined():
        together.wait(5)
        for _ in range(50):
            with lk:
                san.race_access("eng2", "_jobs", write=True)
        together.wait(5)

    threads = [threading.Thread(target=disciplined) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(5)
    san.race_access("eng3", "_config")
    _on_thread(san, lambda: san.race_access("eng3", "_config"))
    return err, san.race_fields()


def test_race_witness_trips_as_jax():
    got = {pkg: _race_script(SIDES[pkg][0]) for pkg in SIDES}
    for pkg, (err, fields) in got.items():
        san = SIDES[pkg][0]
        msg = str(err)
        assert isinstance(err, san.DataRace)
        assert "data race on '_stats' of 'eng1'" in msg
        assert "(held ['stats_lock'])" in msg and "(held ['route_lock'])" in msg
        assert _kinds(san) == ["race"]
    assert got["torch"][1] == got["jax"][1]
    assert got["torch"][1][("eng2", "_jobs")] == ("shared_mod", ["shared_lock"])
    assert got["torch"][1][("eng3", "_config")] == ("shared", None) or \
        got["torch"][1][("eng3", "_config")][0] == "shared"


def test_engine_and_fleet_locks_are_sanitized_under_race():
    from paddle_tpu_torch.checkpoint import CheckpointManager  # noqa: F401
    from paddle_tpu_torch.distributed.watchdog import CommWatchdog

    tsan.enable("race")
    dog = CommWatchdog(timeout=5)
    assert isinstance(dog._lock, tsan.SanitizedLock)
    slo = tmon.slo.SLOTracker(tmon.slo.serving_objectives())
    assert isinstance(slo._lock, tsan.SanitizedLock)


# -- numsan --------------------------------------------------------------------------

def _regions(pkg, nan_in=None, value=float("nan")):
    toks = np.zeros((8, 4), np.int32)
    kv = np.ones((16, 32), np.float32)
    if nan_in is not None:
        kv.reshape(-1)[nan_in] = value
    if pkg == "jax":
        return (("tokens", jnp.asarray(toks)), ("kv_pools", [(jnp.asarray(kv),)]))
    return (("tokens", torch.from_numpy(toks)), ("kv_pools", [(torch.from_numpy(kv),)]))


@pytest.mark.parametrize("value", [float("nan"), float("inf"), -float("inf")])
def test_numsan_trips_naming_step_and_region_as_jax(value):
    msgs = {}
    for pkg, (san, _m, _f, _p) in SIDES.items():
        san.enable("numerics")
        san.numsan_check("serving.mixed_step", _regions(pkg), step=1)
        with pytest.raises(san.NumericsTrip) as ei:
            san.numsan_check("serving.decode_burst", _regions(pkg, 37, value), step=7)
        msgs[pkg] = str(ei.value)
        assert san.numsan_counts() == {"serving.mixed_step": 1, "serving.decode_burst": 1}
        assert _kinds(san) == ["numerics"]
    assert msgs["torch"].split(" — ")[0] == msgs["jax"].split(" — ")[0]
    assert "first non-finite region is 'kv_pools'" in msgs["torch"]
    assert "step 7" in msgs["torch"]


def test_numsan_disabled_issues_nothing_and_int_leaves_skip():
    tsan.numsan_check("serving.mixed_step", _regions("torch", 3), step=1)
    assert tsan.numsan_counts() == {}
    big = torch.full((4,), 2 ** 30, dtype=torch.int32)
    assert tnum.all_finite((big, torch.zeros(2, dtype=torch.int8), torch.zeros(0)))
    huge = torch.full((1000,), 3e38, dtype=torch.float32)   # a sum would overflow
    assert tnum.all_finite(huge) and jnum.all_finite(jnp.asarray(huge.numpy()))
    bf = torch.ones(5, dtype=torch.bfloat16)
    assert tnum.all_finite(bf)
    bf[2] = float("inf")
    assert not tnum.all_finite(bf)
    c = torch.ones(3, dtype=torch.complex64)
    c[1] = complex(0, float("nan"))
    assert not tnum.all_finite(c)


@pytest.mark.parametrize("seed", [0, 1])
def test_numsan_drill_names_the_seeded_region_as_jax(seed, tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path))
    got = {}
    for pkg, (san, mon, fi, _p) in SIDES.items():
        mon.enable()
        mon.trace.enable()
        san.enable("numerics")
        regions = _regions(pkg)
        before = [np.asarray(regions[0][1]).copy(), np.asarray(regions[1][1][0][0]).copy()]
        fi.arm("numsan.check", action="flag", seed=seed)
        with pytest.raises(san.NumericsTrip) as ei:
            san.numsan_check("mesh.train_step", regions, step=3)
        assert np.array_equal(np.asarray(regions[0][1]), before[0])
        assert np.array_equal(np.asarray(regions[1][1][0][0]), before[1])
        (sp,) = [s for s in mon.trace.spans() if s.name == "monitor.numsan_trip"]
        got[pkg] = (str(ei.value).split(" — ")[0], sp.attrs, fi.trips(),
                    mon.registry.get("paddle_tpu_monitor_sanitizer_trips_total")
                    .labels("numerics").value,
                    mon.registry.get("paddle_tpu_monitor_numsan_checks_total")
                    .labels("mesh.train_step").value,
                    mon.registry.get("paddle_tpu_monitor_fault_injections_total")
                    .labels("numsan.check").value)
        fi.reset()
        mon.trace.reset()
    assert got["torch"] == got["jax"]
    assert got["torch"][1]["region"] == ["tokens", "kv_pools"][seed]
    dumps = glob.glob(os.path.join(str(tmp_path), "paddle_tpu_flight_rank*_pid*.json"))
    assert dumps
    doc = json.load(open(dumps[0]))
    assert doc["reason"].startswith("graftsan numerics trip:")


def test_numsan_reads_one_bool_a_device():
    """The combined check reads back once for a device's leaves, inside
    allow_host_sync: a hostsync region around it does not trip."""
    reads = []
    orig = torch.Tensor.__bool__

    def counting(self):
        reads.append(self.shape)
        return orig(self)

    tsan.enable("numerics", "hostsync")
    regions = (("a", torch.ones(3)), ("b", [torch.ones(4, 4), torch.zeros(2)]))
    torch.Tensor.__bool__ = counting
    try:
        with tsan.protected_region("serving.step"):
            tsan.numsan_check("serving.mixed_step", regions, step=1)
    finally:
        torch.Tensor.__bool__ = orig
    assert reads == [torch.Size([])] and tsan.trips() == []


# -- the host-sync tripwire ------------------------------------------------------------

@pytest.mark.parametrize("read", ["item", "float", "int", "bool"])
def test_host_reads_trip_inside_a_training_span_only(read):
    fn = {"item": lambda t: t.item(), "float": float, "int": int, "bool": bool}[read]
    tsan.enable("hostsync")
    tmon.trace.enable()
    x = torch.ones(())
    fn(x)                                           # outside: silent
    with tmon.trace.training_step(step=0) as ts:
        with ts.stage("forward"):
            with pytest.raises(tsan.HostSyncInProtectedRegion, match="train.forward"):
                fn(x)
    fn(x)
    assert _kinds(tsan) == ["hostsync"]
    assert torch._C._len_torch_dispatch_stack() == 0


def test_tripwire_as_jax_in_spans_and_regions():
    """The same script on both packages: a read in a serving span and a
    protected region trips, in an unprotected span does not, and an
    allowed read passes."""
    got = {}
    for pkg, (san, mon, _fi, P) in SIDES.items():
        san.enable("hostsync")
        mon.trace.enable()
        x = P.to_tensor(np.ones((2,), "float32"))
        outcome = []

        def attempt(region):
            try:
                float(P.sum(x))
                outcome.append((region, "ok"))
            except san.HostSyncInProtectedRegion as e:
                outcome.append((region, "trip", "'" + region + "'" in str(e)))

        with mon.trace.span("serving.step"):
            attempt("serving.step")
            with san.allow_host_sync():
                attempt("allowed")
        with mon.trace.span("jit.compile"):
            attempt("jit.compile")
        with san.protected_region("custom.loop"):
            attempt("custom.loop")
        mon.trace.disable()
        with san.protected_region("untraced.loop"):
            attempt("untraced.loop")
        got[pkg] = (outcome, _kinds(san))
    assert got["torch"] == got["jax"]
    assert [o[1] for o in got["torch"][0]] == ["trip", "ok", "ok", "trip", "trip"]


def test_tripwire_pushed_only_while_on_and_in_a_region():
    assert torch._C._len_torch_dispatch_stack() == 0
    with tsan.protected_region("serving.step"):
        assert torch._C._len_torch_dispatch_stack() == 0     # off: no mode
        torch.ones(()).item()
    tsan.enable("hostsync")
    with tsan.protected_region("outer"):
        with tsan.protected_region("inner"):
            assert torch._C._len_torch_dispatch_stack() == 1  # one mode for the nest
        assert torch._C._len_torch_dispatch_stack() == 1
    assert torch._C._len_torch_dispatch_stack() == 0
    tmon.trace.enable()
    with tmon.trace.span("serving.request"):
        assert torch._C._len_torch_dispatch_stack() == 1
        with tmon.trace.span("dispatch.op"):
            assert torch._C._len_torch_dispatch_stack() == 1
    with tmon.trace.span("jit.compile"):
        assert torch._C._len_torch_dispatch_stack() == 0
    with tsan.protected_region("r"):
        tsan.disable("hostsync")        # a disable inside the region still pops
    assert torch._C._len_torch_dispatch_stack() == 0


def test_tripwire_leaves_results_unchanged_and_ops_run():
    """Ops inside a protected region compute what they compute outside (the
    mode calls each op unchanged), autograd included."""
    tsan.enable("hostsync")
    w = torch.randn(4, 4, generator=torch.Generator().manual_seed(0), requires_grad=True)
    x = torch.randn(3, 4, generator=torch.Generator().manual_seed(1))

    def step():
        y = torch.relu(x @ w).sum()
        y.backward()
        g = w.grad.clone()
        w.grad = None
        return y.detach(), g

    want = step()
    with tsan.protected_region("train.step"):
        got = step()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert tsan.trips() == []


def test_card_reads_are_classified(monkeypatch):
    """The reads that wait for the card (a copy to the host, an op whose
    output size depends on a CUDA tensor's values, a boolean-mask index):
    classified by the mode as on the card, with ``is_cuda`` faked here."""
    tsan.enable("hostsync")
    x = torch.arange(6.0)
    mask = x > 2
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    cases = {
        "copy": lambda: x.to("cpu", copy=True),
        "nonzero": lambda: torch.nonzero(x),
        "masked_select": lambda: torch.masked_select(x, mask),
        "bool_index": lambda: x[mask],
        "unique": lambda: torch.unique(x),
    }
    for name, fn in cases.items():
        with tsan.protected_region("serving.step"):
            with pytest.raises(tsan.HostSyncInProtectedRegion):
                fn()
            with tsan.allow_host_sync():
                fn()
    with tsan.protected_region("serving.step"):
        x[torch.tensor([1, 2])]              # an integer index: no read
        x * 2
    assert _kinds(tsan) == ["hostsync"] * len(cases)


def test_trip_exports_counter_span_and_flight_dump(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path))
    tmon.enable()
    tsan.enable("hostsync")
    with pytest.raises(tsan.HostSyncInProtectedRegion):
        with tsan.protected_region("serving.step"):
            torch.ones(()).item()
    assert tmon.registry.get("paddle_tpu_monitor_sanitizer_trips_total") \
        .labels("hostsync").value == 1
    dumps = glob.glob(os.path.join(str(tmp_path), "paddle_tpu_flight_*.json"))
    assert dumps and json.load(open(dumps[0]))["reason"].startswith("graftsan hostsync trip:")
    tmon.disable()
    tmon.trace.enable()
    with pytest.raises(tsan.HostSyncInProtectedRegion):
        with tmon.trace.span("serving.step"):
            torch.ones(()).item()
    assert [s.name for s in tmon.trace.spans()][-2:] == ["monitor.sanitizer_trip",
                                                         "serving.step"]


def test_amp_debugging_shares_the_numerics_check(monkeypatch):
    from paddle_tpu_torch.amp import debugging as dbg

    calls = []
    orig = tnum.all_finite
    monkeypatch.setattr(tnum, "all_finite", lambda t: calls.append(1) or orig(t))
    dbg.enable_tensor_checker(dbg.TensorCheckerConfig(enable=True))
    try:
        x = T.to_tensor(np.array([1.0, 0.0], "float32"))
        with pytest.raises(FloatingPointError, match="log"):
            T.log(T.subtract(x, x))
    finally:
        dbg.disable_tensor_checker()
    assert calls

"""The port's debug server (``paddle_tpu_torch/monitor/server.py``) on
127.0.0.1 against the JAX package's: lifecycle (no socket or thread until
``serve``; ``install_from_env`` with ``PADDLE_TPU_DEBUG_PORT``), every
endpoint (``/healthz``, ``/statusz``, ``/metricsz``, ``/tracez``,
``/flightz``, ``/perfz``, ``/controlz``, and a 404), the provider registries
(weak, latest wins, a raising provider gives an error section), a serving
engine's own section, the ``obs.scrape`` drill, and ``tools/obs_probe.py``
run as a subprocess: exit 0 against the port's server, 1 with a provider
that votes down, 2 with nothing listening."""
import gc
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from paddle_tpu.monitor import server as jobs
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch.analysis import faultinject as tfi
from paddle_tpu_torch.analysis import sanitizers as tsan
from paddle_tpu_torch.monitor import server as obs

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean():
    obs.shutdown()
    tmon.disable()
    tmon.trace.disable()
    tmon.reset()
    tfi.reset()
    yield
    obs.shutdown()
    tmon.disable()
    tmon.trace.disable()
    tmon.reset()
    tfi.reset()


def _get(port, path, timeout=10.0):
    url = f"http://127.0.0.1:{port}{path}"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            body, code = resp.read().decode(), resp.status
            ctype = resp.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        body, code = e.read().decode(), e.code
        ctype = e.headers.get("Content-Type", "")
    return code, (json.loads(body) if "json" in ctype else body)


def _server_threads():
    return [t for t in threading.enumerate() if t.name == "paddle-tpu-graftscope"]


def test_fully_off_then_serve_idempotent_then_torn_down():
    assert not obs.serving() and obs.port() is None and not _server_threads()
    p = obs.serve()
    assert obs.serve() == p == obs.port() and obs.serving()
    assert len(_server_threads()) == 1
    obs.shutdown()
    obs.shutdown()
    assert not obs.serving() and not _server_threads()
    assert obs.ENDPOINTS == jobs.ENDPOINTS


def test_install_from_env():
    assert obs.install_from_env("") is None and not obs.serving()
    with pytest.warns(UserWarning, match="not started"):
        assert obs.install_from_env("not-a-port") is None
    p = obs.install_from_env("0")
    assert p and obs.port() == p


def test_every_endpoint_answers(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path))
    tmon.enable()
    tmon.trace.enable()
    with tmon.trace.training_step(step=0) as ts:
        with ts.stage("forward"):
            pass
    hung = tmon.trace.start_span("comm.wait", attrs={"desc": "x"})
    p = obs.serve()
    code, health = _get(p, "/healthz")
    assert code == 200 and health["ok"] is True
    code, st = _get(p, "/statusz")
    assert code == 200 and st["monitor"] == {"metrics_enabled": True, "tracing_enabled": True,
                                             "open_spans": 1}
    assert set(st) == set(jobs.status_document()) and st["sanitizers"]["trips"] == []
    assert tmon.validate_provenance(st["provenance"]) == []
    code, text = _get(p, "/metricsz")
    assert code == 200 and "# TYPE paddle_tpu_monitor_scrapes_total counter" in text
    code, tr = _get(p, "/tracez?tail=2")
    assert code == 200 and len(tr["spans"]) == 2 and tr["tracing_enabled"]
    assert [s["name"] for s in tr["open_spans"]] == ["comm.wait"]
    code, fl = _get(p, "/flightz")
    assert code == 200 and os.path.exists(fl["path"]) and fl["reason"] == \
        "graftscope /flightz scrape"
    assert [s["name"] for s in fl["open_spans"]] == ["comm.wait"]
    code, perf = _get(p, "/perfz")
    assert code == 200 and perf["train"]["phases"]["steps"] == 1
    code, ctl = _get(p, "/controlz")
    assert code == 200 and ctl == {"controllers": {}} == jobs.control_document()
    code, nf = _get(p, "/nope")
    assert code == 404 and nf["endpoints"] == list(obs.ENDPOINTS)
    tmon.trace.end_span(hung)
    scrapes = tmon.snapshot()["metrics"]["paddle_tpu_monitor_scrapes_total"]["values"]
    assert scrapes["endpoint=other"] == 1 and scrapes["endpoint=/healthz"] == 1
    assert "monitor.scrape" in {s.name for s in tmon.trace.spans()}


def test_providers_vote_register_and_prune():
    p = obs.serve()
    obs.register_status_provider("sick", lambda: {"health": "down"})
    obs.register_status_provider("boom", lambda: 1 / 0)
    code, h = _get(p, "/healthz")
    assert code == 503 and h["unhealthy"] == ["boom", "sick"]
    st = obs.status_document()["providers"]
    assert st["boom"]["health"] == "error" and "ZeroDivisionError" in st["boom"]["error"]
    obs.register_status_provider("sick", lambda: {"health": "ok"})     # latest wins
    obs.unregister_status_provider("boom")
    assert _get(p, "/healthz")[0] == 200

    class Owner:
        def status(self):
            return {"health": "ok", "x": 1}

        def metrics(self):
            return "# TYPE my_metric gauge\nmy_metric 3\n"

        def control(self):
            return {"decisions": []}

    o = Owner()
    obs.register_status_provider("owner", o.status)
    obs.register_metrics_provider("owner", o.metrics)
    obs.register_control_provider("ctl", o.control)
    assert obs.status_document()["providers"]["owner"]["x"] == 1
    assert "my_metric 3" in _get(p, "/metricsz")[1]
    assert _get(p, "/controlz")[1] == {"controllers": {"ctl": {"decisions": []}}}
    obs.unregister_status_provider("owner", fn=lambda: None)     # another fn: kept
    assert "owner" in obs.status_document()["providers"]
    del o
    gc.collect()
    assert "owner" not in obs.status_document()["providers"]
    assert "my_metric" not in obs.metrics_text()
    assert obs.control_document() == {"controllers": {}}
    obs.unregister_status_provider("sick")


def test_a_serving_engine_registers_its_section():
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.serving import ContinuousBatchingEngine

    cfg = LlamaConfig(vocab_size=32, hidden_size=16, intermediate_size=32,
                      num_hidden_layers=1, num_attention_heads=2)
    eng = ContinuousBatchingEngine(LlamaForCausalLM(cfg, device="cpu"), max_batch=2,
                                   max_len=32, block_size=8, chunk_size=8)
    eng.add_request(np.arange(5, dtype=np.int32))
    while eng.num_active:
        eng.step(max_new_tokens=3)
    key = f"serving.{eng._tag}"
    sec = obs.status_document()["providers"][key]
    assert sec == json.loads(json.dumps(eng.status()))
    assert sec["health"] == "ok" and sec["compiled_programs"] >= 1
    del eng, sec
    gc.collect()
    # engines of other tests in this process may still live: this one's
    # section goes with it
    assert key not in obs.status_document()["providers"]


def test_scrape_drill_answers_503_and_leaves_the_rest(tmp_path, monkeypatch):
    p = obs.serve()
    tfi.arm("obs.scrape", action="flag", nth=1)
    code, body = _get(p, "/statusz")
    assert code == 503 and body["point"] == "obs.scrape"
    assert _get(p, "/statusz")[0] == 200
    tfi.arm("obs.scrape", action="raise", nth=1)
    assert _get(p, "/healthz")[0] == 503
    assert tfi.trips() == [("obs.scrape", "flag"), ("obs.scrape", "raise")]


def test_scrapes_under_every_sanitizer_trip_nothing():
    tsan.enable()
    try:
        obs.shutdown()
        tmon.enable()
        p = obs.serve()
        errs = []

        def scrape():
            try:
                for path in ("/metricsz", "/statusz", "/healthz", "/tracez"):
                    assert _get(p, path)[0] == 200
            except BaseException as e:  # noqa: BLE001
                errs.append(e)

        def write():
            for _ in range(200):
                tmon.counter("paddle_tpu_fleet_requests_total").inc()

        threads = [threading.Thread(target=scrape) for _ in range(3)] + \
            [threading.Thread(target=write) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not errs and tsan.trips() == []
    finally:
        obs.shutdown()
        tsan.disable()
        tsan.reset()


def _probe(*args):
    return subprocess.run([sys.executable, str(ROOT / "tools" / "obs_probe.py"), *args],
                          capture_output=True, text=True, timeout=60)


def test_obs_probe_exit_codes_against_the_port():
    p = obs.serve()
    out = _probe("--port", str(p))
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("HEALTHY")
    out = _probe("--port", str(p), "--json")
    doc = json.loads(out.stdout)
    assert out.returncode == 0 and doc["ok"] is True and doc["healthz_status"] == 200
    obs.register_status_provider("sick", lambda: {"health": "down"})
    try:
        out = _probe("--port", str(p), "--json")
        assert out.returncode == 1, out.stdout + out.stderr
        assert json.loads(out.stdout)["unhealthy"] == ["sick"]
    finally:
        obs.unregister_status_provider("sick")
    obs.shutdown()
    out = _probe("--port", str(p))
    assert out.returncode == 2 and "UNREACHABLE" in out.stdout


def test_debug_port_env_starts_the_server_at_import(tmp_path):
    code = ("import paddle_tpu_torch as P, urllib.request, json; "
            "from paddle_tpu_torch.monitor import server; "
            "p = server.port(); "
            "d = json.loads(urllib.request.urlopen(f'http://127.0.0.1:{p}/healthz').read()); "
            "print(d['ok'], P.analysis.sanitizers.enabled('race'), "
            "P.analysis.faultinject.armed())")
    env = dict(os.environ, PYTHONPATH=str(ROOT), PADDLE_TPU_DEBUG_PORT="0",
               PADDLE_TPU_SANITIZE="race", PADDLE_TPU_FAULTS="fleet.health:delay:nth=3")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "True", "{'fleet.health':", "('delay',", "0)}"]

"""graftscope: the live introspection plane — a stdlib-only per-process
debug HTTP endpoint over the monitor/trace/timeline/SLO stack.

Until now every telemetry consumer needed code IN the process
(``monitor.snapshot()`` / ``span_dump()`` / ``flight_dump()``); this
module is the outside-in door: one ``http.server`` thread serving

========== ===========================================================
endpoint   payload
========== ===========================================================
/metricsz  Prometheus text: the process registry plus every registered
           METRICS provider's document (the fleet appends its
           replica-labeled series, so an N-replica fleet scrapes as
           one target)
/statusz   JSON: provenance, monitor/tracing enable states, graftsan
           sanitizer states + trip tail, armed fault points + trip
           tail, and one section per registered STATUS provider (the
           serving engines, FleetRouter, MeshTrainer, checkpoint
           manager register themselves)
/tracez    the open spans + a bounded recent-span tail from the trace
           ring (``?tail=N``, default 128)
/flightz   triggers a flight dump (same writer the watchdog uses) and
           returns the written document + its path
/perfz     ``timeline.perf_report()``: train-step phase breakdown,
           bubble fraction, comm overlap, serving TTFT decomposition
/controlz  JSON: one section per registered CONTROL provider — the
           graftpilot controller's decision record (telemetry snapshot
           read, rule fired, knob old→new, outcome per tick; see
           docs/control.md)
/healthz   200 when every provider reports ``health: ok`` (503
           otherwise) — the ``tools/obs_probe.py`` liveness contract
========== ===========================================================

Discipline (the same one-slot rules as the rest of the monitor stack):

- **fully off by default** — no listening socket, no thread, nothing
  registered in a hot path; ``serve()`` (or
  ``PADDLE_TPU_DEBUG_PORT=<port>`` at process start, via
  ``install_from_env`` at the end of package init) is the only way a
  socket appears, and ``shutdown()`` tears it down completely;
- **never the engine's problem** — handlers only READ host-side state
  (no jax dispatch, no engine locks); a raising status provider
  contributes an ``error`` section, never a 500 for the others; the
  ``obs.scrape`` fault point (flag ⇒ 503) drills that a failing scrape
  plane leaves serving provably untouched
  (tests/test_obs_server.py under ``PADDLE_TPU_SANITIZE=all``);
- **weak provider registry** — bound-method providers are held via
  ``weakref.WeakMethod`` and pruned when their object dies, so the N-th
  engine of a long test session never leaks through the registry.

See docs/introspection.md for the endpoint/provider contracts.
"""
from __future__ import annotations

import json
import threading
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..analysis import faultinject as _fi

__all__ = [
    "serve", "shutdown", "serving", "port", "install_from_env",
    "register_status_provider", "unregister_status_provider",
    "register_metrics_provider", "unregister_metrics_provider",
    "register_control_provider", "unregister_control_provider",
    "status_document", "health_document", "metrics_text",
    "control_document", "ENDPOINTS",
]

ENDPOINTS = ("/metricsz", "/statusz", "/tracez", "/flightz", "/perfz",
             "/controlz", "/healthz")

_lock = threading.Lock()        # guards the module singletons below
_server = None
_thread = None
_status_providers = {}          # name -> WeakMethod | callable
_metrics_providers = {}
_control_providers = {}


# -- provider registry -------------------------------------------------------

def _ref(fn):
    """Bound methods are held weakly (an engine/router/trainer must be
    collectable while registered); plain callables are held strongly."""
    if hasattr(fn, "__self__"):
        return weakref.WeakMethod(fn)
    return fn


def _resolve(providers):
    """[(name, callable)] of the live providers, pruning dead weakrefs."""
    with _lock:
        items = list(providers.items())
    out, dead = [], []
    for name, ref in items:
        fn = ref() if isinstance(ref, weakref.WeakMethod) else ref
        if fn is None:
            dead.append((name, ref))
        else:
            out.append((name, fn))
    if dead:
        with _lock:
            for name, ref in dead:
                # prune only if the slot still holds THIS dead ref — a
                # re-registration under the same name between snapshot
                # and prune must survive
                if providers.get(name) is ref:
                    providers.pop(name)
    return out


def register_status_provider(name, fn):
    """Register one ``/statusz`` section: ``fn()`` -> JSON-able dict
    (include ``"health": "ok"`` to vote in ``/healthz``). Re-registering
    a name replaces it (latest wins)."""
    with _lock:
        _status_providers[str(name)] = _ref(fn)


def unregister_status_provider(name, fn=None):
    """Remove a section. With ``fn`` given, removes only if the
    registered provider still resolves to that callable — a replaced
    registration is left alone."""
    _unregister(_status_providers, name, fn)


def register_metrics_provider(name, fn):
    """Register one ``/metricsz`` appendix: ``fn()`` -> Prometheus text
    (series the process registry does not carry, e.g. the fleet's
    replica-labeled document)."""
    with _lock:
        _metrics_providers[str(name)] = _ref(fn)


def unregister_metrics_provider(name, fn=None):
    _unregister(_metrics_providers, name, fn)


def register_control_provider(name, fn):
    """Register one ``/controlz`` section: ``fn()`` -> the controller's
    JSON-able decision record (``Controller.controlz``). Same weak-ref
    lifetime rules as the status registry — a collected controller
    unregisters itself."""
    with _lock:
        _control_providers[str(name)] = _ref(fn)


def unregister_control_provider(name, fn=None):
    _unregister(_control_providers, name, fn)


def _unregister(providers, name, fn):
    with _lock:
        ref = providers.get(str(name))
        if ref is None:
            return
        if fn is not None:
            cur = ref() if isinstance(ref, weakref.WeakMethod) else ref
            if cur is not None and cur != fn:
                return
        providers.pop(str(name), None)


# -- documents ---------------------------------------------------------------

def status_document():
    """The ``/statusz`` document (also usable in-process)."""
    from .. import monitor as _m
    from ..analysis import sanitizers as _san

    doc = {
        "provenance": _m.provenance(),
        "monitor": {
            "metrics_enabled": _m.enabled(),
            "tracing_enabled": _m.trace.enabled(),
            "open_spans": len(_m.trace.open_spans()),
        },
        "sanitizers": {
            "lock": _san.enabled("lock"),
            "recompile": _san.enabled("recompile"),
            "hostsync": _san.enabled("hostsync"),
            "trips": [list(t) for t in _san.trips()[-16:]],
        },
        "faults": {
            "armed": {p: list(v) for p, v in _fi.armed().items()},
            "trips": [list(t) for t in _fi.trips()[-16:]],
        },
        "providers": {},
    }
    for name, fn in _resolve(_status_providers):
        try:
            doc["providers"][name] = fn()
        except Exception as e:  # noqa: BLE001 - one bad section must not
            # take down the whole status plane
            doc["providers"][name] = {
                "error": f"{type(e).__name__}: {e}", "health": "error"}
    return doc


def health_document():
    """The ``/healthz`` verdict: a provider section votes unhealthy by
    reporting ``health`` other than ok/healthy (or by raising)."""
    doc = status_document()
    unhealthy = sorted(
        name for name, sec in doc["providers"].items()
        if isinstance(sec, dict)
        and sec.get("health", "ok") not in ("ok", "healthy"))
    return {"ok": not unhealthy, "unhealthy": unhealthy,
            "providers": sorted(doc["providers"])}


def control_document():
    """The ``/controlz`` document: one section per registered control
    provider (empty ``controllers`` when no controller is wired — the
    endpoint exists either way, so probes can distinguish "no
    controller" from "no graftscope")."""
    doc = {"controllers": {}}
    for name, fn in _resolve(_control_providers):
        try:
            doc["controllers"][name] = fn()
        except Exception as e:  # noqa: BLE001 - one bad controller must
            # not take down the decision-record plane
            doc["controllers"][name] = {
                "error": f"{type(e).__name__}: {e}"}
    return doc


def metrics_text():
    """The ``/metricsz`` exposition: the process registry plus every
    metrics provider's appendix."""
    from .. import monitor as _m

    parts = [_m.prometheus_text()]
    for name, fn in _resolve(_metrics_providers):
        try:
            parts.append(fn())
        except Exception as e:  # noqa: BLE001
            parts.append(f"# metrics provider {name} failed: "
                         f"{type(e).__name__}\n")
    return "".join(p if p.endswith("\n") else p + "\n" for p in parts)


def _tracez(query):
    from . import trace as _trace

    try:
        tail = int(query.get("tail", ["128"])[0])
    except ValueError:
        tail = 128
    doc = _trace.span_dump(tail=tail)
    doc["tracing_enabled"] = _trace.enabled()
    return doc


def _flightz(_query):
    from . import trace as _trace

    path = _trace.flight_dump(reason="graftscope /flightz scrape")
    if path is None:
        raise RuntimeError("flight dump failed (see stderr)")
    with open(path) as f:
        doc = json.load(f)
    doc["path"] = path
    return doc


def _perfz(_query):
    from . import timeline as _timeline

    return _timeline.perf_report()


# -- the HTTP plumbing -------------------------------------------------------

class _Handler(BaseHTTPRequestHandler):
    server_version = "paddle-tpu-graftscope/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):    # quiet: scrapers poll at 10 Hz
        pass

    def _send(self, code, body, content_type="application/json"):
        if isinstance(body, (dict, list)):
            body = json.dumps(body, indent=1, sort_keys=True,
                              default=str)
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type",
                         f"{content_type}; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        try:
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            pass                     # scraper went away mid-response

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler contract
        from .registry import now_ns as _now_ns

        t0 = _now_ns()
        # the obs.scrape drill: flag (or raise) ⇒ the SCRAPE PLANE
        # returns 503 while the engine underneath is provably unaffected
        try:
            spec = _fi.fire("obs.scrape")
        except _fi.InjectedFault as e:
            return self._send(503, {"error": str(e), "point": e.point})
        if spec is not None:
            return self._send(
                503, {"error": "injected fault at obs.scrape (flag)",
                      "point": "obs.scrape"})
        parsed = urlparse(self.path)
        route = parsed.path.rstrip("/") or "/"
        query = parse_qs(parsed.query)
        code = 200
        try:
            if route == "/metricsz":
                body, ctype = metrics_text(), "text/plain; version=0.0.4"
            elif route == "/statusz":
                body, ctype = status_document(), "application/json"
            elif route == "/healthz":
                body = health_document()
                ctype = "application/json"
                code = 200 if body["ok"] else 503
            elif route == "/tracez":
                body, ctype = _tracez(query), "application/json"
            elif route == "/flightz":
                body, ctype = _flightz(query), "application/json"
            elif route == "/perfz":
                body, ctype = _perfz(query), "application/json"
            elif route == "/controlz":
                body, ctype = control_document(), "application/json"
            else:
                code = 404
                body, ctype = ({"error": f"unknown endpoint {route!r}",
                                "endpoints": list(ENDPOINTS)},
                               "application/json")
        except Exception as e:  # noqa: BLE001 - a failing handler is a
            # 500 with the error named, never a dead connection
            code, ctype = 500, "application/json"
            body = {"error": f"{type(e).__name__}: {e}", "endpoint": route}
        self._scrape_telemetry(route, code, t0)
        self._send(code, body, content_type=ctype)

    def _scrape_telemetry(self, route, code, t0):
        from .. import monitor as _m

        try:
            # label cardinality stays bounded: arbitrary 404 paths (a
            # port scanner's probes) collapse into one "other" bucket
            endpoint = route if route in ENDPOINTS else "other"
            if _m._state.on:
                _m.counter("paddle_tpu_monitor_scrapes_total",
                           labelnames=("endpoint",)) \
                    .labels(endpoint).inc()
            if _m.trace._state.on:
                _m.trace.record_span(
                    "monitor.scrape", t0, _m.now_ns(),
                    attrs={"endpoint": route, "status": code})
        except Exception:  # noqa: BLE001 - telemetry must not fail a scrape
            pass


# -- lifecycle ---------------------------------------------------------------

def serve(port=0, host="127.0.0.1"):
    """Start the debug endpoint (idempotent — returns the bound port of
    the already-running server). ``port=0`` binds an ephemeral port;
    the default host keeps the plane loopback-only."""
    global _server, _thread
    with _lock:
        if _server is not None:
            return _server.server_address[1]
        # bind UNDER the lock: two concurrent serve(port=N) calls must
        # be idempotent, not race each other into EADDRINUSE
        srv = ThreadingHTTPServer((host, int(port)), _Handler)
        srv.daemon_threads = True
        t = threading.Thread(target=srv.serve_forever,
                             kwargs={"poll_interval": 0.05},
                             daemon=True,
                             name="paddle-tpu-graftscope")
        _server, _thread = srv, t
    # start the LOCAL handle: a concurrent shutdown() may have nulled
    # the module globals already (it will still join/close this thread
    # and socket via the snapshot it took under the lock)
    t.start()
    return srv.server_address[1]


def shutdown(timeout=5.0):
    """Stop the endpoint and join its thread; idempotent. After this
    there is no listening socket and no server thread."""
    global _server, _thread
    with _lock:
        srv, t = _server, _thread
        _server = _thread = None
    if srv is not None:
        srv.shutdown()
        srv.server_close()
    if t is not None and t.is_alive():
        t.join(timeout=timeout)


def serving():
    return _server is not None


def port():
    """The bound port, or None when the server is off."""
    srv = _server
    return None if srv is None else srv.server_address[1]


def install_from_env(env=None):
    """Start the endpoint when ``PADDLE_TPU_DEBUG_PORT`` is set (port
    number; 0 = ephemeral; ``PADDLE_TPU_DEBUG_HOST`` overrides the
    loopback bind). Called at the end of package init — absent env, no
    socket and no thread ever exist. A malformed port warns and stays
    off (a typo must not crash import)."""
    import os

    spec = (env if env is not None
            else os.environ.get("PADDLE_TPU_DEBUG_PORT", "")).strip()
    if not spec:
        return None
    try:
        p = int(spec)
        host = os.environ.get("PADDLE_TPU_DEBUG_HOST", "127.0.0.1")
        return serve(port=p, host=host)
    except Exception as e:  # noqa: BLE001
        import warnings

        warnings.warn(f"PADDLE_TPU_DEBUG_PORT={spec!r}: debug server "
                      f"not started ({type(e).__name__}: {e})",
                      stacklevel=2)
        return None

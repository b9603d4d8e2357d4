"""paddle_tpu_torch.monitor — framework-wide runtime telemetry (the port of
``paddle_tpu/monitor``).

A thread-safe metrics registry (Counter / Gauge / Histogram) with
instrumentation wired into op dispatch (``ops/_apply.py``), the to_static
program cache (``jit/api.py``, ``jit/sot.py``), the continuous-batching
serving engine (``models/serving.py``), the paged-KV allocator
(``models/paged_kv.py``), the radix cache's spill store, the checkpoint
manager, the serving fleet and the dataloader (``io/dataloader.py``),
exported three ways:

- ``monitor.snapshot()`` — JSON dict (always with a provenance block);
- ``monitor.prometheus_text()`` — Prometheus text exposition;
- chrome-trace counter events merged into the profiler's chrome trace.

The metric names, kinds and labels are the JAX package's (``catalog.py``
is a copy), so one dashboard reads both packages. Metrics of parts the
port does not have yet (the mesh, eager collectives, the mesh trainer) stay
in the catalog; nothing records them.

DISABLED BY DEFAULT. Every instrumented site guards on ``_state.on`` (one
attribute load on a preallocated object), so the cost when off is one slot
load per dispatch. ``enable()`` flips collection on process-wide::

    from paddle_tpu_torch import monitor
    monitor.enable()
    ...  # run: dispatch / jit / serving record themselves
    print(monitor.prometheus_text())
    doc = monitor.snapshot()          # doc["provenance"]["git_rev"] etc.

Gauges and counters read host state only: an instrumented site never reads
a CUDA tensor to record a metric.
"""
from __future__ import annotations

import threading
from collections import deque

from . import catalog, provenance as _provenance_mod, trace  # noqa: F401
from .export import (chrome_counter_events as _chrome_events,
                     prometheus_text as _prom_text, snapshot as _snapshot)
from .registry import (Counter, Gauge, Histogram, Registry,  # noqa: F401
                       DEFAULT_NS_BUCKETS, DEFAULT_SECONDS_BUCKETS, now_ns)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "now_ns",
    "enable", "disable", "enabled", "reset",
    "counter", "gauge", "histogram", "registry",
    "snapshot", "prometheus_text", "sample", "chrome_counter_events",
    "provenance", "validate_provenance", "trace",
    "server", "slo", "timeline",
]


class _State:
    """The disabled-mode fast path: instrument sites read ``_state.on`` —
    a single slot load — before touching any metric."""

    __slots__ = ("on",)

    def __init__(self):
        self.on = False


_state = _State()
registry = Registry()

# timeline samples for chrome-trace counter export: bounded, so an
# always-enabled server cannot grow the buffer without bound
_SAMPLE_CAP = 4096
_samples: deque = deque(maxlen=_SAMPLE_CAP)
_sample_lock = threading.Lock()


def enable():
    """Turn collection on process-wide."""
    _state.on = True


def disable():
    """Turn collection off (metric values are kept; use reset() to zero)."""
    _state.on = False


def enabled():
    return _state.on


def reset():
    """Zero every metric, drop buffered timeline samples AND recorded trace
    spans (test isolation and between-run hygiene)."""
    registry.reset()
    with _sample_lock:
        _samples.clear()
    trace.reset()


def _cataloged(kind, name, labelnames, help):
    spec = catalog.spec(name)
    if spec is not None:
        cat_kind, cat_labels, cat_help = spec
        if cat_kind != kind or tuple(cat_labels) != tuple(labelnames):
            raise ValueError(
                f"{name} is cataloged as {cat_kind}{cat_labels}, "
                f"registered as {kind}{tuple(labelnames)}")
        help = help or cat_help
    return help


def counter(name, help="", labelnames=()):
    """Get-or-create a Counter in the default registry (help text defaults
    from the catalog for cataloged names)."""
    return registry.counter(name, _cataloged("counter", name, labelnames,
                                             help), labelnames)


def gauge(name, help="", labelnames=()):
    return registry.gauge(name, _cataloged("gauge", name, labelnames, help),
                          labelnames)


def histogram(name, help="", labelnames=(), buckets=None):
    return registry.histogram(
        name, _cataloged("histogram", name, labelnames, help), labelnames,
        buckets=buckets)


def snapshot():
    """JSON-able dict of every metric + a provenance block (git rev,
    hostname, platform, monotonic start, wall timestamp)."""
    return _snapshot(registry)


def prometheus_text():
    """Prometheus text exposition of the default registry."""
    return _prom_text(registry)


def sample(ts_ns=None):
    """Record one timeline sample (every counter/gauge value now) for the
    chrome-trace counter export. Called by the serving engine per step and
    by Profiler.step(); cheap no-op when the monitor is disabled."""
    if not _state.on:
        return
    values = {}
    for name, m in registry.collect():
        if isinstance(m, Histogram):
            continue  # distributions don't render as counter tracks
        for label_values, child in m.children():
            series = name
            if label_values:
                series += "{" + ",".join(
                    f"{k}={v}" for k, v in zip(m.labelnames, label_values)
                ) + "}"
            values[series] = child.value
    if not values:
        return
    counter("paddle_tpu_monitor_samples_total").inc()
    values["paddle_tpu_monitor_samples_total"] = \
        registry.get("paddle_tpu_monitor_samples_total").value
    with _sample_lock:
        _samples.append((now_ns() if ts_ns is None else ts_ns, values))


def chrome_counter_events():
    """Buffered timeline samples as chrome-trace "C" events (the profiler
    merges these into its span export)."""
    with _sample_lock:
        samples = list(_samples)
    return _chrome_events(samples)


def provenance():
    """The provenance block snapshots carry (also usable standalone, e.g.
    to stamp BENCH_*.json artifacts)."""
    return _provenance_mod.provenance()


def validate_provenance(prov, now=None):
    """List of problems with a provenance block ([] = trustworthy)."""
    return _provenance_mod.validate(prov, now=now)


# graftscope: the introspection plane above this module —
# imported LAST so their lazy back-references into the (by now fully
# initialized) monitor package resolve; all three are stdlib-only at
# import time and hold no thread/socket until explicitly started.
from . import server, slo, timeline  # noqa: E402,F401

"""Exporters: JSON snapshot, Prometheus text exposition, chrome-trace
counter events.

Three consumers, one registry:

- ``snapshot(registry)``: a JSON-able dict for programmatic checks and
  artifact stamping (always carries a provenance block);
- ``prometheus_text(registry)``: the text exposition format
  (https://prometheus.io/docs/instrumenting/exposition_formats/) so a
  scrape endpoint is one ``write()`` away;
- ``chrome_counter_events(samples)``: ``"ph": "C"`` events from the
  monitor's timeline samples, merged by the profiler into its chrome trace
  so metrics render on the same timeline as host/device spans.
"""
from __future__ import annotations

import math
import os

from . import provenance as _prov
from .registry import Histogram

__all__ = ["snapshot", "prometheus_text", "chrome_counter_events"]


def _label_key(labelnames, values):
    return ",".join(f"{k}={v}" for k, v in zip(labelnames, values))


def _series_snapshot(metric, child):
    if isinstance(child, Histogram):
        buckets, s, count, data = child.snapshot_state()  # one atomic read
        return {
            "count": count,
            "sum": s,
            "buckets": [[le if math.isfinite(le) else "+Inf", c]
                        for le, c in buckets],
            "p50": child._rank(data, 50),
            "p90": child._rank(data, 90),
            "p99": child._rank(data, 99),
        }
    return child.value


def snapshot(registry):
    """{"provenance": {...}, "metrics": {name: {...}}} — values keyed by a
    "k=v,k=v" label string ("" for unlabeled series)."""
    metrics = {}
    for name, m in registry.collect():
        values = {}
        for label_values, child in m.children():
            values[_label_key(m.labelnames, label_values)] = \
                _series_snapshot(m, child)
        metrics[name] = {
            "type": m.kind,
            "help": m.help,
            "labelnames": list(m.labelnames),
            "values": values,
        }
    return {"provenance": _prov.provenance(), "metrics": metrics}


def _escape_help(text):
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(text):
    return (text.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt(v):
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _labels_text(labelnames, values, extra=()):
    pairs = [f'{k}="{_escape_label(str(v))}"'
             for k, v in list(zip(labelnames, values)) + list(extra)]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def prometheus_text(registry):
    """Prometheus text exposition (version 0.0.4) of every registered
    metric."""
    lines = []
    for name, m in registry.collect():
        if m.help:
            lines.append(f"# HELP {name} {_escape_help(m.help)}")
        lines.append(f"# TYPE {name} {m.kind}")
        for label_values, child in m.children():
            if isinstance(child, Histogram):
                buckets, s, count, _ = child.snapshot_state()  # atomic
                for le, c in buckets:
                    lt = _labels_text(m.labelnames, label_values,
                                      extra=(("le", _fmt(le)),))
                    lines.append(f"{name}_bucket{lt} {c}")
                lt = _labels_text(m.labelnames, label_values)
                lines.append(f"{name}_sum{lt} {_fmt(s)}")
                lines.append(f"{name}_count{lt} {count}")
            else:
                lt = _labels_text(m.labelnames, label_values)
                lines.append(f"{name}{lt} {_fmt(child.value)}")
    return "\n".join(lines) + "\n"


def chrome_counter_events(samples):
    """Chrome trace "C" (counter) events from [(ts_ns, {series: value})]
    timeline samples. Timestamps share the profiler's perf_counter_ns
    clock, so these land on the span timeline as stacked counter tracks."""
    pid = os.getpid()
    events = []
    for ts_ns, values in samples:
        for series, value in values.items():
            events.append({
                "name": series,
                "ph": "C",
                "ts": ts_ns / 1e3,  # chrome trace wants microseconds
                "pid": pid,
                "args": {"value": value},
            })
    return events

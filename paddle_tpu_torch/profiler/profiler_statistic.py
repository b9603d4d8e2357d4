"""Summary statistics over a profile: the port of
``paddle_tpu/profiler/profiler_statistic.py``.

Reference: python/paddle/profiler/profiler_statistic.py (SortedKeys :49,
EventSummary :503). The host spans are flat (start, end, thread) records, so
the event tree is rebuilt by containment per thread, and each name's self
time excludes its children. ``_build_summary`` prints the overview by
category, the host event table with its self column and, when the profile
recorded the card, the device table ("Device Op Summary": each CUDA kernel's
calls, total, average, maximum and share of device time, from
``ProfilerResult.device_op_stats``).
"""
from __future__ import annotations

from enum import Enum


class SortedKeys(Enum):
    """Sort orders for summary tables (reference profiler_statistic.py:49)."""

    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5
    GPUMax = 6
    GPUMin = 7


class EventStat:
    __slots__ = ("name", "calls", "total_ns", "max_ns", "min_ns")

    def __init__(self, name):
        self.name = name
        self.calls = 0
        self.total_ns = 0
        self.max_ns = 0
        self.min_ns = None

    def add(self, dur_ns):
        self.calls += 1
        self.total_ns += dur_ns
        self.max_ns = max(self.max_ns, dur_ns)
        self.min_ns = dur_ns if self.min_ns is None else min(self.min_ns, dur_ns)

    @property
    def avg_ns(self):
        return self.total_ns / self.calls if self.calls else 0.0


_SORT_ATTR = {
    SortedKeys.CPUTotal: "total_ns", SortedKeys.GPUTotal: "total_ns",
    SortedKeys.CPUAvg: "avg_ns", SortedKeys.GPUAvg: "avg_ns",
    SortedKeys.CPUMax: "max_ns", SortedKeys.GPUMax: "max_ns",
    SortedKeys.CPUMin: "min_ns", SortedKeys.GPUMin: "min_ns",
}

_UNIT_DIV = {"s": 1e9, "ms": 1e6, "us": 1e3, "ns": 1.0}


def gather_stats(events) -> dict[str, EventStat]:
    """Flat per-name rollup; delegates to the tree aggregation so the two
    paths cannot drift (self-time callers use gather_tree_stats directly)."""
    return gather_tree_stats(events)[0]


def _fmt(ns, unit):
    return f"{ns / _UNIT_DIV[unit]:.3f}"


# -- event tree ---------------------------------------------------------------
class EventNode:
    """One span in the nesting tree (reference HostStatisticNode analog)."""

    __slots__ = ("event", "children")

    def __init__(self, event):
        self.event = event
        self.children = []

    @property
    def total_ns(self):
        return self.event.duration_ns

    @property
    def self_ns(self):
        """Time not covered by child spans (reference self_cpu_time_ms)."""
        return self.total_ns - sum(c.total_ns for c in self.children)


def build_event_tree(events):
    """Nest flat spans by containment per thread (the reference aggregates a
    C++ node tree; here the tree is rebuilt from (start, end, tid))."""
    roots = []
    by_tid = {}
    for ev in events:
        by_tid.setdefault(ev.tid, []).append(ev)
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e.start_ns, -e.end_ns))
        stack = []
        for ev in evs:
            node = EventNode(ev)
            while stack and stack[-1].event.end_ns <= ev.start_ns:
                stack.pop()
            if stack and ev.end_ns <= stack[-1].event.end_ns:
                stack[-1].children.append(node)
            else:
                roots.append(node)
            stack.append(node)
    return roots


def _walk(nodes):
    for n in nodes:
        yield n
        yield from _walk(n.children)


def gather_tree_stats(events):
    """Per-name rollup with SELF time (children excluded), so nested spans do
    not double-count into their parents' ratios."""
    stats = {}
    selfs = {}
    for node in _walk(build_event_tree(events)):
        name = node.event.name
        st = stats.get(name)
        if st is None:
            st = stats[name] = EventStat(name)
            selfs[name] = 0
        st.add(node.total_ns)
        selfs[name] += node.self_ns
    return stats, selfs


def _category_totals(events):
    """Wall time per TracerEventType over ROOT self-containment (reference
    'Model Perspective' / overview tables)."""
    totals = {}
    for node in _walk(build_event_tree(events)):
        cat = node.event.event_type.name
        totals[cat] = totals.get(cat, 0) + node.self_ns
    return totals


def _table(title, header_cols, rows, lines):
    header = "  ".join(header_cols)
    sep = "-" * len(header)
    lines += ["", title, sep, header, sep]
    lines += rows
    lines.append(sep)


def _build_summary(result, sorted_by=SortedKeys.CPUTotal,
                   time_unit: str = "ms") -> str:
    if time_unit not in _UNIT_DIV:
        raise ValueError(f"time_unit must be one of {list(_UNIT_DIV)}")
    stats, selfs = gather_tree_stats(result.events)
    reverse = sorted_by not in (SortedKeys.CPUMin, SortedKeys.GPUMin)
    rows = sorted(stats.values(),
                  key=lambda s: getattr(s, _SORT_ATTR[sorted_by]) or 0,
                  reverse=reverse)
    wall_ns = sum(selfs.values()) or 1
    lines = []

    # 1) overview by category (reference Overview / Model Perspective table)
    cats = sorted(_category_totals(result.events).items(),
                  key=lambda kv: kv[1], reverse=True)
    _table(f"Overview Summary (steps {result.steps[0]}..{result.steps[1]}, "
           f"by category self time)",
           [f"{'Category':<24}", f"{'Total(' + time_unit + ')':>12}",
            f"{'Ratio(%)':>8}"],
           [f"{name:<24}  {_fmt(ns, time_unit):>12}  "
            f"{100.0 * ns / wall_ns:>8.2f}" for name, ns in cats],
           lines)

    # 2) per-name event summary with total vs self time (nested spans do not
    #    double-count; reference EventSummary:503)
    name_w = max([len("Name")] + [min(len(s.name), 60) for s in rows])
    _table("Host Event Summary",
           [f"{'Name':<{name_w}}", f"{'Calls':>7}",
            f"{'Total(' + time_unit + ')':>12}",
            f"{'Self(' + time_unit + ')':>12}",
            f"{'Avg(' + time_unit + ')':>12}",
            f"{'Max(' + time_unit + ')':>12}",
            f"{'Min(' + time_unit + ')':>12}", f"{'Ratio(%)':>8}"],
           [(f"{s.name[:60]:<{name_w}}  {s.calls:>7}  "
             f"{_fmt(s.total_ns, time_unit):>12}  "
             f"{_fmt(selfs[s.name], time_unit):>12}  "
             f"{_fmt(s.avg_ns, time_unit):>12}  "
             f"{_fmt(s.max_ns, time_unit):>12}  "
             f"{_fmt(s.min_ns or 0, time_unit):>12}  "
             f"{100.0 * selfs[s.name] / wall_ns:>8.2f}") for s in rows],
           lines)
    # 3) device time per kernel from the RECORD window's torch.profiler
    #    trace (the reference EventSummary's device view)
    dev_rows = result.device_op_stats() if hasattr(result, "device_op_stats") \
        else []
    if dev_rows:
        dev_rows = dev_rows[:40]
        dn_w = max([len("Op")] + [min(len(r["name"]), 60) for r in dev_rows])
        _table("Device Op Summary (CUDA kernels, torch.profiler)",
               [f"{'Op':<{dn_w}}", f"{'Calls':>7}",
                f"{'Total(' + time_unit + ')':>12}",
                f"{'Avg(' + time_unit + ')':>12}",
                f"{'Max(' + time_unit + ')':>12}", f"{'Ratio(%)':>8}"],
               [(f"{r['name'][:60]:<{dn_w}}  {r['calls']:>7}  "
                 f"{_fmt(r['total_ns'], time_unit):>12}  "
                 f"{_fmt(r['avg_ns'], time_unit):>12}  "
                 f"{_fmt(r['max_ns'], time_unit):>12}  "
                 f"{100.0 * r['ratio']:>8.2f}") for r in dev_rows],
               lines)
    lost = getattr(result, "lost_device_records", 0)
    if lost:
        lines.append(f"{lost} kernel launches have no device record "
                     "(torch.profiler dropped them); the device table misses them")
    return "\n".join(lines)

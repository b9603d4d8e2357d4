"""Profiler: state machine, scheduler and chrome-trace export; the port of
``paddle_tpu/profiler/profiler.py``.

Reference: python/paddle/profiler/profiler.py (Profiler :358, make_scheduler
:129, export_chrome_tracing :227, export_protobuf :280). Host spans are the
JAX package's: ``RecordEvent`` and the dispatch's ``op::<name>`` spans
(``ops/_apply.py``) land in one process-wide collector, timed with
``time.perf_counter_ns``, while a RECORD window is open.

The device side replaces the JAX package's ``xplane.py`` reader with
``torch.profiler``: when ``ProfilerTarget.GPU`` is asked for, each RECORD
window runs under ``torch.profiler.profile(activities=[CPU, CUDA])``.
``ProfilerResult.device_events()`` holds its CUDA kernel events (memcpy and
memset activities too) on the host clock: a marker span recorded when the
window opens ties torch.profiler's trace clock to ``perf_counter_ns``
(``_PRIMER_LAUNCHES`` says why a window opens and closes with a burst of
tiny kernels). The
chrome trace a result saves holds both, the device spans as
``cat: "DeviceOp"`` under a pid of their own per card, and
``device_op_stats()`` gives the per-kernel table (name, calls, total, avg,
min and max ns, ratio of the device time). ``ProfilerTarget.GPU`` (or
``TPU``, which JAX-era code passes and which names the card here) without a
card raises: there is no CPU-only fallback for a device profile.

The monitor's counter tracks (``monitor.sample()`` runs once a profiled
step) and its trace spans (``cat: "TraceSpan"``) inside the profiled window
are merged into the same chrome trace, on the same perf_counter_ns clock, as
the JAX package merges them.
"""
from __future__ import annotations

import json
import os
import socket
import threading
import time
from enum import Enum
from typing import Any, Callable, Iterable, Sequence

import torch

from .. import monitor as _monitor


class SummaryView(Enum):
    """Which summary table to print (reference profiler.py:55)."""

    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6
    MemoryManipulationView = 7
    UDFView = 8


class ProfilerState(Enum):
    """Profiler state machine states (reference profiler.py:89).

    CLOSED -> no collection; READY -> warmup (data discarded); RECORD ->
    collecting; RECORD_AND_RETURN -> last collecting step of a cycle, hands
    the finished profile to ``on_trace_ready``.
    """

    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget(Enum):
    """What to profile (reference profiler.py:110). GPU, TPU and
    CUSTOM_DEVICE all ask for the card's kernels (torch.profiler's CUDA
    activity)."""

    CPU = 0
    GPU = 1
    TPU = 2
    CUSTOM_DEVICE = 3


_DEVICE_TARGETS = (ProfilerTarget.GPU, ProfilerTarget.TPU, ProfilerTarget.CUSTOM_DEVICE)


class TracerEventType(Enum):
    """Host-event categories, mirroring the reference's TracerEventType."""

    Operator = 0
    Dataloader = 1
    ProfileStep = 2
    Forward = 3
    Backward = 4
    Optimization = 5
    Communication = 6
    PythonOp = 7
    PythonUserDefined = 8
    UserDefined = 9


class HostEvent:
    """One completed host-side span."""

    __slots__ = ("name", "event_type", "start_ns", "end_ns", "tid", "step")

    def __init__(self, name, event_type, start_ns, end_ns, tid, step):
        self.name = name
        self.event_type = event_type
        self.start_ns = start_ns
        self.end_ns = end_ns
        self.tid = tid
        self.step = step

    @property
    def duration_ns(self):
        return self.end_ns - self.start_ns


class _Collector:
    """Process-wide host-event sink. RecordEvent spans land here while a
    Profiler is in a RECORD state; the dispatch reads ``ops._apply._PROFILER``,
    which holds this collector exactly then."""

    def __init__(self):
        self._lock = threading.Lock()
        self.events: list[HostEvent] = []
        self.enabled = False
        self.current_step = 0

    def emit(self, name, event_type, start_ns, end_ns):
        if not self.enabled:
            return
        ev = HostEvent(name, event_type, start_ns, end_ns, threading.get_ident(),
                       self.current_step)
        with self._lock:
            self.events.append(ev)

    def set_enabled(self, on):
        from ..ops import _apply

        self.enabled = on
        _apply._PROFILER[0] = self if on else None

    def drain(self):
        with self._lock:
            out, self.events = self.events, []
        return out


_collector = _Collector()


class RecordEvent:
    """User-defined span; context manager / decorator (reference utils.py:47).

    Only records while a Profiler is in a RECORD state. Usable as::

        with RecordEvent("my_span"):
            ...
    or explicitly via begin()/end().
    """

    def __init__(self, name: str,
                 event_type: TracerEventType = TracerEventType.PythonUserDefined):
        self.name = name
        self.event_type = event_type
        self._start_ns = None

    def begin(self):
        self._start_ns = time.perf_counter_ns()

    def end(self):
        if self._start_ns is None:
            return
        _collector.emit(self.name, self.event_type, self._start_ns, time.perf_counter_ns())
        self._start_ns = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def __call__(self, fn):
        import functools

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with RecordEvent(self.name, self.event_type):
                return fn(*args, **kwargs)

        return wrapper


def make_scheduler(*, closed: int, ready: int, record: int, repeat: int = 0,
                   skip_first: int = 0) -> Callable[[int], ProfilerState]:
    """Cyclic profiling schedule (reference profiler.py:129).

    Each cycle is ``closed`` CLOSED steps, ``ready`` READY steps, then
    ``record`` RECORD steps (the last one RECORD_AND_RETURN). ``repeat=0``
    cycles forever; ``skip_first`` initial steps are CLOSED and not part of
    any cycle.
    """
    if closed < 0 or ready < 0 or record <= 0 or repeat < 0 or skip_first < 0:
        raise ValueError(
            "make_scheduler requires closed>=0, ready>=0, record>0, "
            f"repeat>=0, skip_first>=0; got closed={closed}, ready={ready}, "
            f"record={record}, repeat={repeat}, skip_first={skip_first}")
    period = closed + ready + record

    def schedule(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        step -= skip_first
        if repeat > 0 and step >= repeat * period:
            return ProfilerState.CLOSED
        pos = step % period
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == period - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return schedule


def _default_state_scheduler(step: int) -> ProfilerState:
    """Always on (reference profiler.py:220)."""
    return ProfilerState.RECORD


def _trace_handler(dir_name, worker_name, suffix):
    os.makedirs(dir_name, exist_ok=True)

    def handle_fn(prof: "Profiler"):
        nonlocal worker_name
        if not worker_name:
            worker_name = f"host_{socket.gethostname()}_pid_{os.getpid()}"
        # the step in the name keeps back-to-back cycles apart
        filename = (f"{worker_name}_time_{time.time_ns()}"
                    f"_step_{prof.step_num}.paddle_trace{suffix}")
        prof.export(os.path.join(dir_name, filename), format="json")

    return handle_fn


def export_chrome_tracing(dir_name: str, worker_name: str | None = None) -> Callable:
    """on_trace_ready handler writing chrome://tracing JSON
    (reference profiler.py:227)."""
    return _trace_handler(dir_name, worker_name, ".json")


def export_protobuf(dir_name: str, worker_name: str | None = None) -> Callable:
    """on_trace_ready handler (reference profiler.py:280). There is no
    protobuf trace format here: the same JSON with a .pb.json suffix, as in
    the JAX package."""
    return _trace_handler(dir_name, worker_name, ".pb.json")


def _get_supported_targets() -> Iterable[ProfilerTarget]:
    targets = [ProfilerTarget.CPU]
    if torch.cuda.is_available():
        targets += [ProfilerTarget.GPU]
    return targets


# -- the device side: torch.profiler over a RECORD window ----------------------
_ANCHOR = "paddle_tpu_torch::profiler_window"
_END_ANCHOR = "paddle_tpu_torch::profiler_window_end"
# CUPTI reports the host waiting on a full launch queue as a device activity
_NOT_KERNELS = ("Command Buffer Full",)
# On an H100 with torch 2.11, a torch.profiler session in a process that
# has run for a while (one Inductor compile is enough) keeps no device
# record of its first kernel launches (1 to 39 seen, more the longer the
# process has run), however long they come after the session starts. So a
# window opens with _PRIMER_LAUNCHES tiny kernels and a synchronize before
# the caller's work: they absorb the loss. Such a session also, now and
# then, keeps no record of its LAST launches (2 to 245 seen, tools/
# profiler_record_loss.py), so a window closes with _TAIL_LAUNCHES tiny
# kernels after an end marker, and their records are dropped like the
# primer's. Launches of the window whose kernel still has no record are
# counted (ProfilerResult.lost_device_records).
_PRIMER_LAUNCHES = 256
_TAIL_LAUNCHES = 1024


def _prime(n):
    """``n`` tiny kernel launches, then a synchronize."""
    x = torch.zeros(1, device="cuda")
    for _ in range(n):
        x.add_(1)
    torch.cuda.synchronize()


def _lost_launches(function_events, kinds, after_us, before_us=float("inf")):
    """How many kernel launches from ``after_us`` up to ``before_us`` (the
    trace's clock) have no device record."""
    device = {e.id for e in function_events if e.device_type in kinds}
    return sum(1 for e in function_events
               if e.device_type not in kinds and "LaunchKernel" in e.name
               and after_us <= e.time_range.start < before_us and e.id not in device)


def collect_device_events(function_events, anchor_ns, device_types=None):
    """The device activities of a torch.profiler trace (``prof.events()``)
    launched after the ``_ANCHOR`` span and before the ``_END_ANCHOR``
    span, where there is one: ``(events, lost)``, each event a dict
    ``{name, plane, line, start_ns, dur_ns}`` with ``start_ns`` on the
    ``perf_counter_ns`` clock (the anchor started at host time
    ``anchor_ns``), ``lost`` as ``_lost_launches`` counts it.
    ``device_types`` defaults to CUDA."""
    from torch.autograd import DeviceType

    kinds = (DeviceType.CUDA,) if device_types is None else tuple(device_types)
    anchor = next((e for e in function_events if e.name == _ANCHOR), None)
    if anchor is None:
        raise RuntimeError("the profiler's window marker is missing from its trace")
    start = anchor.time_range.start
    end = next((e.time_range.start for e in function_events if e.name == _END_ANCHOR),
               float("inf"))
    offset_ns = anchor_ns - start * 1e3
    # what the runtime launched before the marker and after the end marker:
    # the window's primer and its tail
    outside = {e.id for e in function_events if e.device_type not in kinds
               and e.name.startswith("cu")
               and not start <= e.time_range.start < end}
    out = []
    for e in function_events:
        if (e.device_type not in kinds or e.name in _NOT_KERNELS
                or e.name in (_ANCHOR, _END_ANCHOR) or e.id in outside):
            continue
        out.append({
            "name": e.name,
            "plane": f"{e.device_type.name.lower()}:{e.device_index}",
            "line": f"stream {getattr(e, 'device_resource_id', 0)}",
            "start_ns": offset_ns + e.time_range.start * 1e3,
            "dur_ns": e.time_range.elapsed_us() * 1e3,
        })
    out.sort(key=lambda ev: ev["start_ns"])
    return out, _lost_launches(function_events, kinds, start, end)


def device_op_stats(device_events):
    """Per-kernel device time (the reference's per-op device table): calls,
    total/avg/min/max ns and the share of all device time, rows by total
    time descending."""
    agg = {}
    for ev in device_events:
        row = agg.setdefault(ev["name"], {"name": ev["name"], "calls": 0, "total_ns": 0.0,
                                          "min_ns": None, "max_ns": 0.0})
        row["calls"] += 1
        row["total_ns"] += ev["dur_ns"]
        row["max_ns"] = max(row["max_ns"], ev["dur_ns"])
        row["min_ns"] = ev["dur_ns"] if row["min_ns"] is None else min(row["min_ns"],
                                                                         ev["dur_ns"])
    total = sum(r["total_ns"] for r in agg.values()) or 1.0
    rows = sorted(agg.values(), key=lambda r: -r["total_ns"])
    for r in rows:
        r["avg_ns"] = r["total_ns"] / r["calls"]
        r["ratio"] = r["total_ns"] / total
    return rows


def chrome_events(device_events, base_pid=900000):
    """Device spans as chrome-trace dicts: one pid per card, one tid per
    stream, with metadata naming them."""
    pids, tids, out = {}, {}, []
    for ev in device_events:
        if ev["plane"] not in pids:
            pid = base_pid + len(pids)
            pids[ev["plane"]] = pid
            out.append({"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                        "args": {"name": f"device {ev['plane']}"}})
        pid = pids[ev["plane"]]
        lkey = (ev["plane"], ev["line"])
        if lkey not in tids:
            tids[lkey] = len(tids) + 1
            out.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": tids[lkey], "args": {"name": ev["line"]}})
        out.append({"name": ev["name"], "cat": "DeviceOp", "ph": "X",
                    "ts": ev["start_ns"] / 1e3, "dur": max(ev["dur_ns"], 1.0) / 1e3,
                    "pid": pid, "tid": tids[lkey], "args": {}})
    return out


class _DeviceTrace:
    """torch.profiler (CPU and CUDA activities) over one RECORD window,
    opened and closed with the primer launches above."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        _prime(_PRIMER_LAUNCHES)
        t0 = time.perf_counter_ns()
        with record_function(_ANCHOR):
            t1 = time.perf_counter_ns()
        self._anchor_ns = (t0 + t1) // 2

    def stop(self):
        """``(events, lost)`` (``collect_device_events``)."""
        from torch.profiler import record_function

        torch.cuda.synchronize()
        with record_function(_END_ANCHOR):
            pass
        _prime(_TAIL_LAUNCHES)
        self._prof.__exit__(None, None, None)
        return collect_device_events(self._prof.events(), self._anchor_ns)


class ProfilerResult:
    """The host events and device events of one finished RECORD window. The
    saved chrome trace is one timeline: host spans and, on the host clock,
    the card's kernels (reference chrometracing_logger.cc merges host and
    CUPTI the same way)."""

    def __init__(self, events: list[HostEvent], steps: tuple[int, int],
                 device_events: list[dict] | None = None, lost_device_records: int = 0):
        self.events = events
        self.steps = steps
        self._device_events = device_events or []
        self.lost_device_records = lost_device_records

    def device_events(self):
        """The card's kernel spans (``collect_device_events``)."""
        return self._device_events

    def device_op_stats(self):
        """Per-kernel device-time rows (``device_op_stats``)."""
        return device_op_stats(self._device_events)

    def save(self, path: str):
        _write_chrome_trace(self.events, path, self._device_events)


def _write_chrome_trace(events, path, device_events=None):
    pid = os.getpid()
    trace_events: list[dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": f"paddle_tpu_torch host (pid {pid})"},
    }]
    for ev in events:
        trace_events.append({
            "name": ev.name,
            "cat": ev.event_type.name,
            "ph": "X",
            "ts": ev.start_ns / 1e3,  # chrome trace wants microseconds
            "dur": ev.duration_ns / 1e3,
            "pid": pid,
            "tid": ev.tid % 10**6,
            "args": {"step": ev.step},
        })
    if device_events:
        trace_events.extend(chrome_events(device_events))
    if events:
        # the monitor's counter and span tracks inside the profiled window
        w0 = min(e.start_ns for e in events) - 10_000_000
        w1 = max(e.end_ns for e in events) + 10_000_000
        trace_events.extend(
            ev for ev in _monitor.chrome_counter_events() if w0 <= ev["ts"] * 1e3 <= w1)
        trace_events.extend(
            ev for ev in _monitor.trace.chrome_span_events() if w0 <= ev["ts"] * 1e3 <= w1)
    with open(path, "w") as f:
        json.dump({"traceEvents": trace_events, "displayTimeUnit": "ms"}, f)


def load_profiler_result(filename: str) -> ProfilerResult:
    """Re-load a chrome trace exported by this profiler (or the JAX
    package's): the host spans. Device spans (``DeviceOp``) and monitor spans
    (``TraceSpan``) are skipped, as the JAX loader skips them, and an unknown
    category loads as UserDefined."""
    with open(filename) as f:
        doc = json.load(f)
    events = []
    for te in doc.get("traceEvents", []):
        if te.get("ph") != "X":
            continue
        cat = te.get("cat", "UserDefined")
        if cat in ("DeviceOp", "TraceSpan"):
            continue
        try:
            etype = TracerEventType[cat]
        except KeyError:
            etype = TracerEventType.UserDefined
        start_ns = int(te["ts"] * 1e3)
        events.append(HostEvent(te["name"], etype, start_ns, start_ns + int(te["dur"] * 1e3),
                                te.get("tid", 0), te.get("args", {}).get("step", 0)))
    return ProfilerResult(events, (0, 0))


class Profiler:
    """Performance profiler (reference profiler.py:358).

    Typical use::

        with profiler.Profiler(
                targets=[profiler.ProfilerTarget.CPU, profiler.ProfilerTarget.GPU],
                scheduler=(2, 5),
                on_trace_ready=profiler.export_chrome_tracing("./log")) as p:
            for batch in loader:
                train_step(batch)
                p.step()
        p.summary()

    ``scheduler`` may be None (always RECORD), a (start, end) batch-range
    tuple, or a callable step -> ProfilerState (see make_scheduler).
    ``targets`` None profiles the host and, when there is one, the card.
    """

    def __init__(self, *,
                 targets: Sequence[ProfilerTarget] | None = None,
                 scheduler: Callable[[int], ProfilerState] | tuple | None = None,
                 on_trace_ready: Callable | None = None,
                 record_shapes: bool = False,
                 profile_memory: bool = False,
                 timer_only: bool = False,
                 emit_nvtx: bool = False,
                 custom_device_types: list[str] | None = None,
                 with_flops: bool = False):
        supported = list(_get_supported_targets())
        if targets:
            targets = list(targets)
            if any(t in _DEVICE_TARGETS for t in targets) and not torch.cuda.is_available():
                raise RuntimeError(
                    f"Profiler(targets={[t.name for t in targets]}): a device profile needs "
                    "a CUDA card and none is visible; profile the host with "
                    "targets=[ProfilerTarget.CPU]")
            self.targets = [ProfilerTarget.GPU if t in _DEVICE_TARGETS else t
                            for t in dict.fromkeys(targets)]
        else:
            self.targets = supported
        if scheduler is None:
            self._scheduler = _default_state_scheduler
        elif isinstance(scheduler, (tuple, list)):
            start, end = scheduler
            if start < 0 or end <= start:
                raise ValueError(f"invalid scheduler range ({start}, {end})")
            self._scheduler = make_scheduler(closed=max(start - 1, 0), ready=min(start, 1),
                                             record=end - start, repeat=1)
        elif callable(scheduler):
            self._scheduler = scheduler
        else:
            raise TypeError(f"invalid scheduler: {scheduler!r}")
        self.on_trace_ready = on_trace_ready
        self.record_shapes = record_shapes
        self.profile_memory = profile_memory
        self.timer_only = timer_only
        self.with_flops = with_flops
        self.current_state = ProfilerState.CLOSED
        self.step_num = 0
        self._record_start_step = 0
        self._profile_step_span: RecordEvent | None = None
        self._device_trace: _DeviceTrace | None = None
        self._last_result: ProfilerResult | None = None
        self._timer = None

    # -- lifecycle -----------------------------------------------------------
    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def start(self):
        """Enter the schedule's state for step 0 and begin collection
        (reference profiler.py:592)."""
        from .timer import benchmark

        self._timer = benchmark()
        self._timer.begin()
        if self.timer_only:
            return
        self.current_state = self._scheduler(self.step_num)
        if self.current_state in (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN):
            self._start_record(self.step_num)
        self._open_step_span()

    def stop(self):
        """Flush collection; fire on_trace_ready if recording
        (reference profiler.py:641)."""
        if self._timer is not None:
            self._timer.end()
        if self.timer_only:
            return
        self._close_step_span()
        if self.current_state in (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN):
            self._finish_record()
            if self.on_trace_ready and self._last_result is not None:
                self.on_trace_ready(self)
        self.current_state = ProfilerState.CLOSED

    def step(self, num_samples: int | None = None):
        """Advance one step; drive the state machine (reference profiler.py:691)."""
        if self._timer is not None:
            self._timer.after_step(num_samples)
        if self.timer_only:
            self.step_num += 1
            return
        self._close_step_span()
        _monitor.sample()   # one counter-track sample a profiled step
        _collector.current_step = self.step_num + 1
        next_state = self._scheduler(self.step_num + 1)
        self._trigger_action(self.current_state, next_state, self.step_num + 1)
        self.step_num += 1
        self.current_state = next_state
        self._open_step_span()

    def step_info(self, unit: str | None = None) -> str:
        """Mean step/reader timing since the last call (reference profiler.py:735)."""
        if self._timer is None:
            return ""
        return self._timer.step_info(unit)

    # -- state transitions ---------------------------------------------------
    def _trigger_action(self, cur: ProfilerState, nxt: ProfilerState, next_step: int):
        recording = (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)
        if cur not in recording and nxt in recording:
            self._start_record(next_step)
        if cur is ProfilerState.RECORD_AND_RETURN:
            self._finish_record()
            if self.on_trace_ready and self._last_result is not None:
                self.on_trace_ready(self)
            if nxt in recording:  # back-to-back cycles
                self._start_record(next_step)
        elif cur in recording and nxt not in recording:
            # the schedule left the window without RECORD_AND_RETURN: keep
            # the data, hand nothing off (the reference flushes it on stop())
            self._finish_record()

    def _start_record(self, start_step: int):
        _collector.current_step = start_step
        self._record_start_step = start_step
        if ProfilerTarget.GPU in self.targets:
            self._device_trace = _DeviceTrace()
        _collector.set_enabled(True)

    def _finish_record(self):
        _collector.set_enabled(False)
        device = ([], 0)
        if self._device_trace is not None:
            device = self._device_trace.stop()
            self._device_trace = None
        self._last_result = ProfilerResult(
            _collector.drain(), (self._record_start_step, self.step_num), *device)

    def _open_step_span(self):
        if self.current_state in (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN):
            self._profile_step_span = RecordEvent(f"ProfileStep#{self.step_num}",
                                                  TracerEventType.ProfileStep)
            self._profile_step_span.begin()

    def _close_step_span(self):
        if self._profile_step_span is not None:
            self._profile_step_span.end()
            self._profile_step_span = None

    # -- results -------------------------------------------------------------
    def export(self, path: str = "", format: str = "json"):
        """Write the last finished profile as a chrome trace
        (reference profiler.py:853)."""
        if format not in ("json", "pb"):
            raise ValueError(f"unsupported export format: {format}")
        if self._last_result is None:
            raise RuntimeError("no finished profile to export; run a RECORD window first")
        self._last_result.save(path)

    def summary(self, sorted_by=None, op_detail: bool = True, thread_sep: bool = False,
                time_unit: str = "ms", views=None):
        """Print the statistics tables of the last profile
        (reference profiler.py:883)."""
        from .profiler_statistic import SortedKeys, _build_summary

        if self._last_result is None:
            return
        if sorted_by is None:
            sorted_by = SortedKeys.CPUTotal
        print(_build_summary(self._last_result, sorted_by=sorted_by, time_unit=time_unit))


def get_profiler(config_path: str | None = None) -> Profiler:
    """Build a Profiler from a JSON config file (reference profiler.py:951)."""
    kwargs: dict[str, Any] = {}
    if config_path:
        with open(config_path) as f:
            cfg = json.load(f)
        if "targets" in cfg:
            kwargs["targets"] = [ProfilerTarget[t] for t in cfg["targets"]]
        if "scheduler" in cfg:
            sch = cfg["scheduler"]
            kwargs["scheduler"] = make_scheduler(**sch) if isinstance(sch, dict) else tuple(sch)
        if "timer_only" in cfg:
            kwargs["timer_only"] = bool(cfg["timer_only"])
    return Profiler(**kwargs)

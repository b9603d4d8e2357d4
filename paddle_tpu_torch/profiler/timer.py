"""Throughput timer: the port of ``paddle_tpu/profiler/timer.py``.

Reader and batch cost and ips, the hapi/high-level-API benchmark (reference
python/paddle/profiler/timer.py: Event :44, Benchmark :351, benchmark()
:448). A process-wide singleton that a data loader brackets with
before_reader/after_reader and a training loop advances with step();
``step_info`` reports the averages since its previous call, and ``summary``
the per-run averages with the reader's share. Host clock only
(``time.perf_counter``); a step's time is what the host waited for it.
"""
from __future__ import annotations

import time


class Event:
    """Accumulates reader/batch timings for one profiling run
    (reference timer.py:44)."""

    def __init__(self):
        self.reader_cost_averager = _Averager()
        self.batch_cost_averager = _Averager()
        self.total_samples = 0
        self.total_iters = 0
        self.skip_iter = 10  # first iters include compile; excluded from averages
        self.reader_records = _Records()
        self.batch_records = _Records()
        self.speed_records = _Records()
        self.need_record = True

    def reset(self):
        self.reader_cost_averager.reset()
        self.batch_cost_averager.reset()

    def record_reader(self, usetime):
        self.reader_cost_averager.record(usetime)
        if self.total_iters >= self.skip_iter:
            self.reader_records.update(usetime)

    def record_batch(self, usetime, num_samples=None):
        self.batch_cost_averager.record(usetime, num_samples)
        self.total_iters += 1
        if num_samples:
            self.total_samples += num_samples
        if self.total_iters >= self.skip_iter:
            self.batch_records.update(usetime)
            if num_samples and usetime > 0:
                self.speed_records.update(num_samples / usetime)

    def reader_average(self):
        return self.reader_cost_averager.get_average()

    def batch_average(self):
        return self.batch_cost_averager.get_average()

    def speed_average(self):
        return self.batch_cost_averager.get_ips_average()

    def get_summary(self):
        return {
            "reader_avg": self.reader_records.avg(),
            "reader_max": self.reader_records.max(),
            "reader_min": self.reader_records.min(),
            "batch_avg": self.batch_records.avg(),
            "batch_max": self.batch_records.max(),
            "batch_min": self.batch_records.min(),
            "ips_avg": self.speed_records.avg(),
            "ips_max": self.speed_records.max(),
            "ips_min": self.speed_records.min(),
            "reader_ratio": (100.0 * self.reader_records.total
                             / self.batch_records.total
                             if self.batch_records.total else 0.0),
        }


class _Averager:
    def __init__(self):
        self.reset()

    def reset(self):
        self._total_time = 0.0
        self._count = 0
        self._total_samples = 0

    def record(self, usetime, num_samples=None):
        self._total_time += usetime
        self._count += 1
        if num_samples:
            self._total_samples += num_samples

    def get_average(self):
        return self._total_time / self._count if self._count else 0.0

    def get_ips_average(self):
        if not self._total_samples or self._total_time <= 0:
            return 0.0
        return self._total_samples / self._total_time


class _Records:
    def __init__(self):
        self.total = 0.0
        self.count = 0
        self._max = None
        self._min = None

    def update(self, v):
        self.total += v
        self.count += 1
        self._max = v if self._max is None else max(self._max, v)
        self._min = v if self._min is None else min(self._min, v)

    def avg(self):
        return self.total / self.count if self.count else 0.0

    def max(self):
        return self._max or 0.0

    def min(self):
        return self._min or 0.0


class Benchmark:
    """Process-wide throughput recorder (reference timer.py:351)."""

    def __init__(self):
        self.num_samples = None
        self.start_reader = 0.0
        self.start_time = 0.0
        self.running = False
        self.events: list[Event] = []
        self.current_event: Event | None = None
        self._recording_reader: int | None = None

    # -- lifecycle (driven by Profiler / DataLoader / user) -------------------
    def begin(self):
        if self.running:
            return
        self.running = True
        self.current_event = Event()
        self.events.append(self.current_event)
        self.start_time = time.perf_counter()

    def before_reader(self):
        self.start_reader = time.perf_counter()

    def after_reader(self):
        if self.current_event is None or not self.current_event.need_record:
            return
        self.current_event.record_reader(time.perf_counter() - self.start_reader)

    def step(self, num_samples=None):
        self.num_samples = num_samples
        self.after_step(num_samples)

    def after_step(self, num_samples=None):
        if self.current_event is None or not self.running:
            return
        now = time.perf_counter()
        self.current_event.record_batch(now - self.start_time, num_samples)
        self.start_time = now

    def end(self):
        self.running = False

    def check_if_need_record(self, reader):
        """DataLoader hook: only the outermost reader of a run is timed
        (reference timer.py:419). The first reader to register wins; nested
        readers see need_record=False and are not counted."""
        if self.current_event is None:
            return
        if self._recording_reader is None:
            self._recording_reader = id(reader)
        self.current_event.need_record = (id(reader) == self._recording_reader)

    def is_recording_reader(self, reader) -> bool:
        return self._recording_reader in (None, id(reader))

    def release_reader(self, reader):
        """Called when a reader's epoch ends so the next run can re-register."""
        if self._recording_reader == id(reader):
            self._recording_reader = None

    # -- reporting ------------------------------------------------------------
    def step_info(self, unit=None):
        """Averages since the previous call, then reset (reference timer.py:374)."""
        ev = self.current_event
        if ev is None:
            return ""
        msg = ""
        reader_avg = ev.reader_average()
        batch_avg = ev.batch_average()
        if reader_avg:
            msg += f" reader_cost: {reader_avg:.5f} s"
        if batch_avg:
            msg += f" batch_cost: {batch_avg:.5f} s"
        speed = ev.speed_average()
        if speed:
            msg += f" ips: {speed:.5f} {unit or 'samples'}/s"
        ev.reset()
        return msg

    def summary(self):
        """Print per-run min/max/avg table (reference TimerHook._print_summary)."""
        print("Perf Summary".center(100, "="))
        header = (f"{'':<12}{'avg':<16}{'max':<16}{'min':<16}")
        for i, ev in enumerate(self.events):
            s = ev.get_summary()
            print(f"run {i}: reader_ratio = {s['reader_ratio']:.2f}%")
            print(header)
            print(f"{'reader_cost':<12}{s['reader_avg']:<16.5f}"
                  f"{s['reader_max']:<16.5f}{s['reader_min']:<16.5f}")
            print(f"{'batch_cost':<12}{s['batch_avg']:<16.5f}"
                  f"{s['batch_max']:<16.5f}{s['batch_min']:<16.5f}")
            print(f"{'ips':<12}{s['ips_avg']:<16.5f}"
                  f"{s['ips_max']:<16.5f}{s['ips_min']:<16.5f}")


_benchmark = Benchmark()


def benchmark() -> Benchmark:
    """The process-wide Benchmark singleton (reference timer.py:448)."""
    return _benchmark

"""Thread-safe metrics primitives: Counter, Gauge, Histogram + Registry.

Design constraints:

- near-zero overhead when the monitor is disabled: instrument sites guard
  every recording call on ``monitor._state.on`` (one attribute load), so
  nothing here sits on a hot path unless telemetry is on;
- thread-safe when enabled: the serving engine, dataloader producer thread,
  and user threads all record concurrently — every mutation takes the
  metric's lock (increments are exact, not racy);
- histograms have FIXED bucket boundaries (no dynamic rebinning: exposition
  series stay comparable across a run) and a BOUNDED reservoir of raw
  observations (ring buffer) for percentile estimates in snapshots.

The clock for all instrumented spans is :func:`now_ns` — the single timing
implementation the dispatch/JIT/serving sites share (replacing the ad-hoc
``perf_counter_ns`` pairs that used to live in ``ops/_apply.py``).
"""
from __future__ import annotations

import bisect
import re
import time

from ..analysis.sanitizers import new_lock as _new_lock

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "now_ns",
           "DEFAULT_NS_BUCKETS", "DEFAULT_SECONDS_BUCKETS"]


#: Monotonic span clock (perf_counter_ns) — one implementation for every
#: instrumented site; also the timestamp base of chrome-trace counter
#: events, so metric samples land on the profiler's span timeline. The
#: builtin itself: a dispatched op reads it twice with the monitor on.
now_ns = time.perf_counter_ns


# 1us .. 10s in nanoseconds: covers sub-40us dispatch through multi-second
# trace+compile events on one fixed grid.
DEFAULT_NS_BUCKETS = (
    1_000, 5_000, 10_000, 25_000, 50_000, 100_000, 250_000, 500_000,
    1_000_000, 5_000_000, 10_000_000, 50_000_000, 100_000_000,
    500_000_000, 1_000_000_000, 10_000_000_000,
)

# 1ms .. 120s in seconds (JIT trace+compile wall time).
DEFAULT_SECONDS_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
    60.0, 120.0,
)

_NAME_RE = re.compile(r"^[a-z_][a-z0-9_]*$")
_LABEL_RE = re.compile(r"^[a-z_][a-z0-9_]*$")
_RESERVOIR_SIZE = 256


class _Metric:
    """Shared labeled-family plumbing. A metric is either a single series
    (no labelnames) or a family whose children are keyed by their label
    values; the family lock also guards child creation."""

    kind = "untyped"

    def __init__(self, name, help="", labelnames=()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r} on {name}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        # graftsan known-lock site: sanitized only when the lock sanitizer
        # is enabled at construction, a plain threading.Lock otherwise
        self._lock = _new_lock(f"monitor.registry.{type(self).__name__}")
        self._children = {}
        self._init_series()

    def _init_series(self):
        raise NotImplementedError

    def labels(self, *values, **kv):
        """Child series for one label-value combination (created on first
        use, then cached)."""
        if not self.labelnames:
            raise ValueError(f"{self.name} is not a labeled metric")
        if kv:
            if values:
                raise ValueError("pass label values positionally or by "
                                 "keyword, not both")
            values = tuple(kv[ln] for ln in self.labelnames)
        else:
            values = tuple(values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, got {values}")
        values = tuple(str(v) for v in values)
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.get(values)
                if child is None:
                    child = self._make_child()
                    self._children[values] = child
        return child

    def child(self, values):
        """``labels(*values)`` for a tuple of label-value strings in label
        order: the hot path's form, one dict read once the child exists."""
        child = self._children.get(values)
        return child if child is not None else self.labels(*values)

    def _make_child(self):
        return type(self)(self.name, self.help)

    def children(self):
        """[(label_values, child)] snapshot; [((), self)] when unlabeled."""
        if self.labelnames:
            with self._lock:
                return sorted(self._children.items())
        return [((), self)]

    def remove(self, *values, **kv):
        """Drop one label-value combination's child series (no-op when
        absent). The escape hatch for caller-supplied label values
        (e.g. per-tenant SLO series): a family whose children are never
        removed grows the registry — and every later exposition — with
        the label-value history of the whole process lifetime."""
        if not self.labelnames:
            raise ValueError(f"{self.name} is not a labeled metric")
        if kv:
            if values:
                raise ValueError("pass label values positionally or by "
                                 "keyword, not both")
            values = tuple(kv[ln] for ln in self.labelnames)
        values = tuple(str(v) for v in values)
        with self._lock:
            self._children.pop(values, None)

    def _require_series(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} is labeled by {self.labelnames}; call "
                ".labels(...) first")

    def clear(self):
        with self._lock:
            self._children.clear()
            self._init_series()


class Counter(_Metric):
    """Monotonically increasing count (Prometheus counter)."""

    kind = "counter"

    def _init_series(self):
        self._value = 0.0

    def inc(self, amount=1):
        self._require_series()
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self):
        return self._value


class Gauge(_Metric):
    """Point-in-time value (Prometheus gauge)."""

    kind = "gauge"

    def _init_series(self):
        self._value = 0.0

    def set(self, value):
        self._require_series()
        with self._lock:
            self._value = float(value)

    def inc(self, amount=1):
        self._require_series()
        with self._lock:
            self._value += amount

    def dec(self, amount=1):
        self.inc(-amount)

    @property
    def value(self):
        return self._value


class Histogram(_Metric):
    """Fixed-boundary histogram with a bounded ring reservoir.

    ``buckets`` are upper bounds (le) in ascending order; an implicit +Inf
    bucket terminates the grid. The reservoir keeps the last
    ``_RESERVOIR_SIZE`` raw observations for snapshot-time percentile
    estimates — bounded memory no matter how long the process runs.
    """

    kind = "histogram"

    def __init__(self, name, help="", labelnames=(), buckets=None):
        self._buckets = tuple(sorted(buckets or DEFAULT_NS_BUCKETS))
        if not self._buckets:
            raise ValueError("histogram needs at least one bucket bound")
        super().__init__(name, help, labelnames)

    def _init_series(self):
        self._counts = [0] * (len(self._buckets) + 1)
        self._sum = 0.0
        self._count = 0
        self._reservoir = []

    def _make_child(self):  # children inherit the bucket grid
        return Histogram(self.name, self.help, buckets=self._buckets)

    @property
    def buckets(self):
        return self._buckets

    def observe(self, value):
        self._require_series()
        value = float(value)
        idx = bisect.bisect_left(self._buckets, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1
            if len(self._reservoir) < _RESERVOIR_SIZE:
                self._reservoir.append(value)
            else:
                self._reservoir[self._count % _RESERVOIR_SIZE] = value

    observe_ns = observe  # intent-revealing alias for nanosecond spans

    def time(self):
        """Context manager observing the body's wall time in nanoseconds."""
        return _HistTimer(self)

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    def snapshot_state(self):
        """Atomic view for exporters: (cumulative_buckets, sum, count,
        reservoir) read under ONE lock acquisition, so a concurrent
        observe() cannot produce an exposition where _count disagrees with
        the +Inf bucket (the Prometheus histogram invariant)."""
        with self._lock:
            counts = list(self._counts)
            total = self._count
            s = self._sum
            data = sorted(self._reservoir)
        out, acc = [], 0
        for bound, c in zip(self._buckets, counts[:-1]):
            acc += c
            out.append((bound, acc))
        out.append((float("inf"), acc + counts[-1]))
        return out, s, total, data

    @staticmethod
    def _rank(data, q):
        if not data:
            return None
        rank = min(len(data) - 1, max(0, int(round(q / 100 * (len(data) - 1)))))
        return data[rank]

    def cumulative_buckets(self):
        """[(le, cumulative_count)] including the +Inf terminal bucket."""
        return self.snapshot_state()[0]

    def percentile(self, q):
        """Estimate the q-th percentile (0..100) from the reservoir; None
        when nothing has been observed."""
        return self._rank(self.snapshot_state()[3], q)


class _HistTimer:
    __slots__ = ("_hist", "_t0")

    def __init__(self, hist):
        self._hist = hist

    def __enter__(self):
        self._t0 = now_ns()
        return self

    def __exit__(self, *exc):
        self._hist.observe(now_ns() - self._t0)
        return False


_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Registry:
    """Name -> metric map. get-or-create semantics so instrument sites can
    bind lazily without import-order coordination; re-registration with a
    different type or label set is an error (names are a contract)."""

    def __init__(self):
        self._lock = _new_lock("monitor.registry.Registry")
        self._metrics = {}

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = cls(name, help, labelnames=tuple(labelnames), **kw)
                    self._metrics[name] = m
                    return m
        if type(m) is not cls or m.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind} with labels "
                f"{m.labelnames}")
        want = kw.get("buckets")
        if want is not None and m.buckets != tuple(sorted(want)):
            # the bucket grid is part of the contract too: a silent win for
            # whichever registration ran first would corrupt the series
            raise ValueError(
                f"metric {name!r} already registered with buckets "
                f"{m.buckets}, requested {tuple(sorted(want))}")
        return m

    def counter(self, name, help="", labelnames=()):
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()):
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(), buckets=None):
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name):
        return self._metrics.get(name)

    def collect(self):
        """[(name, metric)] sorted by name (stable exposition order)."""
        with self._lock:
            return sorted(self._metrics.items())

    def reset(self):
        """Zero every registered metric (children included). Metrics stay
        registered — instrument sites hold direct references."""
        for _, m in self.collect():
            m.clear()

"""Hang detection for blocking sections: the port of
paddle_tpu/distributed/watchdog.py.

``CommWatchdog.watch(desc)`` wraps a blocking section (a serving step, a
collective's wait); one daemon scanner thread checks every section in flight
each tick and fires the timeout callback once per stuck section. Finished
sections land in a bounded history for ``dump()``.

With span tracing on (``paddle_tpu_torch.monitor.trace``) each watched
section opens a ``comm.wait`` span, and with tracing on or
``PADDLE_TPU_FLIGHT_DIR`` set a timeout writes the flight-recorder dump (open
spans, the last spans, the metrics snapshot) to the file of ``flight_key``
(``last_flight_dump``), where the serving engine's recovery dump of the same
hang lands too, as in the JAX package. The scanner thread writes the dump
from host state only and touches no CUDA: the hung step may hold the card,
and a dump that synchronised with it would hang as well. The lock is
witnessed by the lock-order sanitizer when it is on at construction. The
process-wide default watchdog of the eager collectives is not ported (the
port has no collectives yet).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import sys
import threading
import time

from ..analysis.sanitizers import new_lock as _new_lock
from ..monitor import trace as _trace

__all__ = ["CommWatchdog", "WatchdogTimeout", "paused"]

# the watch sections each thread has open (innermost last)
_OPEN = threading.local()


class WatchdogTimeout(RuntimeError):
    pass


class CommWatchdog:
    def __init__(self, timeout=1800.0, on_timeout=None, max_history=10000, flight_key=None):
        self.timeout = timeout
        self.on_timeout = on_timeout
        self.flight_key = flight_key
        # a known-lock site: held by user threads (watch enter and exit) and
        # by the scanner
        self._lock = _new_lock("distributed.watchdog.CommWatchdog")
        self._inflight = {}                         # id -> (desc, start)
        self._ids = itertools.count()
        self.events = collections.deque(maxlen=max_history)  # (desc, start, end)
        self.timed_out = []
        self.last_flight_dump = None
        self._stop = threading.Event()
        self._scanner = None

    # -- scanner -------------------------------------------------------------
    def _ensure_scanner(self):
        if self._scanner is None or not self._scanner.is_alive():
            self._stop.clear()
            self._scanner = threading.Thread(target=self._scan_loop, daemon=True)
            self._scanner.start()

    def _scan_loop(self):
        tick = max(min(1.0, self.timeout / 4.0), 0.01)
        fired = set()
        while not self._stop.wait(tick):
            now = time.monotonic()
            with self._lock:
                inflight = list(self._inflight.items())
                if not inflight:
                    continue
            for wid, (desc, start) in inflight:
                if wid in fired or start is None:  # None: paused
                    continue
                if now - start > self.timeout:
                    fired.add(wid)
                    self.timed_out.append(desc)
                    self._flight_dump(desc)
                    try:
                        if self.on_timeout is not None:
                            self.on_timeout(desc, self.dump())
                        else:
                            print(f"[comm watchdog] {desc} exceeded {self.timeout}s\n"
                                  f"{self.dump()}")
                    except Exception as e:  # noqa: BLE001 - a failing callback
                        # must not kill the scanner (later hangs still need an
                        # observer), but the failure must not vanish either
                        import traceback

                        print(f"[comm watchdog] on_timeout callback for {desc} raised "
                              f"{type(e).__name__}: {e}\n{traceback.format_exc()}",
                              file=sys.stderr)

    def _flight_dump(self, desc):
        """Write the flight recorder (open spans: the hang candidates; the
        recent spans; the metrics snapshot) to the file of ``flight_key``,
        when tracing is on or PADDLE_TPU_FLIGHT_DIR is set. A dump failure
        never masks the timeout it documents."""
        try:
            if _trace._state.on or os.environ.get("PADDLE_TPU_FLIGHT_DIR"):
                self.last_flight_dump = _trace.flight_dump(
                    reason=f"watchdog timeout: {desc} exceeded {self.timeout}s",
                    extra={"watchdog": self.dump()},
                    key=self.flight_key)
        except Exception:  # noqa: BLE001
            pass

    def stop(self):
        self._stop.set()
        if self._scanner is not None:
            self._scanner.join(timeout=5)

    # -- watch sections ------------------------------------------------------
    def watch(self, desc="collective"):
        return _Watch(self, desc)

    def dump(self):
        """In-flight sections first, then the recent history."""
        with self._lock:
            now = time.monotonic()
            lines = [f"[comm] {desc}: PAUSED" if start is None else
                     f"[comm] {desc}: {(now - start) * 1000:.1f} ms (IN FLIGHT)"
                     for desc, start in self._inflight.values()]
            lines += [f"[comm] {desc}: {(end - start) * 1000:.1f} ms (done)"
                      for desc, start, end in self.events]
            return "\n".join(lines)


@contextlib.contextmanager
def paused():
    """Stop the clock of the calling thread's open watch sections while the
    block runs (module docstring)."""
    watches = list(getattr(_OPEN, "stack", ()))
    for w in watches:
        w._pause()
    try:
        yield
    finally:
        for w in watches:
            w._resume()


class _Watch:
    def __init__(self, dog, desc):
        self._dog = dog
        self._desc = desc
        self._span = None
        self._elapsed = 0.0     # seconds counted before a pause

    def _pause(self):
        dog = self._dog
        with dog._lock:
            desc, start = dog._inflight[self._id]
            if start is not None:
                self._elapsed = time.monotonic() - start
                dog._inflight[self._id] = (desc, None)

    def _resume(self):
        dog = self._dog
        with dog._lock:
            desc, start = dog._inflight[self._id]
            if start is None:
                dog._inflight[self._id] = (desc, time.monotonic() - self._elapsed)

    def __enter__(self):
        dog = self._dog
        with dog._lock:
            self._id = next(dog._ids)
            dog._inflight[self._id] = (self._desc, time.monotonic())
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        stack.append(self)
        if _trace._state.on:
            # an open comm.wait span in a flight dump is the hang candidate
            self._span = _trace.start_span("comm.wait", attrs={"desc": self._desc})
        dog._ensure_scanner()
        return self

    def __exit__(self, exc_type, exc, tb):
        dog = self._dog
        _OPEN.stack.remove(self)
        with dog._lock:
            desc, start = dog._inflight.pop(self._id)
            end = time.monotonic()
            dog.events.append((desc, end - self._elapsed if start is None else start, end))
        _trace.end_span(self._span)
        return False

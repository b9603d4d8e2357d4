"""Hang detection for blocking sections: the port of
paddle_tpu/distributed/watchdog.py.

``CommWatchdog.watch(desc)`` wraps a blocking section (a serving step, a
collective's wait); one daemon scanner thread checks every section in flight
each tick and fires the timeout callback once per stuck section. Finished
sections land in a bounded history for ``dump()``.

What differs from the JAX package: a timeout writes no flight-recorder file
and a section opens no ``comm.wait`` span (both belong to the tracing slice,
ROADMAP Queue A item 7), so ``last_flight_dump`` stays ``None``, and with it
a serving engine's ``last_recovery_dump`` and the ``"dump"`` of its
``recovery_stats``. ``flight_key`` is accepted and kept for that slice. The
process-wide default watchdog of the eager collectives is not ported (the
port has no collectives yet). The lock is a plain ``threading.Lock``.
"""
from __future__ import annotations

import collections
import itertools
import sys
import threading
import time

__all__ = ["CommWatchdog", "WatchdogTimeout"]


class WatchdogTimeout(RuntimeError):
    pass


class CommWatchdog:
    def __init__(self, timeout=1800.0, on_timeout=None, max_history=10000, flight_key=None):
        self.timeout = timeout
        self.on_timeout = on_timeout
        self.flight_key = flight_key
        self._lock = threading.Lock()
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
                if wid in fired:
                    continue
                if now - start > self.timeout:
                    fired.add(wid)
                    self.timed_out.append(desc)
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
            lines = [f"[comm] {desc}: {(now - start) * 1000:.1f} ms (IN FLIGHT)"
                     for desc, start in self._inflight.values()]
            lines += [f"[comm] {desc}: {(end - start) * 1000:.1f} ms (done)"
                      for desc, start, end in self.events]
            return "\n".join(lines)


class _Watch:
    def __init__(self, dog, desc):
        self._dog = dog
        self._desc = desc

    def __enter__(self):
        dog = self._dog
        with dog._lock:
            self._id = next(dog._ids)
            dog._inflight[self._id] = (self._desc, time.monotonic())
        dog._ensure_scanner()
        return self

    def __exit__(self, exc_type, exc, tb):
        dog = self._dog
        with dog._lock:
            desc, start = dog._inflight.pop(self._id)
            dog.events.append((desc, start, time.monotonic()))
        return False

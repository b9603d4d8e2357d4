"""Snapshot provenance: who/where/when a metrics artifact was produced.

A test fixture (rev ``deadbee``, a year-2030 timestamp) replayed as a real
benchmark is exactly the failure a provenance block prevents. Every ``monitor.snapshot()`` carries one, and
:func:`validate` lets downstream consumers (bench replay, dashboards)
REFUSE artifacts whose provenance is a placeholder or from the future
instead of trusting them.
"""
from __future__ import annotations

import os
import socket
import subprocess
import time

__all__ = ["provenance", "git_rev", "is_placeholder_rev", "validate"]

# revs that mark synthetic/fixture artifacts, never a real checkout
PLACEHOLDER_REVS = frozenset({
    "deadbee", "deadbeef", "cafebabe", "badc0de", "baddcafe", "feedface",
    "unknown", "none", "null",
})

_HEX = frozenset("0123456789abcdef")
_CACHE = {}


def git_rev(short=True):
    """Short git rev of the repo this package lives in, or None outside a
    checkout. Cached: provenance is stamped on every snapshot."""
    key = ("rev", short)
    if key not in _CACHE:
        rev = None
        try:
            cmd = ["git", "rev-parse"] + (["--short"] if short else []) \
                + ["HEAD"]
            out = subprocess.run(
                cmd, capture_output=True, text=True, timeout=10,
                cwd=os.path.dirname(os.path.abspath(__file__)))
            rev = out.stdout.strip() or None
        except Exception:  # noqa: BLE001 - provenance must never raise
            rev = None
        _CACHE[key] = rev
    return _CACHE[key]


def _platform():
    """Device platform without forcing CUDA up: ``"gpu"`` only once CUDA is
    already initialised in this process (a snapshot during a run on the
    card), ``"cpu"`` when torch is loaded but CUDA is not, and
    ``"uninitialized"`` before torch is imported — a snapshot never starts
    a CUDA context (the JAX package's twin consults ``jax`` only once it
    is imported, for the same reason)."""
    import sys

    torch = sys.modules.get("torch")
    if torch is None:
        return "uninitialized"
    try:
        return "gpu" if torch.cuda.is_initialized() else "cpu"
    except Exception:  # noqa: BLE001
        return "unknown"


_MONOTONIC_START_NS = time.perf_counter_ns()
_WALL_START = time.time()


def provenance():
    """The provenance block attached to every snapshot. git_rev is OMITTED
    (not sentinel-filled) outside a git checkout: an absent rev means
    "unversioned deployment" and still validates, while a PRESENT
    placeholder marks forgery."""
    prov = {
        "hostname": socket.gethostname(),
        "pid": os.getpid(),
        "platform": _platform(),
        "monotonic_start_ns": _MONOTONIC_START_NS,
        "monotonic_ns": time.perf_counter_ns(),
        "wall_time": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                   time.gmtime()),
        "wall_time_unix": time.time(),
    }
    rev = git_rev()
    if rev is not None:
        prov["git_rev"] = rev
    return prov


def is_placeholder_rev(rev):
    """True when ``rev`` cannot be a real commit: empty, a known sentinel
    (deadbee & friends), all-zeros, or not hex at all."""
    if not rev:
        return True
    rev = str(rev).strip().lower()
    if rev in PLACEHOLDER_REVS:
        return True
    if not (7 <= len(rev) <= 40) or not set(rev) <= _HEX:
        return True
    if set(rev) == {"0"}:
        return True
    return False


def validate(prov, now=None, max_future_s=300.0):
    """Problems with a provenance block (empty list = trustworthy).

    Checks the two classes of forgery seen in the wild: a placeholder git
    rev and a wall timestamp in the future (clock skew up to
    ``max_future_s`` is tolerated).
    """
    problems = []
    if not isinstance(prov, dict):
        return [f"provenance block missing or not a dict: {prov!r}"]
    rev = prov.get("git_rev")
    # absent rev = unversioned deployment (fine); present-but-placeholder
    # or malformed = forgery
    if rev is not None and is_placeholder_rev(rev):
        problems.append(f"placeholder or malformed git rev: {rev!r}")
    now = time.time() if now is None else now
    wall = prov.get("wall_time_unix")
    if wall is None and prov.get("wall_time"):
        try:
            import calendar

            wall = calendar.timegm(
                time.strptime(prov["wall_time"], "%Y-%m-%dT%H:%M:%SZ"))
        except (ValueError, TypeError):
            problems.append(
                f"unparseable wall_time: {prov.get('wall_time')!r}")
    if wall is not None and wall > now + max_future_s:
        problems.append(
            f"timestamp in the future: {prov.get('wall_time') or wall}")
    return problems

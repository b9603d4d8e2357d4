"""Async sharded training checkpoints: the port of
paddle_tpu/checkpoint/manager.py, digest-verified, atomically committed,
resumable across a changed data-parallel degree.

The JAX package's behaviour and on-disk format, unchanged, so a checkpoint
written by either package restores in the other (and
``tools/ckpt_inspect.py`` verifies the port's):

- **asynchronous**: ``save()`` makes only the device->host copy on the
  calling (step) thread; serialization, fsync and the atomic commit run on
  one writer thread with double buffering (one write in flight and one
  staged), so step N+1 never blocks on step N's write;
- **integrity-checked**: every shard file carries a blake2b digest in the
  manifest; ``restore()`` re-hashes the bytes it reads and raises
  :class:`CheckpointCorrupt` on a mismatch (``restore_latest_valid`` falls
  back to the previous committed step);
- **atomic**: shards and manifest are written into a hidden temp directory,
  fsynced, then renamed into place by one ``os.replace``;
- **elastic**: ZeRO-1 per-replica optimizer-state slices are saved one shard
  per replica row and re-sliced onto the current dp degree at restore
  (``RestoredCheckpoint.zero_sharded``; plain numpy rows, as the JAX file
  keeps them);
- **bounded**: retention keeps the newest ``keep`` committed steps.

What the port adds: ``save()`` takes torch tensors (on any device) beside
numpy arrays, and copies each to host memory of its own before the writer
thread reads it. A bfloat16 tensor is stored as its uint16 bit pattern with
``"bfloat16"`` in the manifest entry, byte for byte what the JAX package
writes for an ``ml_dtypes.bfloat16`` array; it decodes without ``ml_dtypes``
(:meth:`RestoredCheckpoint.tensor`). Fault points ``ckpt.write`` and
``ckpt.restore`` fire through the port's harness. The graftsan witnesses
and the telemetry are no-op stubs until the port's observability slice
(ROADMAP Queue A item 7).

numpy and the standard library at import; torch is imported where a tensor
is copied or decoded.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import queue
import re
import shutil
import sys
import threading
import time

import numpy as np

from ..analysis import faultinject as _fi


class _san:  # noqa: N801 - module-shaped stub until ROADMAP Queue A item 7
    """The JAX manager's graftsan witnesses (lock order, data race): the
    port has no sanitizers yet (ROADMAP Queue A item 7), so a plain lock and
    no witness."""

    @staticmethod
    def new_lock(name, factory=threading.Lock):
        return factory()

    @staticmethod
    def race_access(owner, field, write=False):
        return None


import itertools as _itertools

# per-manager tag for the graftsan race witness (owner identity)
_CKPT_SEQ = _itertools.count(1)


__all__ = [
    "CheckpointError", "CheckpointCorrupt", "NoCheckpoint",
    "CheckpointManager", "RestoredCheckpoint",
    "FORMAT", "MANIFEST", "read_manifest", "verify_checkpoint",
    "step_dirs", "reshard_rows", "training_state", "load_training_state",
]

FORMAT = "paddle_tpu-ckpt-v1"
MANIFEST = "manifest.json"
_STEP_RE = re.compile(r"^step_(\d{8})$")
_TMP_PREFIX = ".tmp-"
_STOP = object()


class CheckpointError(RuntimeError):
    """Base class of every checkpoint failure."""


class CheckpointCorrupt(CheckpointError):
    """A shard's bytes do not match the manifest digest (or the manifest
    itself is unreadable): the checkpoint must not be restored."""

    def __init__(self, message, step=None, shard=""):
        super().__init__(message)
        self.step = step
        self.shard = shard


class NoCheckpoint(CheckpointError):
    """No committed (and digest-valid, when verifying) checkpoint exists."""


def _step_dirname(step):
    return f"step_{int(step):08d}"


def step_dirs(directory):
    """Committed steps under ``directory``: sorted ``[(step, path), ...]``.
    Only ``step_NNNNNNNN`` directories containing a manifest count — temp
    dirs and torn writes are invisible by construction."""
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for name in names:
        m = _STEP_RE.match(name)
        if not m:
            continue
        path = os.path.join(directory, name)
        if os.path.isfile(os.path.join(path, MANIFEST)):
            out.append((int(m.group(1)), path))
    out.sort()
    return out


def read_manifest(path):
    """Parse one checkpoint directory's manifest; raises
    :class:`CheckpointCorrupt` when it is missing or unparseable."""
    mf = os.path.join(path, MANIFEST)
    try:
        with open(mf) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorrupt(
            f"unreadable manifest {mf!r}: {e}") from e
    if doc.get("format") != FORMAT:
        raise CheckpointCorrupt(
            f"{mf!r}: unknown format {doc.get('format')!r} "
            f"(expected {FORMAT!r})")
    return doc


def _digest(data):
    return hashlib.blake2b(data, digest_size=16).hexdigest()


def _resolve_dtype(name):
    """Logical dtype from its string, including ml_dtypes (bfloat16,
    float8_*) when available; None when numpy cannot hold it."""
    try:
        return np.dtype(name)
    except TypeError:
        try:
            import ml_dtypes
        except ImportError:
            return None
        return np.dtype(getattr(ml_dtypes, name))


def _storable(arr):
    """npz/npy round-trips only native dtypes; ml_dtypes come back as
    opaque void — store the bit pattern as a same-width uint (the logical
    dtype is recorded in the manifest entry)."""
    if arr.dtype.kind == "V":
        return arr.view(f"u{arr.dtype.itemsize}")
    return arr


def _encode(arr):
    """One shard's on-disk bytes (npy container) + its digest."""
    buf = io.BytesIO()
    np.save(buf, _storable(np.ascontiguousarray(arr)), allow_pickle=False)
    data = buf.getvalue()
    return data, _digest(data)


def _decode(data, dtype_name):
    """The stored array in its logical dtype; where numpy cannot hold that
    dtype (bfloat16 without ml_dtypes), the stored bit pattern."""
    arr = np.load(io.BytesIO(data), allow_pickle=False)
    logical = _resolve_dtype(dtype_name)
    if logical is not None and arr.dtype != logical:
        arr = arr.view(logical)
    return arr


def _host_copy(value):
    """``(array, dtype name)``: a host copy of ``value`` that nothing else
    aliases. A torch tensor is copied off its device (synchronously, never
    ``non_blocking``, so the writer thread cannot read it before the copy
    lands); a bfloat16 or float8 tensor becomes its bit pattern."""
    torch = sys.modules.get("torch")  # a tensor exists only once torch is imported
    if torch is not None and isinstance(value, torch.Tensor):
        t = value.detach().to("cpu", copy=True)
        if t.dtype.is_floating_point and t.dtype.itemsize < 4 and t.dtype != torch.float16:
            name = str(t.dtype).replace("torch.", "")
            bits = {1: torch.uint8, 2: torch.int16}[t.dtype.itemsize]
            return t.contiguous().view(bits).numpy().view(f"u{t.dtype.itemsize}"), name
        return t.numpy(), str(t.dtype).replace("torch.", "")
    a = np.array(value, copy=True)
    return a, str(a.dtype)


def _read_shard_verified(path, name, sh, step=None):
    """ONE read of one shard, digest-gated: the returned bytes are
    exactly the bytes that were hashed (no verify-then-reread TOCTOU).
    Shared by ``verify_checkpoint`` (the ``tools/ckpt_inspect.py``
    contract) and ``restore()`` — a checkpoint the tool calls clean is a
    checkpoint the trainer will accept, by construction."""
    fp = os.path.join(path, sh["file"])
    try:
        with open(fp, "rb") as f:
            data = f.read()
    except OSError as e:
        raise CheckpointCorrupt(
            f"missing shard {sh['file']!r} of {name!r} under "
            f"{path!r}: {e}", step=step, shard=sh["file"]) from e
    if _digest(data) != sh["digest"]:
        raise CheckpointCorrupt(
            f"digest mismatch for shard {sh['file']!r} of {name!r} "
            f"under {path!r} (torn or corrupted write)",
            step=step, shard=sh["file"])
    return data


def verify_checkpoint(path):
    """Re-hash every shard of the checkpoint at ``path`` against its
    manifest. Returns the manifest doc; raises :class:`CheckpointCorrupt`
    on the first mismatch or missing shard."""
    doc = read_manifest(path)
    for name, ent in doc["entries"].items():
        for sh in ent["shards"]:
            _read_shard_verified(path, name, sh, step=doc.get("step"))
    return doc


class RestoredCheckpoint:
    """One restored checkpoint: host arrays + the re-shardable ZeRO flats.

    ``arrays``: {name: np.ndarray} for kind="full" entries.
    ``zero``:   {name: flat (numel,) np.ndarray} for kind="zero" entries —
    the logical UNSHARDED optimizer-state vector, gathered from however
    many replica rows the SAVING mesh had.
    """

    def __init__(self, step, path, arrays, zero, meta, manifest):
        self.step = step
        self.path = path
        self.arrays = arrays
        self.zero = zero
        self.meta = meta
        self.manifest = manifest

    def dtype(self, name):
        """The logical dtype name of an entry, as the manifest records it."""
        return self.manifest["entries"][name]["dtype"]

    def tensor(self, name, device=None):
        """A ``kind="full"`` entry as a torch tensor of its logical dtype on
        ``device`` (default the CPU). ``arrays[name]`` is numpy, which holds
        bfloat16 only through ``ml_dtypes``; without it ``arrays`` keeps the
        bit pattern, and this decodes it."""
        import torch

        arr = self.arrays[name]
        logical = self.dtype(name)
        if _resolve_dtype(logical) is None or arr.dtype.kind == "V" \
                or str(arr.dtype) != logical:
            target = getattr(torch, logical)
            bits = {1: np.uint8, 2: np.int16}[arr.dtype.itemsize]
            tbits = {1: torch.uint8, 2: torch.int16}[arr.dtype.itemsize]
            t = torch.from_numpy(np.ascontiguousarray(arr).view(bits)).view(tbits).view(target)
        else:
            t = torch.from_numpy(np.ascontiguousarray(arr))
        return t.to(device) if device is not None else t

    def zero_sharded(self, name, dp_degree):
        """Re-slice one ZeRO flat onto ``dp_degree`` replicas: the
        ``(dp_degree, k)`` zero-padded row layout
        ``mesh/zero.init_sharded_state`` produces — restoring onto a
        DIFFERENT dp degree than the save is exactly this re-slice."""
        return reshard_rows(self.zero[name], dp_degree)


def reshard_rows(flat, dp_degree):
    """A logical flat state vector -> the zero-padded ``(dp, k)`` row
    layout of ``mesh/zero.init_sharded_state``. THE one implementation of
    the ZeRO row layout on the host side — ``zero_sharded`` and the
    trainer's full->rows conversion both ride it."""
    flat = np.asarray(flat).reshape(-1)
    dp = int(dp_degree)
    k = -(-flat.shape[0] // dp)
    pad = dp * k - flat.shape[0]
    if pad:
        flat = np.concatenate([flat, np.zeros((pad,), flat.dtype)])
    return flat.reshape(dp, k)


def _telemetry(step, n_shards, total_bytes, seconds, kind):
    """The JAX manager's counters, histogram and span per commit and restore:
    a no-op until the port has a monitor (ROADMAP Queue A item 7)."""
    return None


class CheckpointManager:
    """Own one checkpoint directory: async digest-verified saves with an
    atomic-rename commit, bounded retention, and dp-elastic restore.

    ``save(step, arrays, zero=, meta=)`` snapshot contract:

    - ``arrays``: {name: torch tensor or array-like} — full (replicated)
      tensors: params, optimizer state, RNG state;
    - ``zero``: {name: (value, numel)} — per-replica sharded state in the
      ``(dp, k)`` row layout; ``numel`` is the TRUE element count of the
      logical vector (the rows carry zero padding);
    - ``meta``: any JSON-able payload (loss scale, dataloader cursor,
      dp degree, step provenance).

    The device->host copy happens synchronously inside ``save()`` (so the
    caller's next step may update its tensors in place at once);
    everything after — npy encode, digests, fsync, commit, retention —
    runs on the writer thread. ``wait()`` joins outstanding writes and
    re-raises the first failure.
    """

    def __init__(self, directory, keep=3):
        self.directory = str(directory)
        self.keep = int(keep)
        os.makedirs(self.directory, exist_ok=True)
        self._pending = queue.Queue(maxsize=1)  # + 1 in flight = 2 buffers
        self._writer = None
        self._errors = []
        self._err_lock = _san.new_lock(
            "checkpoint.CheckpointManager._err_lock")
        self._san_tag = f"ckpt{next(_CKPT_SEQ)}"
        self._clean_stale_tmp()

    # -- save ----------------------------------------------------------------
    def save(self, step, arrays, zero=None, meta=None, block=False):
        """Snapshot one step. Host copies happen here (the step thread);
        the write + commit happen on the writer thread unless ``block``.
        Returns ``step``."""
        job = self._prepare(int(step), arrays or {}, zero or {}, meta or {})
        if block:
            self._write(job)
        else:
            self._ensure_writer()
            self._pending.put(job)  # bounded: the double-buffer backstop
        return int(step)

    def _prepare(self, step, arrays, zero, meta):
        """The synchronous half: device->host copies only. The copy must
        be a real copy (``_host_copy``): a CPU tensor's ``.numpy()`` or
        ``.to("cpu")`` aliases its storage, and the caller's next step
        updates parameters and optimizer state in place, which would
        overwrite the bytes while the writer thread is still encoding,
        committing corrupted bytes under a valid digest."""
        t0 = time.perf_counter()
        host_full = {}
        for name, v in arrays.items():
            host_full[name] = _host_copy(v)
        host_zero = {}
        for name, (v, numel) in zero.items():
            a, dtype_name = _host_copy(v)
            if a.ndim != 2:
                raise ValueError(
                    f"zero entry {name!r} must be (dp, k)-shaped, "
                    f"got {a.shape}")
            host_zero[name] = (a, dtype_name, int(numel))
        return {"step": step, "full": host_full, "zero": host_zero,
                "meta": meta, "t0": t0}

    def _ensure_writer(self):
        if self._writer is None or not self._writer.is_alive():
            self._writer = threading.Thread(
                target=self._writer_loop, daemon=True,
                name="ckpt-writer")
            self._writer.start()

    def _writer_loop(self):
        while True:
            job = self._pending.get()
            if job is _STOP:
                self._pending.task_done()
                return
            try:
                self._write(job)
            except BaseException as e:  # surfaced by wait()
                with self._err_lock:
                    _san.race_access(self._san_tag, "_errors",
                                     write=True)
                    self._errors.append(e)
            finally:
                self._pending.task_done()

    def _write(self, job):
        """The asynchronous half: encode + digest + fsync + atomic commit
        + retention. ``ckpt.write`` fires HERE — action=raise leaves only
        the ignored temp directory (the torn-write drill), action=flag
        corrupts one shard's bytes AFTER its digest was recorded (the
        restore-must-reject drill)."""
        step = job["step"]
        final = os.path.join(self.directory, _step_dirname(step))
        if os.path.isfile(os.path.join(final, MANIFEST)):
            # already committed: a deterministic replay re-saves the
            # same step with the same bytes — keep the existing commit.
            # Deleting a good commit to rewrite it would open a crash
            # window that can DESTROY it (and a corrupted existing
            # commit is already handled by restore's fallback).
            return
        tmp = os.path.join(
            self.directory,
            f"{_TMP_PREFIX}{_step_dirname(step)}-{os.getpid()}")
        if os.path.isdir(tmp):
            shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        spec = _fi.fire("ckpt.write")
        corrupt = spec is not None and spec.action == "flag"
        entries = {}
        n, total = 0, 0
        for name, (arr, dtype_name) in job["full"].items():
            data, dig = _encode(arr)
            if corrupt:
                # flip one payload byte after digesting: the bytes on
                # disk no longer match the manifest — exactly what a torn
                # device write / bit rot looks like to restore()
                data = data[:-1] + bytes([data[-1] ^ 0xFF])
                corrupt = False
            fname = f"s{n:05d}.npy"
            n += 1
            total += len(data)
            self._fsync_write(os.path.join(tmp, fname), data)
            entries[name] = {
                "kind": "full", "dtype": dtype_name,
                "shape": list(arr.shape),
                "shards": [{"file": fname, "digest": dig,
                            "bytes": len(data)}],
            }
        for name, (arr, dtype_name, numel) in job["zero"].items():
            dp, k = arr.shape
            shards = []
            for row in range(dp):
                data, dig = _encode(arr[row])
                if corrupt:
                    data = data[:-1] + bytes([data[-1] ^ 0xFF])
                    corrupt = False
                fname = f"s{n:05d}.npy"
                n += 1
                total += len(data)
                self._fsync_write(os.path.join(tmp, fname), data)
                shards.append({"file": fname, "digest": dig,
                               "bytes": len(data), "row": row})
            entries[name] = {
                "kind": "zero", "dtype": dtype_name, "numel": numel,
                "dp": dp, "slice_len": k, "shards": shards,
            }
        manifest = {
            "format": FORMAT, "step": step,
            "saved_unix": time.time(),
            "meta": job["meta"], "entries": entries,
            "total_bytes": total, "n_shards": n,
        }
        self._fsync_write(
            os.path.join(tmp, MANIFEST),
            json.dumps(manifest, indent=1, sort_keys=True).encode())
        if os.path.isdir(final):
            # a manifest-less leftover (torn write) is not a commit:
            # clearing it loses nothing
            shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)  # THE commit: readers see all-or-nothing
        self._fsync_dir(self.directory)
        self._prune()
        _telemetry(step, n, total, time.perf_counter() - job["t0"], "save")

    @staticmethod
    def _fsync_write(path, data):
        with open(path, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())

    @staticmethod
    def _fsync_dir(path):
        try:
            fd = os.open(path, os.O_RDONLY)
        except OSError:  # pragma: no cover - platform without dir fds
            return
        try:
            os.fsync(fd)
        except OSError:  # pragma: no cover
            pass
        finally:
            os.close(fd)

    def _prune(self):
        committed = step_dirs(self.directory)
        for _, path in committed[:max(0, len(committed) - self.keep)]:
            shutil.rmtree(path, ignore_errors=True)

    def _clean_stale_tmp(self):
        try:
            names = os.listdir(self.directory)
        except OSError:
            return
        for name in names:
            if name.startswith(_TMP_PREFIX):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    def clear(self):
        """Delete EVERY committed step (and stale temp dirs) — the fresh-
        run reset: a trainer starting with ``resume=False`` must not let
        a later recovery restore a PRIOR run's state from the same
        directory. Flushes in-flight writes first."""
        self.wait()
        for _, path in step_dirs(self.directory):
            shutil.rmtree(path, ignore_errors=True)
        self._clean_stale_tmp()

    def wait(self):
        """Join outstanding async writes; re-raise the first failure (a
        silently lost checkpoint would otherwise only surface at restore
        time)."""
        self._pending.join()
        with self._err_lock:
            _san.race_access(self._san_tag, "_errors", write=True)
            errors, self._errors = self._errors, []
        if errors:
            raise errors[0]

    def close(self):
        """Flush and stop the writer thread."""
        if self._writer is not None and self._writer.is_alive():
            self._pending.put(_STOP)
            self._writer.join(timeout=30)
        self._writer = None

    def status(self):
        """The manager's graftscope /statusz section (embedded in the
        trainer's): commit state read from the directory listing —
        numpy+stdlib only, like everything in this module."""
        steps = self.steps()
        return {
            "directory": str(self.directory),
            "committed": len(steps),
            "steps": steps[-5:],
            "latest_step": steps[-1] if steps else None,
            "keep": self.keep,
            "writer_alive": bool(self._writer is not None
                                 and self._writer.is_alive()),
        }

    # -- restore -------------------------------------------------------------
    def steps(self):
        """Committed step numbers, ascending."""
        return [s for s, _ in step_dirs(self.directory)]

    def latest_step(self):
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step=None):
        """Load ONE committed checkpoint (default: the newest), verifying
        every shard digest. Raises :class:`CheckpointCorrupt` on any
        mismatch and :class:`NoCheckpoint` when nothing is committed."""
        _fi.fire("ckpt.restore")
        committed = dict(step_dirs(self.directory))
        if step is None:
            if not committed:
                raise NoCheckpoint(
                    f"no committed checkpoint under {self.directory!r}")
            step = max(committed)
        elif int(step) not in committed:
            raise NoCheckpoint(
                f"step {step} is not committed under {self.directory!r} "
                f"(have: {sorted(committed)})")
        t0 = time.perf_counter()
        path = committed[int(step)]
        doc = read_manifest(path)
        arrays, zero = {}, {}
        for name, ent in doc["entries"].items():
            if ent["kind"] == "full":
                arr = _decode(
                    _read_shard_verified(path, name, ent["shards"][0],
                                         step=doc.get("step")),
                    ent["dtype"])
                arrays[name] = arr.reshape(tuple(ent["shape"]))
            else:
                rows = [
                    _decode(_read_shard_verified(path, name, sh,
                                                 step=doc.get("step")),
                            ent["dtype"])
                    for sh in sorted(ent["shards"],
                                     key=lambda s: s["row"])]
                flat = np.concatenate([r.reshape(-1) for r in rows])
                zero[name] = flat[:int(ent["numel"])]
        rc = RestoredCheckpoint(int(step), path, arrays, zero,
                                doc.get("meta", {}), doc)
        _telemetry(int(step), doc.get("n_shards", 0),
                   doc.get("total_bytes", 0),
                   time.perf_counter() - t0, "restore")
        return rc

    def restore_latest_valid(self):
        """Newest committed checkpoint that passes digest verification —
        a torn or corrupted newest step FALLS BACK to the previous commit
        instead of failing the recovery. Raises :class:`NoCheckpoint`
        when none survives (the per-step failures are attached as
        ``.failures``)."""
        failures = []
        for step in sorted(self.steps(), reverse=True):
            try:
                return self.restore(step)
            except CheckpointCorrupt as e:
                failures.append((step, str(e)))
        err = NoCheckpoint(
            f"no digest-valid committed checkpoint under "
            f"{self.directory!r}"
            + (f"; rejected: {failures}" if failures else ""))
        err.failures = failures
        raise err


def training_state(model, optimizer):
    """``(arrays, meta)`` for :meth:`CheckpointManager.save`: the model's
    ``state_dict()`` under ``"model/<key>"``, the optimizer's state tensors
    under ``"opt/<key>"`` and its master weights under
    ``"opt/master_weights/<name>"`` (the optimizer ``state_dict()``'s JAX
    keys), its ``"@step"`` and ``"LR_Scheduler"`` in ``meta``, and the state
    of a scheduler that ``LinearWarmup`` wraps under
    ``"LR_Scheduler.lr_sched"`` (the JAX scheduler's ``state_dict()`` holds
    no nested scheduler). The tensors are the live ones: ``save()`` copies
    them to the host before it returns."""
    arrays = {f"model/{k}": v for k, v in model.state_dict().items()}
    state = optimizer.state_dict()
    for k, v in state.items():
        if k == "master_weights":
            arrays.update({f"opt/master_weights/{n}": t for n, t in v.items()})
        elif k not in ("@step", "LR_Scheduler"):
            arrays[f"opt/{k}"] = v
    meta = {"@step": state["@step"], "LR_Scheduler": state["LR_Scheduler"]}
    inner = getattr(optimizer._learning_rate, "lr_sched", None)
    if inner is not None:
        meta["LR_Scheduler.lr_sched"] = inner.state_dict()
    return arrays, meta


def load_training_state(restored, model, optimizer):
    """Load a :func:`training_state` checkpoint (a :class:`RestoredCheckpoint`)
    into ``model`` (its parameters' device and dtype) and ``optimizer``
    (``set_state_dict``, which also restores its LR scheduler)."""
    dev = next(model.parameters()).device
    model.load_state_dict({k[len("model/"):]: restored.tensor(k, dev)
                           for k in restored.arrays if k.startswith("model/")})
    state = {"master_weights": {}, "@step": restored.meta.get("@step", 0),
             "LR_Scheduler": restored.meta.get("LR_Scheduler", {})}
    for k in restored.arrays:
        if k.startswith("opt/master_weights/"):
            state["master_weights"][k[len("opt/master_weights/"):]] = restored.tensor(k, dev)
        elif k.startswith("opt/"):
            state[k[len("opt/"):]] = restored.tensor(k, dev)
    optimizer.set_state_dict(state)
    inner = getattr(optimizer._learning_rate, "lr_sched", None)
    if inner is not None and "LR_Scheduler.lr_sched" in restored.meta:
        inner.set_state_dict(restored.meta["LR_Scheduler.lr_sched"])

"""Multiprocess DataLoader workers with shared-memory batch transport: the
port of ``paddle_tpu/io/worker.py``.

Reference analog: python/paddle/io/dataloader/dataloader_iter.py:154,368
(_DataLoaderIterMultiProcess — per-worker index queues, shared-memory tensor
transport via core._convert_to_shared_memory, reorder by receive index, worker
liveness watch) and worker.py (_worker_loop, WorkerInfo).

Workers are forked processes that run the dataset's Python code and the
collate function. They never touch CUDA: a process forked after its parent
initialised CUDA cannot use the card ("Cannot re-initialize CUDA in forked
subprocess"), so a CUDA tensor in a sample or a collated batch raises a
``TypeError`` in the worker, which reaches the parent as a ``RuntimeError``
(the JAX package's error for its device tensors). CPU torch tensors are host
data: they travel as numpy arrays. A batch goes to the parent through the
worker's native shared-memory ring (``native_shm.py``: one pickle header and
the arrays' raw bytes as out-of-band frames), or, when the ring is missing or
the batch does not fit it, through one ``multiprocessing.shared_memory``
segment an array: the worker writes the bytes once, the queue carries only a
descriptor, and the parent copies out and unlinks. ``stats`` counts the
batches each transport carried and the bytes that crossed the rings.
"""
from __future__ import annotations

import multiprocessing
import os
import queue as queue_mod
import time
import traceback
from multiprocessing import shared_memory

import numpy as np
import torch


class WorkerInfo:
    def __init__(self, id, num_workers, dataset, seed=None):  # noqa: A002
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset
        self.seed = seed

    def __repr__(self):
        return (f"WorkerInfo(id={self.id}, num_workers={self.num_workers})")


_WORKER_INFO = [None]  # set inside forked worker processes


def get_worker_info():
    return _WORKER_INFO[0]


# -- shared-memory packing ---------------------------------------------------
_SHM_TAG = "__paddle_tpu_shm__"


def _host_arrays(obj):
    """The batch tree with CPU torch tensors as numpy arrays (dtypes numpy
    lacks, such as bfloat16, stay tensors and are pickled)."""
    if isinstance(obj, torch.Tensor) and not obj.is_cuda:
        try:
            return obj.detach().numpy()
        except TypeError:
            return obj
    if isinstance(obj, dict):
        return {k: _host_arrays(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        out = [_host_arrays(v) for v in obj]
        return out if isinstance(obj, list) else tuple(out)
    return obj


def _pack(obj, segments):
    """Replace ndarrays in a collated batch tree with shm descriptors."""
    if isinstance(obj, np.ndarray) and obj.nbytes > 0:
        shm = shared_memory.SharedMemory(create=True, size=obj.nbytes)
        segments.append(shm)  # appended FIRST so a later failure can clean up
        view = np.ndarray(obj.shape, obj.dtype, buffer=shm.buf)
        view[...] = obj
        return (_SHM_TAG, shm.name, obj.shape, str(obj.dtype))
    if isinstance(obj, dict):
        return {k: _pack(v, segments) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        packed = [_pack(v, segments) for v in obj]
        return packed if isinstance(obj, list) else tuple(packed)
    return obj


def _unpack(obj):
    """Reconstruct ndarrays from shm descriptors (copy out, close + unlink)."""
    if isinstance(obj, tuple) and len(obj) == 4 and obj[0] == _SHM_TAG:
        _, name, shape, dtype = obj
        shm = shared_memory.SharedMemory(name=name)
        try:
            arr = np.array(
                np.ndarray(shape, np.dtype(dtype), buffer=shm.buf))
        finally:
            shm.close()
            try:
                shm.unlink()
            except FileNotFoundError:
                pass
        return arr
    if isinstance(obj, dict):
        return {k: _unpack(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unpack(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_unpack(v) for v in obj)
    return obj


def _contains_device_tensor(obj):
    """Whether the tree holds a CUDA tensor (``is_cuda`` reads the tensor's
    device; it does not initialise CUDA)."""
    if isinstance(obj, torch.Tensor):
        return obj.is_cuda
    if isinstance(obj, dict):
        return any(_contains_device_tensor(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return any(_contains_device_tensor(v) for v in obj)
    return False


def _disown_and_close(segments, unlink=False):
    for shm in segments:
        try:
            from multiprocessing import resource_tracker

            resource_tracker.unregister(shm._name, "shared_memory")
        except Exception:
            pass
        try:
            shm.close()
            if unlink:
                shm.unlink()
        except Exception:
            pass
    segments.clear()


def _worker_loop(dataset, collate_fn, index_queue, result_queue, worker_id,
                 num_workers, worker_init_fn, base_seed, ring_name=None):
    """Body of one forked worker (reference worker.py _worker_loop)."""
    _WORKER_INFO[0] = WorkerInfo(worker_id, num_workers, dataset,
                                 seed=(base_seed + worker_id
                                       if base_seed is not None else None))
    parent_pid = os.getppid()  # the REAL parent; may legitimately be pid 1
    torch.set_num_threads(1)   # torch's CPU ops in a worker: one thread each
    ring = None
    if ring_name is not None:
        try:
            from .native_shm import ShmRing

            ring = ShmRing(ring_name)
        except Exception:
            ring = None  # fall back to the per-array SharedMemory path
    if base_seed is not None:
        import random

        np.random.seed((base_seed + worker_id) % (2 ** 31))
        # python's random too: forked workers otherwise share the parent's
        # Mersenne state and draw identical augmentation streams
        random.seed(base_seed + worker_id)
    try:
        if worker_init_fn is not None:
            worker_init_fn(worker_id)
    except Exception:  # noqa: BLE001
        result_queue.put(("error", -1, traceback.format_exc()))
        return
    while True:
        job = index_queue.get()
        if job is None:
            return
        seq, indices = job
        segments = []
        try:
            samples = [dataset[i] for i in indices]
            if _contains_device_tensor(samples):
                raise TypeError(
                    "dataset returned CUDA tensors inside a forked worker; "
                    "forked children must not touch CUDA — use a dataset that "
                    "returns numpy arrays or CPU tensors, or set "
                    "DataLoader(use_shared_memory=False) for the thread "
                    "fallback")
            batch = collate_fn(samples)
            if _contains_device_tensor(batch):
                raise TypeError(
                    "collate_fn produced CUDA tensors inside a forked "
                    "worker; forked children must not touch CUDA — collate "
                    "on the host (the parent stages to the device) or set "
                    "DataLoader(use_shared_memory=False)")
            batch = _host_arrays(batch)
            if ring is not None:
                # native transport: one memcpy into the shared ring instead of
                # per-array shm segments
                import pickle

                # out-of-band buffers: array bytes go to the ring RAW instead
                # of being copied into the pickle stream first
                oob = []
                header = pickle.dumps((seq, batch), protocol=5,
                                      buffer_callback=oob.append)
                frames = [header] + [b.raw() for b in oob]
                try:
                    total = sum(len(f) + 16 for f in frames)
                    if total + 16 > ring.capacity:
                        raise ValueError("batch exceeds ring")

                    def push_frame(f):
                        while not ring.push(f, timeout=1.0):
                            # parent gone (reparented away from the ORIGINAL
                            # parent) or shutdown sentinel: stop retrying so
                            # join can proceed
                            if os.getppid() != parent_pid:
                                return False
                            try:
                                job2 = index_queue.get_nowait()
                            except queue_mod.Empty:
                                continue
                            if job2 is None:
                                return False
                            index_queue.put(job2)  # keep for after this push
                        return True

                    if not all(push_frame(f) for f in frames):
                        return
                    result_queue.put(("ring", seq, (worker_id, len(oob))))
                    continue
                except ValueError:
                    pass  # batch larger than the ring: per-array shm fallback
            payload = _pack(batch, segments)
            result_queue.put(("ok", seq, payload))
            # only after a successful put does the parent own cleanup:
            # deregister from this worker's resource tracker (so worker
            # exit doesn't warn about names the parent unlinks) and close.
            # If the worker is killed BEFORE the put, the tracker still
            # owns the segments and reclaims them at exit.
            _disown_and_close(segments)
        except Exception:  # noqa: BLE001 — surfaced in the parent
            _disown_and_close(segments, unlink=True)  # reclaim partial packs
            result_queue.put(("error", seq, traceback.format_exc()))


class MultiprocessBatchLoader:
    """Order-preserving fan-out of index batches over forked workers.

    Reusable across epochs (reference persistent_workers): call ``epoch(it)``
    per pass; ``shutdown()`` when done.
    """

    _POLL_S = 2.0  # liveness check cadence while waiting on results

    def __init__(self, dataset, collate_fn, num_workers,
                 prefetch_factor=2, timeout=0, worker_init_fn=None, base_seed=None,
                 ring_capacity=64 << 20):
        self._ctx = multiprocessing.get_context("fork")
        self._index_queues = [self._ctx.Queue() for _ in range(num_workers)]
        self._result_queue = self._ctx.Queue()
        self._timeout = timeout or None
        self._num_workers = num_workers
        self._max_outstanding = num_workers * max(prefetch_factor, 2)
        self._send_seq = 0
        self._recv_seq = 0
        #: batches each transport carried, and the bytes the rings carried
        self.stats = {"ring": 0, "shm": 0, "ring_bytes": 0}
        # native shared-memory rings (one SPSC ring per worker) when the C++
        # transport compiled; workers fall back per-batch when a batch exceeds
        # the ring, and entirely when attach fails
        self._rings = {}
        ring_names = [None] * num_workers
        try:
            from .native_shm import ShmRing, available

            if available():
                uid = f"{os.getpid()}_{id(self) & 0xFFFFFF:x}"
                for wid in range(num_workers):
                    name = f"/pt_dl_{uid}_{wid}"
                    self._rings[wid] = ShmRing(
                        name, capacity=ring_capacity, create=True)
                    ring_names[wid] = name
        except Exception:
            self._rings = {}
            ring_names = [None] * num_workers
        self._workers = [
            self._ctx.Process(
                target=_worker_loop,
                args=(dataset, collate_fn, self._index_queues[wid],
                      self._result_queue, wid, num_workers, worker_init_fn,
                      base_seed, ring_names[wid]),
                daemon=True)
            for wid in range(num_workers)
        ]
        for p in self._workers:
            p.start()
        self._closed = False

    def _check_alive(self):
        dead = [i for i, p in enumerate(self._workers) if not p.is_alive()]
        if dead:
            self.shutdown()
            raise RuntimeError(
                f"DataLoader worker(s) {dead} exited unexpectedly "
                "(killed or crashed before reporting)")

    def _get_result(self):
        """result_queue.get with liveness polling so a dead worker raises
        instead of blocking forever (reference watchdog semantics)."""
        deadline = (time.monotonic() + self._timeout
                    if self._timeout is not None else None)
        while True:
            try:
                return self._result_queue.get(timeout=self._POLL_S)
            except queue_mod.Empty:
                self._check_alive()
                if deadline is not None and time.monotonic() > deadline:
                    self.shutdown()
                    raise TimeoutError(
                        f"DataLoader worker timed out after {self._timeout}s "
                        "(stuck transform?)") from None

    def epoch(self, batch_indices_iter):
        """Yield collated batches for one pass over the given index batches."""
        if self._closed:
            raise RuntimeError("MultiprocessBatchLoader already shut down")
        if getattr(self, "_epoch_active", False):
            # two interleaved epochs would steal each other's results off the
            # shared result queue and hang on sequence numbers the other took
            raise RuntimeError(
                "a previous epoch over this worker pool is still active; "
                "finish it (or use a second DataLoader) before starting "
                "another pass")
        self._epoch_active = True
        it = iter(batch_indices_iter)
        outstanding = 0
        reorder = {}

        def feed():
            nonlocal it, outstanding
            while outstanding < self._max_outstanding and it is not None:
                try:
                    indices = next(it)
                except StopIteration:
                    it = None
                    return
                wid = self._send_seq % self._num_workers
                self._index_queues[wid].put((self._send_seq, list(indices)))
                self._send_seq += 1
                outstanding += 1

        try:
            feed()
            while outstanding > 0:
                while self._recv_seq in reorder:
                    batch = reorder.pop(self._recv_seq)
                    self._recv_seq += 1
                    outstanding -= 1
                    feed()
                    yield batch
                if outstanding == 0:
                    break
                status, seq, payload = self._get_result()
                if status == "error":
                    self.shutdown()
                    raise RuntimeError(
                        f"DataLoader worker failed:\n{payload}")
                if status == "ring":
                    import pickle

                    wid, n_oob = payload
                    ring = self._rings[wid]
                    frames = []
                    for _ in range(1 + n_oob):
                        blob = ring.pop(timeout=self._timeout or 300)
                        if blob is None:
                            self.shutdown()
                            raise TimeoutError(
                                "ring marker arrived but payload never did "
                                f"(worker {wid})")
                        frames.append(blob)
                    # out-of-band reconstruct: arrays view the popped frames
                    ring_seq, batch = pickle.loads(frames[0],
                                                   buffers=frames[1:])
                    if ring_seq != seq:  # SPSC FIFO: marker order == data order
                        self.shutdown()
                        raise RuntimeError(
                            f"ring transport desynchronized: marker seq {seq} "
                            f"!= payload seq {ring_seq} (worker {wid})")
                    self.stats["ring"] += 1
                    self.stats["ring_bytes"] += sum(len(f) for f in frames)
                    reorder[seq] = batch
                else:
                    self.stats["shm"] += 1
                    reorder[seq] = _unpack(payload)
        except GeneratorExit:
            # consumer abandoned the epoch mid-way: outstanding results would
            # desynchronize seq bookkeeping; tear the pool down
            self.shutdown()
            raise
        finally:
            self._epoch_active = False

    def shutdown(self):
        if self._closed:
            return
        self._closed = True
        for q in self._index_queues:
            try:
                q.put(None)
            except (ValueError, OSError):
                pass
        for p in self._workers:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
        # drain in-flight results and unlink their shm segments; a feeder
        # thread may still be flushing, so poll with a short timeout until
        # the pipe stays empty
        empty_rounds = 0
        while empty_rounds < 2:
            try:
                status, _, payload = self._result_queue.get(timeout=0.2)
                if status == "ok":
                    _unpack(payload)
            except queue_mod.Empty:
                empty_rounds += 1
        for ring in self._rings.values():
            try:
                ring.close()
                ring.unlink()
            except Exception:
                pass
        self._rings = {}

    def __del__(self):
        try:
            self.shutdown()
        except Exception:
            pass


def fork_available():
    return os.name == "posix" and "fork" in multiprocessing.get_all_start_methods()

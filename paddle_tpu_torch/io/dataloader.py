"""DataLoader with threaded prefetch and device staging: the port of
``paddle_tpu/io/dataloader.py``.

Reference analog: python/paddle/io/dataloader/dataloader_iter.py (multiprocess
workers and shared-memory queues) and the C++ double-buffer prefetcher
(phi/core/operators/reader/buffered_reader.h). Batches are collated on the
host (forked workers, a thread pool, or the caller's thread), and a producer
thread stages the next batch onto the device while the current step runs.

Staging onto the card (``_to_device``): each numpy leaf is copied once into
pinned host memory and copied to the card with ``non_blocking=True`` on the
producer's own CUDA stream; the producer records an event after the batch's
copies, and the consumer's stream waits on that event before it takes the
batch, with ``record_stream`` telling the caching allocator that the consumer's
stream uses the tensors. No host sync is made: the consumer's kernels are
ordered after the copies on the card. The pinned buffers are released after
the copies are issued; PyTorch's pinned-memory allocator holds such a buffer
until the copy that reads it has run. CPU torch tensors are staged the same
way; tensors already on the loader's device are passed on. The loader stages
onto the card unless ``places`` or ``device`` names the CPU (or
``device.set_device("cpu")`` was called): on the CPU the leaves become CPU
tensors. With the hostsync sanitizer on, the producer stages each batch inside
a protected region (``dataloader.stage``), so a device-to-host sync there
trips as one in a training step does.

The order of batches is the sampler's: a shuffling sampler draws from numpy's
global stream (``sampler.py``), and the forked workers' ``base_seed`` comes
from Python's ``random``, so batch order does not depend on ``num_workers``.
The monitor's ``paddle_tpu_dataloader_batches_total`` and
``paddle_tpu_dataloader_fetch_latency_ns`` and the ``dataloader.batch`` span
record the consumer's wait for each batch, as in the JAX package; the
``profiler.timer`` reader hooks time the outermost loader of a benchmark run.
``CursorLoader.__next__`` fires the fault point ``data.next``.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..analysis import faultinject as _fi
from ..analysis import sanitizers as _san
from .dataset import IterableDataset
from .sampler import BatchSampler

_worker_info = threading.local()

_MON = None  # (state, batches counter, fetch-latency histogram, now_ns,
#              trace._state, trace module)


def _mon():
    global _MON
    if _MON is None:
        from .. import monitor as _m

        _MON = (_m._state,
                _m.counter("paddle_tpu_dataloader_batches_total"),
                _m.histogram("paddle_tpu_dataloader_fetch_latency_ns"),
                _m.now_ns, _m.trace._state, _m.trace)
    return _MON


def get_worker_info():
    from .worker import get_worker_info as _mp_worker_info

    info = _mp_worker_info()  # set inside forked subprocess workers
    if info is not None:
        return info
    return getattr(_worker_info, "info", None)


def default_collate_fn(batch):
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, np.float32)
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, (tuple, list)):
        return [default_collate_fn(list(items)) for items in zip(*batch)]
    return batch


def _numeric(arr):
    return arr.dtype.kind in "biufc"


def _to_device(batch, device):
    """The collated batch with its numpy leaves and host tensors on
    ``device``. For the card: one copy into pinned memory a leaf, then an
    asynchronous copy on the current stream."""
    if isinstance(batch, np.ndarray):
        if not _numeric(batch):
            return batch
        if device.type != "cuda":
            return torch.from_numpy(np.array(batch))
        dtype = torch.from_numpy(np.empty(0, batch.dtype)).dtype
        pinned = torch.empty(batch.shape, dtype=dtype, pin_memory=True)
        pinned.numpy()[...] = batch
        return pinned.to(device, non_blocking=True)
    if isinstance(batch, torch.Tensor):
        if batch.device == device:
            return batch
        if device.type == "cuda" and not batch.is_cuda:
            return batch.pin_memory().to(device, non_blocking=True)
        return batch.to(device)
    if isinstance(batch, dict):
        return {k: _to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        out = [_to_device(v, device) for v in batch]
        return out if isinstance(batch, list) else tuple(out)
    return batch


def _record_stream(batch, stream):
    """Tell the caching allocator that ``stream`` uses the batch's tensors."""
    if isinstance(batch, torch.Tensor):
        if batch.is_cuda:
            batch.record_stream(stream)
    elif isinstance(batch, dict):
        for v in batch.values():
            _record_stream(v, stream)
    elif isinstance(batch, (list, tuple)):
        for v in batch:
            _record_stream(v, stream)


def _place_device(places, device):
    """The loader's device from ``device``, else ``places`` (a place, a
    device string or a list of them: the first), else the port's default
    (the card, or the CPU after ``set_device("cpu")``)."""
    from .. import resolve_device

    if device is None and places is not None:
        place = places[0] if isinstance(places, (list, tuple)) else places
        device = getattr(place, "device", place)
    return resolve_device(device)


class CursorLoader:
    """A resumable batch stream with an EXACT integer cursor — the
    dataloader half of the checkpoint resume-determinism contract
    (docs/checkpoint.md).

    Wraps any deterministically-ordered loader/iterable and yields its
    batches forever (cycling epochs), counting every batch yielded. The
    cursor (``state_dict()``) rides each training checkpoint (the port's
    ``CheckpointManager`` ``meta``); ``set_state_dict()`` rewinds by
    re-iterating from the start and skipping exactly ``cursor`` batches, so
    the batch a restored step sees is the batch the original step saw. The
    wrapped loader must produce the same order every pass (``shuffle=False``,
    or a shuffle whose numpy stream is seeded the same before each run) —
    resume-determinism is only as strong as the underlying order.
    """

    def __init__(self, loader):
        self.loader = loader
        self.cursor = 0        # total batches yielded across epochs
        self.epoch = 0
        self._it = None

    def state_dict(self):
        return {"cursor": self.cursor, "epoch": self.epoch}

    def set_state_dict(self, state):
        """Rewind to an exact cursor: restart the underlying loader and
        fast-forward ``cursor`` batches (deterministic order required).
        Completed epochs of a SIZED loader are skipped arithmetically —
        only the partial epoch's batches are actually re-fetched, so a
        deep resume costs O(batches into the current epoch), not
        O(total batches ever trained)."""
        target = int(state["cursor"])
        self.cursor = 0
        self.epoch = 0
        self._it = None
        try:
            per_epoch = len(self.loader)
        except TypeError:          # unsized (IterableDataset): replay all
            per_epoch = 0
        if per_epoch > 0:
            self.epoch, remainder = divmod(target, per_epoch)
            self.cursor = target - remainder
        for _ in range(target - self.cursor):
            self._advance()

    def _advance(self):
        if self._it is None:
            self._it = iter(self.loader)
        try:
            batch = next(self._it)
        except StopIteration:
            self.epoch += 1
            self._it = iter(self.loader)
            batch = next(self._it)     # an empty loader IS an error
        self.cursor += 1
        return batch

    def __iter__(self):
        return self

    def __next__(self):
        # the drillable data-pipeline hazard (kill/stall mid-epoch)
        _fi.fire("data.next")
        return self._advance()


class DataLoader:
    """paddle.io.DataLoader. ``device`` (a port addition) or ``places``
    chooses where the batches are staged: the card by default."""

    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False, drop_last=False,
                 collate_fn=None, num_workers=0, use_buffer_reader=True,
                 prefetch_factor=2, use_shared_memory=True, timeout=0,
                 worker_init_fn=None, persistent_workers=False, device=None):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = max(prefetch_factor, 2)
        self.use_buffer_reader = use_buffer_reader
        self.use_shared_memory_workers = use_shared_memory
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.persistent_workers = persistent_workers
        self.places = places
        self.device = device
        self._persistent_pool = None
        self._mp_decision = None
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            if batch_size is None:
                self.batch_sampler = None
                self.batch_size = None
            else:
                self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                                  batch_size=batch_size, drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no len()")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    def _batches(self):
        if self._iterable_mode:
            batch = []
            for item in self.dataset:
                batch.append(item)
                if len(batch) == self.batch_size:
                    yield self.collate_fn(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self.collate_fn(batch)
            return
        if self.batch_sampler is None:
            for i in range(len(self.dataset)):
                yield self.collate_fn([self.dataset[i]])
            return
        if self.num_workers > 0:
            if self._use_subprocess_workers():
                yield from self._mp_batches()
            else:
                yield from self._thread_batches()
            return
        for indices in self.batch_sampler:
            yield self.collate_fn([self.dataset[i] for i in indices])

    def _use_subprocess_workers(self):
        """Subprocess workers (reference dataloader_iter.py:368 multiprocess
        path) unless fork is unavailable or sample 0 holds a CUDA tensor —
        forked children must never touch CUDA, so such datasets fall back to
        the GIL-sharing thread pool. The probe reads dataset[0] directly
        (NOT through the batch sampler — that would consume one-shot samplers
        and advance the shuffle RNG); it is best-effort, and the worker itself
        rejects CUDA tensors with a clear error for datasets that mix types.
        CPU tensors are host data and go through the workers."""
        from .worker import _contains_device_tensor, fork_available

        if self._mp_decision is not None:
            return self._mp_decision  # probe once, not one sample per epoch
        if not self.use_shared_memory_workers or not fork_available():
            self._mp_decision = False
            return False
        try:
            sample = self.dataset[0]
        except Exception:
            self._mp_decision = False
            return False
        self._mp_decision = not _contains_device_tensor(sample)
        return self._mp_decision

    def _mp_batches(self):
        from .worker import MultiprocessBatchLoader

        pool = self._persistent_pool
        if pool is None or pool._closed:
            pool = MultiprocessBatchLoader(
                self.dataset, self.collate_fn,
                num_workers=self.num_workers,
                prefetch_factor=self.prefetch_factor,
                timeout=self.timeout,
                worker_init_fn=self.worker_init_fn,
                # python's random stream, NOT np.random: drawing from np here
                # would advance the sampler's shuffle RNG and make batch order
                # depend on num_workers
                base_seed=__import__("random").getrandbits(30))
            if self.persistent_workers:
                self._persistent_pool = pool
        self._last_pool = pool
        try:
            yield from pool.epoch(iter(self.batch_sampler))
        finally:
            if not self.persistent_workers:
                pool.shutdown()

    def _thread_batches(self):
        with ThreadPoolExecutor(self.num_workers) as pool:
            def fetch(indices):
                return self.collate_fn([self.dataset[i] for i in indices])

            futures = []
            it = iter(self.batch_sampler)
            # keep prefetch_factor*workers futures in flight
            depth = self.num_workers * self.prefetch_factor
            try:
                for _ in range(depth):
                    futures.append(pool.submit(fetch, next(it)))
            except StopIteration:
                it = None
            while futures:
                f = futures.pop(0)
                if it is not None:
                    try:
                        futures.append(pool.submit(fetch, next(it)))
                    except StopIteration:
                        it = None
                yield f.result()

    def transport_stats(self):
        """The batches each worker transport carried and the bytes that
        crossed the native rings, for the last pool this loader used (None
        without forked workers)."""
        pool = getattr(self, "_last_pool", None)
        return None if pool is None else dict(pool.stats)

    def __iter__(self):
        # throughput-timer hooks (profiler.timer): time this loader's fetches when
        # it is the outermost reader of the current benchmark run
        from ..profiler.timer import benchmark

        bm = benchmark()
        bm.check_if_need_record(self)
        timed = bm.is_recording_reader(self)
        try:
            yield from self._iter_impl(bm if timed else None)
        finally:
            if timed:
                bm.release_reader(self)

    def _iter_impl(self, bm):
        mon = _mon()
        device = _place_device(self.places, self.device)
        on_card = device.type == "cuda"
        if not self.use_buffer_reader:
            it = iter(self._batches())
            while True:
                if bm is not None:
                    bm.before_reader()
                t0 = mon[3]() if (mon[0].on or mon[4].on) else 0
                try:
                    b = next(it)
                except StopIteration:
                    return
                staged = _to_device(b, device)   # on the consumer's stream
                if mon[0].on or mon[4].on:
                    t1 = mon[3]()
                    if mon[4].on:
                        mon[5].record_span("dataloader.batch", t0, t1)
                    if mon[0].on:
                        mon[2].observe_ns(t1 - t0)
                        mon[1].inc()
                if bm is not None:
                    bm.after_reader()
                yield staged
            return
        # double-buffer: stage the next batch to device while the current one is consumed
        q: queue.Queue = queue.Queue(maxsize=self.prefetch_factor)
        sentinel = object()
        err = []
        stop = threading.Event()
        copy_stream = torch.cuda.Stream(device) if on_card else None

        def stage(b):
            if not on_card:
                return _to_device(b, device), None
            with torch.cuda.stream(copy_stream):
                staged = _to_device(b, device)
                ready = torch.cuda.Event()
                ready.record(copy_stream)
            return staged, ready

        def producer():
            try:
                for b in self._batches():
                    if _san._state.hostsync:
                        # a device->host sync while staging would stall the
                        # pipeline: the hostsync tripwire watches this thread too
                        with _san.protected_region("dataloader.stage"):
                            item = stage(b)
                    else:
                        item = stage(b)
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # noqa: BLE001
                err.append(e)
            finally:
                # the sentinel must be delivered or the consumer blocks forever on
                # q.get(); block (stop-aware) rather than put_nowait — a full queue
                # at end-of-epoch would otherwise silently drop it
                while not stop.is_set():
                    try:
                        q.put(sentinel, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                if bm is not None:
                    bm.before_reader()
                t0 = mon[3]() if (mon[0].on or mon[4].on) else 0
                if _san._state.lock:
                    # dynamic GL004: a consumer blocking on the staging
                    # queue while holding any sanitized lock would convoy
                    # (or deadlock against) the producer thread
                    _san.check_wait("io.dataloader.queue_get")
                item = q.get()
                if item is sentinel:
                    break
                staged, ready = item
                if ready is not None:
                    # the consumer's kernels wait for the copies on the card
                    stream = torch.cuda.current_stream(device)
                    stream.wait_event(ready)
                    _record_stream(staged, stream)
                if mon[0].on or mon[4].on:
                    # consumer-visible stall: ~0 while the producer keeps
                    # the queue full, the fetch+stage time when it can't
                    t1 = mon[3]()
                    if mon[4].on:
                        mon[5].record_span("dataloader.batch", t0, t1)
                    if mon[0].on:
                        mon[2].observe_ns(t1 - t0)
                        mon[1].inc()
                if bm is not None:
                    bm.after_reader()
                yield staged
            t.join()
            if err:
                raise err[0]
        finally:
            # consumer abandoned the iterator (break/early stop): release the producer
            stop.set()

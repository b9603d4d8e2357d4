"""paddle.reader: legacy reader (generator-factory) combinators, the port of
``paddle_tpu/reader.py``.

Reference analog: python/paddle/reader/decorator.py — a reader is a zero-arg
callable returning an iterator of samples; these combinators compose readers.
Host-only Python on threads, as in the JAX package: no sample is staged onto
the device here. Kept for reference-code compatibility; new code should use
``paddle_tpu_torch.io`` Dataset/DataLoader (which feed the card through the
native shared-memory ring and a copy stream).
"""
from __future__ import annotations

import itertools
import queue as _queue
import random as _random
import threading


class ComposeNotAligned(ValueError):
    pass


def cache(reader):
    """Materialize once, replay from memory (decorator.py:75)."""
    all_data = None

    def cached():
        nonlocal all_data
        if all_data is None:
            all_data = list(reader())
        return iter(all_data)

    return cached


def map_readers(func, *readers):
    """Element-wise func over zipped readers (decorator.py:161)."""

    def mapped():
        for sample in zip(*[r() for r in readers]):
            yield func(*sample)

    return mapped


def shuffle(reader, buf_size):
    """Buffered shuffle (decorator.py:202)."""

    def shuffled():
        buf = []
        for s in reader():
            buf.append(s)
            if len(buf) >= buf_size:
                _random.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            _random.shuffle(buf)
            yield from buf

    return shuffled


def chain(*readers):
    """Concatenate readers (decorator.py:247)."""

    def chained():
        return itertools.chain(*[r() for r in readers])

    return chained


def compose(*readers, check_alignment=True):
    """Zip readers into flattened tuples (decorator.py:310)."""

    def fl(item):
        return item if isinstance(item, tuple) else (item,)

    def composed():
        for items in itertools.zip_longest(*[r() for r in readers]):
            if check_alignment and any(i is None for i in items):
                raise ComposeNotAligned(
                    "readers have different lengths")
            yield sum((fl(i) for i in items), ())

    return composed


def buffered(reader, size):
    """Background-thread prefetch buffer (decorator.py:369)."""

    class _End:
        pass

    def buffered_():
        q = _queue.Queue(maxsize=size)

        def fill():
            for s in reader():
                q.put(s)
            q.put(_End)

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        while True:
            s = q.get()
            if s is _End:
                break
            yield s

    return buffered_


def firstn(reader, n):
    """First n samples (decorator.py:431)."""

    def firstn_():
        return itertools.islice(reader(), n)

    return firstn_


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Thread-pool mapped reader (decorator.py:476). `order=True` preserves
    input order."""

    def xmapped():
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=process_num) as pool:
            if order:
                yield from pool.map(mapper, reader())
            else:
                from concurrent.futures import as_completed

                futs = [pool.submit(mapper, s) for s in reader()]
                for f in as_completed(futs):
                    yield f.result()

    return xmapped


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Interleave readers (decorator.py:578). Threads stand in for processes:
    sample production here is Python-level; heavy parallel decoding belongs in
    paddle.io.DataLoader's subprocess workers + shm ring."""

    def merged():
        q = _queue.Queue(maxsize=queue_size)
        n_live = [len(readers)]
        lock = threading.Lock()

        def run(r):
            for s in r():
                q.put(s)
            with lock:
                n_live[0] -= 1
                if n_live[0] == 0:
                    q.put(_SENTINEL)

        _SENTINEL = object()
        for r in readers:
            threading.Thread(target=run, args=(r,), daemon=True).start()
        while True:
            s = q.get()
            if s is _SENTINEL:
                break
            yield s

    return merged


__all__ = ["cache", "map_readers", "shuffle", "chain", "compose", "buffered",
           "firstn", "xmap_readers", "multiprocess_reader",
           "ComposeNotAligned"]

"""Fixed-shape programs captured as CUDA graphs: the port's counterpart of the
JAX engines' internal ``jax.jit`` programs (the serving engine's mixed step
and decode burst, the decode engine's prompt pass, decode step and beam
reorder).

A ``_Program`` binds a function to buffers it writes in place (a KV cache or
block pools). On the CPU a call runs the function eagerly. On CUDA the first
call copies its inputs into static buffers, runs the function once on the
process's side stream for its device (lazy library set-up must not happen
under capture; the run writes what the replay writes again; one stream, as
the caching allocator keeps what a stream freed for that stream) and
captures it into a CUDA graph, under the
process-wide capture lock and in ``thread_local`` error mode, so other
threads' CUDA work does not break it (the wait for the lock and the capture
pause the calling thread's hang-watchdog sections: a fleet replica whose
peers capture is waiting, not hung); every call then copies its inputs into
the buffers and replays. A capture that fails raises: nothing falls back to
eager execution on the card. The garbage collector is off during a capture:
a program dropped in a reference cycle would otherwise have its graph
destroyed mid-capture, which invalidates the capture.

Programs may share one graph memory pool (``pool``, a
``torch.cuda.graph_pool_handle()``): a capture then reuses the memory that
the pool's earlier captures freed, so what the programs keep between
replays is their outputs, not one copy of the intermediates each. That is
safe because the programs of a pool replay one after another on one stream
and every caller reads (or clones) a program's output before the next call.

Python does not run on a replay, so the kernels' launch counters (plain
integers their wrappers bump) would not move: the capture records how far
they moved while the graph was captured, puts them back (a capture launches
nothing), and each replay adds that much, so a replayed program counts as
an eager run of it does.

A graph reads the weights at the addresses they had when it was captured:
after ``amp.decorate`` recasts parameters in place
(``framework.PARAM_EPOCH`` moves), a replay raises instead of reading the
old storage; build the engine again.
"""
from __future__ import annotations

import contextlib
import gc
import threading

import torch

from ..framework import PARAM_EPOCH

# one capture at a time in the process: replica threads of a fleet capture
# their programs side by side (fleet warmup), and each capture is
# thread-local, so another thread's table upload or result copy in the
# middle of it does not invalidate it
_CAPTURE_LOCK = threading.Lock()
# device -> the stream every capture's warm-up run takes (under the lock)
_SIDE_STREAMS = {}

# (module, attribute) of every counter a kernel wrapper bumps
_COUNTERS = (("flash_attention", "launches"), ("flash_attention", "launches_bwd_dq"),
             ("flash_attention", "launches_bwd_dkv"), ("flash_attention", "launches_f32"),
             ("flash_attention", "launches_bwd_dq_f32"),
             ("flash_attention", "launches_bwd_dkv_f32"),
             ("flash_attention", "copies_for_alignment"),
             ("flash_attention", "pads_for_head_dim"), ("axpy", "launches"))


@contextlib.contextmanager
def _capture_section():
    """The capture lock, held with the calling thread's hang-watchdog
    sections paused from the moment it starts to wait for it (module
    docstring)."""
    from ..distributed.watchdog import paused

    with paused(), _CAPTURE_LOCK:
        yield


def _counter_modules():
    from ..ops.cuda import axpy, flash_attention

    mods = {"flash_attention": flash_attention, "axpy": axpy}
    return [(mods[m], a) for m, a in _COUNTERS]


class _Program:
    """One fixed-shape program, ``fn(first, pools, *rest)``, on the device
    of ``pools`` (the buffers it writes in place; module docstring), its
    graph captured into the memory pool ``pool`` (None: a private one). The
    returned value is the graph's static output on CUDA: read it before the
    next call. ``_Program.captures`` counts the graphs captured in the
    process."""

    captures = 0

    def __init__(self, fn, pools, pool=None):
        self._fn = fn
        self._pools = pools
        self._pool = pool
        self._device = pools[0][0].device
        self._graph = None
        self._static = None
        self._out = None
        self._credit = None
        self._epoch = None

    def _run(self, inputs):
        return self._fn(inputs[0], self._pools, *inputs[1:])

    def __call__(self, *inputs):
        dev = self._device
        if dev.type != "cuda":
            return self._run([x.to(dev) for x in inputs])
        if self._graph is None:
            self._capture(inputs)
        if self._epoch != PARAM_EPOCH[0]:
            raise RuntimeError("amp.decorate recast the parameters after this program "
                               "was captured on the old weights; build the engine again")
        for buf, x in zip(self._static, inputs):
            buf.copy_(x)
        self._graph.replay()
        for (mod, name), n in zip(_counter_modules(), self._credit):
            setattr(mod, name, getattr(mod, name) + n)
        return self._out

    def _capture(self, inputs):
        dev = self._device
        with _capture_section():
            static = [torch.empty_like(x, device=dev) for x in inputs]
            for buf, x in zip(static, inputs):
                buf.copy_(x)
            side = _SIDE_STREAMS.get(dev)
            if side is None:
                side = _SIDE_STREAMS[dev] = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._run(static)
            torch.cuda.current_stream(dev).wait_stream(side)
            counters = _counter_modules()
            before = [getattr(mod, name) for mod, name in counters]
            graph = torch.cuda.CUDAGraph()
            # no garbage collection inside the capture: a collected cycle
            # holding another program would destroy its graph mid-capture,
            # which the capture does not survive
            gc_was_on = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=self._pool,
                                      capture_error_mode="thread_local"):
                    out = self._run(static)
            finally:
                if gc_was_on:
                    gc.enable()
            self._credit = [getattr(mod, name) - b for (mod, name), b in zip(counters, before)]
            for (mod, name), n in zip(counters, self._credit):
                setattr(mod, name, getattr(mod, name) - n)
            self._static, self._out, self._graph = static, out, graph
            self._epoch = PARAM_EPOCH[0]
            _Program.captures += 1

    @property
    def captured(self):
        return self._graph is not None

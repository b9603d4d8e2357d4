"""Devices, streams, events and memory statistics: the port of
``paddle_tpu/device/__init__.py`` (and ``device/cuda.py``, ``cuda`` here).

Entry points of the port build on the card unless told otherwise.
``set_device("cpu")`` is that word for everything that takes no device of
its own (``to_tensor`` without ``place``, the creation ops, ``seed``, the
models' default ``device``); ``set_device("gpu:N")`` (or ``"cuda:N"``)
names a card. With neither a card nor ``set_device("cpu")`` those entry
points raise (``paddle_tpu_torch.resolve_device``).

On the card the rest maps onto ``torch.cuda``: ``Stream`` and ``Event`` are
CUDA streams and events, ``stream_guard`` makes a stream current, and the
memory statistics are the caching allocator's. On the CPU (``set_device(
"cpu")``, or no card) they keep the JAX package's shim: a ``Stream`` and an
``Event`` are ordering barriers, ``query()`` is True, ``stream_guard`` does
nothing and the memory statistics are 0.
"""
from __future__ import annotations

import contextlib
import gc

import torch

__all__ = [
    "set_device", "get_device", "get_all_device_type", "get_available_device",
    "get_available_custom_device", "device_count", "cuda_device_count", "synchronize",
    "current_stream", "set_stream", "Stream", "Event", "stream_guard", "memory_stats",
    "memory_allocated", "max_memory_allocated", "memory_reserved", "max_memory_reserved",
    "empty_cache", "is_compiled_with_cuda", "is_compiled_with_rocm", "is_compiled_with_xpu",
    "is_compiled_with_ipu", "is_compiled_with_cinn", "is_compiled_with_distribute",
    "is_compiled_with_custom_device", "get_all_custom_device_type", "get_cudnn_version",
    "XPUPlace", "IPUPlace", "cuda",
]

_CURRENT = [None]  # a torch.device, or None: the current card


def set_device(device):
    """``"cpu"``, ``"gpu"``, ``"gpu:N"``, ``"cuda:N"`` or a ``torch.device``;
    returns the ``torch.device``. A card that is not there raises."""
    if isinstance(device, torch.device):
        name, idx = device.type, device.index or 0
    else:
        name, _, num = str(device).lower().partition(":")
        idx = int(num) if num else 0
    if name == "cpu":
        _CURRENT[0] = torch.device("cpu")
    elif name in ("gpu", "cuda"):
        if not torch.cuda.is_available() or idx >= torch.cuda.device_count():
            raise RuntimeError(f"set_device({device!r}): no such card is visible "
                               f"({torch.cuda.device_count()} cards)")
        _CURRENT[0] = torch.device("cuda", idx)
    else:
        raise ValueError(f"set_device takes 'cpu', 'gpu' or 'gpu:N', got {device!r}")
    return _CURRENT[0]


def get_device() -> str:
    """``"cpu"`` or ``"gpu:N"``: where entry points build by default."""
    dev = _CURRENT[0]
    if dev is None:
        if not torch.cuda.is_available():
            return "cpu"
        dev = torch.device("cuda", torch.cuda.current_device())
    return "cpu" if dev.type == "cpu" else f"gpu:{dev.index}"


def _on_card(device=None):
    """The ``torch.device`` of a card that ``device`` (None: the current
    device) names, or None for the CPU."""
    if device is None:
        dev = _CURRENT[0]
        if dev is None:
            return (torch.device("cuda", torch.cuda.current_device())
                    if torch.cuda.is_available() else None)
        return dev if dev.type == "cuda" else None
    if isinstance(device, Stream):
        return device.device if device.device.type == "cuda" else None
    if isinstance(device, int):
        return torch.device("cuda", device)
    if isinstance(device, torch.device):
        return device if device.type == "cuda" else None
    name, _, num = str(device).lower().partition(":")
    if name == "cpu":
        return None
    return torch.device("cuda", int(num) if num else torch.cuda.current_device())


def get_all_device_type():
    return sorted({"cpu"} | ({"gpu"} if torch.cuda.is_available() else set()))


def get_available_device():
    """``"gpu:N"`` for each card, or ``["cpu:0"]`` without one (the JAX
    package lists its default backend's devices)."""
    return [f"gpu:{i}" for i in range(cuda_device_count())] or ["cpu:0"]


def get_available_custom_device():
    return []


def cuda_device_count():
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def device_count():
    """Cards visible (1 for the CPU alone, as the JAX package counts its one
    CPU device)."""
    return cuda_device_count() or 1


def is_compiled_with_cuda():
    return torch.backends.cuda.is_built() and torch.version.cuda is not None


def is_compiled_with_rocm():
    return torch.version.hip is not None


def is_compiled_with_xpu():
    return False


def is_compiled_with_ipu():
    return False


def is_compiled_with_cinn():
    return False


def is_compiled_with_distribute():
    return torch.distributed.is_available()


def is_compiled_with_custom_device(device_type="gpu"):
    return False


def get_all_custom_device_type():
    return []


def get_cudnn_version():
    """cuDNN's version as an int, or None without a card (the reference's
    value when it is unavailable)."""
    if not torch.cuda.is_available():
        return None
    return torch.backends.cudnn.version()


def synchronize(device=None):
    """Wait for every kernel queued on the card (a no-op on the CPU)."""
    dev = _on_card(device)
    if dev is not None:
        torch.cuda.synchronize(dev)


class Stream:
    """paddle.device.Stream: a CUDA stream on the card (``priority`` 1 is
    high, 2 normal, as paddle numbers them); on the CPU an ordering barrier.
    ``Stream(stream_base=...)`` wraps an existing ``torch.cuda.Stream``."""

    def __init__(self, device=None, priority=2, stream_base=None):
        if stream_base is not None:
            self._stream = stream_base
            self.device = stream_base.device
            return
        dev = _on_card(device)
        self.device = dev if dev is not None else torch.device("cpu")
        self._stream = (torch.cuda.Stream(dev, priority=-1 if priority == 1 else 0)
                        if dev is not None else None)

    @property
    def cuda_stream(self):
        return None if self._stream is None else self._stream.cuda_stream

    def synchronize(self):
        if self._stream is not None:
            self._stream.synchronize()

    def wait_event(self, event):
        if self._stream is not None and event._event is not None:
            self._stream.wait_event(event._event)

    def wait_stream(self, stream):
        if self._stream is not None and stream._stream is not None:
            self._stream.wait_stream(stream._stream)

    def record_event(self, event=None):
        event = event or Event(self.device)
        event.record(self)
        return event

    def query(self):
        return True if self._stream is None else self._stream.query()

    def __eq__(self, other):
        return isinstance(other, Stream) and self._stream == other._stream and (
            self._stream is not None or self.device == other.device)

    def __hash__(self):
        return hash((self.device, self.cuda_stream))

    def __repr__(self):
        return f"<paddle_tpu_torch.device.Stream {self.device} {self.cuda_stream}>"


class Event:
    """paddle.device.Event: a CUDA event on the card (``enable_timing`` for
    ``elapsed_time``); on the CPU a barrier whose ``query()`` is True."""

    def __init__(self, device=None, enable_timing=False, blocking=False, interprocess=False):
        dev = _on_card(device)
        self.device = dev if dev is not None else torch.device("cpu")
        self._event = (torch.cuda.Event(enable_timing=enable_timing, blocking=blocking,
                                        interprocess=interprocess)
                       if dev is not None else None)

    def record(self, stream=None):
        if self._event is None:
            return
        stream = stream if stream is not None else current_stream(self.device)
        self._event.record(stream._stream)

    def query(self):
        return True if self._event is None else self._event.query()

    def synchronize(self):
        if self._event is not None:
            self._event.synchronize()

    def elapsed_time(self, end_event):
        """Milliseconds from this event to ``end_event`` (both recorded with
        ``enable_timing``)."""
        return self._event.elapsed_time(end_event._event)


def current_stream(device=None):
    dev = _on_card(device)
    if dev is None:
        return Stream(torch.device("cpu"))
    return Stream(stream_base=torch.cuda.current_stream(dev))


def set_stream(stream):
    """Make ``stream`` current on its card; returns the stream it replaces."""
    prev = current_stream(stream.device if stream._stream is not None else None)
    if stream._stream is not None:
        torch.cuda.set_stream(stream._stream)
    return prev


@contextlib.contextmanager
def _guard(stream):
    if stream is None or stream._stream is None:
        yield
        return
    with torch.cuda.stream(stream._stream):
        yield


def stream_guard(stream):
    """Run the block with ``stream`` current (nothing on the CPU)."""
    return _guard(stream)


def memory_stats(device=None):
    """The caching allocator's statistics (``torch.cuda.memory_stats``); an
    empty dict on the CPU."""
    dev = _on_card(device)
    return torch.cuda.memory_stats(dev) if dev is not None else {}


def memory_allocated(device=None):
    dev = _on_card(device)
    return torch.cuda.memory_allocated(dev) if dev is not None else 0


def max_memory_allocated(device=None):
    dev = _on_card(device)
    return torch.cuda.max_memory_allocated(dev) if dev is not None else 0


def memory_reserved(device=None):
    dev = _on_card(device)
    return torch.cuda.memory_reserved(dev) if dev is not None else 0


def max_memory_reserved(device=None):
    dev = _on_card(device)
    return torch.cuda.max_memory_reserved(dev) if dev is not None else 0


def empty_cache():
    """Collect dead Python references and release the allocator's unused
    cached blocks to CUDA."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class XPUPlace:
    def __init__(self, device_id=0):
        self.device_id = device_id

    def __repr__(self):
        return f"Place(xpu:{self.device_id})"


class IPUPlace:
    def __repr__(self):
        return "Place(ipu)"


from . import cuda  # noqa: E402,F401  (paddle.device.cuda)

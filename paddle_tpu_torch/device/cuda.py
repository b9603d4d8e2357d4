"""paddle.device.cuda for the port: the counterpart of
``paddle_tpu/device/cuda.py``, on ``torch.cuda``. On the CPU the properties
are the JAX package's CPU shim (name ``"cpu"``, capability (0, 0), no
memory, one processor) and the memory statistics are 0, as
``paddle_tpu_torch.device``'s; ``device_count`` is the number of cards, 0
(the JAX shim counts its CPU device, 1)."""
from __future__ import annotations

import torch

from . import (  # noqa: F401
    Event, Stream, _on_card, current_stream, empty_cache, max_memory_allocated,
    max_memory_reserved, memory_allocated, memory_reserved, stream_guard, synchronize)

__all__ = [
    "Stream", "Event", "current_stream", "device_count", "empty_cache",
    "extract_cuda_device_id", "get_device_capability", "get_device_name",
    "get_device_properties", "max_memory_allocated", "max_memory_reserved",
    "memory_allocated", "memory_reserved", "reset_max_memory_allocated",
    "reset_max_memory_reserved", "stream_guard", "synchronize",
]


def device_count():
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def extract_cuda_device_id(device, op_name=""):
    if isinstance(device, int):
        return device
    s = str(device)
    return int(s.rsplit(":", 1)[1]) if ":" in s else 0


class _CpuProperties:
    name = "cpu"
    major = minor = 0
    total_memory = 0
    multi_processor_count = 1

    def __repr__(self):
        return "_DeviceProperties(name='cpu', total_memory=0MB)"


def reset_max_memory_allocated(device=None):
    dev = _on_card(device)
    if dev is not None:
        torch.cuda.reset_peak_memory_stats(dev)


def reset_max_memory_reserved(device=None):
    reset_max_memory_allocated(device)


def get_device_properties(device=None):
    """``torch.cuda.get_device_properties``: name, major, minor,
    total_memory, multi_processor_count."""
    dev = _on_card(device)
    return _CpuProperties() if dev is None else torch.cuda.get_device_properties(dev)


def get_device_name(device=None):
    dev = _on_card(device)
    return "cpu" if dev is None else torch.cuda.get_device_name(dev)


def get_device_capability(device=None):
    dev = _on_card(device)
    return (0, 0) if dev is None else torch.cuda.get_device_capability(dev)

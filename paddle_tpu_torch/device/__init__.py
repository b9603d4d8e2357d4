"""Device selection: the port of ``set_device``/``get_device`` of
``paddle_tpu/device/__init__.py``.

Entry points of the port build on the card unless told otherwise.
``set_device("cpu")`` is that word for everything that takes no device of
its own (``to_tensor`` without ``place``, the creation ops, ``seed``, the
models' default ``device``); ``set_device("gpu:N")`` (or ``"cuda:N"``)
names a card. With neither a card nor ``set_device("cpu")`` those entry
points raise (``paddle_tpu_torch.resolve_device``).
"""
from __future__ import annotations

import torch

__all__ = ["set_device", "get_device"]

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

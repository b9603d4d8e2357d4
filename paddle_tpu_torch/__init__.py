"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

It mirrors the JAX package's module layout (``models/llama.py``,
``nn/functional/flash_attention.py``, ``ops/...``) with PyTorch's own idiom:
``nn.Module``s, plain functions on tensors, an explicit ``device`` and
explicit ``torch.Generator``s. Hand-written kernels live in ``csrc/`` and
build on first use (``ops/cuda/_build.py``).

Entry points run on CUDA unless the caller passes ``device="cpu"``.
``save``/``load`` are paddle.save/paddle.load (``framework_io.py``);
``jit.save``/``jit.load`` and ``inference`` are the deploy path.
Fault-injection points named in ``PADDLE_TPU_FAULTS`` are armed at import
(``analysis/faultinject.py``), as the JAX package arms them.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "save", "load"]

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds on: CUDA by default, the CPU only
    when asked for. With no device and no card this raises rather than
    quietly building on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on CUDA and no card is visible; pass "
                "device='cpu' to run the plain versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def save(obj, path, **kwargs):
    """paddle.save: ``framework_io.save``."""
    from .framework_io import save as _save

    return _save(obj, path, **kwargs)


def load(path, **kwargs):
    """paddle.load: ``framework_io.load`` (tensors on the card unless
    ``device="cpu"``)."""
    from .framework_io import load as _load

    return _load(path, **kwargs)


from .analysis import faultinject as _faultinject  # noqa: E402

_faultinject.install_from_env()

"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

It mirrors the JAX package's module layout (``models/llama.py``,
``nn/functional/flash_attention.py``, ``ops/...``) with PyTorch's own idiom:
``nn.Module``s, plain functions on tensors, an explicit ``device`` and
explicit ``torch.Generator``s. Hand-written kernels live in ``csrc/`` and
build on first use (``ops/cuda/_build.py``).

Entry points run on CUDA unless the caller passes ``device="cpu"`` (or
``place="cpu"``), or calls ``device.set_device("cpu")``.
``save``/``load`` are paddle.save/paddle.load (``framework_io.py``);
``jit.save``/``jit.load`` and ``inference`` are the deploy path.

The top level is paddle's eager surface: the dtypes, ``to_tensor``,
``seed``, ``set_flags``/``get_flags``, ``set_default_dtype``, the op
namespace (``ops``: ``matmul``, ``concat``, ``sum``, ...), ``amp`` and the
grad-mode helpers. ``Tensor`` is ``torch.Tensor``: the port has no tensor
wrapper, so every op takes and returns torch tensors.
Fault-injection points named in ``PADDLE_TPU_FAULTS`` are armed at import
(``analysis/faultinject.py``), as the JAX package arms them.
"""
from __future__ import annotations

import torch


__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds on: CUDA by default, the CPU only
    when asked for (``device="cpu"``, or ``device.set_device("cpu")`` for
    every entry point at once). With no device and no card this raises rather
    than quietly building on the CPU."""
    if device is None:
        from .device import _CURRENT

        if _CURRENT[0] is not None:
            return _CURRENT[0]
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on CUDA and no card is visible; pass "
                "device='cpu' (or call paddle_tpu_torch.device.set_device('cpu')) "
                "to run the plain versions on the CPU")
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


Tensor = torch.Tensor

from . import autograd  # noqa: E402
from .autograd import (  # noqa: E402,F401
    enable_grad, grad, is_grad_enabled, no_grad, set_grad_enabled)

from . import device  # noqa: E402
from .device import get_device, set_device  # noqa: E402,F401
from . import framework  # noqa: E402
from .framework import Parameter  # noqa: E402,F401
from .framework import dtype as _dtype_mod  # noqa: E402
from .framework.dtype import (  # noqa: E402,F401
    bfloat16, complex64, complex128, float16, float32, float64, get_default_dtype,
    int8, int16, int32, int64, set_default_dtype, uint8)
from .framework.core import to_tensor  # noqa: E402,F401
from .framework.flags import get_flags, set_flags  # noqa: E402,F401
from .framework.random import (  # noqa: E402,F401
    get_cuda_rng_state, get_rng_state, initial_seed, seed, set_cuda_rng_state, set_rng_state)
from . import ops  # noqa: E402
from .ops import *  # noqa: E402,F401,F403
from .ops import (  # noqa: E402,F401  (names shadowed by Python builtins in *)
    abs, all, any, max, min, pow, round, slice, sum, complex)
from . import amp  # noqa: E402,F401
from . import incubate  # noqa: E402,F401
import importlib  # noqa: E402

# ``from .ops import *`` bound ``linalg`` to ``ops.linalg``: the namespace
# module is ``paddle_tpu_torch/linalg.py``
linalg = importlib.import_module(".linalg", __name__)
from . import nn  # noqa: E402,F401
from . import optimizer  # noqa: E402,F401
from . import utils  # noqa: E402,F401

dtype = _dtype_mod.convert_dtype  # paddle.dtype('float32')
bool = torch.bool  # noqa: A001  (paddle exports the dtype as paddle.bool)

from .analysis import faultinject as _faultinject  # noqa: E402

_faultinject.install_from_env()

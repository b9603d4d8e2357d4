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
The rest of the JAX package's top level is here too: the places
(``CUDAPlace(i)`` is ``cuda:i``; ``TPUPlace`` names it as well, so JAX-era
code runs), ``rank``/``shape``/``check_shape``/``reduce_as``/``batch``,
``finfo``/``iinfo``, the constants, ``tensor`` (the op namespace, also
importable as ``paddle_tpu_torch.tensor``), ``_C_ops``/``_legacy_C_ops``
and the subpackages (``jit``, ``profiler``, ``hub``, ``version``, ``io``
with the DataLoader, the legacy ``reader`` combinators, ``geometric``, ...). A
bare import compiles and loads no CUDA library: the kernels build when a
CUDA tensor first reaches them (``ops/cuda/_build.py``).
``monitor`` is the telemetry (metrics, spans, flight dumps, SLOs, the debug
server). At import, as in the JAX package and in its order, the sanitizers
named in ``PADDLE_TPU_SANITIZE`` are enabled (``analysis/sanitizers.py``),
the fault-injection points named in ``PADDLE_TPU_FAULTS`` are armed
(``analysis/faultinject.py``) and, with ``PADDLE_TPU_DEBUG_PORT`` set, the
debug server starts (``monitor/server.py``).
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
    bfloat16, bool_, complex64, complex128, float16, float32, float64, get_default_dtype,
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
from .nn.initializer import ParamAttr  # noqa: E402,F401
from . import optimizer  # noqa: E402,F401
from . import utils  # noqa: E402,F401

dtype = _dtype_mod.convert_dtype  # paddle.dtype('float32')
bool = torch.bool  # noqa: A001  (paddle exports the dtype as paddle.bool)
float8_e4m3fn = torch.float8_e4m3fn
float8_e5m2 = torch.float8_e5m2
# string and raw dtype sentinels (framework/containers.StringTensor)
pstring = "pstring"
raw = "raw"

from .device import (  # noqa: E402,F401
    CPUPlace, CUDAPlace, is_compiled_with_cinn, is_compiled_with_cuda,
    is_compiled_with_custom_device, is_compiled_with_distribute, is_compiled_with_rocm,
    is_compiled_with_xpu)

TPUPlace = CUDAPlace  # the JAX package's place names the card here
CustomPlace = CUDAPlace
CUDAPinnedPlace = CPUPlace  # pinned host staging is host memory

from . import ops as tensor  # noqa: E402  (paddle.tensor is the op surface)
import sys as _sys  # noqa: E402

# ``import paddle_tpu_torch.tensor`` and ``from paddle_tpu_torch.tensor import
# x`` need a sys.modules entry, not only the attribute
_sys.modules[__name__ + ".tensor"] = tensor
from . import _C_ops, _legacy_C_ops  # noqa: E402,F401
from . import distributed  # noqa: E402,F401
from . import framework_io  # noqa: E402,F401
from . import geometric  # noqa: E402,F401
from . import hub  # noqa: E402,F401
from . import inference  # noqa: E402,F401
from . import io  # noqa: E402,F401
from . import jit  # noqa: E402,F401
from . import models  # noqa: E402,F401
from . import monitor  # noqa: E402,F401
from . import profiler  # noqa: E402,F401
from . import quantization  # noqa: E402,F401
from . import reader  # noqa: E402,F401
from . import regularizer  # noqa: E402,F401
from . import sysconfig  # noqa: E402,F401
from . import version  # noqa: E402,F401
from . import static  # noqa: E402,F401
from . import base  # noqa: E402,F401


def rank(x):
    return x.ndim


def shape(x):
    """x's shape as an int64 tensor on x's device."""
    return torch.tensor(tuple(x.shape), dtype=torch.int64, device=x.device)


def in_dynamic_mode():
    """True in eager code; False while ``jit.to_static`` traces (the JAX
    package's functional mode) and after ``enable_static``."""
    return not _STATIC_MODE[0] and not torch.compiler.is_compiling()


_STATIC_MODE = [False]


def enable_static():
    """Static mode: calls on placeholders from here on are recorded into the
    process-global default main Program (``static``), so the guard-less idiom
    (enable_static + static.data + ops + Executor.run) replays against the
    feed. ``program_guard`` still scopes recording to a Program of its own."""
    from .framework import capture as _capture

    _STATIC_MODE[0] = True
    _capture.set_default(static._MAIN[0])


def disable_static(place=None):
    from .framework import capture as _capture

    _STATIC_MODE[0] = False
    _capture.set_default(None)


def in_static_mode():
    return _STATIC_MODE[0]


def disable_signal_handler():
    pass


def create_parameter(shape, dtype="float32", name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """paddle.create_parameter: a trainable ``Parameter`` through the pipeline
    of ``Layer.create_parameter`` (the attribute, the global initializer,
    the defaults), on the card unless ``set_device("cpu")``."""
    from .nn.layer.layers import Layer

    holder = Layer(dtype=dtype)
    p = holder.create_parameter(list(shape), attr=attr, dtype=dtype, is_bias=is_bias,
                                default_initializer=default_initializer)
    if name is not None and p is not None:
        p.name = name
    return p


def reduce_as(x, target, name=None):
    """Sum x over leading and broadcast axes until it has target's shape."""
    xs, ts = list(x.shape), list(target.shape)
    while len(xs) > len(ts):
        x = ops.sum(x, axis=0)
        xs = list(x.shape)
    axes = [i for i, (a, b) in enumerate(zip(xs, ts)) if a != b and b == 1]
    if axes:
        x = ops.sum(x, axis=axes, keepdim=True)
    return x


def batch(reader, batch_size, drop_last=False):
    """Legacy reader combinator (paddle.batch): groups samples into lists."""

    def batched():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batched


class LazyGuard:
    """paddle.LazyGuard: the reference delays parameter materialization; the
    port builds parameters when a layer is built, so the guard is a context
    that does nothing (as in the JAX package)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def check_shape(shape):
    """utils/layers_utils.py:483 check_shape: validate a fill_constant shape,
    in the reference's order (a negative element raises ValueError before a
    non-integer raises TypeError; a bool counts as an int)."""
    import numpy as _np

    if isinstance(shape, torch.Tensor):
        return
    if isinstance(shape, (list, tuple)):
        for ele in shape:
            if isinstance(ele, torch.Tensor):
                continue
            if ele < 0:
                raise ValueError(
                    "All elements in ``shape`` must be positive when it's a list or tuple")
            if not isinstance(ele, (int, _np.integer)):
                raise TypeError(
                    "All elements in ``shape`` must be integers when it's a list or tuple")

# the sanitizers first: the lock wrapper swaps the monitor/trace module
# globals imported above; then the fault points; then the debug server
from .analysis.sanitizers import install_from_env as _san_install  # noqa: E402

_san_install()

from .analysis.faultinject import install_from_env as _fi_install  # noqa: E402

_fi_install()

from .monitor.server import install_from_env as _obs_install  # noqa: E402

_obs_install()

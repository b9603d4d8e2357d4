"""paddle.utils namespace of the port (counterpart of
``paddle_tpu/utils/__init__.py``; reference python/paddle/utils/__init__.py):
the custom-op extension point, C++ extensions, the op table
(``op_table``/``generate_op_docs``), require_version, try_import, deprecated,
run_check, unique_name, and the local-file readers ``download`` and
``weights``.
"""
import functools as _functools
import importlib as _importlib
import warnings as _warnings

import torch as _torch

from . import cpp_extension  # noqa: F401
from . import custom_op  # noqa: F401
from . import download  # noqa: F401
from . import weights  # noqa: F401
from .custom_op import get_custom_op, register_custom_op  # noqa: F401
from ..ops.optable import generate_op_docs, op_table  # noqa: F401
from .. import resolve_device as _resolve_device


def require_version(min_version, max_version=None):
    """reference base/framework.py:573 — assert the installed framework
    version is within [min_version, max_version]. Pre-release suffixes
    order below their release: 1.0.0rc0 < 1.0.0."""
    from .. import version as _version

    def parse(v):
        v = str(v)
        nums, suffix = [], ""
        for p in v.split("."):
            num = ""
            for ch in p:
                if ch.isdigit():
                    num += ch
                else:
                    break
            nums.append(int(num or 0))
            rest = p[len(num):]
            if rest:
                suffix = rest
        # a release ('' suffix) sorts AFTER any rc/dev/a/b of the same nums
        return tuple((nums + [0, 0, 0])[:3]), (1, "") if not suffix \
            else (0, suffix)

    installed = getattr(_version, "full_version", "0.0.0")
    cur = parse(installed)
    if parse(min_version) > cur:
        raise Exception(
            f"installed version {installed!r} < required min_version "
            f"{min_version!r}")
    if max_version is not None and parse(max_version) < cur:
        raise Exception(
            f"installed version {installed!r} > allowed max_version "
            f"{max_version!r}")


def try_import(module_name, err_msg=None):
    """reference utils/lazy_import.py try_import: import or raise with hint."""
    try:
        return _importlib.import_module(module_name)
    except ImportError as e:
        raise ImportError(
            err_msg or f"{module_name} is required but not installed: {e}"
        ) from e


def deprecated(update_to="", since="", reason="", level=0):
    """reference utils/deprecated.py: warn-on-call decorator."""

    def deco(fn):
        @_functools.wraps(fn)
        def wrapper(*args, **kwargs):
            msg = f"API {fn.__name__} is deprecated since {since}"
            if update_to:
                msg += f", use {update_to} instead"
            if reason:
                msg += f" ({reason})"
            _warnings.warn(msg, DeprecationWarning, stacklevel=2)
            return fn(*args, **kwargs)

        return wrapper

    return deco


def run_check(device=None):
    """reference utils/install_check.py run_check: one 64x64 matmul on the
    card proves the install works. Without a card it raises, unless
    ``device="cpu"`` asks for the CPU."""
    dev = _resolve_device(device)
    a = _torch.ones((64, 64), device=dev)
    out = a @ a
    if out[0, 0].item() != 64.0:
        raise RuntimeError(f"run_check: 64x64 matmul of ones gave "
                           f"{out[0, 0].item()} on {dev}, want 64.0")
    kind = _torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host"
    print(f"PaddlePaddle(PyTorch build) works on {dev.type} ({kind})!")


class _UniqueName:
    """reference base/unique_name.py: generate() with per-prefix counters."""

    def __init__(self):
        self._counters = {}

    def generate(self, key="tmp"):
        n = self._counters.get(key, 0)
        self._counters[key] = n + 1
        return f"{key}_{n}"

    def guard(self, new_generator=None):
        import contextlib

        return contextlib.nullcontext()


unique_name = _UniqueName()

"""paddle.version: the port of ``paddle_tpu/version.py``.

Reference analog: python/paddle/version/__init__.py (written at build time:
full_version/major/minor/rc/commit and the probes show()/cuda()/cudnn()/
nccl()/xpu()). The version numbers are the JAX package's; the probes report
the torch build the port runs on: ``cuda()`` is ``torch.version.cuda``,
``cudnn()`` and ``nccl()`` the versions torch was built with, and ``tpu()``
none. ``cudnn_version`` and ``nccl_version`` are read on first use, because
asking loads the libraries (a bare ``import paddle_tpu_torch`` loads no CUDA
library).
"""
from __future__ import annotations

import torch

full_version = "0.3.0"
major = "0"
minor = "3"
patch = "0"
rc = "0"
cuda_version = torch.version.cuda or "False"
tensorrt_version = "False"
xpu_version = "False"
xpu_xccl_version = "False"
xpu_xhpc_version = "False"
istaged = False
commit = "unknown"
with_pip_cuda_libraries = "OFF"
with_pip_tensorrt = "OFF"

__all__ = ["cuda", "cudnn", "nccl", "show", "xpu", "xpu_xccl", "xpu_xhpc", "tpu"]


def __getattr__(name):
    if name == "cudnn_version":
        return cudnn()
    if name == "nccl_version":
        return nccl()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def show():
    """Print the version and build info (reference version.show)."""
    if istaged:
        print("full_version:", full_version)
        print("major:", major)
        print("minor:", minor)
        print("patch:", patch)
        print("rc:", rc)
    else:
        print("commit:", commit)
    print("cuda:", cuda())
    print("cudnn:", cudnn())
    print("nccl:", nccl())
    print("xpu:", xpu())
    print("tpu:", tpu())


def cuda():
    return cuda_version


def cudnn():
    """cuDNN's version torch was built with, as a string, or "False"."""
    if not torch.backends.cudnn.is_available():
        return "False"
    return str(torch.backends.cudnn.version())


def nccl():
    """NCCL's version torch was built with ("2.21.5"), or "0" without it."""
    if torch.version.cuda is None or not torch.cuda.is_available():
        return "0"
    try:
        v = torch.cuda.nccl.version()
    except (RuntimeError, AttributeError):
        return "0"
    return ".".join(str(p) for p in v) if isinstance(v, tuple) else str(v)


def xpu():
    return xpu_version


def xpu_xccl():
    return xpu_xccl_version


def xpu_xhpc():
    return xpu_xhpc_version


def tensorrt():
    return tensorrt_version


def tpu():
    """No TPU here: "False", the JAX function's answer off a TPU."""
    return "False"

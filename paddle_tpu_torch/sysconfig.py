"""paddle.sysconfig: the port of ``paddle_tpu/sysconfig.py`` (reference
python/paddle/sysconfig.py: the include and library directories to build
extensions against). Here they are the port's kernel sources (``csrc``, with
its headers) and the directory its kernels build into (``_build``)."""
from __future__ import annotations

import os

__all__ = ["get_include", "get_lib"]


def get_include():
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")


def get_lib():
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

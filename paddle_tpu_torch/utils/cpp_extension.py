"""paddle.utils.cpp_extension: build and load user C++ extensions.

Counterpart of ``paddle_tpu/utils/cpp_extension.py`` (reference analog:
python/paddle/utils/cpp_extension/cpp_extension.py, ``load`` at :895,
``CppExtension``/``CUDAExtension`` + ``setup`` for ahead-of-time builds).
As in the JAX package, a C++ extension computes on the HOST:

* ``load(name, sources, ...)`` compiles the sources with the system C++
  toolchain into a shared library, named by a hash of the sources and flags,
  and returns a ``CppExtensionModule`` wrapping it (ctypes).
* ``CppExtensionModule.def_op`` registers an exported C symbol as an op
  through ``register_custom_op``, with an optional custom backward.
  Its inputs are copied to the host as float32, the C function runs there,
  and the float32 result goes back to the first input's device. On a CUDA
  tensor that is two copies around a host call, which is what
  ``jax.pure_callback`` does on an accelerator: the op's defined semantics,
  not a fallback. The C call (and its backward's) is a ``torch.library`` op
  (``paddle_tpu_torch_ext::<op name>``) whose fake output is a float32
  tensor of the first input's shape, the ``ShapeDtypeStruct`` the JAX op
  hands ``jax.pure_callback``: so the op traces under ``jit.to_static`` with
  ``full_graph=True``, and the compiled graph calls C where eager code does.
* richer signatures bind through ``.lib`` (the raw ctypes CDLL) and wrap
  with ``register_custom_op`` directly.

``.cu`` sources are skipped, as in the JAX package, and a CUDA-only source
list raises ``BuildError``; the port's own kernels build from ``csrc/`` with
``ops/cuda/_build.py``.

The simple def_op C ABI (float32, same-shape outputs):
    1 input : void sym(const float* x, float* y, int64_t n);
    2 inputs: void sym(const float* a, const float* b, float* y, int64_t n);
    backward (unary): void bwd(const float* x, const float* gy, float* gx,
                               int64_t n);
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import torch

from .custom_op import CustomOpError, register_custom_op
from ..ops._apply import is_registered

__all__ = ["load", "setup", "CppExtension", "CUDAExtension",
           "CppExtensionModule", "BuildError"]


class BuildError(RuntimeError):
    pass


def _compile(name, sources, extra_cflags=(), extra_ldflags=(),
             extra_include_paths=(), build_directory=None, verbose=False,
             versioned=True):
    build_directory = build_directory or os.path.join(
        tempfile.gettempdir(), f"paddle_tpu_torch_extensions_{os.getuid()}")
    os.makedirs(build_directory, exist_ok=True)
    srcs = [s for s in sources if not s.endswith((".cu", ".cuh"))]
    if len(srcs) != len(sources) and verbose:
        print(f"[cpp_extension] skipping CUDA sources (host-side build): "
              f"{sorted(set(sources) - set(srcs))}")
    if not srcs:
        raise BuildError("no C++ sources to build (CUDA-only extension?)")
    # version the output by source content: re-load()ing edited sources in
    # one process must produce a NEW .so (dlopen caches by path, and
    # rewriting a still-mapped .so in place can SIGBUS), and same-named
    # extensions from different projects must not clobber each other
    if versioned:
        h = hashlib.sha256()
        for s in srcs:
            with open(s, "rb") as f:
                h.update(f.read())
        h.update(" ".join((*extra_cflags, *extra_ldflags,
                           *extra_include_paths)).encode())
        out = os.path.join(build_directory,
                           f"lib{name}.{h.hexdigest()[:12]}.so")
        if os.path.exists(out):
            return out
    else:
        # AOT packaging (setup) needs the stable, predictable name
        out = os.path.join(build_directory, f"lib{name}.so")
    compile_err = ""
    spawn_err = ""
    for cc in ("c++", "g++"):
        cmd = [cc, "-O2", "-std=c++17", "-shared", "-fPIC",
               *[f"-I{p}" for p in extra_include_paths], *extra_cflags,
               *srcs, "-o", out, *extra_ldflags]
        if verbose:
            print("[cpp_extension]", " ".join(cmd))
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=600)
        except (FileNotFoundError, subprocess.TimeoutExpired) as e:
            spawn_err = repr(e)
            continue  # try the next toolchain name
        if proc.returncode == 0:
            return out
        # a real compiler diagnostic: report it rather than trying another
        # compiler and risking burying it under a FileNotFoundError
        compile_err = proc.stderr[-2000:]
        break
    raise BuildError(f"compilation failed: {compile_err or spawn_err}")


def _call_c(cfn, *xs):
    """Run a symbol of the float32 ABI on host float32 copies of ``xs``; the
    result goes to the first input's device."""
    host = [x.detach().to("cpu", torch.float32).contiguous() for x in xs]
    out = torch.empty_like(host[0])
    cfn(*(h.data_ptr() for h in host), out.data_ptr(), out.numel())
    return out.to(xs[0].device)


def _host_op(qualname, cfn, schema):
    """``cfn`` of the float32 ABI as a ``torch.library`` op taking a list of
    tensors: the C call runs in the op's real implementation, and its fake
    output is float32 in the first input's shape."""
    def impl(xs):
        return _call_c(cfn, *xs)

    op = torch.library.custom_op(qualname, impl, mutates_args=(), schema=schema)

    @op.register_fake
    def _fake(xs):
        return xs[0].new_empty(xs[0].shape, dtype=torch.float32)

    return op


def _qualname(op_name, suffix=""):
    safe = "".join(c if c.isalnum() else "_" for c in op_name)
    return f"paddle_tpu_torch_ext::{safe}{suffix}"


class CppExtensionModule:
    """A loaded extension: ``.lib`` is the raw ctypes CDLL; ``def_op``
    registers an exported symbol as an op."""

    def __init__(self, name, path):
        self.name = name
        self.path = path
        self.lib = ctypes.CDLL(path)

    def def_op(self, op_name, symbol=None, n_inputs=1, backward_symbol=None):
        """Register C symbol ``symbol`` (default: ``op_name``) as op
        ``op_name`` under the simple float32 elementwise ABI (module
        docstring). Returns the public op callable (tensors -> float32
        tensor on the first input's device)."""
        if is_registered(op_name):
            raise CustomOpError(f"op {op_name!r} is already registered")
        fwd_c = getattr(self.lib, symbol or op_name)
        fwd_c.argtypes = [ctypes.c_void_p] * (n_inputs + 1) + [ctypes.c_int64]
        fwd_c.restype = None
        fwd_op = _host_op(_qualname(op_name), fwd_c, "(Tensor[] xs) -> Tensor")

        def forward(*xs):
            if len(xs) != n_inputs:
                raise TypeError(
                    f"{op_name} takes {n_inputs} input(s), got {len(xs)}")
            if any(x.shape != xs[0].shape for x in xs[1:]):
                # the C ABI iterates xs[0].numel() over every pointer: a
                # smaller input would be read out of bounds
                raise TypeError(
                    f"{op_name}: all inputs must share one shape, got "
                    f"{[tuple(x.shape) for x in xs]}")
            # detached: a gradient with no backward_symbol raises CustomOpError
            return fwd_op([x.detach() for x in xs])

        backward = None
        if backward_symbol is not None:
            if n_inputs != 1:
                raise NotImplementedError(
                    "backward_symbol is supported for unary ops; bind "
                    "multi-input gradients via .lib + register_custom_op")
            bwd_c = getattr(self.lib, backward_symbol)
            bwd_c.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64]
            bwd_c.restype = None
            bwd_op = _host_op(_qualname(op_name, "_grad"), bwd_c, "(Tensor[] xs) -> Tensor")

            def backward(residuals, gy):
                (x,) = residuals
                return (bwd_op([x, gy]),)

        return register_custom_op(op_name, forward, backward=backward)


def load(name, sources, extra_cflags=None, extra_ldflags=None,
         extra_include_paths=None, build_directory=None, verbose=False,
         **unused_reference_kwargs):
    """reference cpp_extension.load:895 — JIT-build the sources, return the
    loaded extension module."""
    path = _compile(name, list(sources), tuple(extra_cflags or ()),
                    tuple(extra_ldflags or ()),
                    tuple(extra_include_paths or ()), build_directory,
                    verbose)
    return CppExtensionModule(name, path)


class CppExtension:
    """Ahead-of-time build description (reference cpp_extension.py:250)."""

    def __init__(self, sources, name=None, include_dirs=None,
                 extra_compile_args=None, extra_link_args=None, **kw):
        self.name = name
        self.sources = list(sources)
        self.include_dirs = list(include_dirs or ())
        self.extra_compile_args = extra_compile_args or []
        self.extra_link_args = extra_link_args or []


def CUDAExtension(sources, *args, **kwargs):  # noqa: N802 - reference name
    """reference cpp_extension.py:302 — the .cu sources are skipped and the
    remaining C++ builds host-side, as in the JAX package."""
    return CppExtension(sources, *args, **kwargs)


def setup(name=None, ext_modules=(), **kw):
    """reference cpp_extension.setup:92 — ahead-of-time build: compiles each
    extension into the current directory (or PADDLE_EXTENSION_DIR)."""
    outdir = os.environ.get("PADDLE_EXTENSION_DIR", os.getcwd())
    built = []
    for ext in ext_modules:
        ext_name = ext.name or name
        if not ext_name:
            raise BuildError("extension needs a name (CppExtension(name=...) "
                             "or setup(name=...))")
        path = _compile(ext_name, ext.sources,
                        tuple(ext.extra_compile_args),
                        tuple(ext.extra_link_args),
                        tuple(ext.include_dirs), build_directory=outdir,
                        versioned=False)
        built.append(path)
    return built

"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. Nothing is
built when a module is imported: the first call that needs a kernel builds
it, so the CPU-only tests import every module without a CUDA toolkit.

Libraries go to ``paddle_tpu_torch/_build/`` (git-ignored), named by a hash
of the source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source never loads a stale build. Each library's compiler log lies beside it
under the same name (``.log``), so a log always describes the build it sits by.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_loaded: dict[str, Path] = {}  # name -> the library file load() opened


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels need the "
                           "CUDA toolkit (set CUDA_HOME)")
    return found


def _target(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    # the shared headers go into every key: an edited header rebuilds them all
    headers = b"".join(p.read_bytes() for p in sorted(SRC_DIR.glob("*.cuh")))
    key = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{key}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start nvcc for one source unless its library is already built."""
    so = _target(name)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, so


def _finish(name: str, job: tuple[subprocess.Popen, Path, Path]) -> None:
    proc, tmp, so = job
    out, _ = proc.communicate()
    so.with_suffix(".log").write_text(out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file


def build_all() -> float:
    """Compile every kernel source, one nvcc per source, all in parallel.

    Returns the wall seconds spent. Already-built libraries are reused.
    """
    t0 = time.perf_counter()
    with _lock:
        jobs = {}
        try:
            for name in sources():
                job = _start(name)
                if job is not None:
                    jobs[name] = job
            for name in list(jobs):
                _finish(name, jobs.pop(name))
        finally:
            for proc, _, _ in jobs.values():  # a failure elsewhere: stop the rest
                proc.kill()
                proc.wait()
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    for the library that :func:`load` opened for ``name``, or, before any load,
    for the one the current source and flags name."""
    path = _loaded.get(name, _target(name)).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            job = _start(name)
            if job is not None:
                _finish(name, job)
            so = _target(name)
            lib = ctypes.CDLL(str(so))
            _loaded[name] = so
            lib.pt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.pt_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero cudaError_t."""
    if err != 0:
        msg = lib.pt_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")

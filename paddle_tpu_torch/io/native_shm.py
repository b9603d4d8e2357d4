"""ctypes bindings for the native shared-memory ring
(``paddle_tpu_torch/_native/shm_ring.cpp``, the port's own copy of the JAX
package's source): the port of ``paddle_tpu/io/native_shm.py``.

Reference analog: the pybind'd C++ shared-memory tensor transport of the
reference DataLoader (memory/allocation/mmap_allocator.cc). Built on first use
with the system C++ compiler into the git-ignored ``paddle_tpu_torch/_build/``
(no pybind11 and no torch headers: plain ``extern "C"`` + ctypes, so the build
takes about a second). The ``.so`` is compiled to a per-process temporary name
and renamed into place, so a process never loads a half-written library.
Every consumer handles ``available() == False`` and falls back to per-array
``multiprocessing.shared_memory`` segments. The ring carries host bytes only.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time

_BUILD_LOCK = threading.Lock()
_LIB = [None]        # ctypes.CDLL | False (failed) | None (not tried)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "_native", "shm_ring.cpp")
_BUILD_DIR = os.path.join(_PKG, "_build")
_SO = os.path.join(_BUILD_DIR, "libshmring.so")


def _compile():
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # compile to a per-process temp name and rename atomically: a concurrent
    # process dlopen'ing a half-written .so can segfault uncatchably
    tmp = f"{_SO}.{os.getpid()}.tmp"
    for cc in ("c++", "g++", "cc"):
        try:
            proc = subprocess.run(
                [cc, "-O2", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp],
                capture_output=True, text=True, timeout=120)
        except (FileNotFoundError, subprocess.TimeoutExpired):
            continue
        if proc.returncode == 0:
            os.replace(tmp, _SO)
            return True
    try:
        os.unlink(tmp)
    except OSError:
        pass
    return False


def _lib():
    if _LIB[0] is not None:
        return _LIB[0] or None
    with _BUILD_LOCK:
        if _LIB[0] is not None:
            return _LIB[0] or None
        try:
            if not os.path.exists(_SO) or (os.path.getmtime(_SO)
                                           < os.path.getmtime(_SRC)):
                if not _compile():
                    _LIB[0] = False
                    return None
            lib = ctypes.CDLL(_SO)
            lib.shmring_create.restype = ctypes.c_void_p
            lib.shmring_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
            lib.shmring_attach.restype = ctypes.c_void_p
            lib.shmring_attach.argtypes = [ctypes.c_char_p]
            lib.shmring_capacity.restype = ctypes.c_uint64
            lib.shmring_capacity.argtypes = [ctypes.c_void_p]
            lib.shmring_free_bytes.restype = ctypes.c_uint64
            lib.shmring_free_bytes.argtypes = [ctypes.c_void_p]
            lib.shmring_try_push.restype = ctypes.c_int
            lib.shmring_try_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                             ctypes.c_uint64]
            lib.shmring_peek_len.restype = ctypes.c_int64
            lib.shmring_peek_len.argtypes = [ctypes.c_void_p]
            lib.shmring_try_pop.restype = ctypes.c_int64
            lib.shmring_try_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.c_uint64]
            lib.shmring_detach.argtypes = [ctypes.c_void_p]
            lib.shmring_unlink.argtypes = [ctypes.c_char_p]
            _LIB[0] = lib
            return lib
        except Exception:
            _LIB[0] = False
            return None


def available():
    return _lib() is not None


class ShmRing:
    """SPSC byte-message ring over POSIX shared memory."""

    TOO_BIG = -2

    def __init__(self, name, capacity=None, create=False):
        lib = _lib()
        if lib is None:
            raise RuntimeError("native shm ring unavailable")
        self._lib = lib
        self.name = name.encode()
        self._owner = create
        if create:
            self._ptr = lib.shmring_create(self.name, int(capacity))
        else:
            self._ptr = lib.shmring_attach(self.name)
        if not self._ptr:
            raise OSError(f"shmring {'create' if create else 'attach'} "
                          f"failed for {name!r}")

    @property
    def capacity(self):
        return int(self._lib.shmring_capacity(self._ptr))

    def try_push(self, data) -> int:
        """data: bytes or a buffer-protocol object (memoryview/PickleBuffer
        raw view) — writable buffers push zero-copy via from_buffer."""
        if isinstance(data, bytes):
            # ctypes passes the bytes' internal pointer for c_void_p args
            return int(self._lib.shmring_try_push(self._ptr, data, len(data)))
        mv = memoryview(data).cast("B")
        n = len(mv)
        try:
            carr = (ctypes.c_ubyte * n).from_buffer(mv)     # zero-copy
        except TypeError:  # read-only buffer
            carr = (ctypes.c_ubyte * n).from_buffer_copy(mv)
        return int(self._lib.shmring_try_push(self._ptr, ctypes.byref(carr), n))

    def push(self, data, timeout=None, poll=0.0005) -> bool:
        """Blocking push; False on timeout, raises ValueError if it can never fit."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            rc = self.try_push(data)
            if rc == 0:
                return True
            if rc == self.TOO_BIG:
                raise ValueError(
                    f"message of {len(data)} bytes exceeds ring capacity "
                    f"{self.capacity}")
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(poll)

    def try_pop(self):
        n = int(self._lib.shmring_peek_len(self._ptr))
        if n < 0:
            return None
        buf = ctypes.create_string_buffer(n)
        got = int(self._lib.shmring_try_pop(self._ptr, buf, n))
        if got < 0:
            return None
        return buf.raw[:got]

    def pop(self, timeout=None, poll=0.0005):
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            msg = self.try_pop()
            if msg is not None:
                return msg
            if deadline is not None and time.monotonic() > deadline:
                return None
            time.sleep(poll)

    def close(self):
        if self._ptr:
            self._lib.shmring_detach(self._ptr)
            self._ptr = None

    def unlink(self):
        self._lib.shmring_unlink(self.name)

    def __del__(self):
        try:
            self.close()
            if self._owner:
                self.unlink()
        except Exception:
            pass

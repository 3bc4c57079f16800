"""Native C++ runtime (ctypes binding of pipeline.cpp, the port's own copy
of the JAX package's runtime).

The library is built with g++ at first use into ``sage_slam_tpu_torch/
_build/`` (git-ignored), named by the hash of the source and the flags, and
renamed into place, as _build.py does for nvcc; nothing is written beside
the source. A missing g++ or a failed build raises. It exposes:

* Runtime: rate-controlled OS threads for the mapping and loop backends
  (the reference's pthread architecture, deepfactors.cpp:1495-1505);
* TaskQueue: a blocking work queue;
* convex_hull_area, median: host-side math.

A Python exception inside a ctypes callback would be printed and dropped,
and the thread would go on. ``Runtime.spawn`` therefore runs the task
inside a wrapper that keeps the first exception any worker raises
(``Runtime.error``) and stops every worker; ``Runtime.check`` re-raises it
on the calling thread.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from .._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "pipeline.cpp"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib = None
_lib_lock = threading.Lock()
_TASK_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p)


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libslamrt-{digest}.so"


def build() -> Path:
    """Compile pipeline.cpp with g++ unless this source and these flags are
    built already -> the library's path."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH; the native runtime cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native runtime build failed (g++ exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The native library, built first if needed."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.rt_create.restype = ptr
        lib.rt_destroy.argtypes = [ptr]
        lib.rt_spawn_worker.restype = ptr
        lib.rt_spawn_worker.argtypes = [ptr, ctypes.c_char_p, _TASK_FN, ptr, ctypes.c_double]
        lib.rt_stop_worker.argtypes = [ptr]
        lib.rt_stop_all.argtypes = [ptr]
        lib.rt_join_all.argtypes = [ptr]
        lib.rt_queue_create.restype = ptr
        lib.rt_queue_destroy.argtypes = [ptr]
        lib.rt_queue_push.argtypes = [ptr, i64]
        lib.rt_queue_pop.restype = i64
        lib.rt_queue_pop.argtypes = [ptr, i64]
        lib.rt_queue_size.restype = i64
        lib.rt_queue_size.argtypes = [ptr]
        lib.rt_queue_close.argtypes = [ptr]
        lib.rt_convex_hull_area.restype = ctypes.c_double
        lib.rt_convex_hull_area.argtypes = [ctypes.POINTER(ctypes.c_float), i64]
        lib.rt_median.restype = ctypes.c_float
        lib.rt_median.argtypes = [ctypes.POINTER(ctypes.c_float), i64]
        _lib = lib
        return lib


class Runtime:
    """Owns native worker threads; their tasks are Python callables run
    from C++ threads."""

    def __init__(self):
        self._lib = load()
        self._h = self._lib.rt_create()
        self._keepalive = []  # the CFUNCTYPE wrappers must outlive the threads
        self._workers = []
        self._error_lock = threading.Lock()
        self.error = None  # the first exception a worker raised
        self.error_worker = None

    def spawn(self, name: str, fn, frequency_hz: float = 0.0):
        """Run ``fn()`` on a new thread at most ``frequency_hz`` times per
        second until stopped. The first exception of any worker is kept
        and stops every worker (the stop flags are lock-free, so a worker
        may set them while the owner joins)."""

        def task(_ctx):
            if self.error is not None:
                return
            try:
                fn()
            except BaseException as exc:  # noqa: BLE001 - handed to the owner's thread
                with self._error_lock:
                    if self.error is None:
                        self.error, self.error_worker = exc, name
                for handle in list(self._workers):
                    self._lib.rt_stop_worker(handle)

        cb = _TASK_FN(task)
        self._keepalive.append(cb)
        handle = self._lib.rt_spawn_worker(self._h, name.encode(), cb, None, frequency_hz)
        self._workers.append(handle)
        return handle

    def check(self):
        """Re-raise a worker's exception on the calling thread."""
        if self.error is not None:
            raise RuntimeError(f"worker {self.error_worker!r} failed") from self.error

    def stop_all(self):
        self._lib.rt_stop_all(self._h)

    def join_all(self):
        self._lib.rt_join_all(self._h)

    def close(self):
        if self._h:
            self._lib.rt_destroy(self._h)  # stops and joins what is left
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass


class TaskQueue:
    def __init__(self):
        self._lib = load()
        self._h = self._lib.rt_queue_create()

    def push(self, item: int):
        self._lib.rt_queue_push(self._h, item)

    def pop(self, timeout_ms: int = 100) -> int:
        """The next item, or -1 on timeout or once closed and empty."""
        return self._lib.rt_queue_pop(self._h, timeout_ms)

    def __len__(self):
        return self._lib.rt_queue_size(self._h)

    def close(self):
        self._lib.rt_queue_close(self._h)


def convex_hull_area(points: np.ndarray) -> float:
    """Monotone-chain convex hull area of [N, 2] points (float32 in,
    float64 arithmetic)."""
    pts = np.ascontiguousarray(points, np.float32)
    return load().rt_convex_hull_area(pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(pts))


def median(values: np.ndarray) -> float:
    v = np.ascontiguousarray(values, np.float32)
    return load().rt_median(v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(v))

"""Native (C++) runtime support: prefetching dataset loader + stage timers.

Builds ``libslamrt.so`` from ``slamrt.cpp`` at first use (g++ + zlib); the
built library is not kept in version control.  Exposes it via ctypes.  See ``slamrt.cpp`` for what lives here
and why (the reference's runtime scaffolding is C++; ours is too, around the
JAX/XLA compute path).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libslamrt.so")
_SRC = os.path.join(_DIR, "slamrt.cpp")

_lib = None


def _build():
    # build beside the target, then rename: a concurrent loader in another
    # process sees either no library or a complete one
    tmp = f"{_SO}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            [
                "g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                _SRC, "-o", tmp, "-lz", "-lpthread",
            ],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        _build()
    lib = ctypes.CDLL(_SO)
    lib.slamrt_load_image_gray.restype = ctypes.c_int
    lib.slamrt_load_image_gray.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_long,
    ]
    lib.slamrt_prefetch_open.restype = ctypes.c_void_p
    lib.slamrt_prefetch_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.slamrt_prefetch_get.restype = ctypes.c_int
    lib.slamrt_prefetch_get.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.slamrt_prefetch_close.argtypes = [ctypes.c_void_p]
    lib.slamrt_timer_start.argtypes = [ctypes.c_char_p]
    lib.slamrt_timer_stop.argtypes = [ctypes.c_char_p]
    lib.slamrt_timer_dump.restype = ctypes.c_int
    lib.slamrt_timer_dump.argtypes = [ctypes.c_char_p]
    _lib = lib
    return lib


def load_image_gray(path: str, max_hw=(2048, 2048)) -> np.ndarray:
    """Decode a PNG/PGM to a grayscale uint8 array using the native decoder."""
    lib = get_lib()
    cap = max_hw[0] * max_hw[1]
    buf = np.empty(cap, np.uint8)
    w = ctypes.c_int(0)
    h = ctypes.c_int(0)
    rc = lib.slamrt_load_image_gray(
        path.encode(), buf.ctypes.data_as(ctypes.c_void_p),
        ctypes.byref(w), ctypes.byref(h), cap,
    )
    if rc != 0:
        raise IOError(f"slamrt decode failed ({rc}) for {path}")
    return buf[: w.value * h.value].reshape(h.value, w.value).copy()


class PrefetchingLoader:
    """Ordered multi-threaded frame prefetcher over a path list."""

    def __init__(self, paths, width, height, n_buffers=8, n_threads=2):
        lib = get_lib()
        self._lib = lib
        self.width = width
        self.height = height
        self.n = len(paths)
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._handle = lib.slamrt_prefetch_open(
            arr, len(paths), width, height, n_buffers, n_threads
        )
        self._paths_keepalive = arr

    def get(self, idx: int) -> np.ndarray:
        out = np.empty((self.height, self.width), np.uint8)
        rc = self._lib.slamrt_prefetch_get(
            self._handle, idx, out.ctypes.data_as(ctypes.c_void_p)
        )
        if rc != 0:
            raise IOError(f"prefetch decode failed ({rc}) at frame {idx}")
        return out

    def close(self):
        if self._handle:
            self._lib.slamrt_prefetch_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class StageTimer:
    """Per-stage wall timers (REGISTER_TIMES equivalent), dumpable to file."""

    def __init__(self):
        self._lib = get_lib()

    def start(self, name: str):
        self._lib.slamrt_timer_start(name.encode())

    def stop(self, name: str):
        self._lib.slamrt_timer_stop(name.encode())

    def dump(self, path: str):
        self._lib.slamrt_timer_dump(path.encode())

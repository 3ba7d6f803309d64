"""Native I/O runtime bindings (ctypes over a small C++/libpng library).

The compute path is JAX; the host runtime around it — frame
decode, batch loading, prefetch — is native C++, like the reference's
(ref: src/Utilities/PngUtilities.cpp, src/DataLoader/). Built on first
use with g++ (cached as libtsdf_io.so next to the source); falls back
cleanly if no toolchain is present (``available()`` returns False and
callers use the numpy codec in io/png.py).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "tsdf_io.cpp")
_SO = os.path.join(_DIR, "libtsdf_io.so")

_lib = None
_lock = threading.Lock()
_build_error: str | None = None


def _build() -> bool:
    global _build_error
    cmd = [
        "g++", "-O2", "-shared", "-fPIC", "-std=c++17",
        _SRC, "-lpng", "-lz", "-lpthread", "-o", _SO,
    ]
    try:
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=120
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        _build_error = str(e)
        return False
    if proc.returncode != 0:
        _build_error = proc.stderr[-2000:]
        return False
    return True


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SO) or os.path.getmtime(
            _SO
        ) < os.path.getmtime(_SRC):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError as e:
            global _build_error
            _build_error = str(e)
            return None
        u32p = ctypes.POINTER(ctypes.c_uint32)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        lib.tsdf_png16_size.argtypes = [ctypes.c_char_p, u32p, u32p]
        lib.tsdf_load_png16.argtypes = [
            ctypes.c_char_p, u16p, ctypes.c_uint32, ctypes.c_uint32,
        ]
        lib.tsdf_save_png16.argtypes = [
            ctypes.c_char_p, u16p, ctypes.c_uint32, ctypes.c_uint32,
        ]
        lib.tsdf_load_png16_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, u16p,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,
        ]
        lib.tsdf_prefetch_create.restype = ctypes.c_void_p
        lib.tsdf_prefetch_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ]
        lib.tsdf_prefetch_dims.argtypes = [
            ctypes.c_void_p, ctypes.c_int, u32p, u32p,
        ]
        lib.tsdf_prefetch_take.argtypes = [
            ctypes.c_void_p, ctypes.c_int, u16p,
            ctypes.c_uint32, ctypes.c_uint32,
        ]
        lib.tsdf_prefetch_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    return _build_error


def _u16p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))


def load_png16(path: str) -> np.ndarray:
    """(H, W) u16 depth image via the native decoder."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native io unavailable: {_build_error}")
    w = ctypes.c_uint32()
    h = ctypes.c_uint32()
    if lib.tsdf_png16_size(path.encode(), ctypes.byref(w), ctypes.byref(h)):
        raise IOError(f"cannot read {path}")
    out = np.empty((h.value, w.value), np.uint16)
    if lib.tsdf_load_png16(path.encode(), _u16p(out), w.value, h.value):
        raise IOError(f"decode failed: {path}")
    return out


def save_png16(path: str, image: np.ndarray) -> None:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native io unavailable: {_build_error}")
    image = np.ascontiguousarray(image, np.uint16)
    h, w = image.shape
    if lib.tsdf_save_png16(path.encode(), _u16p(image), w, h):
        raise IOError(f"encode failed: {path}")


def load_png16_batch(paths: list[str], threads: int = 8) -> np.ndarray:
    """(N, H, W) u16: all images decoded in parallel native threads."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native io unavailable: {_build_error}")
    if not paths:
        return np.empty((0, 0, 0), np.uint16)
    w = ctypes.c_uint32()
    h = ctypes.c_uint32()
    if lib.tsdf_png16_size(
        paths[0].encode(), ctypes.byref(w), ctypes.byref(h)
    ):
        raise IOError(f"cannot read {paths[0]}")
    out = np.empty((len(paths), h.value, w.value), np.uint16)
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    ok = lib.tsdf_load_png16_batch(
        arr, len(paths), _u16p(out), w.value, h.value, threads
    )
    if ok != len(paths):
        raise IOError(f"decoded {ok}/{len(paths)} images")
    return out


class PNGPrefetcher:
    """Background-thread decode-ahead over an ordered path list.

    Iterating yields (H, W) u16 frames; decode overlaps consumer compute
    (the TUM fuse loop feeds the device from this).
    """

    def __init__(self, paths: list[str], threads: int = 4):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native io unavailable: {_build_error}")
        self._lib = lib
        self._paths = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(paths))(*self._paths)
        self._arr = arr  # keep alive
        self._n = len(paths)
        self._handle = lib.tsdf_prefetch_create(arr, self._n, threads)

    def __len__(self):
        return self._n

    def __iter__(self):
        for i in range(self._n):
            yield self.get(i)

    def get(self, i: int) -> np.ndarray:
        w = ctypes.c_uint32()
        h = ctypes.c_uint32()
        if self._lib.tsdf_prefetch_dims(
            self._handle, i, ctypes.byref(w), ctypes.byref(h)
        ):
            raise IOError(f"frame {i} failed to decode")
        out = np.empty((h.value, w.value), np.uint16)
        if self._lib.tsdf_prefetch_take(
            self._handle, i, _u16p(out), w.value, h.value
        ):
            raise IOError(f"frame {i} failed to decode")
        return out

    def close(self):
        if self._handle:
            self._lib.tsdf_prefetch_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

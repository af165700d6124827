"""ctypes bindings for the native C++ I/O runtime (native/sfm_io.cpp).

Builds on demand with make; every entry point has a pure-Python
fallback in sfm_tpu_torch.io.image_io, so the package works without a
toolchain.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess

import numpy as np

_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libsfm_io.so"
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _LIB_PATH.exists():
        try:
            subprocess.run(
                ["make", "-C", str(_NATIVE_DIR)],
                check=True, capture_output=True, timeout=120,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    lib.sfm_pnm_size.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long)
    ]
    lib.sfm_pnm_size.restype = ctypes.c_int
    lib.sfm_load_gray.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
    ]
    lib.sfm_load_gray.restype = ctypes.c_int
    lib.sfm_load_gray_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_long,
        ctypes.c_int,
    ]
    lib.sfm_load_gray_batch.restype = ctypes.c_int
    lib.sfm_write_ply.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_long,
    ]
    lib.sfm_write_ply.restype = ctypes.c_long
    lib.sfm_prefetch_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_long),
    ]
    lib.sfm_prefetch_open.restype = ctypes.c_void_p
    lib.sfm_prefetch_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_long),
    ]
    lib.sfm_prefetch_next.restype = ctypes.c_int
    lib.sfm_prefetch_close.argtypes = [ctypes.c_void_p]
    lib.sfm_prefetch_close.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def load_gray(path) -> np.ndarray:
    """[H, W] float32 grayscale of one PNM via the native decoder."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native io unavailable")
    w = ctypes.c_long()
    h = ctypes.c_long()
    rc = lib.sfm_pnm_size(str(path).encode(), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise ValueError(f"cannot parse PNM header: {path}")
    out = np.empty((h.value, w.value), np.float32)
    rc = lib.sfm_load_gray(str(path).encode(),
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                           ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise ValueError(f"decode failed: {path}")
    return out


def load_gray_batch(paths, n_threads: int = 0) -> np.ndarray:
    """Parallel batch decode of same-sized PNMs -> [N, H, W] f32."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native io unavailable")
    paths = [str(p) for p in paths]
    w = ctypes.c_long()
    h = ctypes.c_long()
    rc = lib.sfm_pnm_size(paths[0].encode(), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise ValueError(f"cannot parse PNM header: {paths[0]}")
    n = len(paths)
    out = np.zeros((n, h.value, w.value), np.float32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    ok = lib.sfm_load_gray_batch(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        w.value, h.value, n_threads,
    )
    if ok != n:
        raise ValueError(f"decoded {ok}/{n} images")
    return out


class FramePrefetcher:
    """Decode-ahead frame stream over the native worker pool.

    Iterates (index, [H, W] f32) in path order while ``depth`` frames
    are decoded ahead by native threads, so frame decode overlaps the
    card's work on the previous frame.  Use as a context manager or
    iterator; ``image_io.iter_gray_frames`` adds the pure-Python
    fallback.
    """

    def __init__(self, paths, depth: int = 4, n_threads: int = 0):
        lib = _load()
        if lib is None:
            raise RuntimeError("native io unavailable")
        self._lib = lib
        self._paths = [str(p) for p in paths]
        n = len(self._paths)
        self._arr = (ctypes.c_char_p * n)(*[p.encode() for p in self._paths])
        w = ctypes.c_long()
        h = ctypes.c_long()
        self._handle = lib.sfm_prefetch_open(
            self._arr, n, depth, n_threads, ctypes.byref(w), ctypes.byref(h))
        if not self._handle:
            raise ValueError(f"cannot parse PNM header: {self._paths[0]}")
        self.w = w.value
        self.h = h.value

    def __iter__(self):
        return self

    def __next__(self):
        if self._handle is None:
            raise StopIteration
        out = np.empty((self.h, self.w), np.float32)
        idx = ctypes.c_long()
        rc = self._lib.sfm_prefetch_next(
            self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(idx))
        if rc == 1:
            self.close()
            raise StopIteration
        if rc != 0:
            raise ValueError(f"decode failed: {self._paths[idx.value]}")
        return idx.value, out

    def close(self):
        if self._handle is not None:
            self._lib.sfm_prefetch_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def save_ply(path, points, valid=None) -> int:
    """Binary PLY export (every vertex white); returns number of vertices
    written."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native io unavailable")
    pts = np.ascontiguousarray(points, np.float32)
    n = pts.shape[0]
    val_p = None
    if valid is not None:
        valid = np.ascontiguousarray(valid, np.uint8)
        val_p = valid.ctypes.data_as(ctypes.c_char_p)
    count = lib.sfm_write_ply(
        str(path).encode(),
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        None, val_p, n,
    )
    if count < 0:
        raise IOError(f"PLY write failed: {path}")
    return int(count)

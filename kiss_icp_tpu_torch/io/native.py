"""ctypes bindings for the native scan IO / prefetch runtime.

The C++ library (the repository's native/scan_io.cpp, built by `make
native` into libkisstpu_native.so next to this file) owns the host data
path: binary scan decode and a background prefetch thread pool that overlaps
disk IO with device compute. Everything degrades to the same numpy decode
when the library is absent (`available()` -> False), so the port works from
a plain checkout. Same API as the JAX package's `io/native.py`.

Formats: 0 = float32 x4 records (KITTI/MulRan .bin), 1 = float32 x6 (Boreas),
2 = NCLT int16-scaled.
"""

from __future__ import annotations

import ctypes
import os
from typing import List

import numpy as np

FORMAT_F32X4 = 0
FORMAT_F32X6 = 1
FORMAT_NCLT = 2

_LIB_PATH = os.path.join(os.path.dirname(__file__), "libkisstpu_native.so")
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        # Corrupt / wrong-arch / truncated build product: degrade to the
        # numpy fallback exactly like a missing library (the module
        # docstring's graceful-degradation promise).
        return None
    lib.kisstpu_read_scan.restype = ctypes.c_int64
    lib.kisstpu_read_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
    ]
    lib.kisstpu_prefetcher_create.restype = ctypes.c_void_p
    lib.kisstpu_prefetcher_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
    ]
    lib.kisstpu_prefetcher_next.restype = ctypes.c_int64
    lib.kisstpu_prefetcher_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)
    ]
    lib.kisstpu_prefetcher_destroy.restype = None
    lib.kisstpu_prefetcher_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def read_scan(path: str, fmt: int, capacity: int = 1 << 20) -> np.ndarray:
    """Decode one scan natively -> (N, 3) float32. Raises if lib missing."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built; run `make native`")
    out = np.empty((capacity, 3), np.float32)
    n = lib.kisstpu_read_scan(
        str(path).encode(), fmt,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), capacity,
    )
    if n < 0:
        raise IOError(f"native read failed: {path}")
    # copy: returning a view would pin the whole (capacity, 3) staging
    # buffer alive for the scan's lifetime.
    return out[:n].copy()


class ScanPrefetcher:
    """Ordered background prefetch over a list of scan files.

    Iterating yields (N, 3) float32 scans in file order while worker threads
    decode ahead. Falls back to synchronous numpy decoding when the native
    library is not built.
    """

    def __init__(self, files: List[str], fmt: int, capacity: int = 1 << 20,
                 depth: int = 4, threads: int = 2):
        self._files = [str(f) for f in files]
        self._fmt = fmt
        self._capacity = capacity
        self._handle = None
        self._idx = 0
        lib = _load()
        if lib is not None and self._files:
            arr = (ctypes.c_char_p * len(self._files))(
                *[f.encode() for f in self._files]
            )
            self._handle = lib.kisstpu_prefetcher_create(
                arr, len(self._files), fmt, capacity, depth, threads
            )
        self._buf = np.empty((capacity, 3), np.float32)

    def __len__(self):
        return len(self._files)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        lib = _load()
        if self._handle is not None:
            n = lib.kisstpu_prefetcher_next(
                self._handle,
                self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
            if n == -1:
                raise StopIteration
            if n < 0:
                # -2: THIS position's file failed to read/decode (or the
                # pool died). An empty scan here would silently register a
                # bogus frame — raise with the offending path instead.
                bad = (self._files[self._idx]
                       if self._idx < len(self._files) else "<unknown>")
                self._idx += 1
                raise IOError(f"native prefetch failed at {bad}")
            self._idx += 1
            return self._buf[:n].copy()
        # numpy fallback (synchronous)
        if self._idx >= len(self._files):
            raise StopIteration
        path = self._files[self._idx]
        self._idx += 1
        return _numpy_decode(path, self._fmt, self._capacity)

    def close(self):
        lib = _load()
        if self._handle is not None and lib is not None:
            lib.kisstpu_prefetcher_destroy(self._handle)
            self._handle = None
        # Exhaust the iterator: continuing after close() must StopIteration,
        # not silently restart the sequence through the numpy fallback.
        self._idx = len(self._files)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _numpy_decode(path: str, fmt: int, capacity: int) -> np.ndarray:
    """Pure-numpy decode matching the native decoders' semantics exactly:
    partial trailing records of truncated files are floored (not an error),
    and points with any |coordinate| >= 1e30 are dropped along with
    non-finite ones — results must not depend on whether `make native` ran.
    """
    if fmt in (FORMAT_F32X4, FORMAT_F32X6):
        stride = 4 if fmt == FORMAT_F32X4 else 6
        flat = np.fromfile(path, dtype=np.float32)
        n_rec = len(flat) // stride
        pts = flat[: n_rec * stride].reshape(-1, stride)[:, :3]
    elif fmt == FORMAT_NCLT:
        pts = read_nclt_scan(path).astype(np.float32)
    else:
        raise ValueError(f"unknown format {fmt}")
    keep = np.all(np.isfinite(pts), axis=1) & np.all(np.abs(pts) < 1e30,
                                                     axis=1)
    return pts[keep][:capacity]


def read_nclt_scan(file_path: str) -> np.ndarray:
    """NCLT velodyne_sync .bin: interleaved int16 x, y, z, (l) scaled by
    0.005 with offset -100, flipped to z-up (a copy of the JAX package's
    `datasets/nclt.read_nclt_scan`, whose loader is not ported yet)."""
    binary = np.fromfile(file_path, dtype=np.int16)
    binary = binary[: (len(binary) // 4) * 4]  # floor a truncated tail
    x = binary[0::4].astype(np.float32) * 0.005 - 100.0
    y = binary[1::4].astype(np.float32) * 0.005 - 100.0
    z = binary[2::4].astype(np.float32) * 0.005 - 100.0
    return np.stack([x, -y, -z], axis=1).astype(np.float64)

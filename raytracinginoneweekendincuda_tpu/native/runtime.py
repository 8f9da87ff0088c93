"""ctypes bindings for the native (C++) runtime helpers.

The reference's native layer is CUDA device code plus host C++ (stb decode,
PPM serialization, BVH build on device).  This build keeps the *compute*
path in XLA/Pallas and implements the host runtime pieces in C++
(`native/src/`): PPM serialization and the BVH builder.  Python fallbacks
exist for every entry point, so the framework works without the shared
library; `build.sh` (or ``python -m raytracinginoneweekendincuda_tpu.native.build``)
compiles it with g++.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _lib_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "librtow_native.so")


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.rtow_write_ppm.restype = ctypes.c_int
        lib.rtow_write_ppm.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.rtow_build_bvh.restype = ctypes.c_int
        lib.rtow_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_double),  # bbox_min  [n,3]
            ctypes.POINTER(ctypes.c_double),  # bbox_max  [n,3]
            ctypes.POINTER(ctypes.c_int32),   # prim ids  [n]
            ctypes.c_int,                     # n leaves
            ctypes.POINTER(ctypes.c_double),  # out nmin   [2n-1,3]
            ctypes.POINTER(ctypes.c_double),  # out nmax   [2n-1,3]
            ctypes.POINTER(ctypes.c_int32),   # out prim   [2n-1]
            ctypes.POINTER(ctypes.c_int32),   # out escape [2n-1]
        ]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def write_ppm(path: str, rgb_u8: np.ndarray) -> None:
    """Serialize an [H,W,3] uint8 buffer as P3 PPM via the C++ helper."""
    lib = _load()
    h, w, _ = rgb_u8.shape
    buf = np.ascontiguousarray(rgb_u8, np.uint8)
    rc = lib.rtow_write_ppm(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h
    )
    if rc != 0:
        raise IOError(f"native PPM writer failed with code {rc} for {path!r}")


def build_bvh(bbox_min: np.ndarray, bbox_max: np.ndarray, prim_ids: np.ndarray):
    """Run the native BVH builder; returns (nmin, nmax, prim, escape).

    Threaded flattened encoding, bit-identical to the Python builder in
    ``scene/bvh.py``.  Returns None if the library is absent.
    """
    lib = _load()
    if lib is None:
        return None
    n = int(bbox_min.shape[0])
    if n == 0:
        z3 = np.zeros((0, 3), np.float64)
        return z3, z3.copy(), np.zeros(0, np.int32), np.zeros(0, np.int32)
    cap = 2 * n - 1
    bmin = np.ascontiguousarray(bbox_min, np.float64)
    bmax = np.ascontiguousarray(bbox_max, np.float64)
    pid = np.ascontiguousarray(prim_ids, np.int32)
    nmin = np.zeros((cap, 3), np.float64)
    nmax = np.zeros((cap, 3), np.float64)
    prim = np.zeros(cap, np.int32)
    escape = np.zeros(cap, np.int32)
    as_p = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
    count = lib.rtow_build_bvh(
        as_p(bmin, ctypes.c_double),
        as_p(bmax, ctypes.c_double),
        as_p(pid, ctypes.c_int32),
        n,
        as_p(nmin, ctypes.c_double),
        as_p(nmax, ctypes.c_double),
        as_p(prim, ctypes.c_int32),
        as_p(escape, ctypes.c_int32),
    )
    if count < 0:
        raise RuntimeError("native BVH build failed")
    return nmin[:count], nmax[:count], prim[:count], escape[:count]

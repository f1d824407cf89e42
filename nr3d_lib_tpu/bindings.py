"""Native (C++) extension loader via ctypes.

The reference builds six CUDA extension packages (csrc/ via setup.py);
here the compute kernels are JAX, and the host-side native pieces (mesh
extraction) are plain C++ compiled on first use with g++ into a shared
library cached next to the sources (no pybind11 in this image — ctypes).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

__all__ = ["load_mcubes", "marching_tets_native"]

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")
_cache = {}


def _build_and_load(name: str, sources) -> Optional[ctypes.CDLL]:
    if name in _cache:
        return _cache[name]
    so_path = os.path.join(_CSRC, name, f"lib{name}.so")
    srcs = [os.path.join(_CSRC, name, s) for s in sources]
    try:
        if (not os.path.exists(so_path)
                or any(os.path.getmtime(s) > os.path.getmtime(so_path)
                       for s in srcs)):
            cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                   *srcs, "-o", so_path]
            subprocess.run(cmd, check=True, capture_output=True)
        lib = ctypes.CDLL(so_path)
    except (subprocess.CalledProcessError, OSError) as e:
        _cache[name] = None
        return None
    _cache[name] = lib
    return lib


def load_mcubes() -> Optional[ctypes.CDLL]:
    lib = _build_and_load("mcubes", ["mcubes.cpp"])
    if lib is None:
        return None
    lib.mt_extract.restype = ctypes.c_int
    lib.mt_extract.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_float]
    lib.mt_counts.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
                              ctypes.POINTER(ctypes.c_int64)]
    lib.mt_copy.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_float),
                            ctypes.POINTER(ctypes.c_int32)]
    lib.mt_free.argtypes = [ctypes.c_int]
    return lib


def marching_tets_native(volume: np.ndarray, level: float = 0.0
                         ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native marching-tetrahedra; None if the toolchain is unavailable."""
    lib = load_mcubes()
    if lib is None:
        return None
    vol = np.ascontiguousarray(volume, np.float32)
    nx, ny, nz = vol.shape
    h = lib.mt_extract(vol.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                       nx, ny, nz, float(level))
    if h < 0:
        return None
    nv = ctypes.c_int64()
    nf = ctypes.c_int64()
    lib.mt_counts(h, ctypes.byref(nv), ctypes.byref(nf))
    verts = np.empty((nv.value, 3), np.float32)
    faces = np.empty((nf.value, 3), np.int32)
    if nv.value:
        lib.mt_copy(h, verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    lib.mt_free(h)
    return verts, faces

"""Native (C++) BVH builders, loaded with ctypes.

The port's copy of ``voidin_tpu/native`` for the BLAS and TLAS builders
(``bvh_builder.cpp``: ``voidin_build_blas``, ``voidin_build_tlas``), the
host-side hot loops of scene setup. The shared library is compiled with the
host's C++ compiler at first use into ``voidin_tpu_torch/_build/``
(git-ignored), named by a hash of the source and flags, so an edited source
rebuilds. Where no compiler is found, or with ``VOIDIN_NATIVE=0``, the
callers fall back to the numpy builders of ``rt/bvh.py``. The native and
numpy builders give different (equally valid) trees; ``builder()`` says
which one a call would use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "bvh_builder.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> str:
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libvoidin_bvh_{h.hexdigest()[:16]}.so")


def _compile(out: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    for cc in ("g++", "c++", "clang++"):
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
            lib = os.path.join(tmpdir, "lib.so")
            try:
                subprocess.run([cc, *FLAGS, _SRC, "-o", lib], check=True,
                               capture_output=True)
            except (subprocess.CalledProcessError, FileNotFoundError):
                continue
            os.replace(lib, out)
            return True
    return False


def enabled() -> bool:
    return os.environ.get("VOIDIN_NATIVE", "1") != "0"


def load() -> Optional[ctypes.CDLL]:
    """The builder library, compiled on first call; None when
    VOIDIN_NATIVE=0 or no C++ compiler builds it."""
    global _lib, _tried
    if not enabled():
        return None
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = library_path()
        if not os.path.exists(out) and not _compile(out):
            return None
        try:
            lib = ctypes.CDLL(out)
        except OSError:
            return None
        lib.voidin_build_blas.restype = ctypes.c_int32
        lib.voidin_build_blas.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.voidin_build_tlas.restype = ctypes.c_int32
        lib.voidin_build_tlas.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_void_p,
        ]
        _lib = lib
        return _lib


def builder() -> str:
    """"native" or "numpy": the builder build_blas / build_tlas use now."""
    return "native" if load() is not None else "numpy"


def build_blas_native(vertices: np.ndarray, indices: np.ndarray):
    """C++ binned-SAH BLAS: (nodes structured array, permuted indices), or
    None when the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    from ..rt.bvh import NODE_DTYPE

    verts = np.ascontiguousarray(vertices, np.float32)
    idx = np.ascontiguousarray(indices, np.int32).copy()
    n_tris = idx.size // 3
    nodes = np.zeros(2 * n_tris + 2, NODE_DTYPE)
    n = lib.voidin_build_blas(
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(verts),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n_tris,
        nodes.ctypes.data,
    )
    if n <= 0:
        return None
    return nodes[:n].copy(), idx


def build_tlas_native(inst_min: np.ndarray, inst_max: np.ndarray):
    """C++ SAH TLAS over instance world AABBs, or None when the library is
    unavailable."""
    lib = load()
    if lib is None:
        return None
    from ..rt.bvh import TLAS_DTYPE

    mn = np.ascontiguousarray(inst_min, np.float32)
    mx = np.ascontiguousarray(inst_max, np.float32)
    nodes = np.zeros(2 * len(mn) + 1, TLAS_DTYPE)
    n = lib.voidin_build_tlas(
        mn.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mx.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(mn),
        nodes.ctypes.data,
    )
    if n <= 0:
        return None
    return nodes[:n].copy()

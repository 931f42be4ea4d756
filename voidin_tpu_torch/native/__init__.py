"""Native (C++) host paths, loaded with ctypes: the BVH builders and the
texture packer.

The port's copy of ``voidin_tpu/native``, the host-side hot loops of scene
setup:

* ``bvh_builder.cpp`` (``voidin_build_blas``, ``voidin_build_tlas``), the
  BLAS and TLAS builders;
* ``texture_packer.cpp`` (``voidin_pack_texture``), the texel-quad mip
  chain of a texture upload (``pack_texture``).

Both sources are compiled together, with the JAX package's flags
(``FLAGS``, no ``-march`` and no fast-math: the packer's deepest mip words
depend on float accumulation order and contraction, and must equal the JAX
library's), by the host's C++ compiler at first use into
``voidin_tpu_torch/_build/`` (git-ignored). The library is named by a hash
of both sources and the flags, so an edit to either rebuilds. Where no
compiler is found, or with ``VOIDIN_NATIVE=0`` (read at each call), the
callers fall back to numpy: the BVH builders of ``rt/bvh.py``, which give
different (equally valid) trees, and the packer of ``scene/texture.py``
(``_pack_numpy``), within a few u8 steps of this one and equal to it in
each level's own texels at mip levels 0-3. ``builder()`` and ``packer()`` say which one a call would
use.
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
_SRCS = [os.path.join(_DIR, "bvh_builder.cpp"),
         os.path.join(_DIR, "texture_packer.cpp")]
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> str:
    h = hashlib.sha256()
    for src in _SRCS:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libvoidin_native_{h.hexdigest()[:16]}.so")


def _compile(out: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    for cc in ("g++", "c++", "clang++"):
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
            lib = os.path.join(tmpdir, "lib.so")
            try:
                subprocess.run([cc, *FLAGS, *_SRCS, "-o", lib], check=True,
                               capture_output=True)
            except (subprocess.CalledProcessError, FileNotFoundError):
                continue
            os.replace(lib, out)
            return True
    return False


def enabled() -> bool:
    return os.environ.get("VOIDIN_NATIVE", "1") != "0"


def load() -> Optional[ctypes.CDLL]:
    """The native library, compiled on first call; None when
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
        lib.voidin_pack_texture.restype = ctypes.c_int32
        lib.voidin_pack_texture.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
        ]
        _lib = lib
        return _lib


def builder() -> str:
    """"native" or "numpy": the builder build_blas / build_tlas use now."""
    return "native" if load() is not None else "numpy"


def packer() -> str:
    """"native" or "numpy": the packer TexturePool.host_arrays uses now."""
    return "native" if load() is not None else "numpy"


def pack_texture(img: np.ndarray, base: int, total: int) -> Optional[np.ndarray]:
    """The texel-quad mip chain of one (h, w, 4) u8 texture as (total, 32)
    u8 rows at pool size `base` (total = the rows of base's mip chain, the
    texture no larger than base), or None when the library is
    unavailable."""
    lib = load()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.uint8)
    rows, s = 0, base
    while s >= 1:
        rows += s * s
        s //= 2
    if (img.ndim != 3 or img.shape[2] != 4 or max(img.shape[:2]) > base
            or base & (base - 1) or total != rows):
        raise ValueError(f"pack_texture takes an (h, w, 4) texture no "
                         f"larger than a pow2 base and that base's {rows} "
                         f"rows, got {img.shape}, base {base}, total {total}")
    out = np.zeros((total, 32), np.uint8)
    rc = lib.voidin_pack_texture(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), img.shape[0],
        img.shape[1], base, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out if rc == 0 else None


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

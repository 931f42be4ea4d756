"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each source compiles with its own nvcc, all started together, and the
objects link into one shared library with a plain C interface, loaded
with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
         -Xcompiler -fPIC -c -o _build/<name>.o csrc/<name>.cu   # per source
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o _build/libvoidin_kernels_<hash>.so _build/*.o

The library lands in ``voidin_tpu_torch/_build/`` (git-ignored), named by a
hash of the sources, the headers they share and the flags, so an edited
kernel rebuilds and an unchanged one loads as is. ``-fmad=false`` keeps
every multiply and add separately rounded, as the plain PyTorch twins
compute them: the kernels are then bit-comparable with their twins.

Nothing here runs at import time; the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path() -> str:
    h = hashlib.sha256()
    headers = sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))
    for src in _sources() + headers:
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libvoidin_kernels_{h.hexdigest()[:16]}.so")


def _check_run(procs):
    """Waits for every (process, command) and raises on the first failure
    with its output; returns the concatenated output."""
    text = ""
    failed = None
    for proc, cmd in procs:
        out, err = proc.communicate()
        text += out + err
        if proc.returncode != 0 and failed is None:
            failed = (proc.returncode, " ".join(cmd), out, err)
    if failed:
        raise RuntimeError("nvcc failed (%d): %s\n%s\n%s" % failed)
    return text


def build(verbose: bool = False) -> str:
    """Compile the kernels if the hashed library is missing; returns its
    path. `verbose` adds -Xptxas -v (registers/shared memory per kernel)
    and prints the compiler's output."""
    out = library_path()
    if os.path.exists(out) and not verbose:
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        compiles, objs = [], []
        for src in _sources():
            obj = os.path.join(tmpdir, os.path.basename(src)[:-3] + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", "-o", obj, src]
            if verbose:
                cmd[1:1] = ["-Xptxas", "-v"]
            compiles.append((subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.PIPE,
                                              text=True), cmd))
            objs.append(obj)
        text = _check_run(compiles)
        lib = os.path.join(tmpdir, "lib.so")
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", lib, *objs]
        text += _check_run([(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.PIPE,
                                              text=True), cmd)])
        if verbose:
            print(text)
        os.replace(lib, out)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first call, with its C signatures."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.voidin_fine_raster_pairs.restype = i
        lib.voidin_fine_raster_pairs.argtypes = [p, p, p, p, p, i, i, p]
        lib.voidin_fine_raster_pairs_track2.restype = i
        lib.voidin_fine_raster_pairs_track2.argtypes = [p, p, p, p, p, p, p,
                                                        i, i, p]
        lib.voidin_fine_raster_pairs_payload.restype = i
        lib.voidin_fine_raster_pairs_payload.argtypes = [p, p, p, p, i, p, p,
                                                         p, i, i, p]
        lib.voidin_fine_raster_pairs_payload_track2.restype = i
        lib.voidin_fine_raster_pairs_payload_track2.argtypes = [
            p, p, p, p, i, p, p, p, p, p, i, i, p]
        lib.voidin_fine_raster_blocks.restype = i
        lib.voidin_fine_raster_blocks.argtypes = [p, p, p, p, i, i, p]
        lib.voidin_fine_raster_blocks_track2.restype = i
        lib.voidin_fine_raster_blocks_track2.argtypes = [p, p, p, p, p, p, i,
                                                         i, p]
        lib.voidin_lut_fetch.restype = i
        lib.voidin_lut_fetch.argtypes = [p, p, i, i64, p, p]
        lib.voidin_lut_fetch_bf16.restype = i
        lib.voidin_lut_fetch_bf16.argtypes = [p, p, i, i64, p, p]
        for fn in (lib.voidin_ltc_rect, lib.voidin_ltc_rect_bf16):
            fn.restype = i
            fn.argtypes = [p, p, p, p, p, i, p, p, i64, p, p, p]
        for fn in (lib.voidin_ltc_ring, lib.voidin_ltc_ring_bf16):
            fn.restype = i
            fn.argtypes = [p, p, p, ctypes.c_float, p, i, p, p, i64, p, p, p]
        lib.voidin_shadow_trace.restype = i
        lib.voidin_shadow_trace.argtypes = [p, i, i, p, p, p, p, p, i,
                                            ctypes.c_float, i, p, p, p]
        lib.voidin_pack_shadow_rows.restype = i
        lib.voidin_pack_shadow_rows.argtypes = [p, i, i, p, i, p, i, p, p, p,
                                                p]
        lib.voidin_shadow_trace_attrs.restype = i
        lib.voidin_shadow_trace_attrs.argtypes = [i, i, p]
        lib.voidin_closest_hit.restype = i
        lib.voidin_closest_hit.argtypes = [p, p, p, p, p, p, p, i64, i, i, p,
                                           p, p, p, p]
        lib.voidin_closest_hit_attrs.restype = i
        lib.voidin_closest_hit_attrs.argtypes = [p]
        lib.voidin_error_string.restype = ctypes.c_char_p
        lib.voidin_error_string.argtypes = [i]
        _lib = lib
        return lib


def check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what}: CUDA error {rc}: "
            f"{lib.voidin_error_string(rc).decode(errors='replace')}"
        )

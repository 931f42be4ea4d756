"""Any-hit shadow rays through TLAS -> BLAS: the hand-written traversal
kernel.

``occluded`` takes the place of the JAX package's lock-step traversals,
``voidin_tpu/rt/traverse.py`` ``occluded`` (:137), ``occluded_packets``
(:321) and ``occluded_threaded`` (:616), which give the same hits. The JAX
package has no Pallas kernel for traversal (it walks the tree in plain jnp
under lax.while_loop); a plain-PyTorch walk would sync with the host at
every one of its hundreds of steps, so the port walks in a kernel of its
own. On a CUDA tensor it repacks the tables into the layout of
``rt/traverse.py pack_shadow_rows`` with one launch of the packing kernel
(``pack_rows``, counter ``LAUNCHES_PACK``) and launches the walk in
``csrc/shadow_trace.cu`` (see its header for what bounds it on an H100;
counter ``LAUNCHES``); on a CPU tensor it runs the plain PyTorch twins,
``pack_shadow_rows`` and ``rt/traverse.py occluded_reference``. A CUDA
tensor goes to the kernels or raises.

In the bounds mode (RasterConfig.debug_bounds, core/checks.py) the twin
checks each gather as the JAX package's walk does; the kernel reads
nothing but table indices, and on CUDA an out-of-range read is no error
the host sees, so the wrapper holds every link column of the tables to
the table sizes before the launch (``check_threaded_table``) and a
corrupt scene raises a named IndexError with nothing launched.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import checks
from ..rt.traverse import (MAX_LEAF, MAX_STEPS, OcclusionResult,
                           ShadowRows, check_threaded_table,
                           occluded_reference, pack_shadow_rows)

LAUNCHES = 0  # walk kernel launches (CUDA path only)
LAUNCHES_PACK = 0  # packing kernel launches (CUDA path only)
MAX_RAYS = (1 << 31) - 64  # the kernel counts rays in 32-bit ints


def check_rows(name, t, cols, dtype, device):
    """Raises unless `t` is an (n, cols) `dtype` tensor on `device`."""
    if (t.device != device or t.dtype != dtype or t.dim() != 2
            or t.shape[1] != cols):
        raise ValueError(f"{name} must be (n, {cols}) {dtype} on {device}, "
                         f"got {tuple(t.shape)} {t.dtype} {t.device}")


def occluded(table, n_tlas, instance_rows, tri_pos, origins, directions,
             t_max=1.0, max_steps=MAX_STEPS, active=None,
             max_leaf=MAX_LEAF) -> OcclusionResult:
    """Any-hit occlusion of R rays: `table`, `n_tlas`, `instance_rows` and
    `tri_pos` from rt/traverse.py scene_rays_threaded, (R, 3) f32
    `origins` and `directions` (not normalized; `t_max`, a float, is in
    units of |direction|), `active` an optional (R,) bool mask. Returns
    OcclusionResult: hit (R,) bool, overflow the pushes dropped on a full
    stack (0: the builders' depth keeps it from filling), exhausted the
    count of rays still walking after `max_steps` steps. CPU tensors run
    the twin; CUDA tensors repack the tables (pack_rows: one launch) and
    launch the walk."""
    if origins.device.type == "cpu":
        return occluded_reference(table, n_tlas, instance_rows, tri_pos,
                                  origins, directions, t_max=t_max,
                                  max_steps=max_steps, active=active,
                                  max_leaf=max_leaf)[0]
    global LAUNCHES
    from . import _build

    dev = origins.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    check_rows("table", table, 16, torch.float32, dev)
    check_rows("instance_rows", instance_rows, 24, torch.float32, dev)
    check_rows("tri_pos", tri_pos, 9, torch.float32, dev)
    check_rows("origins", origins, 3, torch.float32, dev)
    check_rows("directions", directions, 3, torch.float32, dev)
    R = origins.shape[0]
    if directions.shape[0] != R:
        raise ValueError("origins and directions differ in length")
    if active is not None and (active.device != dev
                               or active.dtype != torch.bool
                               or tuple(active.shape) != (R,)):
        raise ValueError(f"active must be ({R},) bool on {dev}")
    if not isinstance(t_max, (int, float)):
        raise ValueError("t_max must be a Python float")
    if max_leaf > MAX_LEAF:
        raise ValueError(f"BLAS leaves above MAX_LEAF={MAX_LEAF}")
    hit = torch.zeros(R, dtype=torch.bool, device=dev)
    counters = torch.zeros(2, dtype=torch.int32, device=dev)
    exhausted, overflow = counters[0], counters[1]
    if R == 0 or instance_rows.shape[0] == 0:
        return OcclusionResult(hit, overflow, exhausted)  # nothing to walk
    if R > MAX_RAYS:
        raise ValueError(f"{R} rays, above the kernel's {MAX_RAYS}")
    if checks.bounds_enabled():
        check_threaded_table(table, n_tlas, instance_rows, tri_pos)
    rows = pack_rows(table, n_tlas, instance_rows, tri_pos)
    origins, directions = origins.contiguous(), directions.contiguous()
    act = None if active is None else active.contiguous()
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.voidin_shadow_trace(
            rows.top.data_ptr(), int(n_tlas), rows.n_inst,
            rows.blas.data_ptr(), rows.tris.data_ptr(), origins.data_ptr(),
            directions.data_ptr(), None if act is None else act.data_ptr(),
            R, ctypes.c_float(t_max), int(max_steps), hit.data_ptr(),
            counters.data_ptr(), stream)
    _build.check(lib, rc, "shadow_trace")
    LAUNCHES += 1
    return OcclusionResult(hit, overflow, exhausted)


def pack_rows(table, n_tlas, instance_rows, tri_pos) -> ShadowRows:
    """rt/traverse.py pack_shadow_rows of CUDA tables in one launch of the
    packing kernel (csrc/shadow_trace.cu pack_shadow_rows_kernel; a frame
    repacks its tables, and the ~25 eager ops of the twin cost the shade
    stage more host time than the walk saves); CPU tables take the
    twin."""
    if table.device.type == "cpu":
        return pack_shadow_rows(table, n_tlas, instance_rows, tri_pos)
    global LAUNCHES_PACK
    from . import _build

    dev = table.device
    check_rows("table", table, 16, torch.float32, dev)
    check_rows("instance_rows", instance_rows, 24, torch.float32, dev)
    check_rows("tri_pos", tri_pos, 9, torch.float32, dev)
    table, instance_rows, tri_pos = (t.contiguous() for t in (
        table, instance_rows, tri_pos))
    n_inst, n_tri = instance_rows.shape[0], tri_pos.shape[0]
    n_blas = table.shape[0] - n_tlas
    top = torch.empty((n_tlas + 1) * 8 + n_inst * 16, dtype=torch.float32,
                      device=dev)
    blas = torch.empty(n_blas, 8, dtype=torch.float32, device=dev)
    tris = torch.empty(n_tri, 12, dtype=torch.float32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.voidin_pack_shadow_rows(
            table.data_ptr(), int(n_tlas), n_blas, instance_rows.data_ptr(),
            n_inst, tri_pos.data_ptr(), n_tri, top.data_ptr(),
            blas.data_ptr(), tris.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "pack_shadow_rows")
    LAUNCHES_PACK += 1
    return ShadowRows(top, int(n_tlas), n_inst, blas, tris)


def kernel_attributes(n_tlas, n_inst):
    """The kernel's build and occupancy on the current card for a scene of
    `n_tlas` TLAS nodes and `n_inst` instances: registers a thread, local
    memory bytes a thread, resident blocks an SM, threads a block and
    shared memory bytes a block."""
    from . import _build

    lib = _build.load()
    out = (ctypes.c_int * 5)()
    _build.check(lib, lib.voidin_shadow_trace_attrs(
        int(n_tlas), int(n_inst), ctypes.addressof(out)),
        "shadow_trace")
    return dict(zip(("registers", "local_bytes", "blocks_per_sm", "threads",
                     "shared_bytes"), list(out)))

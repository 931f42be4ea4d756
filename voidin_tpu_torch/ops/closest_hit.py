"""Closest-hit rays through TLAS -> BLAS: the hand-written traversal
kernel.

``closest_hit`` takes the place of the JAX package's ``closest_hit``
(``voidin_tpu/rt/traverse.py:889``), a lock-step stack walk in plain jnp
under lax.while_loop (no Pallas kernel); in eager PyTorch each of its
steps would sync with the host, so the port walks in a kernel of its own.
On a CUDA tensor it launches the kernel in ``csrc/closest_hit.cu`` (see
its header for what bounds it on an H100); on a CPU tensor it runs the
plain PyTorch twin, ``rt/traverse.py closest_hit_reference``. A CUDA
tensor goes to the kernel or raises. In the bounds mode
(RasterConfig.debug_bounds) the wrapper holds the tables' link columns to
the table sizes before the launch (``check_stack_tables``), as
ops/shadow_trace.py does and for the same reason.
"""

from __future__ import annotations

import torch

from ..core import checks
from ..rt.traverse import (MAX_DIST, ClosestHitResult, check_stack_tables,
                           closest_hit_reference)
from .shadow_trace import check_rows

LAUNCHES = 0  # kernel launches (CUDA path only)


def closest_hit(tlas_rows, blas_rows, instance_rows, tri_pos, origins,
                directions, t_max=MAX_DIST, max_steps=2048,
                active=None) -> ClosestHitResult:
    """Nearest hit of R rays: the tables of rt/traverse.py scene_rays,
    (R, 3) f32 `origins` and `directions` (not normalized; `t_max`, a
    float or (R,) f32, in units of |direction|), `active` an optional (R,)
    bool mask. Returns ClosestHitResult: t (R,) f32 (t_max on a miss),
    visits (R,) i32 (stack pops), overflow (pushes dropped on a full
    stack) and exhausted (rays with a stack left after `max_steps` pops).
    CPU tensors run the twin; CUDA tensors launch the kernel."""
    if origins.device.type == "cpu":
        return closest_hit_reference(tlas_rows, blas_rows, instance_rows,
                                     tri_pos, origins, directions,
                                     t_max=t_max, max_steps=max_steps,
                                     active=active)[0]
    global LAUNCHES
    from . import _build

    dev = origins.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for name, t, cols in (("tlas_rows", tlas_rows, 8),
                          ("blas_rows", blas_rows, 8),
                          ("instance_rows", instance_rows, 24),
                          ("tri_pos", tri_pos, 9), ("origins", origins, 3),
                          ("directions", directions, 3)):
        check_rows(name, t, cols, torch.float32, dev)
    R = origins.shape[0]
    if directions.shape[0] != R:
        raise ValueError("origins and directions differ in length")
    if active is not None and (active.device != dev
                               or active.dtype != torch.bool
                               or tuple(active.shape) != (R,)):
        raise ValueError(f"active must be ({R},) bool on {dev}")
    if isinstance(t_max, (int, float)):
        t = torch.full((R,), float(t_max), dtype=torch.float32, device=dev)
    elif (isinstance(t_max, torch.Tensor) and t_max.dtype == torch.float32
          and t_max.device == dev and t_max.dim() <= 1
          and t_max.numel() in (1, R)):
        t = t_max.expand(R).contiguous().clone()
    else:
        raise ValueError(f"t_max must be a float or ({R},) f32 on {dev}")
    visits = torch.zeros(R, dtype=torch.int32, device=dev)
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    exhausted = torch.zeros((), dtype=torch.int32, device=dev)
    if R == 0 or instance_rows.shape[0] == 0:
        return ClosestHitResult(t, visits, overflow, exhausted)
    if checks.bounds_enabled():
        check_stack_tables(tlas_rows, blas_rows, instance_rows, tri_pos)
    tlas_rows, blas_rows, instance_rows, tri_pos, origins, directions = (
        x.contiguous() for x in (tlas_rows, blas_rows, instance_rows,
                                 tri_pos, origins, directions))
    if tlas_rows.data_ptr() % 16 or blas_rows.data_ptr() % 16:
        raise ValueError("tlas_rows and blas_rows must be 16-byte aligned")
    act = None if active is None else active.contiguous()
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.voidin_closest_hit(
            tlas_rows.data_ptr(), blas_rows.data_ptr(),
            instance_rows.data_ptr(), tri_pos.data_ptr(),
            origins.data_ptr(), directions.data_ptr(),
            None if act is None else act.data_ptr(), R, int(max_steps),
            t.data_ptr(), visits.data_ptr(), overflow.data_ptr(),
            exhausted.data_ptr(), stream)
    _build.check(lib, rc, "closest_hit")
    LAUNCHES += 1
    return ClosestHitResult(t, visits, overflow, exhausted)

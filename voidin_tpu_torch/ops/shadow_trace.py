"""Any-hit shadow rays through TLAS -> BLAS: the hand-written traversal
kernel.

``occluded`` takes the place of the JAX package's lock-step traversals,
``voidin_tpu/rt/traverse.py`` ``occluded`` (:137), ``occluded_packets``
(:321) and ``occluded_threaded`` (:616), which give the same hits. The JAX
package has no Pallas kernel for traversal (it walks the tree in plain jnp
under lax.while_loop); a plain-PyTorch walk would sync with the host at
every one of its hundreds of steps, so the port walks in a kernel of its
own. On a CUDA tensor it launches the kernel in ``csrc/shadow_trace.cu``
(see its header for what bounds it on an H100); on a CPU tensor it runs
the plain PyTorch twin, ``rt/traverse.py occluded_reference``. A CUDA
tensor goes to the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..rt.traverse import (MAX_LEAF, MAX_STEPS, OcclusionResult,
                           occluded_reference)

LAUNCHES = 0  # kernel launches (CUDA path only)


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
    OcclusionResult: hit (R,) bool, overflow 0, exhausted the count of
    rays still walking after `max_steps` nodes. CPU tensors run the twin;
    CUDA tensors launch the kernel."""
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
    exhausted = torch.zeros((), dtype=torch.int32, device=dev)
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    if R == 0 or instance_rows.shape[0] == 0:
        return OcclusionResult(hit, overflow, exhausted)  # nothing to walk
    table, instance_rows, tri_pos, origins, directions = (
        t.contiguous() for t in (table, instance_rows, tri_pos, origins,
                                 directions))
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned")
    act = None if active is None else active.contiguous()
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.voidin_shadow_trace(
            table.data_ptr(), int(n_tlas), instance_rows.data_ptr(),
            tri_pos.data_ptr(), origins.data_ptr(), directions.data_ptr(),
            None if act is None else act.data_ptr(), R,
            ctypes.c_float(t_max), int(max_steps), hit.data_ptr(),
            exhausted.data_ptr(), stream)
    _build.check(lib, rc, "shadow_trace")
    LAUNCHES += 1
    return OcclusionResult(hit, overflow, exhausted)

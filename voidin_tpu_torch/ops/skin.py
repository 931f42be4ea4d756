"""Skinning and refits for every skin of a scene in three launches a frame.

``pose_skins`` poses every skin's triangles into the frame's copies of the
pool tables and refits each skinned mesh's box, ``refit_blas`` refits every
refittable BLAS of the scene, ``refit_tlas`` the TLAS: the hand-written
kernels of ``csrc/skin.cu`` (see its header for what bounds them on an H100
and how the design answers that). They compute what scene/skin.py's eager
chain (apply_skin per skin, refit_blas, refit_tlas) computes, word for
word; that chain is their plain twin and runs on CPU tensors, so this
module launches only on CUDA tensors and raises otherwise. It replaces no
kernel of the JAX package, which skins in plain jnp.

What the launches need is set up once, when a scene moves to a CUDA
device (scene/scene.py scene_from_numpy), and kept on the scene; it
copies nothing the skins hold. ``skin_batch(skins)`` (SceneData.skin_batch)
holds each skin's tables and refit plan by pointer, each triangle block's
skin, and the BLAS refit's steps (level k of every plan);
``tlas_bounds(levels, n)`` (TlasData.refit_bounds) the TLAS plan's level
bounds. Set-up checks what the kernels assume and the chain would refuse
or resolve by its order: disjoint rows, meshes and node ranges, joint
indices inside their skeleton, skeletons that fit the pose kernel's shared
memory, leaf triangles inside their skin. A frame launches, syncs nothing
and uploads nothing.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

TRIS_PER_BLOCK = 128  # csrc/skin.cu kTris
# joints a skin may have: the pose kernel stages the batch's largest
# skeleton in shared memory, 64 B a joint, within sm_90's 227 KB a block
JOINT_BYTES = 64
MAX_JOINTS = 3584

LAUNCHES = 0  # skin_pose_kernel launches
LAUNCHES_BLAS = 0  # blas_refit_kernel launches
LAUNCHES_TLAS = 0  # tlas_refit_kernel launches

# SkinData fields the pose kernel reads, in csrc/skin.cu SkinTables order,
# and those the BLAS refit reads, in BlasPlan order
TABLES = (("rest_pos", torch.float32), ("rest_nrm", torch.float32),
          ("rest_tan", torch.float32), ("tan_w", torch.float32),
          ("uv", torch.float32), ("joints", torch.int32),
          ("weights", torch.float32))
PLAN = ("refit_order", "refit_child", "refit_leaf_tri")


@dataclasses.dataclass
class SkinBatch:
    """Every skin of a scene as the kernels read them (one device)."""

    device: torch.device
    n_skins: int
    n_tri: int  # triangles posed a frame
    joint_rows: int  # rows of the joint array the skins read
    max_joints: int  # the largest skeleton (the pose's shared memory)
    tables: torch.Tensor  # (S, 7) int64: each skin's TABLES pointers
    skin_info: torch.Tensor  # (S, 8) int32, csrc/skin.cu's order
    block_skin: torch.Tensor  # (blocks,) int32
    partials: torch.Tensor  # (blocks, 6) f32 scratch
    skin_done: torch.Tensor  # (S,) int32 arrival counters
    # the BLAS refit over the R skins with a plan (R == 0: none)
    plans: torch.Tensor  # (R, 3) int64: each plan's PLAN pointers
    plan_info: torch.Tensor  # (R, 4) int32: bvh_base, base_tri, leaf cols
    step_first: torch.Tensor  # (K, R) int32: plan r's first row at step k
    step_prefix: torch.Tensor  # (K, R + 1) int32: rows before plan r
    step_rows: int  # the most rows of a step
    refit_nodes: int  # nodes of the plans
    # one past the largest pool row, mesh and node the kernels address
    row_end: int
    mesh_end: int
    node_end: int
    keep: tuple  # the tensors whose pointers `tables` and `plans` hold


def _aligned(t: torch.Tensor, dtype, name: str) -> torch.Tensor:
    """`t` as a kernel reads it by pointer: contiguous and 16-byte aligned
    (the skins' own tensors are; anything else is copied)."""
    if t.dtype != dtype:
        raise ValueError(f"skin {name} must be {dtype}, got {t.dtype}")
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _i32(a, dev):
    return torch.as_tensor(np.asarray(a, np.int64).astype(np.int32),
                           device=dev)


def _covers(levels, n):
    """A plan's (start, end) level slices cover its n rows in order."""
    return bool(levels) and levels[0][0] == 0 and levels[-1][1] == n and all(
        a[1] == b[0] for a, b in zip(levels, levels[1:]))


def skin_batch(skins) -> SkinBatch:
    """The batch of `skins` (scene/skin.py SkinData, on one device)."""
    if not skins:
        raise ValueError("no skins to batch")
    dev = skins[0].rest_pos.device
    keep, ptrs, info, block_skin = [], [], [], []
    plan_keep, plan_ptrs, plan_info, plan_levels = [], [], [], []
    reads = []  # what set-up checks on the device, read back at once
    for s_i, s in enumerate(skins):
        tabs = [_aligned(getattr(s, name), dtype, name)
                for name, dtype in TABLES]
        if any(t.device != dev for t in tabs):
            raise ValueError("the skins must lie on one device")
        n = tabs[0].shape[0]
        if n == 0:
            raise ValueError(f"skin {s_i} has no triangles")
        if not 0 < s.n_joints <= MAX_JOINTS:
            raise ValueError(f"skin {s_i} has {s.n_joints} joints; the pose "
                             f"kernel takes 1 to {MAX_JOINTS}")
        keep += tabs
        ptrs.append([t.data_ptr() for t in tabs])
        n_blocks = -(-n // TRIS_PER_BLOCK)
        info.append([n, s.base_tri, s.joint_offset, s.n_joints, s.mesh_id,
                     len(block_skin), n_blocks, 0])
        block_skin += [s_i] * n_blocks
        reads += [tabs[5].amin(), tabs[5].amax()]
        if s.refit_order is None:
            continue
        plan = [_aligned(getattr(s, name), torch.int32, name)
                for name in PLAN]
        if not _covers(tuple(s.refit_levels), plan[0].shape[0]):
            raise ValueError(f"skin {s_i}: the refit levels do not cover "
                             "its plan")
        plan_keep += plan
        plan_ptrs.append([t.data_ptr() for t in plan])
        plan_info.append([s.bvh_base, s.base_tri, plan[2].shape[1], 0])
        plan_levels.append(tuple(s.refit_levels))
        reads += [plan[0].amin(), plan[0].amax(), plan[1].amax(),
                  plan[2].amax()]

    got = iter(torch.stack(reads).tolist())  # set-up's one read
    node_ranges = []
    for s_i, s in enumerate(skins):
        lo, hi = next(got), next(got)
        if lo < 0 or hi >= s.n_joints:
            raise ValueError(f"skin {s_i}: joint indices outside its "
                             f"{s.n_joints} joints")
        if s.refit_order is None:
            continue
        o_lo, o_hi, c_hi, t_hi = (next(got) for _ in range(4))
        if o_lo < 0 or t_hi >= s.rest_pos.shape[0]:
            raise ValueError(f"skin {s_i}: a refit plan outside its BLAS "
                             "or its triangles")
        node_ranges.append((s.bvh_base + o_lo,
                            s.bvh_base + max(o_hi, c_hi) + 1))
    rows = sorted((r[1], r[1] + r[0]) for r in info)
    for what, spans in (("pool rows", rows),
                        ("BLAS nodes", sorted(node_ranges))):
        if any(a[1] > b[0] for a, b in zip(spans, spans[1:])):
            raise ValueError(f"two skins write overlapping {what}")
    if len({s.mesh_id for s in skins}) != len(skins):
        raise ValueError("two skins pose one mesh")

    # step k refits level k of every plan (each plan deepest level first)
    n_steps = max((len(lv) for lv in plan_levels), default=0)
    first = np.zeros((n_steps, len(plan_levels)), np.int64)
    count = np.zeros((n_steps, len(plan_levels)), np.int64)
    for r, levels in enumerate(plan_levels):
        for k, (a, b) in enumerate(levels):
            first[k, r], count[k, r] = a, b - a
    prefix = np.concatenate([np.zeros((n_steps, 1), np.int64),
                             np.cumsum(count, axis=1)], axis=1)
    return SkinBatch(
        device=dev, n_skins=len(skins), n_tri=sum(r[0] for r in info),
        joint_rows=max(s.joint_offset + s.n_joints for s in skins),
        max_joints=max(s.n_joints for s in skins),
        tables=torch.as_tensor(np.asarray(ptrs, np.int64), device=dev),
        skin_info=_i32(info, dev), block_skin=_i32(block_skin, dev),
        partials=torch.empty(len(block_skin), 6, dtype=torch.float32,
                             device=dev),
        skin_done=torch.zeros(len(skins), dtype=torch.int32, device=dev),
        plans=torch.as_tensor(np.asarray(plan_ptrs, np.int64).reshape(-1, 3),
                              device=dev),
        plan_info=_i32(np.asarray(plan_info).reshape(-1, 4), dev),
        step_first=_i32(first, dev), step_prefix=_i32(prefix, dev),
        step_rows=int(prefix[:, -1].max()) if n_steps else 0,
        refit_nodes=int(count.sum()),
        row_end=rows[-1][1], mesh_end=max(s.mesh_id for s in skins) + 1,
        node_end=max((b for _, b in node_ranges), default=0),
        keep=tuple(keep + plan_keep))


def tlas_bounds(levels, n, device) -> torch.Tensor:
    """The level bounds (K + 1) int32 on `device` of a TLAS refit plan of
    `n` rows whose (start, end) levels are `levels`."""
    levels = tuple(levels)
    if not _covers(levels, n):
        raise ValueError("TLAS: the refit levels do not cover its plan")
    return _i32([a for a, _ in levels] + [levels[-1][1]], device)


def _table(name, t, dtype, cols, device):
    """`t` as a kernel reads it: contiguous rows of `cols` on `device`."""
    if t.device != device or t.dtype != dtype or tuple(t.shape[1:]) != cols:
        raise ValueError(f"{name} must be (*, {cols}) {dtype} on {device}, "
                         f"got {tuple(t.shape)} {t.dtype} {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t


def _rows(name, t, end):
    """The kernels address rows up to `end` of `t`: it must hold them."""
    if t.shape[0] < end:
        raise ValueError(f"{name} has {t.shape[0]} rows, the kernels "
                         f"address {end}")


def _cuda(dev):
    if dev.type != "cuda":
        raise ValueError(f"the skin kernels run on CUDA tensors, got {dev}")


def _launch(fn, name, ptrs, ints, dev):
    """One call of the library's `fn` on `dev`'s current stream: the
    tensors' pointers, then `ints` (an int, or a list passed as int64)."""
    from . import _build

    lib = _build.load()
    arr = (ctypes.c_void_p * len(ptrs))(*[t.data_ptr() for t in ptrs])
    if isinstance(ints, list):
        ints = (ctypes.c_longlong * len(ints))(*ints)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, fn)(arr, ints, stream)
    _build.check(lib, rc, name)


def pose_skins(batch: SkinBatch, joint_mats, tri_pos, tri_attr, mesh_min,
               mesh_max):
    """Poses every skin of `batch` by `joint_mats` ((J, 4, 4) f32, J >=
    batch.joint_rows) into `tri_pos`, `tri_attr` (the frame's copies of
    the pool's rows) and each skinned mesh's row of `mesh_min` /
    `mesh_max`, in place: one launch of skin_pose_kernel."""
    global LAUNCHES
    dev = batch.device
    _cuda(dev)
    jm = _table("joint_mats", joint_mats, torch.float32, (4, 4), dev)
    if jm.shape[0] < batch.joint_rows:
        raise ValueError(f"the skins read {batch.joint_rows} joint rows, "
                         f"joint_mats has {jm.shape[0]}")
    outs = [_table("tri_pos", tri_pos, torch.float32, (9,), dev),
            _table("tri_attr_packed", tri_attr, torch.int32, (12,), dev),
            _table("mesh_min", mesh_min, torch.float32, (3,), dev),
            _table("mesh_max", mesh_max, torch.float32, (3,), dev)]
    _rows("tri_pos", tri_pos, batch.row_end)
    _rows("tri_attr_packed", tri_attr, batch.row_end)
    _rows("mesh_min", mesh_min, batch.mesh_end)
    _rows("mesh_max", mesh_max, batch.mesh_end)
    _launch("voidin_skin_pose", "skin_pose",
            [batch.tables, batch.skin_info, batch.block_skin, jm, *outs,
             batch.partials, batch.skin_done],
            [batch.block_skin.shape[0], JOINT_BYTES * batch.max_joints], dev)
    LAUNCHES += 1


def refit_blas(batch: SkinBatch, tri_pos, bvh_min, bvh_max):
    """Refits every BLAS of `batch` from the posed rows of `tri_pos` into
    `bvh_min` / `bvh_max` (the frame's copies of the pool's nodes), in
    place: one launch of blas_refit_kernel; nothing without a plan."""
    global LAUNCHES_BLAS
    dev = batch.device
    _cuda(dev)
    if batch.refit_nodes == 0:
        return
    outs = [_table("tri_pos", tri_pos, torch.float32, (9,), dev),
            _table("bvh_min", bvh_min, torch.float32, (3,), dev),
            _table("bvh_max", bvh_max, torch.float32, (3,), dev)]
    _rows("tri_pos", tri_pos, batch.row_end)
    _rows("bvh_min", bvh_min, batch.node_end)
    _rows("bvh_max", bvh_max, batch.node_end)
    _launch("voidin_blas_refit", "blas_refit",
            [batch.plans, batch.plan_info, batch.step_first,
             batch.step_prefix, *outs],
            [batch.plans.shape[0], batch.step_first.shape[0],
             bvh_min.shape[0], batch.step_rows], dev)
    LAUNCHES_BLAS += 1


def refit_tlas(tlas, mesh_min, mesh_max, mesh_id, transform, tlas_min,
               tlas_max):
    """Refits `tlas` (scene/scene.py TlasData: its refit plan and level
    bounds) from the instances' mesh boxes and transforms into `tlas_min`
    / `tlas_max` (the frame's copies), in place: one launch of
    tlas_refit_kernel."""
    global LAUNCHES_TLAS
    dev = tlas_min.device
    _cuda(dev)
    if tlas.refit_bounds is None:
        raise ValueError("the TLAS has no level bounds: it was not set up "
                         "on a CUDA device (scene_from_numpy)")
    ins = [_table("refit_order", tlas.refit_order, torch.int32, (), dev),
           _table("refit_child", tlas.refit_child, torch.int32, (2,), dev),
           _table("refit_instance", tlas.refit_instance, torch.int32, (),
                  dev),
           _table("refit_bounds", tlas.refit_bounds, torch.int32, (), dev),
           _table("mesh_min", mesh_min, torch.float32, (3,), dev),
           _table("mesh_max", mesh_max, torch.float32, (3,), dev),
           _table("mesh_id", mesh_id, torch.int32, (), dev),
           _table("transform", transform, torch.float32, (4, 4), dev),
           _table("tlas_min", tlas_min, torch.float32, (3,), dev),
           _table("tlas_max", tlas_max, torch.float32, (3,), dev)]
    _rows("tlas_min", tlas_min, tlas.refit_order.shape[0])
    _rows("tlas_max", tlas_max, tlas.refit_order.shape[0])
    _launch("voidin_tlas_refit", "tlas_refit", ins,
            [tlas.refit_bounds.shape[0] - 1,
             max(b - a for a, b in tlas.refit_levels)], dev)
    LAUNCHES_TLAS += 1

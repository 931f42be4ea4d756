"""Frustum culling + LOD select + draw compaction (emit_draws equivalent).

Counterpart of ``voidin_tpu/passes/cull.py``: a dense visibility test over
all instances (is_visible, emit_draws.wgsl:14-35, with the documented
object-space bounding-radius fix) followed by a stable-sort compaction
into a capacity-padded draw list.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core import fastmath
from ..framework import profiler
from ..scene.instance import InstanceData
from ..scene.mesh import MeshPoolData


@dataclasses.dataclass
class DrawList:
    """Capacity-padded compact draw stream."""

    instance: torch.Tensor  # (N,) i32 visible instance ids; -1 pad
    count: torch.Tensor  # () i64 number of valid entries
    mesh: Optional[torch.Tensor] = None  # (N,) i32 LOD mesh per draw


def view_sphere(meshes: MeshPoolData, instances: InstanceData, camera):
    """Per-instance view-space bounding sphere: ((N,3) center, (N,) radius)."""
    transform = instances.transform
    mesh_id = instances.mesh_id.to(torch.int64)
    mn = meshes.mesh_min[mesh_id]
    mx = meshes.mesh_max[mesh_id]
    center_obj = (mn + mx) * 0.5
    view = torch.as_tensor(camera.view, device=transform.device)
    vm = fastmath.compose_mat4(view, transform)
    center = fastmath.mat4_point(vm, center_obj)
    basis = transform[..., :3, :3]
    sq = basis * basis
    scale = fastmath.sqrt((sq[..., 0, :] + sq[..., 1, :]) + sq[..., 2, :])
    max_scale = torch.amax(scale.abs(), dim=-1)
    half = (mx - mn) * 0.5
    radius = fastmath.norm3(half) * max_scale
    return center, radius


def instance_visibility(meshes: MeshPoolData, instances: InstanceData,
                        camera) -> torch.Tensor:
    """(N,) bool visibility mask (vectorized is_visible)."""
    center, radius = view_sphere(meshes, instances, camera)
    fr = [float(v) for v in camera.frustum]
    visible_x = center[:, 2] * fr[1] - center[:, 0].abs() * fr[0] >= -radius
    visible_y = center[:, 2] * fr[3] - center[:, 1].abs() * fr[2] >= -radius
    # near/far: culled iff z+r > znear AND z-r > zfar; zfar = +inf makes the
    # second clause always false — kept for parity.
    nf_culled = (center[:, 2] + radius > float(camera.znear)) & (
        center[:, 2] - radius > float(camera.zfar)
    )
    return visible_x & visible_y & ~nf_culled


def compact_draws(mask: torch.Tensor, mesh_sel=None) -> DrawList:
    """Stable-sort compaction: visible instance ids first, in order."""
    n = mask.shape[0]
    count = mask.to(torch.int64).sum()
    order = torch.argsort((~mask).to(torch.uint8), stable=True)
    valid = torch.arange(n, device=mask.device) < count
    mesh = None
    if mesh_sel is not None:
        mesh = torch.where(valid, mesh_sel[order], -1).to(torch.int32)
    return DrawList(
        instance=torch.where(valid, order, -1).to(torch.int32),
        count=count,
        mesh=mesh,
    )


def select_lod(meshes: MeshPoolData, instances: InstanceData,
               camera) -> torch.Tensor:
    """(N,) i32 per-instance LOD mesh: level k engages when view distance /
    world radius reaches lod_thresh[m, k]."""
    center, radius = view_sphere(meshes, instances, camera)
    dist = fastmath.norm3(center)
    ratio = dist / torch.clamp(radius, min=1e-6)
    mesh_id = instances.mesh_id.to(torch.int64)
    table = meshes.lod_table[mesh_id]
    thresh = meshes.lod_thresh[mesh_id]
    engaged = (table[:, 1:] >= 0) & (ratio[:, None] >= thresh[:, 1:])
    level = engaged.to(torch.int64).sum(dim=-1)
    return torch.gather(table, 1, level[:, None])[:, 0]


@profiler.scoped("cull")
def emit_draws(meshes: MeshPoolData, instances: InstanceData,
               camera) -> DrawList:
    mesh_sel = (
        select_lod(meshes, instances, camera) if meshes.has_lods else None
    )
    draws = compact_draws(
        instance_visibility(meshes, instances, camera), mesh_sel
    )
    profiler.count("draws", draws.count)
    return draws

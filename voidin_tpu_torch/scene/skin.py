"""Vertex skinning: linear blend skinning of pooled triangle data, with the
BLAS and TLAS refits that keep traced shadows on the current pose.

Counterpart of ``voidin_tpu/scene/skin.py``. The raster reads de-indexed
per-triangle corner tables (``tri_pos``, ``tri_attr_packed``), so a skin
recomputes exactly those rows of its mesh from the rest pose and a (J, 4,
4) array of joint matrices (joint world transform @ inverse bind, composed
on the host each frame) and writes them into copies of the pool tables.
The mesh AABB (frustum culling), the mesh's BLAS node AABBs and the TLAS
node AABBs are then refit bottom-up over the fixed topology, one gather and
one scatter per tree level.

Plain PyTorch, as the JAX package's is plain jnp. The sums round as the
JAX functions do when called op by op: the joint blend in jnp.sum's order,
each ``einsum`` of a 3-vector (XLA's dot) as a chain of fused
multiply-adds (fastmath.dot_fma).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import encoding, fastmath


@dataclasses.dataclass
class SkinData:
    """One skinned mesh's rest-pose corner data and joint bindings,
    covering the pool triangle range [base_tri, base_tri + n_tri)."""

    rest_pos: torch.Tensor  # (T, 3, 3) f32 corner positions (rest)
    rest_nrm: torch.Tensor  # (T, 3, 3) f32
    rest_tan: torch.Tensor  # (T, 3, 3) f32
    tan_w: torch.Tensor  # (T, 3) f32 handedness
    uv: torch.Tensor  # (T, 3, 2) f32
    joints: torch.Tensor  # (T, 3, 4) i32 joint indices per corner
    weights: torch.Tensor  # (T, 3, 4) f32 normalized weights
    # BLAS refit plan (rt/bvh.py blas_refit_plan) over the mesh's fixed
    # BVH: level-ordered node ids (mesh-local), per-leaf triangle ids
    # (skin-local, -1 pad), left-child ids (-1 at a leaf). None = no refit
    # (shadow rays then see the rest pose).
    refit_order: Optional[torch.Tensor] = None  # (B,) i32
    refit_leaf_tri: Optional[torch.Tensor] = None  # (B, C) i32
    refit_child: Optional[torch.Tensor] = None  # (B,) i32
    refit_levels: tuple = ()
    base_tri: int = 0
    mesh_id: int = 0
    joint_offset: int = 0
    n_joints: int = 0
    bvh_base: int = -1  # the mesh's first node in the pool


SKIN_LEAVES = ("rest_pos", "rest_nrm", "rest_tan", "tan_w", "uv", "joints",
               "weights", "refit_order", "refit_leaf_tri", "refit_child")
SKIN_STATICS = ("refit_levels", "base_tri", "mesh_id", "joint_offset",
                "n_joints", "bvh_base")


def skin_leaves(skin: SkinData) -> dict:
    """The skin's arrays as numpy, keyed as SKIN_LEAVES (absent refit
    arrays left out, as a JAX pytree drops None leaves)."""
    return {k: getattr(skin, k).cpu().numpy() for k in SKIN_LEAVES
            if getattr(skin, k) is not None}


def skin_statics(skin) -> dict:
    """The static fields of a SkinData of either package."""
    return {k: getattr(skin, k) for k in SKIN_STATICS}


def skin_from_numpy(leaves: dict, statics: dict, device) -> SkinData:
    """SkinData on `device` from numpy leaves keyed as SKIN_LEAVES and the
    static fields of SKIN_STATICS."""
    arrays = {k: torch.as_tensor(np.array(v), device=device)
              for k, v in leaves.items() if k in SKIN_LEAVES}
    st = {k: statics[k] for k in SKIN_STATICS}
    st["refit_levels"] = tuple(tuple(int(i) for i in lv)
                               for lv in st["refit_levels"])
    return SkinData(**arrays, **st)


def pack_corner_attrs(uv, nrm, tan, tan_w):
    """(T, 3, *) corner attributes -> (T, 12) u32 rows (as int32) in the
    MeshPool tri_attr_packed layout: [uv f32 bits (6) | octahedral
    normals (3) | octahedral tangents with the w sign in the LSB (3)]."""
    t = uv.shape[0]
    uv_bits = uv.reshape(t, 6).contiguous().view(torch.int32)
    n_oct = encoding.encode_octahedral_32(nrm)  # (T, 3)
    t_oct = encoding.encode_octahedral_32(tan)
    t_oct = (t_oct & -2) | (tan_w < 0.0).to(torch.int32)
    return torch.cat([uv_bits, n_oct, t_oct], dim=-1)


def _rotate(R, v):
    """(..., 3, 3) @ (..., 3) as XLA's dot rounds it: each row a chain of
    fused multiply-adds."""
    return torch.stack([fastmath.dot_fma(R[..., i, :], v)
                        for i in range(3)], dim=-1)


def _unit(v):
    """v / max(|v|, 1e-20)."""
    return v / torch.clamp(fastmath.norm3(v), min=1e-20)[..., None]


def apply_skin(meshes, skin: SkinData, joint_mats: torch.Tensor):
    """Skin one mesh region: a new MeshPoolData whose rows of the region
    (tri_pos, tri_attr_packed), mesh AABB and, with a refit plan, BLAS
    node AABBs follow the pose; the other arrays are shared.

    joint_mats: (J_total, 4, 4) f32, the world-joint @ inverse-bind
    matrices of ALL skins concatenated; this skin uses rows
    [joint_offset, joint_offset + n_joints)."""
    jm = joint_mats[skin.joint_offset:skin.joint_offset + skin.n_joints]
    M = jm[skin.joints.long()]  # (T, 3, 4, 4, 4)
    w = skin.weights[..., None, None]
    Mw = ((M[:, :, 0] * w[:, :, 0] + M[:, :, 1] * w[:, :, 1])
          + M[:, :, 2] * w[:, :, 2]) + M[:, :, 3] * w[:, :, 3]
    R = Mw[..., :3, :3]
    pos = _rotate(R, skin.rest_pos) + Mw[..., :3, 3]  # (T, 3, 3)
    nrm = _unit(_rotate(R, skin.rest_nrm))
    tan = _unit(_rotate(R, skin.rest_tan))

    t = pos.shape[0]
    rows = slice(skin.base_tri, skin.base_tri + t)
    tri_pos = meshes.tri_pos.clone()
    tri_pos[rows] = pos.reshape(t, 9)
    tri_attr = meshes.tri_attr_packed.clone()
    tri_attr[rows] = pack_corner_attrs(skin.uv, nrm, tan, skin.tan_w)
    # the mesh AABB follows the pose, so frustum culling does
    flat = pos.reshape(-1, 3)
    mesh_min = meshes.mesh_min.clone()
    mesh_max = meshes.mesh_max.clone()
    mesh_min[skin.mesh_id] = flat.amin(dim=0)
    mesh_max[skin.mesh_id] = flat.amax(dim=0)
    meshes = dataclasses.replace(meshes, tri_pos=tri_pos,
                                 tri_attr_packed=tri_attr,
                                 mesh_min=mesh_min, mesh_max=mesh_max)
    if skin.refit_order is not None:
        meshes = refit_blas(meshes, skin, pos)
    return meshes


def refit_blas(meshes, skin: SkinData, pos: torch.Tensor):
    """Bottom-up BLAS AABB refit from the skinned (T, 3, 3) positions: each
    level of the plan (deepest first) gathers its leaves' triangle AABBs or
    its children's node AABBs and scatters the unions into copies of the
    pool node arrays. The topology (and the pool's triangle permutation)
    stays as built."""
    tri_min = pos.amin(dim=1)  # (T, 3) skin-local triangle AABBs
    tri_max = pos.amax(dim=1)
    leaf_tri = skin.refit_leaf_tri.long()  # (B, C), -1 pad
    valid = (leaf_tri >= 0)[..., None]
    safe = leaf_tri.clamp(min=0)
    inf = torch.tensor(float("inf"), device=pos.device)
    lmin = torch.where(valid, tri_min[safe], inf).amin(dim=1)  # (B, 3)
    lmax = torch.where(valid, tri_max[safe], -inf).amax(dim=1)

    bmin, bmax = meshes.bvh_min.clone(), meshes.bvh_max.clone()
    base = skin.bvh_base
    order = skin.refit_order.long()
    children = skin.refit_child.long()
    for s, e in skin.refit_levels:
        ids = base + order[s:e]
        child = children[s:e]
        is_leaf = (child < 0)[..., None]
        # a leaf reads no child: its clamped index stays in the pool (where
        # XLA clamps an out-of-range gather)
        c0 = base + child.clamp(min=0)
        c1 = (c0 + 1).clamp(max=bmin.shape[0] - 1)
        cmin = torch.minimum(bmin[c0], bmin[c1])
        cmax = torch.maximum(bmax[c0], bmax[c1])
        bmin[ids] = torch.where(is_leaf, lmin[s:e], cmin)
        bmax[ids] = torch.where(is_leaf, lmax[s:e], cmax)
    return dataclasses.replace(meshes, bvh_min=bmin, bvh_max=bmax)


def apply_skins(meshes, skins, joint_mats):
    for s in skins:
        meshes = apply_skin(meshes, s, joint_mats)
    return meshes


def refit_tlas(tlas, meshes, instances):
    """Bottom-up TLAS AABB refit: each instance's world AABB from its
    (refit) mesh AABB's 8 corners through the instance transform (as
    World.build_tlas builds them, rt/bvh.py instance_world_aabbs), then
    parents take the union of their children, deepest level first. The
    topology stays as built. A new TlasData; None passes through."""
    if tlas is None:
        return tlas
    mesh_id = instances.mesh_id.long()
    mn = meshes.mesh_min[mesh_id]  # (N, 3)
    mx = meshes.mesh_max[mesh_id]
    pick = torch.tensor([[i & 1, i & 2, i & 4] for i in range(8)],
                        dtype=torch.bool, device=mn.device)
    corners = torch.where(pick, mx[:, None], mn[:, None])  # (N, 8, 3)
    t = instances.transform
    world = _rotate(t[:, None, :3, :3], corners) + t[:, None, :3, 3]
    imin = world.amin(dim=1)  # (N, 3)
    imax = world.amax(dim=1)

    bmin, bmax = tlas.tlas_min.clone(), tlas.tlas_max.clone()
    order = tlas.refit_order.long()
    children = tlas.refit_child.long()
    instance = tlas.refit_instance.long()
    for s, e in tlas.refit_levels:
        ids = order[s:e]
        child = children[s:e]  # (n, 2)
        is_leaf = (child[:, 0] < 0)[..., None]
        safe_i = instance[s:e].clamp(min=0)
        c0 = child[:, 0].clamp(min=0)
        c1 = child[:, 1].clamp(min=0)
        bmin[ids] = torch.where(is_leaf, imin[safe_i],
                                torch.minimum(bmin[c0], bmin[c1]))
        bmax[ids] = torch.where(is_leaf, imax[safe_i],
                                torch.maximum(bmax[c0], bmax[c1]))
    return dataclasses.replace(tlas, tlas_min=bmin, tlas_max=bmax)


def build_skin_data(mesh, permuted_indices, joints_v, weights_v, base_tri,
                    mesh_id, joint_offset, n_joints, nodes=None,
                    bvh_base=-1) -> SkinData:
    """Host side: de-index per-vertex joints and weights into per-corner
    rows aligned with the pool's (BVH-permuted) triangle order, on the CPU
    (World.device carries them to the scene's device).

    `nodes` (the mesh's NODE_DTYPE array) and `bvh_base` (its first node
    in the pool) enable the per-frame BLAS refit; without them, traced
    shadows of this mesh see its rest-pose BVH."""
    from ..rt import bvh as bvh_mod

    tri = np.asarray(permuted_indices).reshape(-1, 3)
    jv = np.asarray(joints_v)
    wv = np.asarray(weights_v, np.float32)
    wsum = wv.sum(axis=-1, keepdims=True)
    wv = wv / np.maximum(wsum, 1e-8)
    refit = {}
    if nodes is not None and bvh_base >= 0:
        plan = bvh_mod.blas_refit_plan(np.asarray(nodes))
        refit = dict(
            refit_order=torch.from_numpy(plan["order"]),
            refit_leaf_tri=torch.from_numpy(plan["leaf_tri"]),
            refit_child=torch.from_numpy(plan["child"]),
            refit_levels=plan["levels"],
            bvh_base=int(bvh_base),
        )

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    tan = np.asarray(mesh.tangents)[tri]
    return SkinData(
        **refit,
        rest_pos=f32(np.asarray(mesh.vertices)[tri]),
        rest_nrm=f32(np.asarray(mesh.normals)[tri]),
        rest_tan=f32(tan[..., :3]),
        tan_w=f32(tan[..., 3]),
        uv=f32(np.asarray(mesh.uvs)[tri]),
        joints=torch.from_numpy(jv[tri].astype(np.int32)),
        weights=f32(wv[tri]),
        base_tri=int(base_tri),
        mesh_id=int(mesh_id),
        joint_offset=int(joint_offset),
        n_joints=int(n_joints),
    )

"""Wavefront OBJ import (ObjModel equivalent, crates/app/src/models/mod.rs:17-58).

Loads positions/normals/uvs, triangulates polygon faces (fan), computes
flat normals when missing, and creates one material per OBJ material with
its diffuse color baked into a 1x1 texture (the reference shading samples
textures only; base_color does not shade — material.rs/shading.wgsl).
Counterpart of ``voidin_tpu/io/obj.py``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..scene.mesh import Mesh


def _parse_mtl(path: str) -> Dict[str, np.ndarray]:
    mats: Dict[str, np.ndarray] = {}
    if not os.path.exists(path):
        return mats
    cur = None
    for line in open(path, errors="ignore"):
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "newmtl":
            cur = parts[1]
            mats[cur] = np.array([1.0, 1.0, 1.0], np.float32)
        elif parts[0] == "Kd" and cur is not None:
            mats[cur] = np.array([float(x) for x in parts[1:4]], np.float32)
    return mats


def import_obj(world, path: str) -> List[Tuple[int, int]]:
    """Import an OBJ file; returns [(pool_mesh_id, pool_material_id)] per
    material group. Instancing is up to the caller."""
    positions: List[List[float]] = []
    normals: List[List[float]] = []
    uvs: List[List[float]] = []
    mtl_colors: Dict[str, np.ndarray] = {}
    groups: Dict[Optional[str], list] = {}
    current: Optional[str] = None

    for line in open(path, errors="ignore"):
        parts = line.split()
        if not parts:
            continue
        tag = parts[0]
        if tag == "v":
            positions.append([float(x) for x in parts[1:4]])
        elif tag == "vn":
            normals.append([float(x) for x in parts[1:4]])
        elif tag == "vt":
            uvs.append([float(parts[1]), float(parts[2]) if len(parts) > 2 else 0.0])
        elif tag == "mtllib":
            mtl_colors.update(
                _parse_mtl(os.path.join(os.path.dirname(path), parts[1]))
            )
        elif tag == "usemtl":
            current = parts[1]
        elif tag == "f":
            verts = []
            for p in parts[1:]:
                comps = p.split("/")
                vi = int(comps[0])
                ti = int(comps[1]) if len(comps) > 1 and comps[1] else 0
                ni = int(comps[2]) if len(comps) > 2 and comps[2] else 0
                verts.append((vi, ti, ni))
            tris = groups.setdefault(current, [])
            for k in range(1, len(verts) - 1):  # fan triangulation
                tris.append((verts[0], verts[k], verts[k + 1]))

    def resolve(i, n):
        return (i - 1) if i > 0 else (n + i)

    out = []
    for mtl_name, tris in groups.items():
        # de-index into flat corner arrays (obj indices are heterogeneous)
        vpos, vnrm, vuv, indices = [], [], [], []
        cache: Dict[Tuple[int, int, int], int] = {}
        for tri in tris:
            for v in tri:
                if v not in cache:
                    cache[v] = len(vpos)
                    vi, ti, ni = v
                    vpos.append(positions[resolve(vi, len(positions))])
                    vuv.append(
                        uvs[resolve(ti, len(uvs))] if ti and uvs else [0.0, 0.0]
                    )
                    vnrm.append(
                        normals[resolve(ni, len(normals))]
                        if ni and normals
                        else [0.0, 0.0, 0.0]
                    )
                indices.append(cache[v])
        vpos = np.asarray(vpos, np.float32)
        vnrm = np.asarray(vnrm, np.float32)
        vuv = np.asarray(vuv, np.float32)
        indices = np.asarray(indices, np.int32)

        # flat normals where missing
        if not normals or (np.linalg.norm(vnrm, axis=-1) < 1e-6).any():
            tri_v = vpos[indices.reshape(-1, 3)]
            fn = np.cross(tri_v[:, 1] - tri_v[:, 0], tri_v[:, 2] - tri_v[:, 0])
            fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
            acc = np.zeros_like(vpos)
            np.add.at(acc, indices.reshape(-1, 3)[:, 0], fn)
            np.add.at(acc, indices.reshape(-1, 3)[:, 1], fn)
            np.add.at(acc, indices.reshape(-1, 3)[:, 2], fn)
            missing = np.linalg.norm(vnrm, axis=-1) < 1e-6
            acc /= np.maximum(np.linalg.norm(acc, axis=-1, keepdims=True), 1e-20)
            vnrm[missing] = acc[missing]

        tangents = np.tile(np.array([[1, 0, 0, -1]], np.float32), (len(vpos), 1))
        mesh_id = world.meshes.add(Mesh(vpos, vnrm, tangents, vuv, indices))

        color = mtl_colors.get(mtl_name, np.array([1, 1, 1], np.float32))
        tex = world.textures.add(
            (np.concatenate([color, [1.0]]) * 255).astype(np.uint8).reshape(1, 1, 4),
            srgb=False,
        )
        mat_id = world.materials.add(albedo=tex)
        out.append((mesh_id, mat_id))
    return out

"""Pooled SoA mesh storage + procedural meshes.

Counterpart of ``voidin_tpu/scene/mesh.py``. Adding a mesh builds its
BLAS (``rt/bvh.py build_blas``) and permutes its index range so that every
BVH leaf covers contiguous triangles (mesh/mod.rs:320-325), as the JAX
pool does; ``tri_pos`` and the attribute rows follow the permuted order.
``MeshPool(build_bvh=False)`` keeps the input order and gives every mesh
one leaf holding all its triangles, as the JAX package's
``World(build_bvh=False)`` does (the ray tracer refuses such leaves above
``rt/traverse.py MAX_LEAF``).

Builtin meshes (ids 0-3, mesh/mod.rs:267-274):
  0 = horizontal unit plane, 1 = vertical unit plane,
  2 = uv sphere(res 1),      3 = uv sphere(res 10).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..core.encoding import encode_octahedral_32_np
from ..rt import bvh as bvh_mod

HORIZONTAL_PLANE_MESH = 0
VERTICAL_PLANE_MESH = 1
SPHERE_1_MESH = 2
SPHERE_10_MESH = 3


@dataclasses.dataclass
class Mesh:
    """Host-side mesh (numpy)."""

    vertices: np.ndarray  # (V, 3) f32
    normals: np.ndarray  # (V, 3) f32
    tangents: np.ndarray  # (V, 4) f32
    uvs: np.ndarray  # (V, 2) f32
    indices: np.ndarray  # (I,) i32

    def __post_init__(self):
        self.vertices = np.ascontiguousarray(self.vertices, dtype=np.float32)
        self.normals = np.ascontiguousarray(self.normals, dtype=np.float32)
        self.tangents = np.ascontiguousarray(self.tangents, dtype=np.float32)
        self.uvs = np.ascontiguousarray(self.uvs, dtype=np.float32)
        self.indices = np.ascontiguousarray(self.indices, dtype=np.int32)
        assert self.indices.size % 3 == 0


def make_plane_mesh(width: float = 1.0, height: float = 1.0) -> Mesh:
    """Horizontal quad in XZ, +Y normal (plane.rs:5-38)."""
    w, h = width / 2.0, height / 2.0
    vertices = np.array(
        [[-w, 0, -h], [-w, 0, h], [w, 0, h], [w, 0, -h]], dtype=np.float32
    )
    normals = np.tile(np.array([[0, 1, 0]], np.float32), (4, 1))
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=np.float32)
    tangents = np.tile(np.array([[1, 0, 0, -1]], np.float32), (4, 1))
    indices = np.array([0, 1, 2, 0, 2, 3], dtype=np.int32)
    return Mesh(vertices, normals, tangents, uvs, indices)


def make_vertical_plane_mesh(width: float = 1.0, height: float = 1.0) -> Mesh:
    """The horizontal plane rotated by Rx(-pi/2): XZ -> XY, normal -Z."""
    m = make_plane_mesh(width, height)
    rot = np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0]], dtype=np.float32)
    m.vertices = m.vertices @ rot.T
    m.normals = m.normals @ rot.T
    return m


def make_uv_sphere(radius: float = 1.0, resolution: int = 10) -> Mesh:
    """UV sphere with 4*res stacks and 8*res sectors (sphere.rs:6-67)."""
    vside = 4 * resolution
    uside = vside * 2
    v = np.linspace(0.0, 1.0, vside + 1, dtype=np.float32)
    u = np.linspace(0.0, 1.0, uside + 1, dtype=np.float32)
    uu, vv = np.meshgrid(u, v)
    theta = 2.0 * np.pi * uu + np.pi
    phi = np.pi * vv
    x = np.cos(theta) * np.sin(phi) * radius
    y = -np.cos(phi) * radius
    z = np.sin(theta) * np.sin(phi) * radius
    vertices = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
    norms = np.linalg.norm(vertices, axis=-1, keepdims=True)
    normals = vertices / np.maximum(norms, 1e-20)
    uvs = np.stack([uu, vv], axis=-1).reshape(-1, 2).astype(np.float32)
    tangents = np.tile(
        np.array([[1, 0, 0, -1]], np.float32), (len(vertices), 1)
    )
    tri = []
    for i in range(vside):
        k1 = i * (uside + 1)
        for j in range(uside):
            a, b = k1 + j, k1 + j + uside + 1
            if i != 0:
                tri += [a, b, a + 1]
            # the reference emits the second triangle for every stack row
            tri += [a + 1, b, b + 1]
    indices = np.array(tri, dtype=np.int32)
    return Mesh(vertices, normals, tangents, uvs, indices)


def make_box_mesh(width: float, height: float, length: float) -> Mesh:
    """Per-axis box: 24 verts, 6 faces, half-extent per dimension
    (crates/pools/src/mesh/boxx.rs:5-117 — vertices are dims/2, per-face
    normals/uv quads, tangent (1,0,0,-1))."""
    m = make_cube_mesh(1.0)
    scale = np.array([width, height, length], np.float32)
    return Mesh(
        (m.vertices * scale).astype(np.float32),
        m.normals,
        m.tangents,
        m.uvs,
        m.indices,
    )


def make_cube_mesh(size: float = 1.0) -> Mesh:
    """24-vertex, 6-face cube (cube.rs / boxx.rs equivalent)."""
    s = size / 2.0
    faces = [
        ([0, 0, 1], [1, 0, 0]),
        ([0, 0, -1], [-1, 0, 0]),
        ([1, 0, 0], [0, 0, -1]),
        ([-1, 0, 0], [0, 0, 1]),
        ([0, 1, 0], [1, 0, 0]),
        ([0, -1, 0], [1, 0, 0]),
    ]
    verts, norms, tans, uvs, idx = [], [], [], [], []
    for fi, (n, t) in enumerate(faces):
        n = np.array(n, np.float32)
        t = np.array(t, np.float32)
        b = np.cross(n, t)
        for du, dv in [(-1, -1), (1, -1), (1, 1), (-1, 1)]:
            verts.append(n * s + t * (du * s) + b * (dv * s))
            norms.append(n)
            tans.append(np.concatenate([t, [np.float32(-1.0)]]))
            uvs.append([(du + 1) / 2, (dv + 1) / 2])
        base = 4 * fi
        idx += [base, base + 1, base + 2, base, base + 2, base + 3]
    return Mesh(
        np.array(verts, np.float32),
        np.array(norms, np.float32),
        np.array(tans, np.float32),
        np.array(uvs, np.float32),
        np.array(idx, np.int32),
    )


@dataclasses.dataclass
class MeshPoolData:
    """Device mesh pool: the streams the raster path and the ray tracer
    read."""

    tri_pos: torch.Tensor  # (T_pool, 9) f32 de-indexed corner positions
    # (T_pool, 12) u32 bits as int32: [uv0.xy uv1.xy uv2.xy as f32 bits |
    # octahedral corner normals (3) | octahedral corner tangents, w-sign
    # in the LSB (3)]
    tri_attr_packed: torch.Tensor
    mesh_min: torch.Tensor  # (M, 3) f32
    mesh_max: torch.Tensor  # (M, 3) f32
    index_count: torch.Tensor  # (M,) i32
    base_index: torch.Tensor  # (M,) i32
    lod_table: torch.Tensor  # (M, 4) i32, -1 = no level
    lod_thresh: torch.Tensor  # (M, 4) f32
    # Pooled BLAS nodes (bvh/blas.rs BvhNode layout as SoA); a mesh's nodes
    # start at bvh_index[mesh] and their child / exit links are mesh-local
    bvh_index: torch.Tensor  # (M,) i32
    bvh_min: torch.Tensor  # (B, 3) f32
    bvh_max: torch.Tensor  # (B, 3) f32
    bvh_left_first: torch.Tensor  # (B,) i32
    bvh_count: torch.Tensor  # (B,) i32, leaf iff > 0
    # Mesh-local stackless exit links, encoded e+1 (0 = subtree done):
    # rt/bvh.py exit_links
    bvh_exit: torch.Tensor  # (B,) i32
    has_lods: bool = False
    # The most triangles in any BLAS leaf (the builders stop at 3)
    bvh_max_leaf: int = 8


MESH_LEAVES = ("tri_pos", "tri_attr_packed", "mesh_min", "mesh_max",
               "index_count", "base_index", "lod_table", "lod_thresh",
               "bvh_index", "bvh_min", "bvh_max", "bvh_left_first",
               "bvh_count", "bvh_exit")


class MeshPool:
    """Host-side pooled mesh accumulation, a BLAS per mesh."""

    def __init__(self, with_builtins: bool = True, build_bvh: bool = True):
        self.build_bvh = build_bvh
        self.positions: List[np.ndarray] = []
        self.normals: List[np.ndarray] = []
        self.tangents: List[np.ndarray] = []
        self.uvs: List[np.ndarray] = []
        self.indices: List[np.ndarray] = []
        self.bvh_nodes: List[np.ndarray] = []  # structured per-mesh nodes
        self.mesh_info: List[dict] = []
        self._vertex_count = 0
        self._index_count = 0
        self._bvh_count = 0
        if with_builtins:
            self.add(make_plane_mesh(1.0, 1.0))
            self.add(make_vertical_plane_mesh(1.0, 1.0))
            self.add(make_uv_sphere(1.0, 1))
            self.add(make_uv_sphere(1.0, 10))

    def __len__(self):
        return len(self.mesh_info)

    def add(self, mesh: Mesh) -> int:
        """Append a mesh; builds its BLAS and permutes its indices."""
        indices = mesh.indices.copy()
        if self.build_bvh:
            nodes, indices = bvh_mod.build_blas(mesh.vertices, indices)
        else:
            nodes = bvh_mod.single_leaf_nodes(mesh.vertices, indices)
        mesh_id = len(self.mesh_info)
        self.mesh_info.append(
            dict(
                min=mesh.vertices.min(axis=0),
                max=mesh.vertices.max(axis=0),
                index_count=indices.size,
                base_index=self._index_count,
                vertex_offset=self._vertex_count,
                bvh_index=self._bvh_count,
            )
        )
        self.positions.append(mesh.vertices)
        self.normals.append(mesh.normals)
        self.tangents.append(mesh.tangents)
        self.uvs.append(mesh.uvs)
        self.indices.append(indices)
        self.bvh_nodes.append(nodes)
        self._vertex_count += len(mesh.vertices)
        self._index_count += indices.size
        self._bvh_count += len(nodes)
        return mesh_id

    def set_lods(self, base_id: int, lods) -> None:
        """Register a geometric LOD chain: up to 3 (mesh_id, ratio) pairs,
        ratio = view distance / bounding radius, ascending."""
        assert len(lods) <= 3
        ratios = [r for _m, r in lods]
        assert ratios == sorted(ratios), "LOD thresholds must ascend"
        for m, _r in lods:
            assert 0 <= m < len(self.mesh_info)
        self.mesh_info[base_id]["lods"] = list(lods)

    def add_with_auto_lods(self, mesh: Mesh, ratios=(10.0, 25.0),
                           cells=(24, 10)) -> int:
        """Add a mesh plus grid-decimated LOD levels (decimate_grid) at the
        given distance/radius thresholds. Levels that fail to reduce the
        triangle count are skipped. Returns the base mesh id."""
        base = self.add(mesh)
        lods = []
        prev_tris = mesh.indices.size // 3
        for r, c in zip(ratios, cells):
            m = decimate_grid(mesh, c)
            t = m.indices.size // 3
            if t >= prev_tris:
                continue
            lods.append((self.add(m), float(r)))
            prev_tris = t
        if lods:
            self.set_lods(base, lods)
        return base

    def bounds(self) -> dict:
        """Each mesh's object-space AABB: mesh_min, mesh_max (M, 3) f32."""
        info = self.mesh_info
        return dict(
            mesh_min=np.array([i["min"] for i in info],
                              np.float32).reshape(-1, 3),
            mesh_max=np.array([i["max"] for i in info],
                              np.float32).reshape(-1, 3),
        )

    def host_arrays(self) -> dict:
        """The pool's arrays, named and typed as the JAX pool's leaves."""
        info = self.mesh_info
        nodes = (np.concatenate(self.bvh_nodes) if self.bvh_nodes
                 else np.zeros((0,), bvh_mod.NODE_DTYPE))
        return dict(
            indices=(np.concatenate(self.indices) if info
                     else np.zeros((0,), np.int32)),
            **self.bounds(),
            index_count=np.array([i["index_count"] for i in info], np.int32),
            base_index=np.array([i["base_index"] for i in info], np.int32),
            vertex_offset=np.array([i["vertex_offset"] for i in info],
                                   np.int32),
            bvh_index=np.array([i["bvh_index"] for i in info], np.int32),
            bvh_min=np.ascontiguousarray(nodes["min"]),
            bvh_max=np.ascontiguousarray(nodes["max"]),
            bvh_left_first=np.ascontiguousarray(nodes["left_first"]),
            bvh_count=np.ascontiguousarray(nodes["count"]),
            bvh_exit=(np.concatenate([bvh_mod.blas_exit_links(n)
                                      for n in self.bvh_nodes])
                      if self.bvh_nodes else np.zeros((0,), np.int32)),
            tri_pos=self._tri_pos(),
            **self._tri_attrs(),
            **self._lod_arrays(),
        )

    def _lod_arrays(self) -> dict:
        m = len(self.mesh_info)
        table = np.full((m, 4), -1, np.int32)
        thresh = np.zeros((m, 4), np.float32)
        table[:, 0] = np.arange(m, dtype=np.int32)
        for i, info in enumerate(self.mesh_info):
            for k, (mid, ratio) in enumerate(info.get("lods", [])):
                table[i, k + 1] = mid
                thresh[i, k + 1] = ratio
        return dict(lod_table=table, lod_thresh=thresh)

    def _tri_attrs(self) -> dict:
        rows = []
        for normals, tangents, uvs, idx in zip(
            self.normals, self.tangents, self.uvs, self.indices
        ):
            tri = idx.reshape(-1, 3)
            t = tri.shape[0]
            row = np.zeros((t, 12), np.uint32)
            row[:, 0:6] = (
                uvs[tri].reshape(t, 6).astype(np.float32).view(np.uint32)
            )
            for k in range(3):
                row[:, 6 + k] = encode_octahedral_32_np(normals[tri[:, k]])
                tang = tangents[tri[:, k]]
                enc = encode_octahedral_32_np(tang[:, :3])
                # w-sign (glTF handedness) in the LSB of the x quantization
                enc = (enc & np.uint32(~np.uint32(1))) | (
                    tang[:, 3] < 0.0
                ).astype(np.uint32)
                row[:, 9 + k] = enc
            rows.append(row)
        return {
            "tri_attr_packed": (
                np.concatenate(rows) if rows else np.zeros((0, 12), np.uint32)
            )
        }

    def _tri_pos(self) -> np.ndarray:
        rows = [
            verts[idx.reshape(-1, 3)].reshape(-1, 9)
            for verts, idx in zip(self.positions, self.indices)
        ]
        return (
            np.concatenate(rows).astype(np.float32)
            if rows
            else np.zeros((0, 9), np.float32)
        )


def pool_from_numpy(h: dict, device) -> MeshPoolData:
    """Device pool from host arrays (uint32 words travel as int32 bits;
    the BLAS node fields are below 2^31, so their values are kept)."""
    def t(name):
        a = np.array(h[name])
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.as_tensor(a, device=device)

    lod_table = np.asarray(h["lod_table"])
    count = np.asarray(h["bvh_count"])
    return MeshPoolData(
        **{k: t(k) for k in MESH_LEAVES},
        has_lods=bool((lod_table[:, 1:] >= 0).any()),
        bvh_max_leaf=int(count.max()) if count.size else 1,
    )


def make_torus_knot(
    p: int = 2,
    q: int = 3,
    segments: int = 256,
    sides: int = 32,
    radius: float = 1.0,
    tube: float = 0.3,
) -> Mesh:
    """(p,q) torus knot tube — a dense procedural stand-in for the classic
    bunny/dragon scan meshes. ~segments*sides*2 triangles."""
    t = np.linspace(0, 2 * np.pi, segments, endpoint=False, dtype=np.float32)
    r = radius * (2 + np.cos(q * t)) * 0.5
    center = np.stack(
        [r * np.cos(p * t), radius * np.sin(q * t) * 0.5, r * np.sin(p * t)],
        -1,
    )
    # Frenet-ish frame
    nxt = np.roll(center, -1, axis=0)
    tang = nxt - center
    tang /= np.maximum(np.linalg.norm(tang, axis=-1, keepdims=True), 1e-9)
    up = np.array([0, 1, 0], np.float32)
    side = np.cross(tang, up)
    side /= np.maximum(np.linalg.norm(side, axis=-1, keepdims=True), 1e-9)
    up2 = np.cross(side, tang)

    a = np.linspace(0, 2 * np.pi, sides, endpoint=False, dtype=np.float32)
    circ = (
        np.cos(a)[None, :, None] * side[:, None, :]
        + np.sin(a)[None, :, None] * up2[:, None, :]
    )  # (seg, sides, 3)
    verts = (center[:, None, :] + tube * circ).reshape(-1, 3)
    normals = circ.reshape(-1, 3)
    uvs = np.stack(
        np.meshgrid(np.arange(sides) / sides,
                    np.arange(segments) / segments),
        -1,
    ).reshape(-1, 2).astype(np.float32)
    tangents = np.concatenate(
        [np.repeat(tang, sides, axis=0),
         -np.ones((len(verts), 1), np.float32)],
        axis=-1,
    )
    idx = []
    for i in range(segments):
        for j in range(sides):
            a0 = i * sides + j
            a1 = i * sides + (j + 1) % sides
            b0 = ((i + 1) % segments) * sides + j
            b1 = ((i + 1) % segments) * sides + (j + 1) % sides
            idx += [a0, b0, a1, a1, b0, b1]
    return Mesh(verts, normals, tangents.astype(np.float32), uvs,
                np.array(idx, np.int32))


def decimate_grid(mesh: Mesh, cells: int = 24) -> Mesh:
    """Vertex-clustering decimation: snap vertices to a cells^3 grid over
    the mesh AABB, merge clusters (position/normal/tangent/uv averaged),
    drop degenerate triangles. Coarse but robust, for distant geometric
    LODs, where silhouette fidelity at a few pixels is all that matters.
    """
    v = mesh.vertices
    mn = v.min(axis=0)
    ext = np.maximum(v.max(axis=0) - mn, 1e-9)
    key = np.minimum((v - mn) / ext * cells, cells - 1e-4).astype(np.int64)
    flat = (key[:, 0] * cells + key[:, 1]) * cells + key[:, 2]
    uniq, remap = np.unique(flat, return_inverse=True)
    k = len(uniq)

    def avg(a):
        out = np.zeros((k, a.shape[1]), np.float64)
        np.add.at(out, remap, a.astype(np.float64))
        cnt = np.zeros(k, np.float64)
        np.add.at(cnt, remap, 1.0)
        return (out / cnt[:, None]).astype(np.float32)

    verts = avg(v)
    nrm = avg(mesh.normals)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-9)
    tan = avg(mesh.tangents)
    t3 = tan[:, :3]
    t3 /= np.maximum(np.linalg.norm(t3, axis=1, keepdims=True), 1e-9)
    # majority handedness; never 0 (a zero tangent.w kills the bitangent)
    tan = np.concatenate(
        [t3, np.where(tan[:, 3:4] >= 0.0, 1.0, -1.0)], axis=1
    )
    uv = avg(mesh.uvs)

    tri = remap[mesh.indices.reshape(-1, 3)]
    keep = (
        (tri[:, 0] != tri[:, 1]) & (tri[:, 1] != tri[:, 2])
        & (tri[:, 0] != tri[:, 2])
    )
    idx = tri[keep].reshape(-1).astype(np.int32)
    if idx.size == 0:  # degenerate input: keep one triangle
        idx = np.array([0, min(1, k - 1), min(2, k - 1)], np.int32)
    return Mesh(verts, nrm, tan.astype(np.float32), uv, idx)

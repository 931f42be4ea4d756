"""glTF 2.0 import into the scene pools.

Equivalent of the reference GltfDocument
(crates/app/src/models/gltf_model/mod.rs:26-302), with the same pooling
semantics:

* one pool mesh per primitive; tangents default to (0, 1, 0, 1) and uvs to
  (0, 0) when absent; missing indices become 0..n (mod.rs:103-155);
* materials: base_color = pbr base_color_factor with .w REPLACED by the
  alpha cutoff (default 0.5!) — mod.rs:55-56 — albedo/emissive sRGB,
  normal/metallic-roughness linear; missing textures fall back to
  WHITE/BLACK exactly as the reference (albedo/normal WHITE, emissive/mr
  BLACK);
* `scene_instances` flattens the default scene's node hierarchy into
  Instance records (get_scene_instances, mod.rs:160-207).

Counterpart of ``voidin_tpu/io/gltf.py``. Parsing is self-contained
(json + struct + numpy; PNG and JPEG images through ``io/image.py``
``decode_image``, without PIL; a progressive JPEG raises
NotImplementedError naming it); .glb and .gltf supported.
"""

from __future__ import annotations

import base64
import json
import os
import struct as pystruct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..scene.mesh import Mesh
from ..scene.texture import BLACK_TEXTURE, WHITE_TEXTURE
from .image import decode_image

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT4": 16,
}


def _load_container(path: str) -> Tuple[dict, List[bytes]]:
    """Returns (json document, buffer blobs)."""
    with open(path, "rb") as f:
        head = f.read(4)
        f.seek(0)
        data = f.read()
    if head == b"glTF":
        # GLB container: 12-byte header + chunks.
        _, _, _ = pystruct.unpack("<III", data[:12])
        offset = 12
        doc = None
        bin_chunk = None
        while offset < len(data):
            clen, ctype = pystruct.unpack("<II", data[offset : offset + 8])
            chunk = data[offset + 8 : offset + 8 + clen]
            if ctype == 0x4E4F534A:  # JSON
                doc = json.loads(chunk.decode("utf-8"))
            elif ctype == 0x004E4942:  # BIN
                bin_chunk = chunk
            offset += 8 + clen + (-clen % 4)
        buffers = []
        for buf in doc.get("buffers", []):
            if "uri" in buf:
                buffers.append(_load_uri(buf["uri"], os.path.dirname(path)))
            else:
                buffers.append(bin_chunk)
        return doc, buffers
    doc = json.loads(data.decode("utf-8"))
    buffers = [
        _load_uri(buf["uri"], os.path.dirname(path)) for buf in doc.get("buffers", [])
    ]
    return doc, buffers


def _load_uri(uri: str, base_dir: str) -> bytes:
    if uri.startswith("data:"):
        return base64.b64decode(uri.split(",", 1)[1])
    from urllib.parse import unquote

    with open(os.path.join(base_dir, unquote(uri)), "rb") as f:
        return f.read()


def _accessor(doc: dict, buffers: List[bytes], idx: int) -> np.ndarray:
    acc = doc["accessors"][idx]
    n = acc["count"]
    ncomp = _TYPE_COUNTS[acc["type"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    itemsize = np.dtype(dtype).itemsize * ncomp

    if "bufferView" in acc:
        bv = doc["bufferViews"][acc["bufferView"]]
        blob = buffers[bv["buffer"]]
        start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = bv.get("byteStride", itemsize)
        if stride == itemsize:
            arr = np.frombuffer(blob, dtype=dtype, count=n * ncomp, offset=start)
        else:
            raw = np.frombuffer(
                blob, dtype=np.uint8, count=(n - 1) * stride + itemsize, offset=start
            )
            view = np.lib.stride_tricks.as_strided(
                raw, shape=(n, itemsize), strides=(stride, 1)
            )
            arr = view.reshape(-1).view(dtype).copy()
        arr = arr.reshape(n, ncomp) if ncomp > 1 else arr.reshape(n)
    else:
        arr = np.zeros((n, ncomp) if ncomp > 1 else n, dtype)

    # sparse accessors
    if "sparse" in acc:
        sp = acc["sparse"]
        arr = np.array(arr)
        idx_acc = sp["indices"]
        bv = doc["bufferViews"][idx_acc["bufferView"]]
        blob = buffers[bv["buffer"]]
        it = _COMPONENT_DTYPES[idx_acc["componentType"]]
        sidx = np.frombuffer(
            blob,
            dtype=it,
            count=sp["count"],
            offset=bv.get("byteOffset", 0) + idx_acc.get("byteOffset", 0),
        )
        val_acc = sp["values"]
        bv = doc["bufferViews"][val_acc["bufferView"]]
        blob = buffers[bv["buffer"]]
        vals = np.frombuffer(
            blob,
            dtype=dtype,
            count=sp["count"] * ncomp,
            offset=bv.get("byteOffset", 0) + val_acc.get("byteOffset", 0),
        ).reshape(sp["count"], -1)
        arr[sidx] = vals if ncomp > 1 else vals.reshape(-1)
    return arr


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.array(node["matrix"], np.float32).reshape(4, 4).T  # column-major
    m = np.eye(4, dtype=np.float32)
    if "scale" in node:
        m = np.diag(np.array(list(node["scale"]) + [1.0], np.float32))
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ],
            np.float32,
        )
        rm = np.eye(4, dtype=np.float32)
        rm[:3, :3] = r
        m = rm @ m
    if "translation" in node:
        tm = np.eye(4, dtype=np.float32)
        tm[:3, 3] = node["translation"]
        m = tm @ m
    return m


@dataclass
class GltfDocument:
    """Imported glTF: pool ids + node hierarchy for instancing."""

    doc: dict
    mesh_ids: Dict[Tuple[int, int], int]  # (gltf mesh, primitive) -> pool mesh
    material_ids: List[int]  # gltf material index -> pool material
    path: str = ""
    # (gltf mesh, primitive) -> (per-vertex joints (n,4) int, weights (n,4)
    # f32 normalized) for primitives with JOINTS_0/WEIGHTS_0. The reference
    # importer DROPS skins (gltf_model/mod.rs has no skin handling) — kept
    # here so add_to_world can register device skinning data.
    skinned: Dict[Tuple[int, int], tuple] = None
    buffers: List[bytes] = None  # retained for animation sampling

    @classmethod
    def import_file(cls, world, path: str) -> "GltfDocument":
        doc, buffers = _load_container(path)

        # --- textures/materials (make_materials, mod.rs:44-101) ---------
        image_cache: Dict[Tuple[int, bool], int] = {}

        def process_texture(tex_index: int, srgb: bool) -> int:
            img_index = doc["textures"][tex_index].get("source", 0)
            key = (img_index, srgb)
            if key in image_cache:
                return image_cache[key]
            try:
                return _load(img_index, key, srgb)
            except FileNotFoundError as e:
                import warnings

                warnings.warn(f"glTF image missing, using WHITE: {e}", stacklevel=2)
                image_cache[key] = WHITE_TEXTURE
                return WHITE_TEXTURE

        def _load(img_index: int, key, srgb: bool) -> int:
            img = doc["images"][img_index]
            name = img.get("name") or f"images[{img_index}]"
            if "bufferView" in img:
                bv = doc["bufferViews"][img["bufferView"]]
                blob = buffers[bv["buffer"]]
                raw = blob[
                    bv.get("byteOffset", 0) : bv.get("byteOffset", 0)
                    + bv["byteLength"]
                ]
            else:
                uri = img["uri"]
                if uri.startswith("data:"):
                    raw = base64.b64decode(uri.split(",", 1)[1])
                else:
                    from urllib.parse import unquote

                    name = os.path.join(os.path.dirname(path), unquote(uri))
                    with open(name, "rb") as f:
                        raw = f.read()
            rgba = decode_image(raw, name=f"{path}: {name}")
            tid = world.textures.add(rgba, srgb=srgb)
            image_cache[key] = tid
            return tid

        material_ids = []
        for mat in doc.get("materials", []):
            pbr = mat.get("pbrMetallicRoughness", {})
            color = np.array(
                pbr.get("baseColorFactor", [1, 1, 1, 1]), np.float32
            )
            # reference quirk: .w is replaced by the alpha cutoff
            # unconditionally (mod.rs:55-56); default cutoff 0.5.
            color[3] = mat.get("alphaCutoff", 0.5)

            def tex(info, srgb, fallback):
                if info is None:
                    return fallback
                return process_texture(info["index"], srgb)

            albedo = tex(pbr.get("baseColorTexture"), True, WHITE_TEXTURE)
            normal = tex(mat.get("normalTexture"), False, WHITE_TEXTURE)
            emissive = tex(mat.get("emissiveTexture"), True, BLACK_TEXTURE)
            mr = tex(pbr.get("metallicRoughnessTexture"), False, BLACK_TEXTURE)
            material_ids.append(
                world.materials.add(
                    base_color=color,
                    albedo=albedo,
                    normal=normal,
                    metallic_roughness=mr,
                    emissive=emissive,
                )
            )

        # --- meshes (make_meshes, mod.rs:103-155) ------------------------
        mesh_ids: Dict[Tuple[int, int], int] = {}
        skinned: Dict[Tuple[int, int], tuple] = {}
        for mi, mesh in enumerate(doc.get("meshes", [])):
            for pi, prim in enumerate(mesh.get("primitives", [])):
                attrs = prim.get("attributes", {})
                if "POSITION" not in attrs or "NORMAL" not in attrs:
                    continue
                if prim.get("mode", 4) != 4:  # triangles only
                    continue
                pos = _accessor(doc, buffers, attrs["POSITION"]).astype(np.float32)
                nrm = _accessor(doc, buffers, attrs["NORMAL"]).astype(np.float32)
                n = len(pos)
                if "TANGENT" in attrs:
                    tan = _accessor(doc, buffers, attrs["TANGENT"]).astype(np.float32)
                    if len(tan) < n:
                        pad = np.tile(
                            np.array([[0, 1, 0, 1]], np.float32), (n - len(tan), 1)
                        )
                        tan = np.concatenate([tan, pad])
                else:
                    tan = np.tile(np.array([[0, 1, 0, 1]], np.float32), (n, 1))
                if "TEXCOORD_0" in attrs:
                    uv = _accessor(doc, buffers, attrs["TEXCOORD_0"])
                    if uv.dtype == np.uint8:
                        uv = uv.astype(np.float32) / 255.0
                    elif uv.dtype == np.uint16:
                        uv = uv.astype(np.float32) / 65535.0
                    uv = uv.astype(np.float32)
                else:
                    uv = np.zeros((n, 2), np.float32)
                if "indices" in prim:
                    idx = _accessor(doc, buffers, prim["indices"]).astype(np.int32)
                else:
                    idx = np.arange(n, dtype=np.int32)
                mesh_ids[(mi, pi)] = world.meshes.add(
                    Mesh(pos, nrm, tan, uv, idx)
                )
                if "JOINTS_0" in attrs and "WEIGHTS_0" in attrs:
                    jv = _accessor(doc, buffers, attrs["JOINTS_0"]).astype(
                        np.int32
                    )
                    wv = _accessor(doc, buffers, attrs["WEIGHTS_0"])
                    if wv.dtype == np.uint8:
                        wv = wv.astype(np.float32) / 255.0
                    elif wv.dtype == np.uint16:
                        wv = wv.astype(np.float32) / 65535.0
                    skinned[(mi, pi)] = (jv, wv.astype(np.float32))
        return cls(doc=doc, mesh_ids=mesh_ids, material_ids=material_ids,
                   path=path, skinned=skinned, buffers=buffers)

    def scene_instances(self, root_transform: Optional[np.ndarray] = None):
        """Flattened (transform, pool_mesh_id, pool_material_id) list for the
        default scene (get_scene_instances, mod.rs:160-207)."""
        root = (
            np.eye(4, dtype=np.float32)
            if root_transform is None
            else np.asarray(root_transform, np.float32)
        )
        out = []
        scene = self.doc.get("scenes", [{}])[self.doc.get("scene", 0)]

        def walk(node_idx, parent):
            node = self.doc["nodes"][node_idx]
            m = parent @ _node_matrix(node)
            if "mesh" in node:
                mi = node["mesh"]
                # glTF 2.0: "Only the joint transforms are applied to the
                # skinned mesh; the transform of the skinned mesh node MUST
                # be ignored." joint_matrices are in scene-root frame, so a
                # skinned primitive's instance transform is root ONLY —
                # using the node hierarchy here would double-transform.
                for pi, prim in enumerate(
                    self.doc["meshes"][mi].get("primitives", [])
                ):
                    key = (mi, pi)
                    if key not in self.mesh_ids:
                        continue
                    mat = prim.get("material")
                    mat_id = (
                        self.material_ids[mat]
                        if mat is not None and mat < len(self.material_ids)
                        else 0
                    )
                    use_m = (
                        root
                        if "skin" in node and key in (self.skinned or {})
                        else m
                    )
                    out.append((use_m.copy(), self.mesh_ids[key], mat_id))
            for child in node.get("children", []):
                walk(child, m)

        for node_idx in scene.get("nodes", []):
            walk(node_idx, root)
        return out

    def add_to_world(self, world, root_transform=None) -> List[int]:
        """Instantiate the default scene; returns instance ids. Nodes that
        reference a skin also register device skinning data with the world
        (beyond reference parity — the wgpu importer drops skins)."""
        ids = []
        for m, mesh_id, mat_id in self.scene_instances(root_transform):
            ids.append(world.instances.add(m, mesh_id, mat_id))
        self.bind_skins(world)
        return ids

    def bind_skins(self, world) -> List[int]:
        """Register SkinData for every skinned node's primitives; returns
        the gltf skin indices bound, in world-skin order (one entry per
        skinned primitive). Use GltfAnimator.joint_matrices to drive them."""
        if not self.skinned:
            return []
        from ..scene import skin as skin_mod

        bound = []
        scene = self.doc.get("scenes", [{}])[self.doc.get("scene", 0)]

        def walk(node_idx):
            node = self.doc["nodes"][node_idx]
            if "mesh" in node and "skin" in node:
                mi, si = node["mesh"], node["skin"]
                n_joints = len(self.doc["skins"][si]["joints"])
                for pi in range(len(self.doc["meshes"][mi].get("primitives", []))):
                    key = (mi, pi)
                    if key not in self.skinned or key not in self.mesh_ids:
                        continue
                    pool_id = self.mesh_ids[key]
                    jv, wv = self.skinned[key]
                    pool = world.meshes
                    info = pool.mesh_info[pool_id]
                    mesh_view = Mesh(
                        pool.positions[pool_id],
                        pool.normals[pool_id],
                        pool.tangents[pool_id],
                        pool.uvs[pool_id],
                        pool.indices[pool_id],
                    )
                    offset = world.allocate_joints(n_joints)
                    world.skins.append(
                        skin_mod.build_skin_data(
                            mesh_view,
                            pool.indices[pool_id],
                            jv,
                            wv,
                            base_tri=info["base_index"] // 3,
                            mesh_id=pool_id,
                            joint_offset=offset,
                            n_joints=n_joints,
                            nodes=pool.bvh_nodes[pool_id],
                            bvh_base=info["bvh_index"],
                        )
                    )
                    bound.append(si)
            for child in node.get("children", []):
                walk(child)

        for node_idx in scene.get("nodes", []):
            walk(node_idx)
        return bound


class GltfAnimator:
    """Host-side glTF animation sampling -> per-frame joint matrices.

    Samples TRS channels (LINEAR / STEP; CUBICSPLINE uses its vertex
    values with linear interpolation — documented approximation), composes
    the node hierarchy, and returns world-joint @ inverseBind matrices in
    the layout expected by scene skins (SURVEY has no reference analogue:
    the wgpu renderer cannot animate skins at all)."""

    def __init__(self, gdoc: GltfDocument, animation: int = 0):
        self.doc = gdoc.doc
        self.buffers = gdoc.buffers
        anims = self.doc.get("animations", [])
        self.channels: Dict[int, Dict[str, tuple]] = {}
        self.duration = 0.0
        if anims:
            anim = anims[animation]
            for ch in anim["channels"]:
                tgt = ch["target"]
                if "node" not in tgt:
                    continue
                s = anim["samplers"][ch["sampler"]]
                times = _accessor(self.doc, self.buffers, s["input"]).astype(
                    np.float32
                )
                vals = _accessor(self.doc, self.buffers, s["output"]).astype(
                    np.float32
                )
                interp = s.get("interpolation", "LINEAR")
                if interp == "CUBICSPLINE":
                    vals = vals.reshape(len(times), 3, -1)[:, 1]
                self.channels.setdefault(tgt["node"], {})[tgt["path"]] = (
                    times,
                    vals.reshape(len(times), -1),
                    interp,
                )
                self.duration = max(self.duration, float(times[-1]))
        self.parent: Dict[int, int] = {}
        for i, node in enumerate(self.doc.get("nodes", [])):
            for c in node.get("children", []):
                self.parent[c] = i

    def _sample_node(self, node_idx: int, t: float) -> np.ndarray:
        node = self.doc["nodes"][node_idx]
        over = {}
        for path, (times, vals, interp) in self.channels.get(
            node_idx, {}
        ).items():
            if interp == "STEP":
                k = int(np.clip(np.searchsorted(times, t, "right") - 1, 0,
                                len(times) - 1))
                v = vals[k]
            else:
                v = np.array(
                    [np.interp(t, times, vals[:, c]) for c in range(vals.shape[1])],
                    np.float32,
                )
            if path == "rotation" and interp != "STEP":
                # shortest-path nlerp (glTF linear rotation semantics);
                # STEP rotations keep the held keyframe from above
                k = int(np.clip(np.searchsorted(times, t, "right") - 1, 0,
                                len(times) - 2))
                q0, q1 = vals[k], vals[min(k + 1, len(vals) - 1)]
                if np.dot(q0, q1) < 0:
                    q1 = -q1
                tt = 0.0 if times[k + 1] == times[k] else float(
                    np.clip((t - times[k]) / (times[k + 1] - times[k]), 0, 1)
                )
                v = q0 + (q1 - q0) * tt
                v = v / max(np.linalg.norm(v), 1e-8)
            over[path] = v
        if not over:
            return _node_matrix(node)
        n2 = dict(node)
        n2.pop("matrix", None)
        for path in ("translation", "rotation", "scale"):
            if path in over:
                n2[path] = over[path].tolist()
        return _node_matrix(n2)

    def _world(self, node_idx: int, t: float, cache: dict) -> np.ndarray:
        if node_idx in cache:
            return cache[node_idx]
        local = self._sample_node(node_idx, t)
        p = self.parent.get(node_idx)
        m = local if p is None else self._world(p, t, cache) @ local
        cache[node_idx] = m
        return m

    def joint_matrices(self, skin_index: int, t: float,
                       loop: bool = True) -> np.ndarray:
        """(J, 4, 4) world-joint @ inverseBind for one gltf skin at time t."""
        if loop and self.duration > 0:
            t = float(t % self.duration)
        skin = self.doc["skins"][skin_index]
        joints = skin["joints"]
        if "inverseBindMatrices" in skin:
            ibm = _accessor(
                self.doc, self.buffers, skin["inverseBindMatrices"]
            ).astype(np.float32).reshape(-1, 4, 4)
            ibm = np.ascontiguousarray(np.transpose(ibm, (0, 2, 1)))  # col-major
        else:
            ibm = np.tile(np.eye(4, dtype=np.float32), (len(joints), 1, 1))
        cache: dict = {}
        out = np.stack(
            [self._world(j, t, cache) @ ibm[k] for k, j in enumerate(joints)]
        )
        return out.astype(np.float32)

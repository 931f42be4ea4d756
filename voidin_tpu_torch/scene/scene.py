"""Scene container: the World-equivalent.

Counterpart of ``voidin_tpu/scene/scene.py``. The host-side :class:`World`
owns the pools; ``World.device(device)`` (the card unless asked otherwise)
freezes them into :class:`SceneData`, a dataclass of tensors on one device plus the static
flags the frame specializes on.

``scene_from_numpy`` is the one constructor of SceneData: it takes the
scene's leaves as numpy arrays keyed by dotted path (``"meshes.tri_pos"``,
``"tlas.tlas_min"``, ``"ltc1"``, ...) and its static flags. ``World.device``
feeds it the port's own host arrays; the parity tests feed it the leaves of
a JAX SceneData, so both packages render the very same state.

``scene_to_numpy`` is its reverse: the leaves and statics of a SceneData
back on the host, under the same names (``io/snapshot.py`` saves them).

``World.device(with_tlas=True)`` also builds the TLAS over the instances'
world AABBs (``TlasData``), which the raytraced shadows walk. The texture
pool is packed on the host (``TexturePool.host_arrays``: the native C++
packer of ``native/``, as the JAX package's default, numpy without it)
whatever the device, and held on the device as its quad table alone
(``texture.pool_device_bytes``).

``World.skins`` holds the scene's skinning regions (``scene/skin.py``
SkinData); ``SceneData.skins`` carries them to the device, leaves keyed
"skins.<i>.<field>" and their static fields under ``statics["skins"]``.
On a CUDA device ``scene_from_numpy`` also sets up the skin kernels
(``ops/skin.py``) once: ``SceneData.skin_batch`` and
``TlasData.refit_bounds``, which every frame's skinning and refits read.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops import skin as skin_ops
from ..rt import bvh as bvh_mod
from . import mesh as mesh_mod
from . import texture as tex_mod
from .instance import INSTANCE_LEAVES, InstanceData, InstancePool
from .light import LIGHT_LEAVES, LightData, LightPool
from .ltc import load_ltc_tables
from .skin import skin_from_numpy, skin_leaves, skin_statics
from .material import LIGHT_MATERIAL, MATERIAL_LEAVES, MaterialData, MaterialPool
from .mesh import VERTICAL_PLANE_MESH, MeshPool, MeshPoolData
from .texture import TexturePool, TexturePoolData

STATIC_FLAGS = ("alpha_masked", "emissive_const", "mr_const",
                "no_normal_maps", "albedo_srgb", "normal_srgb",
                "emissive_srgb", "mr_srgb")


@dataclasses.dataclass
class TlasData:
    tlas_min: torch.Tensor  # (B, 3) f32
    tlas_max: torch.Tensor  # (B, 3) f32
    # (B,) u32 bits as int32 (lo16 left, hi16 right; 0 = leaf)
    tlas_left_right: torch.Tensor
    tlas_instance: torch.Tensor  # (B,) i32
    # Stackless exit links (rt/bvh.py tlas_exit_links), encoded e+1 with
    # 0 = traversal done. Topology-only; refits never touch it.
    tlas_exit: torch.Tensor  # (B,) i32
    # Refit plan (rt/bvh.py tlas_refit_plan): level-ordered node ids
    # (deepest first), children (-1 = leaf), leaf instance ids, and the
    # (start, end) slices of each level, for re-fitting instance world
    # AABBs bottom-up without rebuilding the topology.
    refit_order: torch.Tensor  # (B,) i32
    refit_child: torch.Tensor  # (B, 2) i32
    refit_instance: torch.Tensor  # (B,) i32
    refit_levels: tuple = ()
    # the levels' bounds (K + 1) i32 for the refit kernel (ops/skin.py
    # tlas_bounds); set up on a CUDA device, else None
    refit_bounds: Optional[torch.Tensor] = None


TLAS_LEAVES = ("tlas_min", "tlas_max", "tlas_left_right", "tlas_instance",
               "tlas_exit", "refit_order", "refit_child", "refit_instance")


def tlas_from_numpy(h: dict, device) -> TlasData:
    """TlasData on `device` from host arrays keyed as TLAS_LEAVES; the
    refit levels are recomputed from the topology."""
    nodes = np.zeros(len(h["tlas_left_right"]), bvh_mod.TLAS_DTYPE)
    nodes["left_right"] = np.asarray(h["tlas_left_right"])
    nodes["instance_idx"] = np.asarray(h["tlas_instance"]).astype(np.uint32)

    def t(name):
        a = np.array(h[name])
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.as_tensor(a, device=device)

    levels = bvh_mod.tlas_refit_plan(nodes)["levels"]
    device = torch.device(device)
    return TlasData(**{k: t(k) for k in TLAS_LEAVES}, refit_levels=levels,
                    refit_bounds=(skin_ops.tlas_bounds(
                        levels, len(nodes), device)
                        if device.type == "cuda" else None))


@dataclasses.dataclass
class SceneData:
    meshes: MeshPoolData
    instances: InstanceData
    materials: MaterialData
    lights: LightData
    textures: TexturePoolData
    ltc1: torch.Tensor  # (64, 64, 4) f32
    ltc2: torch.Tensor  # (64, 64, 4) f32
    tlas: Optional[TlasData] = None
    # Static: some material cuts fragments per texel (visibility.wgsl:79-81)
    alpha_masked: bool = False
    # Static: every material's emissive / metallic-roughness texture is
    # 1x1, so resolve reads MaterialData.emissive_rgba / mr_rgba
    emissive_const: bool = False
    mr_const: bool = False
    # Static: no material has a normal map (normal == WHITE)
    no_normal_maps: bool = False
    # Static per-slot sRGB flags (None = mixed -> per-sample lookup)
    albedo_srgb: Optional[bool] = None
    normal_srgb: Optional[bool] = None
    emissive_srgb: Optional[bool] = None
    mr_srgb: Optional[bool] = None
    # Vertex skinning regions (scene/skin.py SkinData), each recomputing
    # its pool triangle range from the frame's joint matrices
    skins: tuple = ()
    # the skin kernels' set-up of `skins` (ops/skin.py SkinBatch) on a
    # CUDA device with skins, else None
    skin_batch: Optional[skin_ops.SkinBatch] = None

    @property
    def device(self) -> torch.device:
        return self.ltc1.device


def scene_from_numpy(leaves: dict, statics: dict, device) -> SceneData:
    """SceneData on `device` from numpy leaves keyed by dotted path plus
    the static flags of STATIC_FLAGS. The TLAS comes along where the
    leaves hold one ("tlas.*"), and skin i where they hold "skins.<i>.*",
    with its static fields from statics["skins"][i]. Extra leaves (LUT
    quad tables, the pool's vertex streams) are ignored: no pass reads
    them."""
    device = torch.device(device)

    def group(prefix):
        n = len(prefix) + 1
        return {k[n:]: v for k, v in leaves.items()
                if k.startswith(prefix + ".")}

    def tensors(prefix, names):
        g = group(prefix)
        return {
            k: torch.as_tensor(np.array(g[k]), device=device)
            for k in names
        }

    ltc1 = torch.as_tensor(np.array(leaves["ltc1"], np.float32),
                           device=device)
    ltc2 = torch.as_tensor(np.array(leaves["ltc2"], np.float32),
                           device=device)
    flags = {k: statics[k] for k in STATIC_FLAGS if k in statics}
    skins = tuple(skin_from_numpy(group(f"skins.{i}"), st, device)
                  for i, st in enumerate(statics.get("skins", ())))
    return SceneData(
        meshes=mesh_mod.pool_from_numpy(group("meshes"), device),
        instances=InstanceData(**tensors("instances", INSTANCE_LEAVES)),
        materials=MaterialData(**tensors("materials", MATERIAL_LEAVES)),
        lights=LightData(**tensors("lights", LIGHT_LEAVES)),
        # A JAX scene may hold its pool's tap-block tables (leaves
        # "textures.child_blocks" / "textures.parent_blocks", statics
        # "tap_blocks"): a layout of its quad-rate albedo tap, whose words
        # the port's per-pixel tap gives, so both are ignored here.
        textures=tex_mod.pool_from_numpy(group("textures"), device),
        ltc1=ltc1,
        ltc2=ltc2,
        tlas=(tlas_from_numpy(group("tlas"), device)
              if "tlas.tlas_min" in leaves else None),
        skins=skins,
        skin_batch=(skin_ops.skin_batch(skins)
                    if skins and device.type == "cuda" else None),
        **flags,
    )


def scene_to_numpy(scene: SceneData):
    """(leaves, statics) of `scene` on the host, the reverse of
    scene_from_numpy: the leaves keyed as World.host_leaves keys them and
    typed as the device holds them (the host's u32 words as int32, which
    scene_from_numpy takes unchanged), the static flags of STATIC_FLAGS
    and the skins' static fields under statics["skins"]. The statics that
    the leaves determine (the pool's has_lods, the texture base size, the
    TLAS refit levels) are left to scene_from_numpy."""
    parts = dict(meshes=(scene.meshes, mesh_mod.MESH_LEAVES),
                 instances=(scene.instances, INSTANCE_LEAVES),
                 materials=(scene.materials, MATERIAL_LEAVES),
                 lights=(scene.lights, LIGHT_LEAVES),
                 textures=(scene.textures, tex_mod.TEXTURE_LEAVES))
    if scene.tlas is not None:
        parts["tlas"] = (scene.tlas, TLAS_LEAVES)
    leaves = {"ltc1": scene.ltc1.cpu().numpy(),
              "ltc2": scene.ltc2.cpu().numpy()}
    for prefix, (data, names) in parts.items():
        for k in names:
            leaves[f"{prefix}.{k}"] = getattr(data, k).cpu().numpy()
    for i, skin in enumerate(scene.skins):
        for k, v in skin_leaves(skin).items():
            leaves[f"skins.{i}.{k}"] = v
    statics = {k: getattr(scene, k) for k in STATIC_FLAGS}
    statics["skins"] = tuple(skin_statics(s) for s in scene.skins)
    return leaves, statics


class World:
    """Host-side scene assembly (pools + lights)."""

    def __init__(self, texture_base_size: int = 1024, build_bvh: bool = True):
        self.meshes = MeshPool(build_bvh=build_bvh)
        self.instances = InstancePool()
        self.materials = MaterialPool()
        self.lights = LightPool()
        self.textures = TexturePool(base_size=texture_base_size)
        self.skins: list = []  # SkinData entries (scene/skin.py)
        self._n_joints = 0

    def allocate_joints(self, n: int) -> int:
        """Reserve n rows in the frame's concatenated joint-matrix array;
        returns the skin's offset."""
        off = self._n_joints
        self._n_joints += int(n)
        return off

    @property
    def total_joints(self) -> int:
        return self._n_joints

    def add_area_light(self, color, intensity, wh, transform):
        """Adds the light and an emissive quad instance (app.rs:220-236)."""
        self.lights.add_area_light_from_transform(
            color, intensity, wh, transform
        )
        wh = np.asarray(wh, np.float32)
        scale = np.diag([wh[0] / 2.0, wh[1] / 2.0, 1.0, 1.0]).astype(
            np.float32
        )
        self.instances.add(
            np.asarray(transform, np.float32) @ scale,
            VERTICAL_PLANE_MESH,
            LIGHT_MATERIAL,
        )

    def build_tlas(self) -> dict:
        """The TLAS over the instances' world AABBs as host arrays keyed
        as TLAS_LEAVES (the JAX TlasData's leaves by name and type)."""
        mesh_h = self.meshes.bounds()
        inst_h = self.instances.host_arrays()
        imin, imax = bvh_mod.instance_world_aabbs(
            mesh_h["mesh_min"], mesh_h["mesh_max"], inst_h["transform"],
            inst_h["mesh_id"])
        nodes = bvh_mod.build_tlas(imin, imax)
        plan = bvh_mod.tlas_refit_plan(nodes)
        return dict(
            tlas_min=np.ascontiguousarray(nodes["min"]),
            tlas_max=np.ascontiguousarray(nodes["max"]),
            tlas_left_right=np.ascontiguousarray(nodes["left_right"]),
            tlas_instance=np.ascontiguousarray(
                nodes["instance_idx"]).astype(np.int64).astype(np.int32),
            tlas_exit=bvh_mod.tlas_exit_links(nodes),
            refit_order=plan["order"],
            refit_child=plan["child"],
            refit_instance=plan["instance"],
        )

    def any_alpha_mask(self) -> bool:
        """True if any material can cut fragments per texel."""
        for bc, albedo in zip(self.materials.base_color,
                              self.materials.albedo):
            if bc[3] >= 0.5 and self.textures.has_mask(albedo):
                return True
        return False

    def _slot_srgb_static(self, tex_ids) -> Optional[bool]:
        """One shared sRGB flag for a material texture slot, or None when
        mixed. Pure-{0, 255} textures are sRGB fixed points and never
        block the static."""
        flags = set()
        for t in sorted(set(int(t) for t in tex_ids)):
            img = self.textures.images[t]
            if bool(np.isin(img, (0, 255)).all()):
                continue
            flags.add(bool(self.textures.srgb_flags[t]))
        if len(flags) > 1:
            return None
        return flags.pop() if flags else False

    def host_leaves(self, with_tlas: bool = False) -> dict:
        """The scene's leaves as numpy arrays keyed by dotted path."""
        ltc1, ltc2 = load_ltc_tables()
        leaves = {"ltc1": ltc1, "ltc2": ltc2}
        parts = dict(
            meshes=self.meshes.host_arrays(),
            instances=self.instances.host_arrays(),
            materials=self.materials.host_arrays(self.textures),
            lights=self.lights.host_arrays(),
            textures=self.textures.host_arrays(),
        )
        if with_tlas:
            parts["tlas"] = self.build_tlas()
        for i, skin in enumerate(self.skins):
            parts[f"skins.{i}"] = skin_leaves(skin)
        for prefix, arrays in parts.items():
            for k, v in arrays.items():
                leaves[f"{prefix}.{k}"] = v
        return leaves

    def statics(self) -> dict:
        mats = self.materials
        return dict(
            alpha_masked=self.any_alpha_mask(),
            emissive_const=all(self.textures.is_const(t)
                               for t in mats.emissive),
            mr_const=all(self.textures.is_const(t)
                         for t in mats.metallic_roughness),
            no_normal_maps=all(t == 0 for t in mats.normal),
            albedo_srgb=self._slot_srgb_static(mats.albedo),
            normal_srgb=self._slot_srgb_static(mats.normal),
            emissive_srgb=self._slot_srgb_static(mats.emissive),
            mr_srgb=self._slot_srgb_static(mats.metallic_roughness),
            skins=tuple(skin_statics(s) for s in self.skins),
        )

    def device(self, device="cuda", with_tlas: bool = False) -> SceneData:
        """The scene on `device`: the card unless the caller asks for
        another (the CPU tests pass "cpu"). Raises where there is no
        card. `with_tlas` builds the TLAS the raytraced shadows need."""
        return scene_from_numpy(self.host_leaves(with_tlas), self.statics(),
                                device)

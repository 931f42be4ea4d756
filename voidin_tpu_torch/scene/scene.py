"""Scene container: the World-equivalent.

Counterpart of ``voidin_tpu/scene/scene.py``. The host-side :class:`World`
owns the pools; ``World.device(device)`` (the card unless asked otherwise)
freezes them into :class:`SceneData`, a dataclass of tensors on one device plus the static
flags the frame specializes on.

``scene_from_numpy`` is the one constructor of SceneData: it takes the
scene's leaves as numpy arrays keyed by dotted path (``"meshes.tri_pos"``,
``"ltc1"``, ...) and its static flags. ``World.device`` feeds it the port's
own host arrays; the parity tests feed it the leaves of a JAX SceneData,
so both packages render the very same state.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import mesh as mesh_mod
from . import texture as tex_mod
from .instance import INSTANCE_LEAVES, InstanceData, InstancePool
from .light import LIGHT_LEAVES, LightData, LightPool
from .ltc import load_ltc_tables
from .material import LIGHT_MATERIAL, MATERIAL_LEAVES, MaterialData, MaterialPool
from .mesh import VERTICAL_PLANE_MESH, MeshPool, MeshPoolData
from .texture import TexturePool, TexturePoolData

STATIC_FLAGS = ("alpha_masked", "emissive_const", "mr_const",
                "no_normal_maps", "albedo_srgb", "normal_srgb",
                "emissive_srgb", "mr_srgb")


@dataclasses.dataclass
class SceneData:
    meshes: MeshPoolData
    instances: InstanceData
    materials: MaterialData
    lights: LightData
    textures: TexturePoolData
    ltc1: torch.Tensor  # (64, 64, 4) f32
    ltc2: torch.Tensor  # (64, 64, 4) f32
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

    @property
    def device(self) -> torch.device:
        return self.ltc1.device


def scene_from_numpy(leaves: dict, statics: dict, device) -> SceneData:
    """SceneData on `device` from numpy leaves keyed by dotted path plus
    the static flags of STATIC_FLAGS. Extra leaves (BVH/TLAS, LUT quad
    tables, tap-block tables) are ignored: the raster path reads none."""
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
    return SceneData(
        meshes=mesh_mod.pool_from_numpy(group("meshes"), device),
        instances=InstanceData(**tensors("instances", INSTANCE_LEAVES)),
        materials=MaterialData(**tensors("materials", MATERIAL_LEAVES)),
        lights=LightData(**tensors("lights", LIGHT_LEAVES)),
        textures=tex_mod.pool_from_numpy(group("textures"), device),
        ltc1=ltc1,
        ltc2=ltc2,
        **flags,
    )


class World:
    """Host-side scene assembly (pools + lights)."""

    def __init__(self, texture_base_size: int = 1024):
        self.meshes = MeshPool()
        self.instances = InstancePool()
        self.materials = MaterialPool()
        self.lights = LightPool()
        self.textures = TexturePool(base_size=texture_base_size)

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

    def host_leaves(self) -> dict:
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
        )

    def device(self, device="cuda") -> SceneData:
        """The scene on `device`: the card unless the caller asks for
        another (the CPU tests pass "cpu"). Raises where there is no
        card."""
        return scene_from_numpy(self.host_leaves(), self.statics(), device)

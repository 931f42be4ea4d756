"""Material pool (Material struct of shared.wgsl; pools/src/material.rs).

Counterpart of ``voidin_tpu/scene/material.py``. Three default materials
are seeded (ids 0..2); LIGHT_MATERIAL = 2 marks emissive light-quad
instances (material.rs:45).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from .texture import BLACK_TEXTURE, WHITE_TEXTURE

LIGHT_MATERIAL = 2


@dataclasses.dataclass
class MaterialData:
    base_color: torch.Tensor  # (K, 4) f32
    albedo: torch.Tensor  # (K,) i32 texture id
    normal: torch.Tensor  # (K,) i32
    metallic_roughness: torch.Tensor  # (K,) i32
    emissive: torch.Tensor  # (K,) i32
    # Linear-space value of each material's 1x1 emissive / mr texture
    # (zeros where that texture is larger): SceneData.emissive_const /
    # mr_const let the resolve pass read these instead of sampling.
    emissive_rgba: torch.Tensor  # (K, 4) f32
    mr_rgba: torch.Tensor  # (K, 4) f32


MATERIAL_LEAVES = ("base_color", "albedo", "normal", "metallic_roughness",
                   "emissive", "emissive_rgba", "mr_rgba")


class MaterialPool:
    def __init__(self, with_defaults: bool = True):
        self.base_color: List[np.ndarray] = []
        self.albedo: List[int] = []
        self.normal: List[int] = []
        self.metallic_roughness: List[int] = []
        self.emissive: List[int] = []
        if with_defaults:
            for _ in range(3):
                self.add()

    def __len__(self):
        return len(self.albedo)

    def add(
        self,
        base_color=(1.0, 1.0, 1.0, 1.0),
        albedo: int = WHITE_TEXTURE,
        normal: int = WHITE_TEXTURE,
        metallic_roughness: int = BLACK_TEXTURE,
        emissive: int = BLACK_TEXTURE,
    ) -> int:
        self.base_color.append(np.asarray(base_color, np.float32))
        self.albedo.append(int(albedo))
        self.normal.append(int(normal))
        self.metallic_roughness.append(int(metallic_roughness))
        self.emissive.append(int(emissive))
        return len(self.albedo) - 1

    def host_arrays(self, textures) -> dict:
        k = len(self.albedo)
        em_const = np.zeros((k, 4), np.float32)
        mr_const = np.zeros((k, 4), np.float32)
        for i in range(k):
            em_const[i] = textures.const_value(self.emissive[i])
            mr_const[i] = textures.const_value(self.metallic_roughness[i])
        return dict(
            base_color=(
                np.stack(self.base_color) if self.base_color
                else np.zeros((0, 4))
            ).astype(np.float32),
            albedo=np.asarray(self.albedo, np.int32),
            normal=np.asarray(self.normal, np.int32),
            metallic_roughness=np.asarray(self.metallic_roughness, np.int32),
            emissive=np.asarray(self.emissive, np.int32),
            emissive_rgba=em_const,
            mr_rgba=mr_const,
        )

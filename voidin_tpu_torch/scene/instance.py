"""Instance pool: (N,) struct-of-arrays of transforms + mesh/material ids.

Counterpart of ``voidin_tpu/scene/instance.py`` (reference Instance /
InstancePool, pools/src/instance.rs:8-89). The inverse transform is
precomputed at upload, as in the reference's Instance::new.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch


@dataclasses.dataclass
class InstanceData:
    transform: torch.Tensor  # (N, 4, 4) f32 object -> world
    inv_transform: torch.Tensor  # (N, 4, 4) f32 world -> object
    mesh_id: torch.Tensor  # (N,) i32
    material_id: torch.Tensor  # (N,) i32

    @property
    def count(self) -> int:
        return self.transform.shape[0]


INSTANCE_LEAVES = ("transform", "inv_transform", "mesh_id", "material_id")


class InstancePool:
    def __init__(self):
        self.transforms: List[np.ndarray] = []
        self.mesh_ids: List[int] = []
        self.material_ids: List[int] = []

    def __len__(self):
        return len(self.transforms)

    def add(self, transform: np.ndarray, mesh_id: int,
            material_id: int = 0) -> int:
        self.transforms.append(
            np.asarray(transform, np.float32).reshape(4, 4)
        )
        self.mesh_ids.append(int(mesh_id))
        self.material_ids.append(int(material_id))
        return len(self.transforms) - 1

    def host_arrays(self) -> dict:
        if self.transforms:
            t = np.stack(self.transforms)
        else:
            t = np.zeros((0, 4, 4), np.float32)
        inv = np.linalg.inv(t) if len(t) else t
        return dict(
            transform=t,
            inv_transform=inv.astype(np.float32),
            mesh_id=np.asarray(self.mesh_ids, np.int32),
            material_id=np.asarray(self.material_ids, np.int32),
        )

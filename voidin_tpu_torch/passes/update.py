"""Per-frame instance animation (compute_update equivalent).

Counterpart of ``voidin_tpu/passes/update.py`` (shaders/compute_update.wgsl:
12-28): each moving instance's transform is rotated by Rz(speed*dt), with
speed = +-2 sin(0.5 t) and the sign from the world z translation > -15.

The port updates ``instances.transform`` / ``inv_transform`` IN PLACE (an
index_copy_ of the moving rows) instead of building new arrays: the
instance table persists across frames and only the moving rows change.
"""

from __future__ import annotations

import torch

from ..scene.instance import InstanceData


def compute_update(instances: InstanceData, moving_ids: torch.Tensor,
                   time: float, dt: float) -> InstanceData:
    if moving_ids.shape[0] == 0:
        return instances
    ids = moving_ids.to(torch.int64)
    t = instances.transform[ids]  # (M, 4, 4)
    dev = t.device
    speed = 2.0 * torch.sin(torch.tensor(time, dtype=torch.float32,
                                         device=dev) * 0.5)
    sign = torch.where(t[:, 2, 3] > -15.0, 1.0, -1.0)
    angle = speed * sign * torch.tensor(dt, dtype=torch.float32, device=dev)
    c, s = torch.cos(angle), torch.sin(angle)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    rotz = torch.stack(
        [
            torch.stack([c, -s, zero, zero], -1),
            torch.stack([s, c, zero, zero], -1),
            torch.stack([zero, zero, one, zero], -1),
            torch.stack([zero, zero, zero, one], -1),
        ],
        dim=-2,
    )  # (M, 4, 4)
    new_t = torch.stack(
        [
            torch.stack(
                [
                    sum(rotz[:, i, k] * t[:, k, j] for k in range(4))
                    for j in range(4)
                ],
                dim=-1,
            )
            for i in range(4)
        ],
        dim=-2,
    )
    instances.transform.index_copy_(0, ids, new_t)
    instances.inv_transform.index_copy_(0, ids, torch.linalg.inv(new_t))
    return instances

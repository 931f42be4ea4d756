"""G-buffer and visibility-buffer containers.

Counterpart of ``voidin_tpu/passes/gbuffer.py``; layout contract mirrors
the reference GBuffer (app/gbuffer.rs:5-17):
* ``normal_uv``: (H, W, 2) u32 bits (int32) — x = 32-bit octahedral normal,
  y = pack2x16float(uv)
* ``material``: (H, W) int32 material id
* ``depth``: (H, W) float32 reverse-Z (1 near .. 0 far), cleared to 0
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class GBuffer:
    normal_uv: torch.Tensor  # (H, W, 2) u32 bits as int32
    material: torch.Tensor  # (H, W) i32
    depth: torch.Tensor  # (H, W) f32


@dataclasses.dataclass
class VisBuffer:
    """Per-pixel winning work-item id + depth, plus the per-work-item
    resolve record: [original clip x/y/w per vertex (9), instance id,
    idx_start, pad] as (T, 12) f32, or with RasterConfig.slim_rec the
    (T, 24) slim record. Alpha-masked scenes also carry the
    runner-up among distinct depths (RasterConfig.alpha_mask). With
    RasterConfig.kernel_payload the fine raster also hands over each
    pixel's slim resolve record, resolve_rec[max(tri_id, 0)]."""

    tri_id: torch.Tensor  # (H, W) i32, -1 = background
    depth: torch.Tensor  # (H, W) f32 reverse-Z
    resolve_rec: torch.Tensor  # (T, 12 | 24) f32
    overflow: torch.Tensor  # () i64 count of binning/setup overflows
    tri_id2: Optional[torch.Tensor] = None  # (H, W) i32 runner-up id
    depth2: Optional[torch.Tensor] = None  # (H, W) f32 runner-up depth
    payload_img: Optional[torch.Tensor] = None  # (H, W, 24) f32 words

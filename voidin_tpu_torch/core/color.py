"""Color-space helpers (luma, RGB<->YCbCr) — shaders/utils/color.wgsl:1-13.

Torch counterpart of ``voidin_tpu/core/color.py``: the same constant
matrices applied as explicit multiply-adds in the same order.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fastmath

_RGB_TO_YCBCR = np.array(
    [
        [0.2126, 0.7152, 0.0722],
        [-0.1146, -0.3854, 0.5],
        [0.5, -0.4542, -0.0458],
    ],
    dtype=np.float32,
)

_YCBCR_TO_RGB = np.array(
    [
        [1.0, 0.0, 1.5748],
        [1.0, -0.1873, -0.4681],
        [1.0, 1.8556, 0.0],
    ],
    dtype=np.float32,
)


def calculate_luma(col: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (...,) BT.709 luma."""
    return 0.2126 * col[..., 0] + 0.7152 * col[..., 1] + 0.0722 * col[..., 2]


def rgb_to_ycbcr(col: torch.Tensor) -> torch.Tensor:
    return fastmath.const_mat_vec(_RGB_TO_YCBCR, col)


def ycbcr_to_rgb(col: torch.Tensor) -> torch.Tensor:
    return fastmath.const_mat_vec(_YCBCR_TO_RGB, col)

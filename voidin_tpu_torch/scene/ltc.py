"""LTC (Linearly Transformed Cosines) lookup tables.

Two 64x64x4 f32 tables drive area-light shading (shaders/utils/ltc.wgsl):
LTC1 holds the inverse-M matrices packed (m00, m02, m20, m22) per texel,
LTC2 (GGX norm, fresnel, unused, horizon-clipped-sphere form factor).

The port ships its own copy of the fitted tables,
``voidin_tpu_torch/assets/ltc_tables.npz`` (the JAX package's
``voidin_tpu/assets/ltc_tables.npz``, byte for byte), and reads it with
numpy.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Tuple

import numpy as np

LUT_SIZE = 64

_ASSET_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
    "ltc_tables.npz",
)


@lru_cache(maxsize=1)
def load_ltc_tables() -> Tuple[np.ndarray, np.ndarray]:
    data = np.load(_ASSET_PATH)
    return (
        np.asarray(data["ltc1"], np.float32),
        np.asarray(data["ltc2"], np.float32),
    )

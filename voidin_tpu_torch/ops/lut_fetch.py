"""LUT fetch (kernel K3): bilinear 64x64 table sampling.

``lut_fetch`` replaces ``voidin_tpu/ops/lut_fetch.py`` ``lut_fetch_pallas``
/ ``_kernel`` (the Pallas TPU kernel) and the XLA formulation
``passes/shading.sample_lut_bilinear_mxu_multi`` it stood in for. On a
CUDA tensor it launches the hand-written Hopper kernel in
``csrc/lut_fetch.cu`` (see its header for what bounds it on an H100 and
how the design answers that); on a CPU tensor it runs the plain PyTorch
twin ``lut_fetch_reference``. A CUDA tensor goes to the kernel or raises.
"""

from __future__ import annotations

import torch

TDIM = 64  # table size (64 x 64)
MAX_CHAN = 8

LAUNCHES = 0  # f32-variant kernel launches (CUDA path only)
LAUNCHES_BF16 = 0  # bf16-variant kernel launches (CUDA path only)


def _taps(f):
    """(index0, index1, weight0, weight1) along one axis; where the clamp
    makes both taps one texel, the weights add on it."""
    i0f = torch.clamp(torch.floor(f), 0, TDIM - 1)
    t = f - i0f
    i0 = torch.nan_to_num(i0f, nan=0.0).to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=TDIM - 1)
    one_minus = 1.0 - t
    same = i1 == i0
    w0 = torch.where(same, one_minus + t, one_minus)
    w1 = torch.where(same, torch.zeros_like(t), t)
    return i0, i1, w0, w1


def _bf16(x):
    """Round f32 to the nearest bf16 (ties to even), held as f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def lut_fetch_reference(tables, uv, bf16=False):
    """Plain PyTorch twin of K3: `tables` list of (64, 64) f32, `uv`
    (..., 2) pre-scaled by LUT_SCALE/BIAS. Rows first, then columns.
    `bf16` rounds the row weights (after the clamp-edge merge) and the
    table entries to bf16, as the TPU kernel's bf16 variant
    (voidin_tpu/ops/lut_fetch.py:59-61) does; its products are exact in
    f32 and the column weights stay f32."""
    shape = uv.shape[:-1]
    uvf = uv.reshape(-1, 2)
    fx = uvf[:, 0] * TDIM - 0.5
    fy = uvf[:, 1] * TDIM - 0.5
    x0, x1, wx0, wx1 = _taps(fx)
    y0, y1, wy0, wy1 = _taps(fy)
    if bf16:
        wy0, wy1 = _bf16(wy0), _bf16(wy1)
    out = []
    for t in tables:
        flat = _bf16(t).reshape(-1) if bf16 else t.reshape(-1)
        a00 = flat[y0 * TDIM + x0]
        a10 = flat[y1 * TDIM + x0]
        a01 = flat[y0 * TDIM + x1]
        a11 = flat[y1 * TDIM + x1]
        r0 = wy0 * a00 + wy1 * a10
        r1 = wy0 * a01 + wy1 * a11
        out.append((wx0 * r0 + wx1 * r1).reshape(shape))
    return out


def lut_fetch(tables, uv, bf16=False):
    """Bilinear-fetch `tables` (list of C <= 8 (64, 64) f32) at `uv`
    (..., 2); returns a list of C (...,) f32 tensors. `bf16` selects the
    kernel's bf16 variant (see lut_fetch_reference)."""
    n_chan = len(tables)
    if not 1 <= n_chan <= MAX_CHAN:
        raise ValueError(f"1..{MAX_CHAN} tables, got {n_chan}")
    if uv.device.type == "cpu":
        return lut_fetch_reference(tables, uv, bf16=bf16)
    global LAUNCHES, LAUNCHES_BF16
    from . import _build

    if uv.device.type != "cuda":
        raise ValueError(f"unsupported device {uv.device}")
    if uv.dtype != torch.float32 or uv.shape[-1] != 2:
        raise ValueError(f"uv must be (..., 2) f32, got {tuple(uv.shape)} "
                         f"{uv.dtype}")
    for t in tables:
        if t.shape != (TDIM, TDIM) or t.dtype != torch.float32 \
                or t.device != uv.device:
            raise ValueError(f"tables must be ({TDIM}, {TDIM}) f32 on "
                             f"{uv.device}, got {tuple(t.shape)} {t.dtype} "
                             f"{t.device}")
    shape = uv.shape[:-1]
    uvf = uv.reshape(-1, 2).contiguous()
    p = uvf.shape[0]
    tab = torch.stack(list(tables)).contiguous()  # (C, 64, 64)
    out = torch.empty(n_chan, p, dtype=torch.float32, device=uv.device)
    lib = _build.load()
    fn = lib.voidin_lut_fetch_bf16 if bf16 else lib.voidin_lut_fetch
    with torch.cuda.device(uv.device):
        stream = torch.cuda.current_stream(uv.device).cuda_stream
        rc = fn(uvf.data_ptr(), tab.data_ptr(), n_chan, p, out.data_ptr(),
                stream)
    _build.check(lib, rc, "lut_fetch")
    if bf16:
        LAUNCHES_BF16 += 1
    else:
        LAUNCHES += 1
    return [out[c].reshape(shape) for c in range(n_chan)]

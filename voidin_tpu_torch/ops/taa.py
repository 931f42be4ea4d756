"""TAA of a frame with a valid history in one launch.

``taa_resolve_fused`` computes the default TAA of passes/taa.py: reproject
(the depth-dilated reprojection) -> taa_resolve with the per-pixel f16
history fetch, the neighbourhood clamp and the blend, on the whole image.
On a CUDA tensor it launches the hand-written kernel in ``csrc/taa.cu``
(see its header for what bounds it on an H100 and how the design answers
that); on a CPU tensor it runs the plain PyTorch twin the caller hands it,
which is passes/taa.py's own chain (taa_fused_reference), so that this
module knows nothing of the pass above it. A CUDA tensor goes to the
kernel or raises. It replaces no kernel of the JAX package, whose TAA is
plain jnp.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

LAUNCHES = 0  # kernel launches (CUDA path only)

# the 3x3 neighbourhood in the kernel's order: rows -1, 0, 1, then columns
ORDER = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))


def recip(x: float) -> float:
    """The f32 that torch's CUDA division of an f32 tensor by the Python
    scalar `x` multiplies by: the reciprocal taken in f64, rounded once."""
    return float(np.float32(1.0 / x))


def constants(camera, H: int, W: int, weights) -> np.ndarray:
    """The kernel's f32 constants, in csrc/taa.cu Args' order: both camera
    matrices, both jitters, the in-bounds limits, f32(1 / W) and f32(1 /
    H), the Gaussian and Mitchell weights of `weights` ((dy, dx, Gaussian,
    Mitchell) in ORDER, the chain's Python floats), the reciprocals of
    their f64 sums, and of the two smoothstep spans. Each is the f32 that
    the chain's Python scalar becomes on the card."""
    if tuple((dy, dx) for dy, dx, _, _ in weights) != ORDER:
        raise ValueError("weights must list the 3x3 neighbourhood in ORDER")
    wsum = mn_wsum = 0.0
    for _, _, w, wt in weights:
        wsum += w
        mn_wsum += wt
    f32 = np.float32
    lo_hi = [-1.0 + float(f32(1.0 / W)), 1.0 - float(f32(1.0 / W)),
             -1.0 + float(f32(1.0 / H)), 1.0 - float(f32(1.0 / H))]
    return np.concatenate([
        np.asarray(camera.clip_to_world, f32).reshape(16),
        np.asarray(camera.prev_world_to_clip, f32).reshape(16),
        np.asarray(camera.jitter, f32).reshape(2),
        np.asarray(camera.prev_jitter, f32).reshape(2),
        np.asarray(lo_hi, f32),
        np.asarray([recip(W), recip(H)], f32),
        np.asarray([w for _, _, w, _ in weights], f32),
        np.asarray([wt for _, _, _, wt in weights], f32),
        np.asarray([recip(wsum), recip(mn_wsum), recip(0.3 - -0.1),
                    recip(2.0 - 0.0)], f32),
    ]).astype(f32)


def _image(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32 or tuple(
            t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {shape} float32 on "
                         f"{device}, got {tuple(t.shape)} {t.dtype} "
                         f"{t.device}, contiguous {t.is_contiguous()}")
    return t


def taa_resolve_fused(color, depth, history, camera, *, weights, twin):
    """The resolved (H, W, 3) image of TAA's default path: `color` (H, W,
    3) this frame's HDR, `depth` (H, W) its G-buffer depth, `history` (H,
    W, 3) the last frame's resolved image (valid), `camera` the frame's
    CameraUniform, `weights` the neighbourhood's (constants). Each image
    must be contiguous float32 on `color`'s device (else ValueError). CPU
    tensors run `twin(color, depth, history, camera)`, the plain chain;
    CUDA tensors launch the kernel, which writes a fresh image (the
    history is only read)."""
    dev = color.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    H, W = color.shape[:2]
    ins = [_image("color", color, (H, W, 3), dev),
           _image("depth", depth, (H, W), dev),
           _image("history", history, (H, W, 3), dev)]
    if dev.type == "cpu":
        return twin(color, depth, history, camera)
    global LAUNCHES
    from . import _build

    out = torch.empty(H, W, 3, dtype=torch.float32, device=dev)
    if H * W == 0:
        return out  # nothing to launch
    consts = constants(camera, H, W, weights)
    ptrs = (ctypes.c_void_p * 4)(*[t.data_ptr() for t in ins],
                                 out.data_ptr())
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.voidin_taa(ptrs, consts.ctypes.data_as(ctypes.c_void_p), H,
                            W, stream)
    _build.check(lib, rc, "taa_resolve_fused")
    LAUNCHES += 1
    return out

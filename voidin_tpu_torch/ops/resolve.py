"""The dense G-buffer resolve in one launch.

``resolve_dense`` computes every per-pixel field of the default resolve
path (passes/resolve.py: the dense (H, W) resolve of a scene without an
alpha mask, with the 12-column resolve record, the per-pixel albedo tap
and const-folded emissive and metallic-roughness). On a CUDA tensor it
launches the hand-written kernel in ``csrc/resolve.cu`` (see its header for
what bounds it on an H100 and how the design answers that); on a CPU
tensor it runs the plain PyTorch twin the caller hands it, which is
passes/resolve.py's own chain (resolve_dense_reference: _fetch_rows ->
_decode_channels -> _channel_fields), so that this module knows nothing
of the pass above it. A CUDA tensor goes to the kernel or raises. It
replaces no kernel of the JAX package, whose resolve is plain jnp.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import checks

# the fields resolve_dense returns, each in the shape and dtype of the
# G-buffer's and ResolveAux's (passes/gbuffer.py, passes/resolve.py): normal_uv (H, W, 2) int32 (u32 words),
# material (H, W) int32, depth (H, W) f32, albedo (H, W, 4), emissive
# (H, W, 3), mr (H, W, 4) f32
FIELDS = ("normal_uv", "material", "depth", "albedo", "emissive", "mr")

LAUNCHES = 0  # kernel launches (CUDA path only)


def _srgb_mode(flag) -> int:
    """A call site's static sRGB flag for the kernel: 0 none, 1 decode, 2
    the per-texture flag (None)."""
    return 2 if flag is None else int(bool(flag))


def _table(name, t, dtype, cols, device):
    """`t` as the kernel reads it: contiguous rows of `cols` on `device`,
    16-byte aligned (a misaligned view is copied)."""
    if t.device != device or t.dtype != dtype or (
            cols and tuple(t.shape[1:]) != cols):
        raise ValueError(f"{name} must be (*, {cols}) {dtype} on {device}, "
                         f"got {tuple(t.shape)} {t.dtype} {t.device}")
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_rows(scene, vis):
    """The chain's gathers held to their tables (RasterConfig.debug_bounds
    on the card: an out-of-range read in the kernel is no error the host
    sees): the record, attribute-row and instance indices it reads."""
    tid = torch.clamp(vis.tri_id.to(torch.int64), min=0)
    checks.check_indices([(tid, vis.resolve_rec.shape[0], "resolve.rec")])
    rec = vis.resolve_rec[tid]
    checks.check_indices([
        ((rec[..., 10] / 3.0).to(torch.int64),
         scene.meshes.tri_attr_packed.shape[0], "resolve.tri_attr"),
        (rec[..., 9].to(torch.int64), scene.instances.count,
         "resolve.instance")])


def resolve_dense(scene, vis, row0: int = 0, height=None, *, twin):
    """Every field of the default dense resolve of `vis`, whose (H, W)
    rows are the image rows [row0, row0 + H) of a `height`-row image
    (default H; the mip level's difference makes the window's last row
    its own last row, as the chain does). Returns FIELDS as a dict. CPU
    tensors run `twin(scene, vis, row0, height)`, the plain chain that
    returns FIELDS; CUDA tensors launch the kernel."""
    dev = vis.depth.device
    if dev.type == "cpu":
        return twin(scene, vis, row0, height)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    global LAUNCHES
    from . import _build

    H, W = vis.depth.shape
    height = H if height is None else height
    if vis.tri_id.shape != (H, W) or vis.tri_id.dtype != torch.int32:
        raise ValueError("tri_id must be (H, W) int32 like depth")
    if vis.depth.dtype != torch.float32:
        raise ValueError("depth must be f32")
    if checks.bounds_enabled():
        _check_rows(scene, vis)
    mats, tex = scene.materials, scene.textures
    i32, f32 = torch.int32, torch.float32
    ins = [
        _table("tri_id", vis.tri_id, i32, (), dev),
        _table("depth", vis.depth, f32, (), dev),
        _table("resolve_rec", vis.resolve_rec, f32, (12,), dev),
        _table("tri_attr_packed", scene.meshes.tri_attr_packed, i32, (12,),
               dev),
        _table("transform", scene.instances.transform, f32, (4, 4), dev),
        _table("material_id", scene.instances.material_id, i32, (), dev),
        _table("albedo", mats.albedo, i32, (), dev),
        _table("normal", mats.normal, i32, (), dev),
        _table("base_color", mats.base_color, f32, (4,), dev),
        _table("emissive_rgba", mats.emissive_rgba, f32, (4,), dev),
        _table("mr_rgba", mats.mr_rgba, f32, (4,), dev),
        _table("size", tex.size, i32, (2,), dev),
        _table("quads", tex.quads, torch.uint8, (32,), dev),
        _table("srgb", tex.srgb, torch.bool, (), dev),
    ]
    out = dict(
        normal_uv=torch.empty(H, W, 2, dtype=i32, device=dev),
        material=torch.empty(H, W, dtype=i32, device=dev),
        depth=torch.empty(H, W, dtype=f32, device=dev),
        albedo=torch.empty(H, W, 4, dtype=f32, device=dev),
        emissive=torch.empty(H, W, 3, dtype=f32, device=dev),
        mr=torch.empty(H, W, 4, dtype=f32, device=dev),
    )
    if H * W == 0:
        return out  # nothing to launch
    ptrs = (ctypes.c_void_p * 20)(*[t.data_ptr() for t in ins],
                                  *[out[k].data_ptr() for k in FIELDS])
    ints = (ctypes.c_longlong * 8)(
        tex.total, tex.base_size, H, W, row0, height,
        _srgb_mode(scene.albedo_srgb), _srgb_mode(scene.normal_srgb))
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.voidin_resolve_dense(ptrs, ints,
                                      int(not scene.no_normal_maps), stream)
    _build.check(lib, rc, "resolve_dense")
    LAUNCHES += 1
    return out

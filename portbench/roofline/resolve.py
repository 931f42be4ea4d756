"""The dense resolve kernel: ops/resolve.py resolve_dense -> csrc/resolve.cu
resolve_dense_kernel (with and without normal maps). Work: each call's
pixels read the visibility image (tri_id and depth, 8 B) and write the
seven output images (normal and uv words, material, depth, albedo,
emissive, metallic-roughness: 60 B), 68 B a pixel. The tables and texels
the kernel gathers are left out, so the bound stays a lower bound."""

from pb import yardstick

MODULE = "voidin_tpu_torch.ops.resolve"
CALLS = {(MODULE, "resolve_dense"): "reduce"}
KERNELS = ("resolve_dense_kernel",)
COUNTERS = ((MODULE, "LAUNCHES"),)
BYTES_PER_PX = 8 + 60


def reduce(args, kwargs, out):
    vis = args[1]
    return vis.depth.numel()


def bound_ms(calls):
    return sum(yardstick.bound_ms(BYTES_PER_PX * n_px, 0)
               for n_px in calls[(MODULE, "resolve_dense")])

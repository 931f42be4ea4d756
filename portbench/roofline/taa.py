"""The TAA kernel: ops/taa.py taa_resolve_fused -> csrc/taa.cu
taa_fused_kernel (the default fetch's TAA of a frame with a valid
history). Work: each pixel reads its depth (4 B), its colour (12 B) and
the history at its reprojected texel (12 B), and writes the resolved
colour (12 B), 40 B a pixel. The halo, the other three history corners
and the history copy after the launch are left out, so the bound stays a
lower bound."""

from pb import yardstick

MODULE = "voidin_tpu_torch.ops.taa"
CALLS = {(MODULE, "taa_resolve_fused"): "reduce"}
KERNELS = ("taa_fused_kernel",)
COUNTERS = ((MODULE, "LAUNCHES"),)
BYTES_PER_PX = 4 + 12 + 12 + 12


def reduce(args, kwargs, out):
    color = args[0]
    return color.shape[0] * color.shape[1]


def bound_ms(calls):
    return sum(yardstick.bound_ms(BYTES_PER_PX * n_px, 0)
               for n_px in calls[(MODULE, "taa_resolve_fused")])

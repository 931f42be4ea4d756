"""The fused LTC rect kernel: ops/ltc_rect.py ltc_rect_terms ->
csrc/ltc_rect.cu ltc_rect_kernel (f32 and bf16 variants). Work:
yardstick.ltc_rect_bound of the pixels and rect lights it is handed."""

from pb import yardstick

MODULE = "voidin_tpu_torch.ops.ltc_rect"
CALLS = {(MODULE, "ltc_rect_terms"): "reduce"}
KERNELS = ("ltc_rect_kernel",)
COUNTERS = ((MODULE, "LAUNCHES"), (MODULE, "LAUNCHES_BF16"))


def reduce(args, kwargs, out):
    nor, points = args[0], args[4]
    return nor.numel() // 3, int(points.shape[0])


def bound_ms(calls):
    return sum(yardstick.ltc_rect_bound(n_px, n_l)
               for n_px, n_l in calls[(MODULE, "ltc_rect_terms")])

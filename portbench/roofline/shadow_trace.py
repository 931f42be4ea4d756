"""The shadow-ray walk and its packing kernel: ops/shadow_trace.py
occluded and pack_rows -> csrc/shadow_trace.cu shadow_trace_kernel and
pack_shadow_rows_kernel. Work: yardstick.shadow_bound of the lanes,
active rays and tables each walk is handed, plus
yardstick.shadow_pack_bound of the tables each packing launch moves."""

from pb import yardstick

MODULE = "voidin_tpu_torch.ops.shadow_trace"
CALLS = {(MODULE, "occluded"): "reduce_walk",
         (MODULE, "pack_rows"): "reduce_pack"}
KERNELS = ("shadow_trace_kernel", "pack_shadow_rows_kernel")
COUNTERS = ((MODULE, "LAUNCHES"), (MODULE, "LAUNCHES_PACK"))


def reduce_walk(args, kwargs, out):
    table, _, inst, tri, origins = args[:5]
    lanes = int(origins.shape[0])
    return lanes, kwargs.get("active"), table.numel(), inst.numel(), \
        tri.numel()


def reduce_pack(args, kwargs, out):
    table, _, inst, tri = args[:4]
    out_words = out.top.numel() + out.blas.numel() + out.tris.numel()
    return table.numel() + inst.numel() + tri.numel(), out_words, \
        int(tri.shape[0])


def bound_ms(calls):
    walk = 0.0
    for lanes, active, t, i, tr in calls[(MODULE, "occluded")]:
        rays = lanes if active is None else int(active.sum())
        walk += yardstick.shadow_bound(lanes, rays, t, i, tr)
    pack = sum(yardstick.shadow_pack_bound(a, b, n)
               for a, b, n in calls[(MODULE, "pack_rows")])
    return walk + pack

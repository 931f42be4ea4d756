"""Kernel K1, the fine raster of the pair path: ops/fine_raster.py
fine_raster_pairs -> csrc/fine_raster.cu fine_raster_pairs_kernel (every
variant: base, track2, payload). Work: yardstick.k1_bound of the
per-tile record counts K1 is handed."""

from pb import yardstick

MODULE = "voidin_tpu_torch.ops.fine_raster"
CALLS = {(MODULE, "fine_raster_pairs"): "reduce"}
KERNELS = ("fine_raster_pairs_kernel",)
COUNTERS = ((MODULE, "LAUNCHES"), (MODULE, "LAUNCHES_TRACK2"),
            (MODULE, "LAUNCHES_PAYLOAD"))


def reduce(args, kwargs, out):
    counts = args[2]
    track2 = kwargs.get("track2", args[3] if len(args) > 3 else False)
    payload = kwargs.get("payload", args[4] if len(args) > 4 else None)
    px = 0 if payload is None else 4 * int(payload.shape[1])
    return counts, int(counts.shape[0]), 4 if track2 else 2, px


def bound_ms(calls):
    """Least ms of every recorded launch together."""
    return sum(yardstick.k1_bound(int(c.sum()), nt, n_out, px_bytes=px)
               for c, nt, n_out, px in calls[(MODULE, "fine_raster_pairs")])

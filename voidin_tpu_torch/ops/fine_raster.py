"""Fine raster: per-tile reverse-Z depth/id competition (kernels K1, K2).

``fine_raster_pairs`` (K1) replaces ``voidin_tpu/ops/fine_raster.py``
``fine_raster_pairs`` / ``_kernel_pairs``, the Pallas TPU kernel over
tile-sorted pair records; ``fine_raster_blocks`` (K2) replaces
``fine_raster_pallas`` / ``_kernel``, the block variant over per-tile
blocks capped at K records, and ``raster.fine_raster_xla``, its XLA twin.
On a CUDA tensor each launches its hand-written Hopper kernel in
``csrc/fine_raster.cu`` (see its header for what bounds it on an H100 and
how the design answers that); on a CPU tensor it runs its plain PyTorch
twin (``fine_raster_pairs_reference``, ``fine_raster_blocks_reference``).
There is no other path: a CUDA tensor goes to the kernel or raises.

Variants: ``track2=True`` (alpha-masked scenes) also returns the best
depth and id among depths below the winner's; K1's ``payload`` returns
the winner's payload row per pixel (``RasterConfig.kernel_payload``).

Record fields (RECORD_F = 16, f32), b coefficients baked to each pair's
tile origin by binning:
  0..8  edge coefficients   [ax0 ay0 b0  ax1 ay1 b1  ax2 ay2 b2]
  9..11 depth coefficients  [axd ayd bd]
  12    triangle id as f32 (-1 = invalid)
  13,14 anchor (x, y) — consumed by the binning bake
  15    zmax, the sliver clamp of the affine depth
"""

from __future__ import annotations

import torch

RECORD_F = 16
F_D = 9
F_ID = 12
F_ANCHOR = 13
F_ZMAX = 15

TILE_H = 8
TILE_W = 16
TILE_PX = TILE_H * TILE_W  # 128 pixels, one thread each on the card
CHUNK = 128  # K1: records per chunk, aligned to global 128-slot boundaries
TRI_GROUP = 8  # K2: records per group, aligned to the block's start

# Kernel launches (CUDA path only), one count per variant. A K1 launch
# with a payload counts in LAUNCHES_PAYLOAD alone, with or without track2.
LAUNCHES = 0
LAUNCHES_TRACK2 = 0
LAUNCHES_PAYLOAD = 0
LAUNCHES_BLOCKS = 0
LAUNCHES_BLOCKS_TRACK2 = 0

# Tiles the K1 twin evaluates at once: bounds its (tiles, CHUNK, TILE_PX)
# intermediates to ~64 MB each at any resolution.
_TWIN_TILES = 1024


def _pixel_centres(dev):
    lane = torch.arange(TILE_PX, device=dev)
    return ((lane % TILE_W).to(torch.float32) + 0.5,
            (lane // TILE_W).to(torch.float32) + 0.5)


def _candidates(blk, valid, px, py):
    """(T, G, 16) records -> (T, G, TILE_PX) candidate depths: min(depth
    plane, zmax) where the three edge planes are >= 0 and `valid` (T, G)
    holds, else -1. Planes are ((ax*px) + (ay*py)) + b in separately
    rounded operations, as the kernels evaluate them."""
    def plane(f):
        return ((blk[:, :, f, None] * px + blk[:, :, f + 1, None] * py)
                + blk[:, :, f + 2, None])

    inside = ((plane(0) >= 0.0) & (plane(3) >= 0.0) & (plane(6) >= 0.0)
              & valid[:, :, None])
    d = torch.minimum(plane(F_D), blk[:, :, F_ZMAX, None])
    return torch.where(inside, d, -1.0)


def _merge(cand, idt, best):
    """Merge one chunk's (K1) or group's (K2) candidates (T, G, TILE_PX)
    into the running `best` = [depth, id] or, with the runner-up,
    [depth, id, depth2, id2], each (T, TILE_PX), as the TPU kernels merge
    them: within the group the highest id among the maximal depths, across
    groups a strict >. A NaN candidate poisons the group's max (no take).
    The runner-up merge is a line-by-line translation of the TPU kernel's
    (voidin_tpu/ops/fine_raster.py:239-276, raster.py:999-1013). Returns
    (new best, take, at_max, gid)."""
    gmax = torch.amax(cand, dim=1)  # (T, TILE_PX)
    at_max = cand == gmax[:, None, :]
    gid = torch.amax(torch.where(at_max, idt, -1.0), dim=1)
    bd, bi = best[0], best[1]
    take = gmax > bd
    out = [torch.where(take, gmax, bd), torch.where(take, gid, bi)]
    if len(best) == 4:
        # within-group second place: every record at the group's max depth
        # is masked (ties collapse, not just the winner's id)
        c2 = torch.where(at_max, -1.0, cand)
        g2 = torch.amax(c2, dim=1)
        g2id = torch.amax(torch.where(c2 == g2[:, None, :], idt, -1.0),
                          dim=1)
        g2id = torch.where(g2 > 0.0, g2id, -1.0)
        # demoted best; a cross-group bit-equal tie of the running best
        # collapses like the within-group ties
        lv = torch.where(take, bd, torch.where(gmax == bd, -1.0, gmax))
        li = torch.where(take, bi, gid)
        bd2, bi2 = best[2], best[3]
        t2 = g2 > bd2
        m2v = torch.where(t2, g2, bd2)
        m2i = torch.where(t2, g2id, bi2)
        t3 = lv > m2v
        out += [torch.where(t3, lv, m2v), torch.where(t3, li, m2i)]
    return out, take, at_max, gid


def _init_best(nt, dev, track2):
    d = torch.zeros(nt, TILE_PX, dtype=torch.float32, device=dev)
    i = torch.full((nt, TILE_PX), -1.0, dtype=torch.float32, device=dev)
    return [d, i, d.clone(), i.clone()] if track2 else [d, i]


def fine_raster_pairs_reference(records_sorted, starts, counts,
                                track2=False, payload=None):
    """Plain PyTorch twin of K1 with the TPU kernel's grouping.

    `records_sorted` (E_pad, 16) f32 tile-sorted records, E_pad a multiple
    of CHUNK padded so a tile's last chunk is in range; `starts`, `counts`
    (NT,) int. Returns (depth, id), each (NT, TILE_PX) f32, with `track2`
    also the runner-up (depth2, id2) among distinct depths, and with
    `payload` ((E_pad, PAY_F) raw 32-bit words in pair order) last the
    winner's payload row per pixel, (NT, PAY_F, TILE_PX), zero where no
    record wins. The payload is selected by the winning record's slot (the
    record at the chunk's max depth with the chunk's winning id), never by
    a float product, so it is a bit copy. Loops over the chunk index and
    batches over tiles."""
    dev = records_sorted.device
    nt = starts.shape[0]
    chunks = records_sorted.reshape(-1, CHUNK, RECORD_F)
    starts = starts.to(torch.int64)
    counts = counts.to(torch.int64)
    chunk0 = starts // CHUNK
    offset = starts - chunk0 * CHUNK
    span = offset + counts
    n_chunks = torch.where(counts > 0, (span + CHUNK - 1) // CHUNK, 0)
    px, py = _pixel_centres(dev)
    slot = torch.arange(CHUNK, device=dev)
    best = _init_best(nt, dev, track2)
    best_slot = torch.full((nt, TILE_PX), -1, dtype=torch.int64, device=dev)
    max_chunks = int(n_chunks.max()) if nt else 0
    for c in range(max_chunks):
        active = torch.nonzero(n_chunks > c)[:, 0]
        for lo in range(0, active.shape[0], _TWIN_TILES):
            t = active[lo: lo + _TWIN_TILES]
            blk = chunks[chunk0[t] + c]  # (T, CHUNK, 16)
            in_range = (slot >= (offset[t] - c * CHUNK)[:, None]) & (
                slot < (span[t] - c * CHUNK)[:, None]
            )  # (T, CHUNK)
            cand = _candidates(blk, in_range, px, py)
            idt = blk[:, :, F_ID, None].expand_as(cand)
            new, take, at_max, gid = _merge(cand, idt,
                                            [b[t] for b in best])
            for b, v in zip(best, new):
                b[t] = v
            if payload is not None:
                win = at_max & (idt == gid[:, None, :])
                first = torch.argmax(win.to(torch.uint8), dim=1)
                gslot = (chunk0[t] + c)[:, None] * CHUNK + first
                best_slot[t] = torch.where(take, gslot, best_slot[t])
    outs = tuple(best)
    if payload is not None:
        words = payload.contiguous().view(torch.int32)
        rows = words[torch.clamp(best_slot, min=0)]  # (NT, TILE_PX, PAY_F)
        rows = torch.where((best_slot >= 0)[..., None], rows, 0)
        outs += (rows.permute(0, 2, 1).contiguous().view(torch.float32),)
    return outs


def fine_raster_blocks_reference(records, counts, track2=False):
    """Plain PyTorch twin of K2: the counterpart of both
    voidin_tpu/ops/fine_raster.py fine_raster_pallas (:445) and
    voidin_tpu/passes/raster.py fine_raster_xla (:957-1018), which the JAX
    tests hold equal.

    `records` (NT, K, 16) f32 per-tile blocks, K a multiple of TRI_GROUP;
    `counts` (NT,) int, slots at or past min(count, K) ignored. Records
    with a negative id never compete. Groups of TRI_GROUP records aligned
    to the block's start: highest id among a group's maximal depths,
    strict > across groups. Returns (depth, id), each (NT, TILE_PX) f32,
    and with `track2` also the runner-up (depth2, id2)."""
    dev = records.device
    nt, k_cap = records.shape[0], records.shape[1]
    counts = torch.clamp(counts.to(torch.int64), 0, k_cap)
    px, py = _pixel_centres(dev)
    g_slot = torch.arange(TRI_GROUP, device=dev)
    best = _init_best(nt, dev, track2)
    max_count = int(counts.max()) if nt else 0
    for base in range(0, max_count, TRI_GROUP):
        t = torch.nonzero(counts > base)[:, 0]
        blk = records[t, base: base + TRI_GROUP]  # (T, G, 16)
        idf = blk[:, :, F_ID]
        valid = ((base + g_slot)[None, :] < counts[t, None]) & (idf >= 0.0)
        cand = _candidates(blk, valid, px, py)
        new, _, _, _ = _merge(cand, idf[:, :, None].expand_as(cand),
                              [b[t] for b in best])
        for b, v in zip(best, new):
            b[t] = v
    return tuple(best)


def _check_i32(name, t, n, device):
    if t.device != device or t.dtype != torch.int32 or t.shape != (n,):
        raise ValueError(f"{name} must be ({n},) int32 on the records' "
                         f"device, got {tuple(t.shape)} {t.dtype} {t.device}")


def _outputs(nt, n, device):
    return [torch.empty(nt, TILE_PX, dtype=torch.float32, device=device)
            for _ in range(n)]


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def fine_raster_pairs(records_sorted, starts, counts, track2=False,
                      payload=None):
    """Returns (depth, id), each (NT, TILE_PX) f32, with `track2` also the
    runner-up (depth2, id2) for the alpha-cutoff fallback, and with
    `payload` ((E_pad, PAY_F) f32 words in pair order) last the winner's
    (NT, PAY_F, TILE_PX) payload. CPU tensors run the twin; CUDA tensors
    launch kernel K1 (its track2 / payload variant when asked)."""
    if records_sorted.device.type == "cpu":
        return fine_raster_pairs_reference(records_sorted, starts, counts,
                                           track2=track2, payload=payload)
    global LAUNCHES, LAUNCHES_TRACK2, LAUNCHES_PAYLOAD
    from . import _build

    dev = records_sorted.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if records_sorted.dtype != torch.float32 or records_sorted.dim() != 2 \
            or records_sorted.shape[1] != RECORD_F \
            or records_sorted.shape[0] % CHUNK != 0:
        raise ValueError(
            f"records must be (E_pad, {RECORD_F}) f32 with E_pad % {CHUNK} "
            f"== 0, got {tuple(records_sorted.shape)} {records_sorted.dtype}"
        )
    nt = starts.shape[0]
    e_pad = records_sorted.shape[0]
    _check_i32("starts", starts, nt, dev)
    _check_i32("counts", counts, nt, dev)
    if payload is not None and (
            payload.device != dev or payload.dtype != torch.float32
            or payload.dim() != 2 or payload.shape[0] != e_pad
            or payload.shape[1] < 1):
        raise ValueError(f"payload must be ({e_pad}, PAY_F) f32 on the "
                         f"records' device, got {tuple(payload.shape)} "
                         f"{payload.dtype} {payload.device}")
    rec = records_sorted.contiguous()
    starts = starts.contiguous()
    counts = counts.contiguous()
    outs = _outputs(nt, 4 if track2 else 2, dev)
    lib = _build.load()
    ptrs = [o.data_ptr() for o in outs]
    with torch.cuda.device(dev):
        if payload is None:
            fn = (lib.voidin_fine_raster_pairs_track2 if track2
                  else lib.voidin_fine_raster_pairs)
            rc = fn(rec.data_ptr(), starts.data_ptr(), counts.data_ptr(),
                    *ptrs, nt, e_pad // CHUNK, _stream(dev))
        else:
            pay = payload.contiguous()
            pay_f = pay.shape[1]
            pay_out = torch.empty(nt, pay_f, TILE_PX, dtype=torch.float32,
                                  device=dev)
            fn = (lib.voidin_fine_raster_pairs_payload_track2 if track2
                  else lib.voidin_fine_raster_pairs_payload)
            rc = fn(rec.data_ptr(), starts.data_ptr(), counts.data_ptr(),
                    pay.data_ptr(), pay_f, *ptrs, pay_out.data_ptr(), nt,
                    e_pad // CHUNK, _stream(dev))
            outs.append(pay_out)
    _build.check(lib, rc, "fine_raster_pairs")
    if payload is not None:
        LAUNCHES_PAYLOAD += 1
    elif track2:
        LAUNCHES_TRACK2 += 1
    else:
        LAUNCHES += 1
    return tuple(outs)


def fine_raster_blocks(records, counts, track2=False):
    """Returns (depth, id), each (NT, TILE_PX) f32, and with `track2` also
    the runner-up (depth2, id2), from (NT, K, 16) per-tile blocks. CPU
    tensors run the twin; CUDA tensors launch kernel K2 (its track2
    variant when asked)."""
    if records.device.type == "cpu":
        return fine_raster_blocks_reference(records, counts, track2=track2)
    global LAUNCHES_BLOCKS, LAUNCHES_BLOCKS_TRACK2
    from . import _build

    dev = records.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if records.dtype != torch.float32 or records.dim() != 3 \
            or records.shape[2] != RECORD_F \
            or records.shape[1] % TRI_GROUP != 0:
        raise ValueError(
            f"records must be (NT, K, {RECORD_F}) f32 with K % {TRI_GROUP} "
            f"== 0, got {tuple(records.shape)} {records.dtype}"
        )
    nt, k_cap = records.shape[0], records.shape[1]
    _check_i32("counts", counts, nt, dev)
    rec = records.contiguous()
    counts = counts.contiguous()
    outs = _outputs(nt, 4 if track2 else 2, dev)
    lib = _build.load()
    fn = (lib.voidin_fine_raster_blocks_track2 if track2
          else lib.voidin_fine_raster_blocks)
    with torch.cuda.device(dev):
        rc = fn(rec.data_ptr(), counts.data_ptr(),
                *[o.data_ptr() for o in outs], nt, k_cap, _stream(dev))
    _build.check(lib, rc, "fine_raster_blocks")
    if track2:
        LAUNCHES_BLOCKS_TRACK2 += 1
    else:
        LAUNCHES_BLOCKS += 1
    return tuple(outs)

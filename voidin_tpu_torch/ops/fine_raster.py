"""Fine raster (kernel K1): per-tile reverse-Z depth/id competition.

``fine_raster_pairs`` replaces ``voidin_tpu/ops/fine_raster.py``
``fine_raster_pairs`` / ``_kernel_pairs`` (the Pallas TPU kernel). On a
CUDA tensor it launches the hand-written Hopper kernel in
``csrc/fine_raster.cu`` (see its header for what bounds it on an H100 and
how the design answers that); on a CPU tensor it runs the plain PyTorch
twin ``fine_raster_pairs_reference``. There is no other path: a CUDA
tensor goes to the kernel or raises. ``track2=True`` is the TPU kernel's
runner-up variant (alpha-masked scenes): it also returns the best depth
and id among depths below the winner's.

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
CHUNK = 128  # records per chunk, aligned to global 128-slot boundaries

LAUNCHES = 0  # base-variant kernel launches (CUDA path only)
LAUNCHES_TRACK2 = 0  # track2-variant kernel launches (CUDA path only)

# Tiles the twin evaluates at once: bounds its (tiles, CHUNK, TILE_PX)
# intermediates to ~64 MB each at any resolution.
_TWIN_TILES = 1024


def fine_raster_pairs_reference(records_sorted, starts, counts,
                                track2=False):
    """Plain PyTorch twin of K1 with the TPU kernel's grouping.

    `records_sorted` (E_pad, 16) f32 tile-sorted records, E_pad a multiple
    of CHUNK padded so a tile's last chunk is in range; `starts`, `counts`
    (NT,) int. Returns (depth, id), each (NT, TILE_PX) f32, and with
    `track2` also the runner-up (depth2, id2) among distinct depths. Loops
    over the chunk index and batches over tiles; planes are
    ((ax*px) + (ay*py)) + b in separately rounded operations, like the
    kernel. The runner-up merge is a line-by-line translation of the TPU
    kernel's (voidin_tpu/ops/fine_raster.py:239-276)."""
    dev = records_sorted.device
    nt = starts.shape[0]
    chunks = records_sorted.reshape(-1, CHUNK, RECORD_F)
    starts = starts.to(torch.int64)
    counts = counts.to(torch.int64)
    chunk0 = starts // CHUNK
    offset = starts - chunk0 * CHUNK
    span = offset + counts
    n_chunks = torch.where(counts > 0, (span + CHUNK - 1) // CHUNK, 0)
    lane = torch.arange(TILE_PX, device=dev)
    px = (lane % TILE_W).to(torch.float32) + 0.5
    py = (lane // TILE_W).to(torch.float32) + 0.5
    slot = torch.arange(CHUNK, device=dev)
    best_d = torch.zeros(nt, TILE_PX, dtype=torch.float32, device=dev)
    best_i = torch.full((nt, TILE_PX), -1.0, dtype=torch.float32, device=dev)
    if track2:
        best_d2 = torch.zeros_like(best_d)
        best_i2 = torch.full_like(best_i, -1.0)
    max_chunks = int(n_chunks.max()) if nt else 0
    for c in range(max_chunks):
        active = torch.nonzero(n_chunks > c)[:, 0]
        for lo in range(0, active.shape[0], _TWIN_TILES):
            t = active[lo: lo + _TWIN_TILES]
            blk = chunks[chunk0[t] + c]  # (T, CHUNK, 16)
            in_range = (slot >= (offset[t] - c * CHUNK)[:, None]) & (
                slot < (span[t] - c * CHUNK)[:, None]
            )  # (T, CHUNK)

            def plane(f):
                ax = blk[:, :, f, None]
                ay = blk[:, :, f + 1, None]
                b = blk[:, :, f + 2, None]
                return (ax * px + ay * py) + b  # (T, CHUNK, TILE_PX)

            inside = (
                (plane(0) >= 0.0) & (plane(3) >= 0.0) & (plane(6) >= 0.0)
                & in_range[:, :, None]
            )
            d = torch.minimum(plane(F_D), blk[:, :, F_ZMAX, None])
            cand = torch.where(inside, d, -1.0)
            gmax = torch.amax(cand, dim=1)  # (T, TILE_PX)
            idt = blk[:, :, F_ID, None].expand_as(cand)
            at_max = cand == gmax[:, None, :]
            gid = torch.amax(torch.where(at_max, idt, -1.0), dim=1)
            bd, bi = best_d[t], best_i[t]
            take = gmax > bd
            best_d[t] = torch.where(take, gmax, bd)
            best_i[t] = torch.where(take, gid, bi)
            if not track2:
                continue
            # within-chunk second place: every record at the chunk's max
            # depth is masked (ties collapse, not just the winner's id)
            c2 = torch.where(at_max, -1.0, cand)
            g2 = torch.amax(c2, dim=1)
            g2id = torch.amax(torch.where(c2 == g2[:, None, :], idt, -1.0),
                              dim=1)
            g2id = torch.where(g2 > 0.0, g2id, -1.0)
            # demoted best; a cross-chunk bit-equal tie of the running best
            # collapses like the within-chunk ties
            lv = torch.where(take, bd, torch.where(gmax == bd, -1.0, gmax))
            li = torch.where(take, bi, gid)
            bd2, bi2 = best_d2[t], best_i2[t]
            t2 = g2 > bd2
            m2v = torch.where(t2, g2, bd2)
            m2i = torch.where(t2, g2id, bi2)
            t3 = lv > m2v
            best_d2[t] = torch.where(t3, lv, m2v)
            best_i2[t] = torch.where(t3, li, m2i)
    if track2:
        return best_d, best_i, best_d2, best_i2
    return best_d, best_i


def fine_raster_pairs(records_sorted, starts, counts, track2=False):
    """Returns (depth, id), each (NT, TILE_PX) f32, and with `track2` also
    the runner-up (depth2, id2) for the alpha-cutoff fallback. CPU tensors
    run the twin; CUDA tensors launch kernel K1 (its track2 variant when
    asked)."""
    if records_sorted.device.type == "cpu":
        return fine_raster_pairs_reference(records_sorted, starts, counts,
                                           track2=track2)
    global LAUNCHES, LAUNCHES_TRACK2
    from . import _build

    if records_sorted.device.type != "cuda":
        raise ValueError(f"unsupported device {records_sorted.device}")
    if records_sorted.dtype != torch.float32 or records_sorted.dim() != 2 \
            or records_sorted.shape[1] != RECORD_F \
            or records_sorted.shape[0] % CHUNK != 0:
        raise ValueError(
            f"records must be (E_pad, {RECORD_F}) f32 with E_pad % {CHUNK} "
            f"== 0, got {tuple(records_sorted.shape)} {records_sorted.dtype}"
        )
    nt = starts.shape[0]
    for name, t in (("starts", starts), ("counts", counts)):
        if t.device != records_sorted.device or t.dtype != torch.int32 \
                or t.shape != (nt,):
            raise ValueError(f"{name} must be ({nt},) int32 on the records' "
                             f"device, got {tuple(t.shape)} {t.dtype} "
                             f"{t.device}")
    rec = records_sorted.contiguous()
    starts = starts.contiguous()
    counts = counts.contiguous()
    outs = [torch.empty(nt, TILE_PX, dtype=torch.float32, device=rec.device)
            for _ in range(4 if track2 else 2)]
    lib = _build.load()
    fn = (lib.voidin_fine_raster_pairs_track2 if track2
          else lib.voidin_fine_raster_pairs)
    with torch.cuda.device(rec.device):
        stream = torch.cuda.current_stream(rec.device).cuda_stream
        rc = fn(rec.data_ptr(), starts.data_ptr(), counts.data_ptr(),
                *[o.data_ptr() for o in outs], nt, rec.shape[0] // CHUNK,
                stream)
    _build.check(lib, rc, "fine_raster_pairs")
    if track2:
        LAUNCHES_TRACK2 += 1
    else:
        LAUNCHES += 1
    return tuple(outs)

"""Test-only image writers for the files PIL cannot write, so that the
port's decoders (voidin_tpu_torch/io/image.py, io/jpeg.py) can be held to
PIL's pixels on them: tests/test_torch_image_formats.py and
tools/torch_image_fixtures.py use them, and PIL then decodes what they
write.

- ``png_bytes``: any colour type and bit depth, Adam7 or not, every
  scanline under a filter type drawn from a seed (PIL's writer ignores
  ``interlace=1`` and writes no 16-bit RGB keys).
- ``jpeg_bytes``: baseline JPEG (SOF0) at any sampling factors of 1-4, with
  1, 3 or 4 components and an optional Adobe marker (PIL writes factors of
  1-2 only, never 1x2 chroma), put together from the port's encoder pieces
  (io/jpeg.py ``quant_table``, ``huffman_codes``, ``_fdct``,
  ``_pack_bits``); ``set_precision`` and ``set_sof`` rewrite a file's
  frame header to make the files PIL refuses.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from voidin_tpu_torch.io import jpeg

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _pack_rows(samples, depth):
    """(h, w, c) sample values -> (h, scanline bytes) packed rows."""
    h, w, c = samples.shape
    if depth == 16:
        return samples.astype(">u2").reshape(h, w * c).view(np.uint8)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, w * c)
    per = 8 // depth
    v = np.pad(samples[..., 0].astype(np.uint8), ((0, 0), (0, (-w) % per)))
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    return (v.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)


def _filter_rows(rows, bpp, rng, filter_type):
    """Each row under `filter_type` (0-4), or under one drawn from `rng`
    where it is None, as filtered scanline bytes."""
    out = []
    prev = np.zeros(rows.shape[1], np.int64)
    zeros = np.zeros(bpp, np.int64)
    for r in rows.astype(np.int64):
        f = int(rng.integers(0, 5)) if filter_type is None else filter_type
        left = np.concatenate([zeros, r])[:len(r)]
        ul = np.concatenate([zeros, prev])[:len(r)]
        if f == 0:
            p = 0
        elif f == 1:
            p = left
        elif f == 2:
            p = prev
        elif f == 3:
            p = (left + prev) >> 1
        else:
            pa, pb = np.abs(prev - ul), np.abs(left - ul)
            pc = np.abs(left + prev - 2 * ul)
            p = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, prev, ul))
        out.append(bytes([f]) + bytes(((r - p) & 255).astype(np.uint8)))
        prev = r
    return b"".join(out)


def png_bytes(samples, depth, ctype, interlace=False, plte=None, trns=None,
              seed=0, filter_type=None):
    """A PNG of (h, w, channels) sample values at `depth` bits and colour
    type `ctype`, Adam7 when `interlace`; `plte` (n, 3) u8, `trns` the
    tRNS chunk's body; every row under `filter_type`, or under filter
    types drawn from `seed`."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, c = samples.shape
    assert c == _PNG_CHANNELS[ctype]
    rng = np.random.default_rng(seed)
    bpp = max(1, c * depth // 8)
    raw = b""
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        sub = samples[y0::dy, x0::dx]
        if sub.shape[0] and sub.shape[1]:
            raw += _filter_rows(_pack_rows(sub, depth), bpp, rng,
                                filter_type)
    out = _PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(bool(interlace))))
    if plte is not None:
        out += _chunk(b"PLTE", bytes(np.asarray(plte, np.uint8).reshape(-1)))
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(raw, 9)) + _chunk(b"IEND", b"")


def _box_down(plane, fx, fy):
    """Average `plane` over fx x fy boxes (edges repeated), rounded: the
    component's (ceil(H / fy), ceil(W / fx)) samples."""
    h, w = plane.shape
    p = np.pad(plane.astype(np.int64), ((0, (-h) % fy), (0, (-w) % fx)),
               mode="edge")
    p = p.reshape(p.shape[0] // fy, fy, p.shape[1] // fx, fx)
    return (p.sum(axis=(1, 3)) + fx * fy // 2) // (fx * fy)


def _entropy(zz, comp, table_of):
    """Huffman-code (N, 64) zig-zag blocks in stream order with the Annex K
    tables (table_of[i]: 0 luma, 1 chroma), DC predicted per component:
    the scan's stuffed bytes (io/jpeg.py encode_jpeg's coder)."""
    diff = np.empty(len(zz), np.int64)
    for c in np.unique(comp):
        sel = comp == c
        diff[sel] = np.diff(zz[sel, 0], prepend=0)
    dc_codes = [jpeg._code_arrays(jpeg.DC_LUMA),
                jpeg._code_arrays(jpeg.DC_CHROMA)]
    ac_codes = [jpeg._code_arrays(jpeg.AC_LUMA),
                jpeg._code_arrays(jpeg.AC_CHROMA)]

    def coded(codes, table, symbol, mag, size):
        code = np.where(table == 0, codes[0][0][symbol], codes[1][0][symbol])
        length = np.where(table == 0, codes[0][1][symbol],
                          codes[1][1][symbol])
        mag_bits = np.where(mag < 0, mag + (1 << size) - 1, mag)
        return (code << size) | mag_bits, length + size

    dc_size = jpeg._bit_length(diff)
    dc_val, dc_len = coded(dc_codes, table_of, dc_size, diff, dc_size)
    blk, k = np.nonzero(zz[:, 1:])
    k = k + 1
    ac = zz[blk, k]
    first = np.ones(len(blk), bool)
    first[1:] = blk[1:] != blk[:-1]
    prev_k = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev_k - 1
    size = jpeg._bit_length(ac)
    ac_val, ac_len = coded(ac_codes, table_of[blk], (run & 15) << 4 | size,
                           ac, size)
    n_zrl = run >> 4
    zrl_blk = np.repeat(blk, n_zrl)
    zrl_val, zrl_len = coded(ac_codes, table_of[zrl_blk],
                             np.full(len(zrl_blk), 0xF0), 0, 0)
    last = np.ones(len(blk), bool)
    last[:-1] = blk[1:] != blk[:-1]
    last_k = np.zeros(len(zz), np.int64)
    last_k[blk[last]] = k[last]
    eob_blk = np.flatnonzero(last_k < 63)
    eob_val, eob_len = coded(ac_codes, table_of[eob_blk],
                             np.zeros(len(eob_blk), np.int64), 0, 0)
    key = np.concatenate([np.arange(len(zz)) * 256, zrl_blk * 256
                          + np.repeat(2 * k - 1, n_zrl), blk * 256 + 2 * k,
                          eob_blk * 256 + 255])
    perm = np.argsort(key, kind="stable")
    data = jpeg._pack_bits(
        np.concatenate([dc_val, zrl_val, ac_val, eob_val])[perm],
        np.concatenate([dc_len, zrl_len, ac_len, eob_len])[perm])
    return np.insert(data, np.flatnonzero(data == 0xFF) + 1, 0).tobytes()


def jpeg_bytes(planes, factors, quality=90, adobe=None, jfif=True,
               ids=None, interleaved=True):
    """A baseline JPEG of full-size (H, W) uint8 sample planes, one a
    component, each sampled at its (h, v) factors (1-4; box-averaged to
    ceil(W h / hmax) x ceil(H v / vmax)). Component 0 takes the Annex K
    luma tables, the others the chroma ones. `adobe`: an Adobe marker's
    colour transform (0 none, 1 YCbCr, 2 YCCK) or None; `ids`: the
    component ids (1, 2, ... by default); `interleaved=False` writes one
    scan a component."""
    planes = [np.asarray(p, np.uint8) for p in planes]
    height, width = planes[0].shape
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    ids = list(ids or range(1, len(planes) + 1))
    tables = [jpeg.quant_table(jpeg.LUMA_QUANT, quality),
              jpeg.quant_table(jpeg.CHROMA_QUANT, quality)]
    coefs = []  # per component: (block rows, block cols, 64) zig-zag
    for ci, (plane, (h, v)) in enumerate(zip(planes, factors)):
        down = _box_down(plane, hmax // h, vmax // v)
        dh, dw = down.shape
        full = np.pad(down, ((0, mcuy * v * 8 - dh), (0, mcux * h * 8 - dw)),
                      mode="edge")
        blk = jpeg._blocks(full.astype(np.float32) - 128.0)
        f = jpeg._fdct(blk.reshape(-1, 64))
        q = tables[min(ci, 1)].astype(np.float32)
        quant = np.copysign(np.floor(np.abs(f) / q + 0.5), f)
        coefs.append(quant[:, jpeg.ZIGZAG].astype(np.int64).reshape(
            blk.shape[0], blk.shape[1], 64))

    def scan(comps):
        if len(comps) == 1:
            ci = comps[0]
            h, v = factors[ci]
            bw = -(-(-(-width * h // hmax)) // 8)
            bh = -(-(-(-height * v // vmax)) // 8)
            zz = coefs[ci][:bh, :bw].reshape(-1, 64)
            comp = np.full(len(zz), ci)
        else:
            parts, comp = [], []
            for ci in comps:
                h, v = factors[ci]
                c = coefs[ci].reshape(mcuy, v, mcux, h, 64).transpose(
                    0, 2, 1, 3, 4).reshape(mcuy * mcux, v * h, 64)
                parts.append(c)
                comp += [ci] * (v * h)
            zz = np.concatenate(parts, axis=1).reshape(-1, 64)
            comp = np.tile(comp, mcuy * mcux)
        sos = bytes([len(comps)]) + b"".join(
            bytes([ids[ci], 0x00 if ci == 0 else 0x11]) for ci in comps)
        return (jpeg._segment(0xDA, sos + b"\x00\x3f\x00")
                + _entropy(zz, comp, np.minimum(comp, 1)))

    out = [jpeg.SOI]
    if jfif:
        out.append(jpeg._segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00"
                                 b"\x01\x00\x00"))
    if adobe is not None:
        out.append(jpeg._segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00"
                                 + bytes([adobe])))
    for ti, t in enumerate(tables):
        out.append(jpeg._segment(0xDB, bytes([ti])
                                 + bytes(t[jpeg.ZIGZAG].astype(np.uint8))))
    out.append(jpeg._segment(0xC0, struct.pack(
        ">BHHB", 8, height, width, len(planes)) + b"".join(
            bytes([ids[ci], h << 4 | v, min(ci, 1)])
            for ci, (h, v) in enumerate(factors))))
    for cls, tabs in ((0, (jpeg.DC_LUMA, jpeg.DC_CHROMA)),
                      (1, (jpeg.AC_LUMA, jpeg.AC_CHROMA))):
        for ti, (counts, symbols) in enumerate(tabs):
            out.append(jpeg._segment(0xC4, bytes([cls << 4 | ti])
                                     + bytes(counts) + bytes(symbols)))
    n = len(planes)
    for comps in ([list(range(n))] if interleaved else [[c] for c in
                                                         range(n)]):
        out.append(scan(comps))
    out.append(b"\xff\xd9")
    return b"".join(out)


def _sof_at(data: bytes) -> int:
    """Byte index of the frame header's marker (0xFF, 0xC0-0xC2)."""
    i = 2
    while data[i + 1] not in (0xC0, 0xC1, 0xC2):
        i += 2 + struct.unpack(">H", data[i + 2:i + 4])[0]
    return i


def set_sof(data: bytes, marker: int) -> bytes:
    """The file with its frame header's marker set to `marker` (0xC5: a
    hierarchical frame, and so on)."""
    i = _sof_at(data)
    return data[:i + 1] + bytes([marker]) + data[i + 2:]


def set_precision(data: bytes, bits: int) -> bytes:
    """The file with its frame header's sample precision set to `bits`."""
    i = _sof_at(data)
    return data[:i + 4] + bytes([bits]) + data[i + 5:]


def set_height(data: bytes, height: int) -> bytes:
    """The file with its frame header's height set (0: defined by DNL)."""
    i = _sof_at(data)
    return data[:i + 5] + struct.pack(">H", height) + data[i + 7:]

"""Test-only image writers for the files PIL cannot write, so that the
port's decoders (voidin_tpu_torch/io/image.py, jpeg.py, webp.py, gif.py,
bmp.py, tiff.py) can be held to
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
- ``progressive_jpeg_bytes``: the same coefficients as Huffman progressive
  scans (DC first and refinement, AC first) by a script that may stop
  short, the files libjpeg block-smooths.
- ``arith_jpeg_bytes``: the same coefficients arithmetic-coded (SOF9, or
  SOF10 by a script such as ``simple_progression``, libjpeg's own), with
  a DAC marker and restarts, coded by a port of libjpeg's jcarith.c.
- ``lossless_jpeg_bytes``: lossless JPEG (SOF3) at predictors 1-7, point
  transforms, restarts, 1-4 components and sampling factors.
- ``bmp_bytes``: BMP with every header size, 1-32 bits, palettes,
  bitfields, RLE8 / RLE4 (with a delta escape) and top-down rows.
- ``gif_bytes``: GIF87a / 89a with global and local palettes, the
  interlace, transparency, a frame at an offset on a larger screen, and
  LZW (``_lzw_codes``) that clears a full table or keeps it full.
- ``tiff_bytes``: one-IFD TIFF or BigTIFF (``tiff_container``) at 1-32
  bits, float and signed samples, any photometric, chunky YCbCr units at
  any subsampling, extra samples, II / MM, strips or tiles, chunky or
  planar, FillOrder 2, LZW (and the old LSB-first style), Deflate,
  PackBits, LZMA, predictors 2 and 3, and any other tags;
  ``jpeg_tiff_bytes`` (JPEG-in-TIFF, tables in JPEGTables or each
  strip), ``ojpeg_tiff_bytes`` (old-style JPEG from a JFIF stream) and
  ``webp_tiff_bytes`` (WebP-in-TIFF), which PIL cannot write.
- ``webp_anim_bytes`` / ``riff_chunks`` / ``webp_file``: WebP containers
  built from the chunks of PIL's still files (an animation whose first
  frame sits at an offset over a background colour).
- ``vp8_variant``: PIL's lossy WebP re-coded through ``BoolEncoder`` (RFC
  6386's boolean encoder) with VP8 header fields libwebp's encoder never
  sets through PIL (simple loop filter, sharpness, loop-filter deltas,
  token partitions, relative segment values), every macroblock decision
  carried over as the port's decoder reads it.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from voidin_tpu_torch.io import jpeg
from voidin_tpu_torch.io import jpeg_arith as arith

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


def _entropy(zz, comp, table_of, dc=True, ss=1, se=63):
    """Huffman-code (N, 64) zig-zag blocks in stream order with the Annex K
    tables (table_of[i]: 0 luma, 1 chroma): each block's DC difference
    from the previous block of its component (`dc`), then its band ss..se
    (none where se < ss) by run and size with ZRLs, and EOB where the band
    ends in zeros: the scan's stuffed bytes (io/jpeg.py encode_jpeg's
    coder; a progressive file's EOB is a run of one block)."""
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

    n = len(zz)
    dc_size = jpeg._bit_length(diff)
    dc_val, dc_len = coded(dc_codes, table_of, dc_size, diff, dc_size)
    keep = np.full(n, dc)
    blk, k = np.nonzero(zz[:, ss:se + 1])
    k = k + ss
    ac = zz[blk, k]
    first = np.ones(len(blk), bool)
    first[1:] = blk[1:] != blk[:-1]
    prev_k = np.where(first, ss - 1, np.concatenate([[0], k[:-1]]))
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
    last_k = np.full(n, ss - 1)
    last_k[blk[last]] = k[last]
    eob_blk = np.flatnonzero(last_k < se) if se >= ss else np.zeros(0, int)
    eob_val, eob_len = coded(ac_codes, table_of[eob_blk],
                             np.zeros(len(eob_blk), np.int64), 0, 0)
    key = np.concatenate([np.arange(n)[keep] * 256, zrl_blk * 256
                          + np.repeat(2 * k - 1, n_zrl), blk * 256 + 2 * k,
                          eob_blk * 256 + 255])
    perm = np.argsort(key, kind="stable")
    data = jpeg._pack_bits(
        np.concatenate([dc_val[keep], zrl_val, ac_val, eob_val])[perm],
        np.concatenate([dc_len[keep], zrl_len, ac_len, eob_len])[perm])
    return _stuff(data)


def _stuff(data):
    """Entropy-coded bytes with a 0x00 after every 0xFF."""
    data = np.asarray(data, np.uint8)
    return np.insert(data, np.flatnonzero(data == 0xFF) + 1, 0).tobytes()


def _start(jfif, adobe):
    """SOI, a JFIF marker if `jfif`, an Adobe marker of colour transform
    `adobe` (0 none, 1 YCbCr, 2 YCCK) unless None."""
    out = [jpeg.SOI]
    if jfif:
        out.append(jpeg._segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01"
                                 b"\x00\x01\x00\x00"))
    if adobe is not None:
        out.append(jpeg._segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00"
                                 + bytes([adobe])))
    return out


class _Image:
    """The quantized coefficients of full-size (H, W) uint8 sample planes,
    one a component, each sampled at its (h, v) factors (1-4; box-averaged
    to ceil(W h / hmax) x ceil(H v / vmax)) and coded with the Annex K
    tables at `quality` (component 0 the luma table, the others the chroma
    one): `coefs[c]` (block rows, block cols, 64) zig-zag over the MCU
    grid, its padding the edge samples repeated."""

    def __init__(self, planes, factors, quality=90):
        planes = [np.asarray(p, np.uint8) for p in planes]
        self.height, self.width = planes[0].shape
        self.factors = list(factors)
        self.hmax = max(h for h, _ in factors)
        self.vmax = max(v for _, v in factors)
        self.mcux = -(-self.width // (8 * self.hmax))
        self.mcuy = -(-self.height // (8 * self.vmax))
        self.tables = [jpeg.quant_table(jpeg.LUMA_QUANT, quality),
                       jpeg.quant_table(jpeg.CHROMA_QUANT, quality)]
        self.coefs = []
        for ci, (plane, (h, v)) in enumerate(zip(planes, factors)):
            down = _box_down(plane, self.hmax // h, self.vmax // v)
            dh, dw = down.shape
            full = np.pad(down, ((0, self.mcuy * v * 8 - dh),
                                 (0, self.mcux * h * 8 - dw)), mode="edge")
            blk = jpeg._blocks(full.astype(np.float32) - 128.0)
            f = jpeg._fdct(blk.reshape(-1, 64))
            q = self.tables[min(ci, 1)].astype(np.float32)
            quant = np.copysign(np.floor(np.abs(f) / q + 0.5), f)
            self.coefs.append(quant[:, jpeg.ZIGZAG].astype(np.int64).reshape(
                blk.shape[0], blk.shape[1], 64))

    def scan_blocks(self, comps):
        """(N, 64) zig-zag blocks of a scan of components `comps` in stream
        order, each block's component, and blocks an MCU: one component
        covers its own ceil(width / 8) x ceil(height / 8) blocks, several
        the MCU grid (h x v blocks of each, row-major, in each MCU)."""
        if len(comps) == 1:
            ci = comps[0]
            h, v = self.factors[ci]
            bw = -(-(-(-self.width * h // self.hmax)) // 8)
            bh = -(-(-(-self.height * v // self.vmax)) // 8)
            zz = self.coefs[ci][:bh, :bw].reshape(-1, 64)
            return zz, np.full(len(zz), ci), 1
        parts, comp = [], []
        for ci in comps:
            h, v = self.factors[ci]
            parts.append(self.coefs[ci].reshape(
                self.mcuy, v, self.mcux, h, 64).transpose(0, 2, 1, 3, 4)
                .reshape(self.mcuy * self.mcux, v * h, 64))
            comp += [ci] * (v * h)
        zz = np.concatenate(parts, axis=1).reshape(-1, 64)
        return zz, np.tile(comp, self.mcuy * self.mcux), len(comp)

    def header(self, sof, ids=None, jfif=True, adobe=None, precision=8):
        """SOI, the JFIF and Adobe markers, both quantization tables and
        the frame header of marker `sof`."""
        ids = list(ids or range(1, len(self.coefs) + 1))
        out = _start(jfif, adobe)
        for ti, t in enumerate(self.tables):
            out.append(jpeg._segment(0xDB, bytes([ti]) + bytes(
                t[jpeg.ZIGZAG].astype(np.uint8))))
        out.append(jpeg._segment(sof, struct.pack(
            ">BHHB", precision, self.height, self.width, len(self.coefs))
            + b"".join(bytes([ids[ci], h << 4 | v, min(ci, 1)])
                       for ci, (h, v) in enumerate(self.factors))))
        return out, ids


def _huffman_tables():
    out = []
    for cls, tabs in ((0, (jpeg.DC_LUMA, jpeg.DC_CHROMA)),
                      (1, (jpeg.AC_LUMA, jpeg.AC_CHROMA))):
        for ti, (counts, symbols) in enumerate(tabs):
            out.append(jpeg._segment(0xC4, bytes([cls << 4 | ti])
                                     + bytes(counts) + bytes(symbols)))
    return out


def _sos(ids, comps, ss, se, ah, al):
    return jpeg._segment(0xDA, bytes([len(comps)]) + b"".join(
        bytes([ids[ci], 0x00 if ci == 0 else 0x11]) for ci in comps)
        + bytes([ss, se, ah << 4 | al]))


def jpeg_bytes(planes, factors, quality=90, adobe=None, jfif=True,
               ids=None, interleaved=True):
    """A baseline JPEG of full-size (H, W) uint8 sample planes, one a
    component, each sampled at its (h, v) factors (see _Image). `adobe`:
    an Adobe marker's colour transform (0 none, 1 YCbCr, 2 YCCK) or None;
    `ids`: the component ids (1, 2, ... by default); `interleaved=False`
    writes one scan a component."""
    im = _Image(planes, factors, quality)
    out, ids = im.header(0xC0, ids, jfif, adobe)
    out += _huffman_tables()
    n = len(planes)
    for comps in ([list(range(n))] if interleaved else [[c] for c in
                                                         range(n)]):
        zz, comp, _ = im.scan_blocks(comps)
        out.append(_sos(ids, comps, 0, 63, 0, 0)
                   + _entropy(zz, comp, np.minimum(comp, 1)))
    out.append(b"\xff\xd9")
    return b"".join(out)


def _shift(v, al):
    """Coefficients after the point transform Al (T.81 G.1.2.1: the DC an
    arithmetic shift, AC divided rounding toward zero)."""
    return np.sign(v) * (np.abs(v) >> al)


def simple_progression(n_comps):
    """libjpeg's jpeg_simple_progression script for 1 or 3 components:
    (components, Ss, Se, Ah, Al) a scan."""
    if n_comps == 1:
        return [([0], 0, 0, 0, 1), ([0], 1, 5, 0, 2), ([0], 6, 63, 0, 2),
                ([0], 1, 63, 2, 1), ([0], 0, 0, 1, 0), ([0], 1, 63, 1, 0)]
    every = list(range(n_comps))
    return [(every, 0, 0, 0, 1), ([0], 1, 5, 0, 2), ([2], 1, 63, 0, 1),
            ([1], 1, 63, 0, 1), ([0], 6, 63, 0, 2), ([0], 1, 63, 2, 1),
            (every, 0, 0, 1, 0), ([2], 1, 63, 1, 0), ([1], 1, 63, 1, 0),
            ([0], 1, 63, 1, 0)]


def progressive_jpeg_bytes(planes, factors, script, quality=90, ids=None):
    """A Huffman progressive JPEG (SOF2) of the scans `script` lists, each
    (components, Ss, Se, Ah, Al): DC first and refinement scans and AC
    first scans (the files a script that stops early writes, whose AC
    coefficients libjpeg's block smoothing estimates); an AC refinement
    scan is not written."""
    im = _Image(planes, factors, quality)
    out, ids = im.header(0xC2, ids)
    out += _huffman_tables()
    for comps, ss, se, ah, al in script:
        zz, comp, _ = im.scan_blocks(comps)
        if ss == 0 and ah:
            bits = (zz[:, 0] >> al) & 1
            data = _stuff(jpeg._pack_bits(bits, np.ones(len(bits), np.int64))
                          ) if len(bits) else b""
        elif ss == 0:
            data = _entropy(zz[:, :1] >> al, comp, np.minimum(comp, 1),
                            ss=1, se=0)
        elif ah == 0:
            data = _entropy(_shift(zz, al), comp, np.minimum(comp, 1),
                            dc=False, ss=ss, se=se)
        else:
            raise NotImplementedError("AC refinement scans are not written")
        out.append(_sos(ids, comps, ss, se, ah, al) + data)
    out.append(b"\xff\xd9")
    return b"".join(out)


# ----------------------------------------------------- arithmetic coding


class _QMEncoder:
    """libjpeg's jcarith.c arith_encode and finish_pass (T.81 D.1): `encode(
    bins, k, bit)` codes one decision with statistics bin bins[k] (state |
    MPS << 7, as io/jpeg_arith.py reads them); `finish()` returns the
    interval's stuffed bytes."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = (
            0, 0x10000, 0, 0, 11, -1)

    def _byte(self, v):
        self.out.append(v)
        if v == 0xFF:
            self.out.append(0)

    def _zeros(self):
        self.out.extend(b"\x00" * self.zc)
        self.zc = 0

    def _flush_stack(self):
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._zeros()
            self._byte(self.buffer)
        if self.sc:
            self._zeros()
            self.out.extend(b"\xff\x00" * self.sc)
            self.sc = 0

    def _carry(self):
        if self.buffer >= 0:
            self._zeros()
            self._byte(self.buffer + 1)
        self.zc += self.sc
        self.sc = 0

    def encode(self, bins, k, bit):
        sv = bins[k]
        qe, nl, nm = arith._STATES[sv & 0x7F]
        self.a -= qe
        if bit != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            bins[k] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            bins[k] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._carry()
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._flush_stack()
                    self.buffer = temp
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                return

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0x8000000:
            self._carry()
        else:
            self._flush_stack()
        if self.c & 0x7FFF800:
            self._zeros()
            self._byte((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._byte((self.c >> 11) & 0xFF)
        return bytes(self.out)


def _arith_ac_mag(enc, st, k, v, kx_bin):
    """An AC value's magnitude (|value| - 1 = v) from bin st[k]."""
    m = 0
    if v:
        enc.encode(st, k, 1)
        m = 1
        v2 = v >> 1
        if v2:
            enc.encode(st, k, 1)
            m = 2
            k = kx_bin
            v2 >>= 1
            while v2:
                enc.encode(st, k, 1)
                m <<= 1
                k += 1
                v2 >>= 1
    enc.encode(st, k, 0)
    k += 14
    while m > 1:
        m >>= 1
        enc.encode(st, k, 1 if v & m else 0)


def _arith_dc(enc, st, state, si, value, lower, upper):
    """One DC value (Figure F.4) against its component's prediction and
    context in `state` (lists last, ctx)."""
    last, ctx = state
    s0 = ctx[si]
    v = value - last[si]
    if v == 0:
        enc.encode(st, s0, 0)
        ctx[si] = 0
        return
    last[si] = value
    enc.encode(st, s0, 1)
    sign = int(v < 0)
    enc.encode(st, s0 + 1, sign)
    k = s0 + 2 + sign
    v = abs(v) - 1
    m = 0
    if v:
        enc.encode(st, k, 1)
        m = 1
        k = 20
        v2 = v >> 1
        while v2:
            enc.encode(st, k, 1)
            m <<= 1
            k += 1
            v2 >>= 1
    enc.encode(st, k, 0)
    if m < (1 << lower) >> 1:
        ctx[si] = 0
    elif m > (1 << upper) >> 1:
        ctx[si] = 12 + 4 * sign
    else:
        ctx[si] = 4 + 4 * sign
    k += 14
    while m > 1:
        m >>= 1
        enc.encode(st, k, 1 if v & m else 0)


def _arith_ac_first(enc, st, fixed, block, ss, se, kx):
    """One block's band ss..se of point-transformed coefficients (Figure
    F.5)."""
    nz = np.flatnonzero(block[ss:se + 1])
    ke = ss + int(nz[-1]) if len(nz) else ss - 1
    k = ss
    while k <= ke:
        b = 3 * (k - 1)
        enc.encode(st, b, 0)
        while block[k] == 0:
            enc.encode(st, b + 1, 0)
            b += 3
            k += 1
        enc.encode(st, b + 1, 1)
        v = int(block[k])
        enc.encode(fixed, 0, int(v < 0))
        _arith_ac_mag(enc, st, b + 2, abs(v) - 1, 189 if k <= kx else 217)
        k += 1
    if k <= se:
        enc.encode(st, 3 * (k - 1), 1)


def _arith_ac_refine(enc, st, fixed, block, ss, se, al):
    """One block's refinement of band ss..se at bit Al (Figure G.10, as
    jcarith.c codes it) from its full coefficients."""
    mag = np.abs(block)
    cur = mag >> al
    nz = np.flatnonzero(cur[1:se + 1])
    ke = int(nz[-1]) + 1 if len(nz) else 0
    nzx = np.flatnonzero((mag >> (al + 1))[1:ke + 1])
    kex = int(nzx[-1]) + 1 if len(nzx) else 0
    k = ss - 1
    while k < ke:
        b = 3 * k
        if k >= kex:
            enc.encode(st, b, 0)
        while True:
            k += 1
            v = int(cur[k])
            if v:
                if v >> 1:
                    enc.encode(st, b + 2, v & 1)
                else:
                    enc.encode(st, b + 1, 1)
                    enc.encode(fixed, 0, int(block[k] < 0))
                break
            enc.encode(st, b + 1, 0)
            b += 3
    if k < se:
        enc.encode(st, 3 * k, 1)


def arith_jpeg_bytes(planes, factors, quality=90, script=None,
                     conditioning=None, restart=0, ids=None, jfif=True):
    """An arithmetic-coded JPEG of the coefficients jpeg_bytes codes for
    the same arguments: sequential (SOF9, one interleaved scan) when
    `script` is None, else progressive (SOF10) by `script` (see
    simple_progression). `conditioning`: (L, U, Kx) written in a DAC
    marker for tables 0 and 1 (None: no marker, the defaults 0, 1, 5);
    `restart`: a restart interval in MCUs (0: none)."""
    im = _Image(planes, factors, quality)
    out, ids = im.header(0xC9 if script is None else 0xCA, ids, jfif)
    lower, upper, kx = conditioning or arith.DEFAULT_CONDITIONING
    if conditioning is not None:
        out.append(jpeg._segment(0xCC, bytes([0x00, upper << 4 | lower,
                                              0x01, upper << 4 | lower,
                                              0x10, kx, 0x11, kx])))
    if restart:
        out.append(jpeg._segment(0xDD, struct.pack(">H", restart)))
    progressive = script is not None
    every = list(range(len(planes)))
    for comps, ss, se, ah, al in script or [(every, 0, 63, 0, 0)]:
        zz, comp, per_mcu = im.scan_blocks(comps)
        step = restart * per_mcu or len(zz)
        fixed = [arith.FIXED_STATE]
        data = []
        for start in range(0, len(zz), step):
            if start:
                data.append(bytes([0xFF, 0xD0 + (start // step - 1) % 8]))
            enc = _QMEncoder()
            dc_st = [[0] * arith.DC_BINS for _ in range(2)]
            ac_st = [[0] * arith.AC_BINS for _ in range(2)]
            state = ([0] * len(every), [0] * len(every))
            for b in range(start, min(start + step, len(zz))):
                t = min(int(comp[b]), 1)
                blk = zz[b]
                if progressive and ss == 0 and ah:
                    enc.encode(fixed, 0, int(blk[0] >> al) & 1)
                    continue
                if ss == 0:
                    _arith_dc(enc, dc_st[t], state, int(comp[b]),
                              int(blk[0] >> al), lower, upper)
                if progressive and ss == 0:
                    continue
                if ah:
                    _arith_ac_refine(enc, ac_st[t], fixed, blk, ss, se, al)
                else:
                    _arith_ac_first(enc, ac_st[t], fixed, _shift(blk, al),
                                    max(ss, 1), se, kx)
            data.append(enc.finish())
        out.append(_sos(ids, comps, ss, se, ah, al) + b"".join(data))
    out.append(b"\xff\xd9")
    return b"".join(out)


# ------------------------------------------------------------- lossless

# A DC-class Huffman table for the difference categories 0-16 (16: the
# difference 32768, no extra bits)
LOSSLESS_TABLE = ([0, 1, 5] + [1] * 11 + [0, 0], list(range(17)))


def _predict(x, psv, first_rows, pt):
    """Each 8-bit sample's prediction (T.81 H.1.2.1, libjpeg's jdlossls.c):
    a row in `first_rows` predicts its first sample by 2^(8 - Pt - 1) and
    the others from the left; every other row predicts its first sample
    from above and the others by predictor `psv` (1-7) from the left (a),
    above (b) and upper-left (c) samples."""
    h, w = x.shape
    pred = np.zeros((h, w), np.int64)
    a = np.zeros_like(pred)
    b = np.zeros_like(pred)
    c = np.zeros_like(pred)
    a[:, 1:] = x[:, :-1]
    b[1:] = x[:-1]
    c[1:, 1:] = x[:-1, :-1]
    pred = {1: a, 2: b, 3: c, 4: a + b - c, 5: a + ((b - c) >> 1),
            6: b + ((a - c) >> 1), 7: (a + b) >> 1}[psv].copy()
    pred[:, 0] = b[:, 0]
    for r in first_rows:
        pred[r, 1:] = x[r, :-1]
        pred[r, 0] = 1 << (8 - pt - 1)
    return pred


def lossless_jpeg_bytes(planes, factors=None, predictor=1, pt=0,
                        restart_rows=0, ids=None, jfif=False, adobe=None,
                        interleaved=True):
    """A lossless JPEG (SOF3, Huffman) of full-size (H, W) uint8 sample
    planes, one a component, each sampled at its (h, v) factors (1-4,
    box-averaged; default 1x1) and shifted right by the point transform
    `pt`, coded with `predictor` (1-7). `restart_rows`: a restart interval
    of that many MCU rows (libjpeg reads a lossless file's restarts only
    at row boundaries); the rows after each restart start over as the
    scan's first row does. One interleaved scan, or one scan a component.
    `jfif` / `adobe` / `ids`: the markers and component ids that choose
    the colour space (io/jpeg.py _colour_space)."""
    planes = [np.asarray(p, np.uint8) for p in planes]
    factors = list(factors or [(1, 1)] * len(planes))
    height, width = planes[0].shape
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    ids = list(ids or range(1, len(planes) + 1))
    samples = [(_box_down(p, hmax // h, vmax // v) >> pt)
               for p, (h, v) in zip(planes, factors)]
    mcux, mcuy = -(-width // hmax), -(-height // vmax)
    out = _start(jfif, adobe)
    out.append(jpeg._segment(0xC3, struct.pack(
        ">BHHB", 8, height, width, len(planes)) + b"".join(
            bytes([ids[ci], h << 4 | v, 0])
            for ci, (h, v) in enumerate(factors))))
    counts, symbols = LOSSLESS_TABLE
    out.append(jpeg._segment(0xC4, bytes([0]) + bytes(counts)
                             + bytes(symbols)))
    codes = jpeg._code_arrays(LOSSLESS_TABLE)
    scans = [list(range(len(planes)))] if interleaved else [
        [c] for c in range(len(planes))]
    for comps in scans:
        one = len(comps) == 1
        per = []  # per component: its differences, MCU by MCU
        for ci in comps:
            x = samples[ci].astype(np.int64)
            h, v = (1, 1) if one else factors[ci]
            # the rows that start over: the first, and the first of each
            # iMCU row (factors[ci][1] rows) in which a restart falls
            vc = factors[ci][1]
            first = {r // vc * vc for r in range(
                0, x.shape[0], restart_rows * v or x.shape[0])}
            d = (x - _predict(x, predictor, first, pt)) & 0xFFFF
            # the scan's sample grid, dummy samples past the image coded 0
            gy, gx = x.shape if one else (mcuy * v, mcux * h)
            g = np.zeros((gy, gx), np.int64)
            g[:x.shape[0], :x.shape[1]] = np.where(d >= 0x8000, d - 0x10000,
                                                   d)
            per.append(g.reshape(gy // v, v, gx // h, h).transpose(
                0, 2, 1, 3).reshape(-1, v * h))
        diffs = np.concatenate(per, axis=1).reshape(-1)
        mcus_per_row = gx if one else mcux
        per_mcu = sum(p.shape[1] for p in per)
        size = np.where(diffs == -0x8000, 16, jpeg._bit_length(diffs))
        extra = np.where(size == 16, 0, size)
        mag = np.where(diffs < 0, diffs + (1 << extra) - 1, diffs)
        vals = codes[0][size] << extra | np.where(size == 16, 0, mag)
        lens = codes[1][size] + extra
        if restart_rows:
            out.append(jpeg._segment(0xDD, struct.pack(
                ">H", restart_rows * mcus_per_row)))
        step = restart_rows * mcus_per_row * per_mcu or len(diffs)
        body = []
        for i, start in enumerate(range(0, len(diffs), step)):
            if i:
                body.append(bytes([0xFF, 0xD0 + (i - 1) % 8]))
            body.append(_stuff(jpeg._pack_bits(vals[start:start + step],
                                               lens[start:start + step])))
        out.append(jpeg._segment(0xDA, bytes([len(comps)]) + b"".join(
            bytes([ids[ci], 0x00]) for ci in comps)
            + bytes([predictor, 0, pt])) + b"".join(body))
    out.append(b"\xff\xd9")
    return b"".join(out)


_SOF_MARKERS = set(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}


def _sof_at(data: bytes) -> int:
    """Byte index of the frame header's marker (0xFF, SOF0-15)."""
    i = 2
    while data[i + 1] not in _SOF_MARKERS:
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


# --- BMP ------------------------------------------------------------------

def _bmp_rle(idx, rle4, delta_row=None):
    """RLE8 / RLE4 stream of (h, w) indices, stored bottom row first: runs
    of equal pixels as encoded runs, mixed stretches of >= 3 pixels as
    absolute runs (word-aligned), an end of line after each row and an end
    of bitmap; `delta_row` (stored order) is skipped by a delta escape
    followed by two pad bytes, which PIL's decoder reads as the move."""
    out = bytearray()
    h, w = idx.shape
    for r, row in enumerate(idx[::-1]):
        if r == delta_row:
            out += bytes((0, 2, 0, 0, 0, 1))
            continue
        x = 0
        while x < w:
            run = 1
            while x + run < w and run < 255 and row[x + run] == row[x]:
                run += 1
            if run >= 3 or w - x < 3:
                v = row[x]
                out += bytes((run, (v << 4 | v) if rle4 else v))
                x += run
                continue
            n = 3
            def run_starts(i):
                return i + 2 < w and row[i] == row[i + 1] == row[i + 2]

            while (x + n < w and n < (254 if rle4 else 255)
                   and not run_starts(x + n)):
                n += 1
            if rle4 and n % 2:
                n -= 1  # PIL drops the odd pixel of an RLE4 absolute run
            if n < 3:
                out += bytes((1, row[x] << 4 if rle4 else row[x]))
                x += 1
                continue
            vals = row[x:x + n]
            body = (bytes(int(vals[i]) << 4 | int(vals[i + 1])
                          for i in range(0, n, 2)) if rle4
                    else bytes(int(v) for v in vals))
            out += bytes((0, n)) + body
            if len(body) % 2:
                out += b"\x00"
            x += n
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def bmp_bytes(pixels, bits, header=40, compression=0, palette=None,
              masks=None, top_down=False, colors=None, delta_row=None):
    """A BMP file: `pixels` (h, w) indices for bits <= 8 (`palette` (n, 3)
    RGB), (h, w) uint16 / uint32 words for 16 / 32 bits, (h, w, 3) RGB for
    24. `header` 12 (OS/2 core, 3-byte palette entries), 40, 52, 56, 64,
    108 or 124; `compression` 0 (BI_RGB), 1 / 2 (RLE8 / RLE4), 3
    (BI_BITFIELDS, `masks` (r, g, b[, a]): in the header from 52 bytes on,
    after a 40-byte one) or 6 (BI_ALPHABITFIELDS); `colors` the header's
    palette count (default the palette's length)."""
    pixels = np.asarray(pixels)
    h, w = pixels.shape[:2]
    if compression in (1, 2):
        body = _bmp_rle(pixels, compression == 2, delta_row)
    else:
        if bits < 8:
            per = 8 // bits
            padded = np.zeros((h, -(-w // per) * per), np.uint8)
            padded[:, :w] = pixels
            v = padded.reshape(h, -1, per).astype(np.uint16)
            rows = np.zeros(v.shape[:2], np.uint16)
            for k in range(per):
                rows |= v[..., k] << (8 - bits * (k + 1))
            rows = rows.astype(np.uint8)
        elif bits == 8:
            rows = pixels.astype(np.uint8)
        elif bits == 16:
            rows = pixels.astype("<u2").view(np.uint8).reshape(h, 2 * w)
        elif bits == 24:
            rows = pixels[..., ::-1].astype(np.uint8).reshape(h, 3 * w)
        else:
            rows = pixels.astype("<u4").view(np.uint8).reshape(h, 4 * w)
        stride = ((w * bits + 31) >> 3) & ~3
        full = np.zeros((h, stride), np.uint8)
        full[:, :rows.shape[1]] = rows
        body = (full if top_down else full[::-1]).tobytes()
    pal = b""
    n_colors = 0
    if palette is not None:
        palette = np.asarray(palette, np.uint8)
        n_colors = len(palette)
        ent = palette[:, ::-1]
        if header != 12:
            ent = np.concatenate([ent, np.zeros((n_colors, 1), np.uint8)], 1)
        pal = ent.tobytes()
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h,
                           1, bits, compression, len(body), 2835, 2835,
                           n_colors if colors is None else colors, 0)
        extra = b""
        if masks is not None:
            extra = struct.pack(f"<{len(masks)}I", *masks)
        if header >= 52:
            info += (extra + bytes(header))[:header - 40]
            extra = b""
        else:
            info += bytes(header - 40)
        info += extra
    offset = 14 + len(info) + len(pal)
    head = b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset)
    return head + info + pal + body


# --- GIF ------------------------------------------------------------------

def _lzw_codes(symbols, min_bits, early, deferred=False):
    """LZW code stream of `symbols` as (code, width) pairs, starting with
    a clear code. `early` widens one code early (TIFF); otherwise when the
    next free code reaches 1 << width (GIF, old-style TIFF). A full table
    gets a clear code, or with `deferred` stays full (GIF's deferred
    clear)."""
    clear = 1 << min_bits
    eoi = clear + 1
    out = []
    width = min_bits + 1
    table = {}
    nxt = clear + 2

    def reset():
        nonlocal table, nxt, width
        table = {(s,): s for s in range(clear)}
        nxt = clear + 2
        width = min_bits + 1

    reset()
    out.append((clear, width))
    cur = ()
    for s in symbols:
        cand = cur + (int(s),)
        if cand in table:
            cur = cand
            continue
        out.append((table[cur], width))
        if nxt < 4096:
            table[cand] = nxt
            nxt += 1
            # the entry just added is nxt - 1: TIFF widens after entry
            # 2**width - 1, GIF and old-style TIFF after entry 2**width
            if nxt - 1 + int(early) == 1 << width and width < 12:
                width += 1
            if early and nxt >= 4094:
                out.append((clear, width))
                reset()
        elif not deferred:
            out.append((clear, width))
            reset()
        cur = (int(s),)
    if cur:
        out.append((table[cur], width))
    out.append((eoi, width))
    return out


def _pack_lsb(codes):
    acc = nbits = 0
    out = bytearray()
    for code, width in codes:
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def _pack_msb(codes):
    acc = nbits = 0
    out = bytearray()
    for code, width in codes:
        acc = acc << width | code
        nbits += width
        while nbits >= 8:
            out.append(acc >> (nbits - 8) & 0xFF)
            nbits -= 8
    if nbits:
        out.append(acc << (8 - nbits) & 0xFF)
    return bytes(out)


def _sub_blocks(data):
    out = bytearray()
    for i in range(0, len(data), 255):
        chunk = data[i:i + 255]
        out += bytes((len(chunk),)) + chunk
    return bytes(out + b"\x00")


def gif_bytes(idx, min_bits=8, global_palette=None, local_palette=None,
              screen=None, origin=(0, 0), interlace=False, transparency=None,
              deferred_clear=False, background=0, version=b"GIF89a",
              second_frame=None):
    """A GIF whose first frame is the (h, w) indices `idx` at `origin` on
    a `screen` (w, h) (default the frame's size), with a global and / or
    local palette ((n, 3), n a power of two from 2), the 4-pass interlace,
    a transparency index (graphic control extension) and LZW codes of
    `min_bits` bits that clear the table when it fills, or with
    `deferred_clear` keep coding with the full table. `second_frame`
    appends another frame of the same size (decoders read the first)."""
    idx = np.asarray(idx)
    h, w = idx.shape
    sw, sh = screen or (w, h)

    def table_bits(p):
        n = len(p)
        return n.bit_length() - 2

    out = bytearray(version + struct.pack("<HH", sw, sh))
    flags = 0
    if global_palette is not None:
        flags = 0x80 | 0x70 | table_bits(global_palette)
    out += bytes((flags, background, 0))
    if global_palette is not None:
        out += np.asarray(global_palette, np.uint8).tobytes()

    def frame(ix, x0, y0, trns, pal):
        fo = bytearray()
        if trns is not None:
            fo += b"!\xf9\x04" + bytes((1,)) + b"\x00\x00" + bytes(
                (trns, 0))
        fh, fw = ix.shape
        lflags = 0x40 if interlace else 0
        if pal is not None:
            lflags |= 0x80 | table_bits(pal)
        fo += b"," + struct.pack("<HHHHB", x0, y0, fw, fh, lflags)
        if pal is not None:
            fo += np.asarray(pal, np.uint8).tobytes()
        rows = ix
        if interlace:
            order = np.concatenate([np.arange(0, fh, 8), np.arange(4, fh, 8),
                                    np.arange(2, fh, 4), np.arange(1, fh, 2)])
            rows = ix[order]
        codes = _lzw_codes(rows.reshape(-1), min_bits, early=False,
                           deferred=deferred_clear)
        fo += bytes((min_bits,)) + _sub_blocks(_pack_lsb(codes))
        return bytes(fo)

    out += frame(idx, origin[0], origin[1], transparency, local_palette)
    if second_frame is not None:
        out += frame(np.asarray(second_frame), 0, 0, None, None)
    return bytes(out + b";")


# --- TIFF -----------------------------------------------------------------

def _packbits(data):
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 2:
            out += bytes(((257 - run) & 0xFF, data[i]))
            i += run
            continue
        j = i + 1
        while j < n and j - i < 128 and not (j + 1 < n
                                             and data[j] == data[j + 1]):
            j += 1
        out += bytes((j - i - 1,)) + bytes(data[i:j])
        i = j
    return bytes(out)


def _tiff_compress(raw, compression, old_lzw=False):
    if compression == 1:
        return raw
    if compression == 5:
        if old_lzw:
            return _pack_lsb(_lzw_codes(raw, 8, early=False))
        return _pack_msb(_lzw_codes(raw, 8, early=True))
    if compression in (8, 32946):
        return zlib.compress(raw, 6)
    if compression == 32773:
        return _packbits(raw)
    if compression == 34925:
        import lzma

        return lzma.compress(raw, format=lzma.FORMAT_XZ)
    return raw  # a payload for a form the reader refuses


def _pack_samples(block, bits, order):
    """(rows, cols, spp) samples -> row-padded bytes: unsigned ints at 1-32
    bits, or a float32 / int32 array at 32 bits as it is."""
    rows, cols, spp = block.shape
    if bits == 8:
        return block.astype(np.uint8).tobytes()
    if bits == 16:
        return block.astype(order + "u2").tobytes()
    if bits == 32:
        kind = {"f": "f4", "i": "i4"}.get(block.dtype.kind, "u4")
        return block.astype(order + kind).tobytes()
    flat = block.reshape(rows, cols * spp).astype(np.uint32)
    nbits = cols * spp * bits
    out = np.zeros((rows, (nbits + 7) // 8 * 8), np.uint8)
    for b in range(bits):
        out[:, np.arange(cols * spp) * bits + b] = (
            flat >> (bits - 1 - b) & 1)
    return np.packbits(out, axis=1).tobytes()


def _float_predict(raw, rows, cols, spp, nbytes, order):
    """libtiff's floating-point predictor (3) on a chunk: each row's samples
    split into byte planes, most significant first, then differenced byte
    by byte at a stride of the samples a pixel."""
    a = np.frombuffer(raw, np.uint8).reshape(rows, cols * spp, nbytes)
    if order == "<":
        a = a[..., ::-1]
    planes = a.transpose(0, 2, 1).reshape(rows, -1).astype(np.int64)
    d = planes.copy()
    d[:, spp:] -= planes[:, :-spp]
    return (d & 0xFF).astype(np.uint8).tobytes()


def ycbcr_units(samples, sub):
    """libtiff's chunky YCbCr layout for subsampling `sub` (h, v): for each
    h x v block of (H, W, 3) samples, its h * v Y samples row by row, then
    the Cb and Cr of its top-left pixel; edge blocks padded by
    replication. (rows of units, bytes a row)."""
    sh, sv = sub
    h, w, _ = samples.shape
    ph, pw = -(-h // sv) * sv, -(-w // sh) * sh
    pad = np.pad(samples, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
    blk = pad.reshape(ph // sv, sv, pw // sh, sh, 3).transpose(0, 2, 1, 3, 4)
    y = blk[..., 0].reshape(ph // sv, pw // sh, sv * sh)
    c = blk[:, :, 0, 0, 1:]
    return np.concatenate([y, c], -1).astype(np.uint8).reshape(ph // sv, -1)


def tiff_container(chunks, tags, byteorder="II", bigtiff=False):
    """A one-IFD TIFF (or BigTIFF, version 43 with 8-byte offsets, counts
    and LONG8 offset fields) of the stored `chunks` and `tags` {tag: (type,
    values)}; the chunks' offsets and byte counts are added as
    StripOffsets / StripByteCounts unless TileWidth is among the tags."""
    order = "<" if byteorder == "II" else ">"
    tags = dict(tags)
    off_tag, cnt_tag = (324, 325) if 322 in tags else (273, 279)
    data_start = 16 if bigtiff else 8
    offsets = []
    blob = bytearray()
    for c in chunks:
        offsets.append(data_start + len(blob))
        blob += c
        if len(blob) % 2:
            blob += b"\x00"
    long_t = 16 if bigtiff else 4
    tags[off_tag] = (long_t, offsets)
    tags[cnt_tag] = (long_t, [len(c) for c in chunks])
    ifd_at = data_start + len(blob)
    n = len(tags)
    entry, field_size = (20, 8) if bigtiff else (12, 4)
    ext_at = ifd_at + (8 if bigtiff else 2) + entry * n + field_size
    ifd = bytearray(struct.pack(order + ("Q" if bigtiff else "H"), n))
    ext = bytearray()
    fmts = {1: "B", 2: "B", 3: "H", 4: "I", 5: "I", 7: "B", 8: "h", 9: "i",
            10: "i", 11: "f", 12: "d", 16: "Q", 17: "q", 18: "Q"}
    for tag in sorted(tags):
        typ, vals = tags[tag]
        if isinstance(vals, (bytes, bytearray)):
            vals = list(vals)
        if typ in (5, 10):  # rationals as (numerator, denominator) pairs
            count = len(vals) // 2
        else:
            count = len(vals)
        body = struct.pack(order + fmts[typ] * len(vals), *vals)
        if len(body) <= field_size:
            field = body + bytes(field_size - len(body))
        else:
            field = struct.pack(order + ("Q" if bigtiff else "I"),
                                ext_at + len(ext))
            ext += body
            if len(ext) % 2:
                ext += b"\x00"
        ifd += struct.pack(order + ("HHQ" if bigtiff else "HHI"), tag, typ,
                           count) + field
    ifd += struct.pack(order + ("Q" if bigtiff else "I"), 0)
    magic = b"II" if byteorder == "II" else b"MM"
    if bigtiff:
        head = magic + struct.pack(order + "HHHQ", 43, 8, 0, ifd_at)
    else:
        head = magic + struct.pack(order + "HI", 42, ifd_at)
    return head + bytes(blob) + bytes(ifd) + bytes(ext)


def tiff_bytes(samples, bits, photometric, byteorder="II", compression=1,
               predictor=1, planar=1, rows_per_strip=None, tile=None,
               extra=None, colormap=None, fillorder=1, old_lzw=False,
               sample_format=None, orientation=None, bigtiff=False,
               ycbcr=None, tags=None):
    """A one-IFD TIFF of `samples` (h, w, spp) unsigned ints at `bits`
    bits a sample (or a float32 / int32 array at 32 bits): `photometric`
    0-8 (3 takes `colormap` (3, 2**bits) 16-bit entries), `extra` the
    ExtraSamples values, `compression` 1, 5 (LZW; `old_lzw` the LSB-first
    old style), 8 / 32946 (Deflate), 32773 (PackBits), 34925 (LZMA) or any
    other number (its payload left raw), `predictor` 2 (horizontal
    differencing at 8, 16 and 32 bits) or 3 (floating point), `planar` 2
    for one plane a sample, strips of `rows_per_strip` or tiles of `tile`
    (tw, th) (edge tiles padded), FillOrder 2 (bits of every stored byte
    reversed), a SampleFormat and an Orientation tag where given, BigTIFF
    with `bigtiff`, chunky YCbCr units at subsampling `ycbcr` (h, v) (the
    YCbCrSubsampling tag written; rows a strip in units), and any other
    `tags` {tag: (type, values)}. `byteorder` "II" or "MM"."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, spp = samples.shape
    order = "<" if byteorder == "II" else ">"
    per = spp if planar == 1 else 1

    def diff(block):
        if predictor != 2:
            return block
        if block.dtype.kind in "fi" and bits == 32:
            block = block.view(np.uint32)  # difference the words' bits
        d = block.astype(np.int64)
        d[:, 1:] -= block[:, :-1].astype(np.int64)
        return d & ((1 << bits) - 1)

    def pack(block):
        raw = _pack_samples(diff(block), bits, order)
        if predictor == 3:
            raw = _float_predict(raw, block.shape[0], block.shape[1], per,
                                 bits // 8, order)
        return raw

    planes = [samples] if planar == 1 else [samples[..., k:k + 1]
                                             for k in range(spp)]
    chunks = []
    if ycbcr is not None:
        units = ycbcr_units(samples, ycbcr)
        rps = -(-(rows_per_strip or h) // ycbcr[1])
        chunks = [units[y:y + rps].tobytes()
                  for y in range(0, units.shape[0], rps)]
    elif tile is None:
        rps = rows_per_strip or h
        for plane in planes:
            for y in range(0, h, rps):
                chunks.append(pack(plane[y:y + rps]))
    else:
        tw, th = tile
        for plane in planes:
            for y in range(0, h, th):
                for x in range(0, w, tw):
                    blk = np.zeros((th, tw, plane.shape[2]), plane.dtype)
                    part = plane[y:y + th, x:x + tw]
                    blk[:part.shape[0], :part.shape[1]] = part
                    chunks.append(pack(blk))
    chunks = [_tiff_compress(c, compression, old_lzw) for c in chunks]
    if fillorder == 2:
        rev = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                            axis=1)[:, ::-1]
        lut = np.packbits(rev, axis=1)[:, 0]
        chunks = [lut[np.frombuffer(c, np.uint8)].tobytes() for c in chunks]

    long_t = 16 if bigtiff else 4
    out = {256: (long_t, [w]), 257: (long_t, [h]), 258: (3, [bits] * spp),
           259: (3, [compression]), 262: (3, [photometric]),
           277: (3, [spp]), 284: (3, [planar])}
    if fillorder != 1:
        out[266] = (3, [fillorder])
    if predictor != 1:
        out[317] = (3, [predictor])
    if extra is not None:
        out[338] = (3, list(extra))
    if colormap is not None:
        out[320] = (3, list(np.asarray(colormap).reshape(-1)))
    if sample_format is not None:
        out[339] = (3, [sample_format] * spp)
    if orientation is not None:
        out[274] = (3, [orientation])
    if ycbcr is not None:
        out[530] = (3, list(ycbcr))
    if tile is None:
        out[278] = (long_t, [rows_per_strip or h])
    else:
        out[322] = (long_t, [tile[0]])
        out[323] = (long_t, [tile[1]])
    out.update(tags or {})
    return tiff_container(chunks, out, byteorder, bigtiff)


def _jpeg_segments(stream):
    """[(marker, segment bytes)] of a JPEG stream up to its first SOS; the
    SOS and what follows it as the last item (marker 0xDA)."""
    out, i = [], 2
    while i < len(stream):
        marker = stream[i + 1]
        if marker == 0xDA:
            out.append((marker, stream[i:]))
            break
        n = struct.unpack(">H", stream[i + 2:i + 4])[0]
        out.append((marker, stream[i:i + 2 + n]))
        i += 2 + n
    return out


def jpeg_tiff_bytes(planes, photometric, rows_per_strip, factors=None,
                    quality=85, split_tables=True, tile=None):
    """A JPEG-in-TIFF (compression 7) file of full-size (H, W) uint8
    planes (1 grey, or 3: RGB for photometric 2, YCbCr for 6), each strip
    (or `tile` (tw, th), edge tiles padded) a baseline JPEG of those
    planes at `factors` (jpeg_bytes, no JFIF marker); with `split_tables`
    its quantization and Huffman tables go to JPEGTables (347) and the
    strips are abbreviated streams, as libtiff writes them. A photometric
    6 file carries YCbCrSubsampling from the factors."""
    planes = [np.asarray(p) for p in planes]
    h, w = planes[0].shape
    factors = factors or [(1, 1)] * len(planes)
    if tile is None:
        boxes = [(y, 0, min(rows_per_strip, h - y), w)
                 for y in range(0, h, rows_per_strip)]
    else:
        tw, th = tile
        boxes = [(y, x, th, tw) for y in range(0, h, th)
                 for x in range(0, w, tw)]
    chunks, tables = [], b""
    for y, x, bh, bw in boxes:
        parts = []
        for p in planes:
            blk = np.zeros((bh, bw), np.uint8)
            part = p[y:y + bh, x:x + bw]
            blk[:part.shape[0], :part.shape[1]] = part
            parts.append(blk)
        stream = jpeg_bytes(parts, factors, quality, jfif=False)
        if split_tables:
            segs = _jpeg_segments(stream)
            tables = b"\xff\xd8" + b"".join(
                seg for m, seg in segs if m in (0xDB, 0xC4)) + b"\xff\xd9"
            stream = b"\xff\xd8" + b"".join(
                seg for m, seg in segs if m not in (0xDB, 0xC4))
        chunks.append(stream)
    n = len(planes)
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * n),
            259: (3, [7]), 262: (3, [photometric]), 277: (3, [n]),
            284: (3, [1])}
    if tile is None:
        tags[278] = (4, [rows_per_strip])
    else:
        tags[322], tags[323] = (4, [tile[0]]), (4, [tile[1]])
    if tables:
        tags[347] = (7, tables)
    if photometric == 6:
        hmax = max(f[0] for f in factors)
        vmax = max(f[1] for f in factors)
        tags[530] = (3, [hmax // factors[1][0], vmax // factors[1][1]])
    return tiff_container(chunks, tags)


def ojpeg_tiff_bytes(stream, width, height, subsampling=(2, 2),
                     tags=None):
    """An old-style JPEG-in-TIFF (compression 6) file: one JPEG stream
    (a whole JFIF file), pointed at by JPEGInterchangeFormat (513) and its
    length (514) and by the one strip, photometric 6 and the stream's
    YCbCrSubsampling, as writers of the old form made them."""
    out = {256: (4, [width]), 257: (4, [height]), 258: (3, [8, 8, 8]),
           259: (3, [6]), 262: (3, [6]), 277: (3, [3]), 278: (4, [height]),
           284: (3, [1]), 513: (4, [8]), 514: (4, [len(stream)]),
           530: (3, list(subsampling))}
    out.update(tags or {})
    return tiff_container([stream], out)


def webp_tiff_bytes(strips, width, height, rows_per_strip, alpha=False):
    """A WebP-in-TIFF (compression 50001) file whose strips are the given
    WebP files, RGB or RGBA (`alpha`, ExtraSamples 2)."""
    n = 4 if alpha else 3
    tags = {256: (4, [width]), 257: (4, [height]), 258: (3, [8] * n),
            259: (3, [50001]), 262: (3, [2]), 277: (3, [n]),
            278: (4, [rows_per_strip]), 284: (3, [1])}
    if alpha:
        tags[338] = (3, [2])
    return tiff_container(list(strips), tags)


# --- WebP -----------------------------------------------------------------

def riff_chunks(data: bytes):
    """[(fourcc, body)] of a WebP file's chunks."""
    out = []
    pos, end = 12, 8 + struct.unpack_from("<I", data, 4)[0]
    while pos + 8 <= end:
        tag = data[pos:pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        out.append((tag, data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def _chunk_le(tag: bytes, body: bytes) -> bytes:
    return tag + struct.pack("<I", len(body)) + body + b"\x00" * (
        len(body) & 1)


def webp_file(chunks) -> bytes:
    """A RIFF WebP file of [(fourcc, body)] chunks."""
    body = b"WEBP" + b"".join(_chunk_le(t, b) for t, b in chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def webp_anim_bytes(frames, canvas, background=(0, 0, 0, 0), alpha=True):
    """An animated WebP: `frames` [(image chunks of a still WebP (ALPH +
    'VP8 ' or 'VP8L'), (x, y) even offset, (w, h))] on a `canvas` (w, h)
    with ANIM's `background` colour (r, g, b, a) — which decoders of the
    first frame ignore — and the VP8X alpha flag."""
    cw, ch = canvas
    flags = 0x02 | (0x10 if alpha else 0)
    vp8x = bytes((flags, 0, 0, 0)) + (cw - 1).to_bytes(3, "little") + (
        ch - 1).to_bytes(3, "little")
    r, g, b, a = background
    out = [(b"VP8X", vp8x), (b"ANIM", bytes((b, g, r, a)) + b"\x00\x00")]
    for chunks, (x, y), (w, h) in frames:
        head = ((x // 2).to_bytes(3, "little") + (y // 2).to_bytes(3, "little")
                + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")
                + (100).to_bytes(3, "little") + b"\x00")
        out.append((b"ANMF", head + b"".join(_chunk_le(t, bd)
                                             for t, bd in chunks)))
    return webp_file(out)


# --- VP8 header variants --------------------------------------------------

class BoolEncoder:
    """The VP8 boolean encoder (RFC 6386 7.3)."""

    def __init__(self):
        self.out = bytearray()
        self.range = 255
        self.bottom = 0
        self.bit_count = 24

    def _carry(self):
        i = len(self.out) - 1
        while i >= 0 and self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, prob, bit):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if self.bit_count == 0:
                self.out.append((self.bottom >> 24) & 0xFF)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def value(self, v, n):
        for i in range(n - 1, -1, -1):
            self.put(128, (v >> i) & 1)

    def signed(self, v, n):
        self.value(abs(v), n)
        self.put(128, int(v < 0))

    def flag_signed(self, v, n):
        self.put(128, int(v != 0))
        if v:
            self.signed(v, n)

    def flush(self):
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def vp8_variant(webp: bytes, simple=None, sharpness=None, n_parts=None,
                lf_deltas=None, relative_segments=False) -> bytes:
    """A lossy WebP (no alpha) re-coded with header fields libwebp's
    encoder never sets through PIL: the simple loop filter, a sharpness,
    reference / mode loop-filter deltas ((ref[4], mode[4])), 2-8 token
    partitions (rows dealt out by mb_y & (n - 1)), segment quantizers and
    filter strengths relative to the frame's. Every macroblock decision is
    carried over as decoded (the port's decoder, recording each boolean
    decision and its probability), so the pixels change only through the
    changed fields."""
    from voidin_tpu_torch.io import webp as W

    chunk = dict(riff_chunks(webp))[b"VP8 "]

    class Recorder(W._Bool):
        """Logs each decision; in partition 0 notes where the quantizer
        fields start (after the header's only 2-bit value, the partition
        count) and the base quantizer index (the 7-bit value after it)."""

        def __init__(self, data):
            super().__init__(data)
            self.log = []
            self.quant_start = self.base_q = None

        def bit(self, prob):
            b = super().bit(prob)
            self.log.append((prob, b))
            return b

        def value_bits(self, n):
            v = super().value_bits(n)
            if n == 2 and self.quant_start is None:
                self.quant_start = len(self.log)
            elif n == 7 and self.quant_start is not None \
                    and self.base_q is None:
                self.base_q = v
            return v

    class Rows(list):
        """The token partitions, noting where each macroblock row starts."""
        starts = []

        def __getitem__(self, i):
            part = super().__getitem__(i)
            Rows.starts.append((i, len(part.log)))
            return part

    frames = []

    class Frame(W._VP8Frame):
        def __init__(self, data):
            super().__init__(data)
            self.header_end = len(self.br.log)
            self.parts = Rows(self.parts)
            frames.append(self)

    saved = W._Bool, W._VP8Frame
    W._Bool, W._VP8Frame = Recorder, Frame
    Rows.starts = []
    try:
        W._decode_vp8_planes(chunk)
    finally:
        W._Bool, W._VP8Frame = saved
    fr = frames[0]
    # each row's token decisions
    rows = []
    for k, (p, start) in enumerate(Rows.starts):
        log = list.__getitem__(fr.parts, p).log
        nxt = [s for q, s in Rows.starts[k + 1:] if q == p]
        rows.append(log[start:nxt[0] if nxt else len(log)])

    enc = BoolEncoder()
    enc.put(128, 0)
    enc.put(128, 0)
    enc.put(128, fr.use_segment)
    if fr.use_segment:
        enc.put(128, fr.update_map)
        enc.put(128, 1)  # segment data follows
        rel = relative_segments
        enc.put(128, 0 if rel else fr.absolute)
        base = fr.br.base_q
        for q in fr.seg_q:
            enc.flag_signed(q - base if rel and fr.absolute else q, 7)
        for f in fr.seg_f:
            enc.flag_signed(f - fr.level if rel and fr.absolute else f, 6)
        if fr.update_map:
            for p in fr.seg_probs:
                enc.put(128, int(p != 255))
                if p != 255:
                    enc.value(p, 8)
    enc.put(128, fr.simple if simple is None else int(simple))
    enc.value(fr.level, 6)
    enc.value(fr.sharpness if sharpness is None else sharpness, 3)
    ref, mode = ((fr.ref_lf, fr.mode_lf) if lf_deltas is None
                 else lf_deltas)
    use = fr.use_lf_delta or lf_deltas is not None
    enc.put(128, int(use))
    if use:
        enc.put(128, 1)
        for v in list(ref) + list(mode):
            enc.flag_signed(v, 6)
    parts = n_parts or list.__len__(fr.parts)
    enc.value(parts.bit_length() - 1, 2)
    # the rest of partition 0 as decoded: quantizers, probabilities, modes
    for prob, b in fr.br.log[fr.br.quant_start:]:
        enc.put(prob, b)
    part0 = enc.flush()
    tokens = []
    for k in range(parts):
        te = BoolEncoder()
        for y, row in enumerate(rows):
            if y & (parts - 1) == k:
                for prob, b in row:
                    te.put(prob, b)
        tokens.append(te.flush())
    bits = (chunk[0] | chunk[1] << 8 | chunk[2] << 16) & 0x1F
    tag = bits | len(part0) << 5
    sizes = b"".join(len(t).to_bytes(3, "little") for t in tokens[:-1])
    body = (tag.to_bytes(3, "little") + chunk[3:10] + part0 + sizes
            + b"".join(tokens))
    return webp_file([(b"VP8 ", body)])


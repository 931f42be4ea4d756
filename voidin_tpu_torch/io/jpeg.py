"""JPEG encoder (baseline JFIF) and decoder in numpy, without PIL.

The JAX package writes and reads JPEG through PIL (``io/avi.py``'s
recorder frames, ``io/gltf.py``'s textures, the presets' texture files).
The port's hosts have no PIL, so this module carries a codec of its own:

* ``encode_jpeg`` writes an RGB image as baseline JFIF (SOF0) as PIL's
  ``Image.save(..., "JPEG", quality=q)`` does: the Annex K quantization
  tables scaled by quality as libjpeg scales them, libjpeg's fixed-point
  RGB -> YCbCr, chroma at 4:2:0 (PIL's default) averaged with libjpeg's
  alternating bias, the standard Annex K Huffman tables. The DCT is float; the entropy coder works on arrays of
  all the symbols of the image at once (no Python loop per coefficient).
* ``decode_jpeg`` reads every 8-bit file PIL reads: baseline,
  extended-sequential and progressive (SOF0 / SOF1 / SOF2), lossless
  (SOF3), and arithmetic-coded sequential and progressive (SOF9 / SOF10,
  io/jpeg_arith.py, with the DAC marker's conditioning); greyscale,
  YCbCr, RGB, CMYK and YCCK; sampling factors 1-4 in each direction that
  divide the largest (4:4:4, 4:2:2, 4:2:0, 4:4:0, true 4:1:1, ...);
  interleaved and single-component scans, Huffman tables redefined
  between scans, restart intervals, any size. Progressive files take DC
  and AC first and refinement scans: spectral selection, successive
  approximation, EOB runs and the refinement scans' correction bits. It
  follows libjpeg(-turbo)'s defaults, so its pixels match PIL's: the
  integer ("islow") IDCT with its range-limit table; block smoothing of a
  progressive file whose scans leave any of coefficients 1-9 not fully
  known (a file cut short, a DC-only or unrefined script): libjpeg-turbo
  3's estimate from the 5x5 neighbourhood of DC values; the fancy
  (triangle) upsamplers for h2v1 and h2v2 on components wider than 2 and
  for h1v2, replication otherwise, edge rows and columns repeated;
  libjpeg's reading of the colour space (JFIF, then the Adobe transform,
  then the component ids) and its fixed-point YCbCr -> RGB; and a CMYK
  file read as PIL reads it (inverted, Adobe's polarity) and taken to RGB
  by PIL's CMYK -> RGBA. A lossless file's predictors 1-7 and point
  transform are undone as libjpeg-turbo does, its components upsampled by
  replication and its colours left as they are (RGB without a marker).
* Refused with NotImplementedError naming the file, as PIL refuses them:
  12-bit (and any other than 8-bit) samples, hierarchical (SOF5-7,
  SOF13-15) and arithmetic-coded lossless (SOF11) files, a height set by
  DNL, 2 components, a lossless file in YCbCr or YCCK (libjpeg-turbo does
  not convert a lossless file's colours) or whose restart interval is not
  a whole number of MCU rows. An interleaved MCU of more than 10 blocks
  raises ValueError, as libjpeg refuses it.

The Huffman decode walks the symbols in a Python loop, but every bit
position's code length and symbol is looked up for all positions at once
beforehand, so the loop does one table read a symbol (sequential and
progressive first scans). A progressive AC refinement scan also reads one
correction bit for every nonzero coefficient a symbol passes: its loop
finds where a symbol lands from each block's running counts of zero and
nonzero coefficients, one lookup a symbol, and the correction bits are
gathered afterwards in one pass. A lossless scan walks its samples the
same way, one table read a sample, then undoes predictors 1, 2 and 4 as
cumulative sums and the others one anti-diagonal at a time. An
arithmetic-coded scan decodes one binary decision a Python call
(io/jpeg_arith.py).
"""

from __future__ import annotations

import struct

import numpy as np

from voidin_tpu_torch.io import jpeg_arith

SOI = b"\xff\xd8"

# Zig-zag position -> natural (row-major) index within the 8x8 block.
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])

# Annex K.1 quantization tables, natural order.
LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
])
CHROMA_QUANT = np.full(64, 99)
CHROMA_QUANT[:32] = [
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
]


# Annex K.3 Huffman tables: (code counts by length 1-16, symbols).
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
])
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
])

def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """`base` scaled by quality as libjpeg's jpeg_set_quality does
    (baseline: entries clamped to 1-255)."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255)


def huffman_codes(counts, symbols):
    """Canonical codes (Annex C): {symbol: (code, length)}."""
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def _code_arrays(table):
    """(code, length) arrays indexed by symbol 0-255."""
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    for s, (c, n) in huffman_codes(*table).items():
        code[s], length[s] = c, n
    return code, length


def _bit_length(v):
    """Bits of |v| (the JPEG magnitude category), elementwise."""
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)


def _fixed(x):
    return int(x * 65536 + 0.5)


def _rgb_to_ycc(rgb):
    """libjpeg's jccolor.c RGB -> YCbCr in 16-bit fixed point."""
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    half, off = 1 << 15, 128 << 16
    y = (_fixed(0.299) * r + _fixed(0.587) * g + _fixed(0.114) * b
         + half) >> 16
    cb = (-_fixed(0.16874) * r - _fixed(0.33126) * g + _fixed(0.5) * b
          + off + half - 1) >> 16
    cr = (_fixed(0.5) * r - _fixed(0.41869) * g - _fixed(0.08131) * b
          + off + half - 1) >> 16
    return y, cb, cr


def _downsample(plane):
    """libjpeg's h2v2 averaging with its alternating bias (1, 2, 1, ...)."""
    bias = 1 + (np.arange(plane.shape[1] // 2) & 1)
    return (plane[0::2, 0::2] + plane[0::2, 1::2] + plane[1::2, 0::2]
            + plane[1::2, 1::2] + bias) >> 2


def _dct_matrix():
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    t = np.cos((2 * x + 1) * u * np.pi / 16) * np.sqrt(2 / 8)
    t[0] = np.sqrt(1 / 8)
    return t


# The 2-D DCT T f T^T as one (64, 64) operator on row-major blocks.
_DCT64 = np.kron(_dct_matrix(), _dct_matrix()).T.astype(np.float32)


def _fdct(blocks):
    """(N, 64) level-shifted samples -> (N, 64) DCT coefficients."""
    return blocks @ _DCT64


def _blocks(plane):
    """(rows, cols) with both multiples of 8 -> (rows/8, cols/8, 64)."""
    r, c = plane.shape
    return plane.reshape(r // 8, 8, c // 8, 8).swapaxes(1, 2).reshape(
        r // 8, c // 8, 64)


def _pack_bits(values, lengths):
    """Concatenate the big-endian bit strings values[i] (lengths[i] <= 32
    bits each) into bytes; the last byte is padded with 1 bits."""
    offsets = np.cumsum(lengths) - lengths
    total = int(lengths.sum())
    n_bytes = -(-total // 8)
    start = offsets >> 3
    aligned = values.astype(np.int64) << (40 - (offsets & 7) - lengths)
    out = np.zeros(n_bytes + 5, np.int64)
    for j in range(5):
        out += np.bincount(start + j, weights=(aligned >> (32 - 8 * j)) & 255,
                           minlength=n_bytes + 5).astype(np.int64)
    out = out[:n_bytes]
    if total % 8:
        out[-1] |= (1 << (8 - total % 8)) - 1
    return out.astype(np.uint8)


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def encode_jpeg(img: np.ndarray, quality: int = 92) -> bytes:
    """An (H, W, 3) uint8 RGB image as baseline JFIF bytes, YCbCr at
    4:2:0 (see the module docstring)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes (H, W, 3) uint8 images, got "
                         f"{img.shape} {img.dtype}")
    height, width = img.shape[:2]
    if not (0 < height < 65536 and 0 < width < 65536):
        raise ValueError(f"JPEG sizes are 1-65535, got {width}x{height}")
    # whole 16x16 MCUs, the right and bottom edges repeated
    mcux, mcuy = -(-width // 16), -(-height // 16)
    y, cb, cr = _rgb_to_ycc(np.pad(
        img, ((0, 16 * mcuy - height), (0, 16 * mcux - width), (0, 0)),
        mode="edge"))
    tables = [quant_table(LUMA_QUANT, quality),
              quant_table(CHROMA_QUANT, quality)]

    # per component (plane, its blocks per MCU side): the blocks' quantized
    # zig-zag coefficients and their positions in the scan (MCU order, the
    # component's blocks row-major within each MCU)
    coefs, order = [], []
    n_before = 0
    for ci, (plane, n) in enumerate(((y, 2), (_downsample(cb), 1),
                                     (_downsample(cr), 1))):
        blk = _blocks(plane.astype(np.float32) - 128.0)
        by, bx = blk.shape[:2]
        f = _fdct(blk.reshape(-1, 64))
        q = tables[min(ci, 1)].astype(np.float32)
        quant = np.copysign(np.floor(np.abs(f) / q + 0.5), f)
        coefs.append(quant[:, ZIGZAG].astype(np.int64))
        idx = np.arange(by * bx).reshape(mcuy, n, mcux, n).transpose(
            0, 2, 1, 3).reshape(mcuy, mcux, n * n) + n_before
        order.append(idx)
        n_before += by * bx
    scan = np.concatenate(order, axis=2).reshape(-1)
    comp = np.concatenate([np.full(len(c), i) for i, c in enumerate(coefs)])
    zz = np.concatenate(coefs)[scan]
    comp = comp[scan]
    table_of = np.minimum(comp, 1)  # component 0 luma tables, 1-2 chroma

    # DC: differences from the previous block of the same component
    dc = zz[:, 0]
    diff = np.empty_like(dc)
    for ci in range(3):
        sel = comp == ci
        diff[sel] = np.diff(dc[sel], prepend=0)
    dc_codes = [_code_arrays(DC_LUMA), _code_arrays(DC_CHROMA)]
    ac_codes = [_code_arrays(AC_LUMA), _code_arrays(AC_CHROMA)]

    def coded(codes, table, symbol, mag, size):
        code = np.where(table == 0, codes[0][0][symbol], codes[1][0][symbol])
        length = np.where(table == 0, codes[0][1][symbol],
                          codes[1][1][symbol])
        mag_bits = np.where(mag < 0, mag + (1 << size) - 1, mag)
        return (code << size) | mag_bits, length + size

    n_blocks = len(zz)
    dc_size = _bit_length(diff)
    dc_val, dc_len = coded(dc_codes, table_of, dc_size, diff, dc_size)

    blk, k = np.nonzero(zz[:, 1:])
    k = k + 1
    ac = zz[blk, k]
    first = np.ones(len(blk), bool)
    first[1:] = blk[1:] != blk[:-1]
    prev_k = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev_k - 1
    size = _bit_length(ac)
    ac_val, ac_len = coded(ac_codes, table_of[blk], (run & 15) << 4 | size,
                           ac, size)
    n_zrl = run >> 4
    zrl_blk = np.repeat(blk, n_zrl)
    zrl_val, zrl_len = coded(ac_codes, table_of[zrl_blk],
                             np.full(len(zrl_blk), 0xF0), 0, 0)
    last = np.ones(len(blk), bool)
    last[:-1] = blk[1:] != blk[:-1]
    last_k = np.zeros(n_blocks, np.int64)
    last_k[blk[last]] = k[last]
    eob_blk = np.flatnonzero(last_k < 63)
    eob_val, eob_len = coded(ac_codes, table_of[eob_blk],
                             np.zeros(len(eob_blk), np.int64), 0, 0)

    # stream order: by block; within it DC, each coefficient's ZRLs then
    # itself by k, EOB last
    key = np.concatenate([np.arange(n_blocks) * 256, zrl_blk * 256
                          + np.repeat(2 * k - 1, n_zrl), blk * 256 + 2 * k,
                          eob_blk * 256 + 255])
    vals = np.concatenate([dc_val, zrl_val, ac_val, eob_val])
    lens = np.concatenate([dc_len, zrl_len, ac_len, eob_len])
    perm = np.argsort(key, kind="stable")
    data = _pack_bits(vals[perm], lens[perm])
    ff = np.flatnonzero(data == 0xFF)
    data = np.insert(data, ff + 1, 0)

    jfif = b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    out = [SOI, _segment(0xE0, jfif)]
    for ti, t in enumerate(tables):
        out.append(_segment(0xDB, bytes([ti])
                            + bytes(t[ZIGZAG].astype(np.uint8))))
    # components 1-3: Y sampled 2x2 with tables 0, Cb and Cr 1x1 with 1
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, height, width, 3)
                        + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for cls, tabs in ((0, (DC_LUMA, DC_CHROMA)), (1, (AC_LUMA, AC_CHROMA))):
        for ti, (counts, symbols) in enumerate(tabs):
            out.append(_segment(0xC4, bytes([cls << 4 | ti]) + bytes(counts)
                                + bytes(symbols)))
    sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11])
    out.append(_segment(0xDA, sos + b"\x00\x3f\x00"))
    out.append(data.tobytes())
    out.append(b"\xff\xd9")
    return b"".join(out)


# ---------------------------------------------------------------- decoder


class JpegError(ValueError):
    """A JPEG file the decoder cannot read (malformed, cut short); the
    message names the file."""


_CONST_BITS, _PASS1_BITS = 13, 2
_F = dict(f0_298=2446, f0_390=3196, f0_541=4433, f0_765=6270, f0_899=7373,
          f1_175=9633, f1_501=12299, f1_847=15137, f1_961=16069,
          f2_053=16819, f2_562=20995, f3_072=25172)


def _idct_1d(c0, c1, c2, c3, c4, c5, c6, c7, shift):
    """One pass of libjpeg's jidctint.c (islow) butterfly over arrays of
    the eight inputs; returns the eight outputs descaled by `shift`."""
    z1 = (c2 + c6) * _F["f0_541"]
    tmp2 = z1 - c6 * _F["f1_847"]
    tmp3 = z1 + c2 * _F["f0_765"]
    tmp0 = (c0 + c4) << _CONST_BITS
    tmp1 = (c0 - c4) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = c7, c5, c3, c1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F["f1_175"]
    t0 = t0 * _F["f0_298"]
    t1 = t1 * _F["f2_053"]
    t2 = t2 * _F["f3_072"]
    t3 = t3 * _F["f1_501"]
    z1 = z1 * -_F["f0_899"]
    z2 = z2 * -_F["f2_562"]
    z3 = z3 * -_F["f1_961"] + z5
    z4 = z4 * -_F["f0_390"] + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    rnd = 1 << (shift - 1)
    return [(x + rnd) >> shift for x in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def _idct_range_limit():
    """libjpeg's post-IDCT range-limit table, indexed by x & 1023."""
    t = np.zeros(1024, np.uint8)
    t[:128] = np.arange(128, 256)
    t[128:512] = 255
    t[896:] = np.arange(128)
    return t


_RANGE_LIMIT = _idct_range_limit()


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """(N, 64) dequantized coefficients (natural order) -> (N, 8, 8) uint8
    samples, bit for bit as libjpeg's jpeg_idct_islow."""
    c = coef.reshape(-1, 8, 8).astype(np.int64)
    cols = _idct_1d(*[c[:, i, :] for i in range(8)],
                    shift=_CONST_BITS - _PASS1_BITS)
    ws = np.stack(cols, axis=1)  # (N, row, col)
    rows = _idct_1d(*[ws[:, :, i] for i in range(8)],
                    shift=_CONST_BITS + _PASS1_BITS + 3)
    out = np.stack(rows, axis=2)
    return _RANGE_LIMIT[out & 1023]


def _clamp_shift(a, axis):
    """(previous, next) neighbours of `a` along `axis`, edges repeated."""
    n = a.shape[axis]
    prev = np.take(a, np.maximum(np.arange(n) - 1, 0), axis=axis)
    nxt = np.take(a, np.minimum(np.arange(n) + 1, n - 1), axis=axis)
    return prev, nxt


def _interleave(a, b, axis):
    out = np.stack([a, b], axis=axis + 1)
    shape = list(a.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def upsample(plane: np.ndarray, fx: int, fy: int,
             fancy: bool = True) -> np.ndarray:
    """libjpeg's upsampling of a (downsampled_height, downsampled_width)
    component by (fx, fy): the fancy triangle filters for 2x1, 2x2 and
    1x2 (edges replicated), plain replication otherwise, and everywhere
    without `fancy` (a lossless file: libjpeg-turbo upsamples fancily
    only when a data unit is wider than one sample)."""
    p = plane.astype(np.int64)
    if (fx, fy) == (1, 1):
        return p
    if not fancy:
        return np.repeat(np.repeat(p, fy, axis=0), fx, axis=1)
    fancy = p.shape[1] > 2
    if (fx, fy) == (2, 1) and fancy:
        left, right = _clamp_shift(p, 1)
        return _interleave((3 * p + left + 1) >> 2, (3 * p + right + 2) >> 2,
                           1)
    if (fx, fy) == (1, 2):  # h1v2_fancy_upsample at any width
        up, down = _clamp_shift(p, 0)
        return _interleave((3 * p + up + 1) >> 2, (3 * p + down + 2) >> 2, 0)
    if (fx, fy) == (2, 2) and fancy:
        up, down = _clamp_shift(p, 0)
        rows = []
        for cs in (3 * p + up, 3 * p + down):
            left, right = _clamp_shift(cs, 1)
            rows.append(_interleave((3 * cs + left + 8) >> 4,
                                    (3 * cs + right + 7) >> 4, 1))
        return _interleave(rows[0], rows[1], 0)
    return np.repeat(np.repeat(p, fy, axis=0), fx, axis=1)


def _ycc_to_rgb(y, cb, cr):
    """libjpeg's jdcolor.c YCbCr -> RGB in 16-bit fixed point."""
    half = 1 << 15
    cb = cb - 128
    cr = cr - 128
    r = y + ((_fixed(1.40200) * cr + half) >> 16)
    g = y + ((-_fixed(0.34414) * cb + half - _fixed(0.71414) * cr) >> 16)
    b = y + ((_fixed(1.77200) * cb + half) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


_BAD = 0x3F0


def _decode_lut(counts, symbols, dc: bool, eob_runs: bool = False):
    """For every 16-bit window: symbol << 8 | bits to advance (the code's
    length plus the bits that follow it: a DC difference's or an AC
    coefficient's magnitude, and with `eob_runs` (progressive AC scans) an
    EOBn symbol's n run bits). A window that starts no code reads as the
    symbol _BAD, which no block survives (its run carries the coefficient
    index past 63, its DC size past 11)."""
    lut = np.full(1 << 16, _BAD << 8 | 1, np.int32)
    for s, (code, n) in huffman_codes(counts, symbols).items():
        if dc:
            extra = s if s < 16 else 0  # lossless category 16: no bits
        elif s & 15 or not eob_runs:
            extra = s & 15
        else:
            extra = 0 if s >> 4 == 15 else s >> 4
        lut[code << (16 - n):(code + 1) << (16 - n)] = s << 8 | (n + extra)
    return lut


# libjpeg-turbo's block smoothing estimates zig-zag coefficients 1 to
# this less one where a progressive file leaves them unrefined (jdcoefct.c
# SAVED_COEFS)
_SMOOTHED_COEFS = 10


class _Frame:
    """What the markers of one file set: tables by id, the restart
    interval, the frame header's size and components, and each
    component's (block rows, block cols, 64) zig-zag coefficients with,
    for a progressive file, the low bit each coefficient is known to
    (coef_bits: -1 before any scan codes it, libjpeg's coef_bits)."""

    def __init__(self):
        self.quant = {}  # table id -> (64,) natural order
        self.huff = {}  # (class, id) -> (counts, symbols)
        self.restart = 0
        self.adobe_transform = None
        self.jfif = False
        self.progressive = False
        self.arithmetic = False
        self.lossless = False
        self.conditioning = {}  # table id -> [L, U, Kx] (DAC marker)
        self.width = self.height = None
        self.comps = []  # dicts id, h, v, tq in frame-header order
        self.coef = {}  # component id -> coefficients
        self.coef_bits = {}  # component id -> (64,) int
        self.samples = {}  # lossless: component id -> (rows, cols) uint8


def _parse_scan_data(data, start):
    """The entropy-coded bytes from `start` to the next marker that is not
    a restart: (unstuffed bytes, the byte index where each restart
    interval starts in them, the index of the terminating marker)."""
    tail = data[start:]
    ff = np.flatnonzero(tail[:-1] == 0xFF)
    nxt = tail[ff + 1]
    rst = (nxt >= 0xD0) & (nxt <= 0xD7)
    stuffed = nxt == 0
    ends = ff[~rst & ~stuffed & (nxt != 0xFF)]
    end = int(ends[0]) if len(ends) else len(tail)
    keep = np.ones(end, bool)
    ok = ff < end
    keep[ff[ok & stuffed] + 1] = False
    rst_at = ff[ok & rst]
    keep[rst_at] = False
    keep[rst_at + 1] = False
    # 0xFF fill bytes before a marker
    fill = ff[ok & (nxt == 0xFF)]
    keep[fill] = False
    kept_before = np.concatenate([[0], np.cumsum(keep)])
    seg_starts = np.concatenate([[0], kept_before[rst_at + 2]])
    return tail[:end][keep], seg_starts, start + end


def _scan_blocks(fr, scan_comps, unit=8):
    """A scan's blocks in stream order: (blocks per MCU, each block's index
    into scan_comps, its block row and column in its component). A
    single-component scan covers that component's own ceil(width / 8) x
    ceil(height / 8) blocks, one block an MCU; an interleaved scan covers
    the MCU grid, each component's h x v blocks row-major in each MCU. A
    lossless file's data unit is one sample (`unit` 1)."""
    hmax = max(c["h"] for c in fr.comps)
    vmax = max(c["v"] for c in fr.comps)
    if len(scan_comps) == 1:
        c = scan_comps[0]
        bw = -(-(-(-fr.width * c["h"] // hmax)) // unit)
        bh = -(-(-(-fr.height * c["v"] // vmax)) // unit)
        rows, cols = np.divmod(np.arange(bw * bh), bw)
        return 1, np.zeros(bw * bh, np.int64), rows, cols
    per = [(si, by, bx) for si, c in enumerate(scan_comps)
           for by in range(c["v"]) for bx in range(c["h"])]
    si, by, bx = (np.array(v) for v in zip(*per))
    hs = np.array([scan_comps[i]["h"] for i in si])
    vs = np.array([scan_comps[i]["v"] for i in si])
    mcux = -(-fr.width // (unit * hmax))
    mcuy = -(-fr.height // (unit * vmax))
    my, mx = np.divmod(np.arange(mcux * mcuy), mcux)
    rows = (my[:, None] * vs + by).reshape(-1)
    cols = (mx[:, None] * hs + bx).reshape(-1)
    return len(per), np.tile(si, mcux * mcuy), rows, cols


class _Scan:
    """One scan's entropy-coded bits: `peek[p]` holds the 16 bits from bit
    p on, `limit` the scan's length in bits, `table(cls, id)` a Huffman
    table's _decode_lut read at every bit position, and `start(b)` the bit
    where block b's restart interval begins (None inside an interval)."""

    def __init__(self, fr, data, seg_starts, n_blocks, per_mcu, name):
        self.fr, self.name = fr, name
        byts = np.concatenate([data, np.zeros(8, np.uint8)]).astype(np.int64)
        win = byts[:-2] << 16 | byts[1:-1] << 8 | byts[2:]
        peek = ((win[:, None] >> (8 - np.arange(8))) & 0xFFFF).reshape(-1)
        self.peek = peek.astype(np.int32)
        self.limit = 8 * len(data)
        self.seg_starts = seg_starts
        self.n_blocks = n_blocks
        self.per_mcu = per_mcu
        self.blocks_per_interval = fr.restart * per_mcu
        self._luts = {}

    def table(self, cls, tid, eob_runs=False):
        key = (cls, tid, eob_runs)
        if key not in self._luts:
            if (cls, tid) not in self.fr.huff:
                raise JpegError(f"{self.name}: scan uses an undefined "
                                f"Huffman table {(cls, tid)}")
            counts, symbols = self.fr.huff[(cls, tid)]
            self._luts[key] = _decode_lut(counts, symbols, cls == 0,
                                          eob_runs)[self.peek]
        return self._luts[key]

    def interval(self):
        """Each block's restart interval."""
        b = np.arange(self.n_blocks)
        return (b // self.blocks_per_interval if self.blocks_per_interval
                else np.zeros(self.n_blocks, np.int64))

    def restart_bits(self):
        """{block: the bit its restart interval starts at} for every block
        that starts one after the first."""
        step = self.blocks_per_interval
        if not step:
            return {}
        firsts = range(step, self.n_blocks, step)
        if len(firsts) >= len(self.seg_starts):
            raise JpegError(f"{self.name}: restart marker missing")
        return {b: 8 * int(self.seg_starts[i + 1])
                for i, b in enumerate(firsts)}

    def check_end(self, p):
        if p > self.limit:
            raise JpegError(f"{self.name}: JPEG data ends inside a block")

    def values(self, pos, cls, tids, eob_runs=False):
        """The signed values of the magnitude bits after the codes at bit
        positions `pos` (tables `tids` of class `cls`)."""
        comb = np.zeros(len(pos), np.int64)
        for tid in np.unique(tids):
            sel = tids == tid
            comb[sel] = self.table(cls, int(tid), eob_runs)[pos[sel]]
        sym = comb >> 8
        if cls == 0 and len(sym) and sym.max() > 11:
            raise JpegError(f"{self.name}: corrupt JPEG data (DC size)")
        size = sym if cls == 0 else sym & 15
        start = pos + (comb & 255) - size
        bits = self.peek[start].astype(np.int64) >> (16 - size)
        return np.where(size == 0, 0,
                        np.where(bits >= (1 << np.maximum(size - 1, 0)),
                                 bits, bits - (1 << size) + 1))


def _dc_predict(diff, comp_of, interval, n_comps):
    """DC values from their differences: per scan component, summed from
    the start of each restart interval."""
    dc = np.zeros(len(diff), np.int64)
    for si in range(n_comps):
        sel = np.flatnonzero(comp_of == si)
        d = diff[sel]
        cs = np.cumsum(d)
        first = np.ones(len(sel), bool)
        first[1:] = interval[sel][1:] != interval[sel][:-1]
        base = np.maximum.accumulate(np.where(first, np.arange(len(sel)), 0))
        dc[sel] = cs - cs[base] + d[base]
    return dc


def _first_scan(sc, tables, dc, ss, se, eob_runs):
    """Huffman-decode a sequential scan (dc, ss=1, se=63) or a progressive
    first scan (DC alone, or the band ss..se of one component with EOB
    runs): the bit positions of the DC codes, and of the AC codes with
    their zig-zag index and block. One table read a symbol."""
    dc_pos, ac_pos, ac_k, ac_end = [], [], [], []
    dc_append, ac_append, k_append = dc_pos.append, ac_pos.append, ac_k.append
    end_append = ac_end.append
    restarts = sc.restart_bits()
    peek = sc.peek
    per_mcu = sc.per_mcu
    p = 0
    eobrun = 0
    try:
        for b in range(sc.n_blocks):
            if b in restarts:
                p = restarts[b]
                eobrun = 0
            dct, act = tables[b % per_mcu]
            if dc:
                dc_append(p)
                p += dct[p] & 255
            if eobrun:
                eobrun -= 1
            else:
                k = ss
                while k <= se:
                    c = act[p]
                    s = c >> 8
                    q = p
                    p += c & 255
                    if s & 15:
                        k += s >> 4
                        ac_append(q)
                        k_append(k)
                        k += 1
                    elif s == 0xF0:
                        k += 16
                    else:
                        if eob_runs:
                            r = s >> 4
                            eobrun = (1 << r) - 1 + (
                                int(peek[p - r]) >> (16 - r) if r else 0)
                        break
            end_append(len(ac_pos))
            if b % per_mcu == per_mcu - 1:
                sc.check_end(p)
    except IndexError:
        raise JpegError(f"{sc.name}: corrupt JPEG entropy data") from None
    ac_k = np.asarray(ac_k, np.int64)
    if len(ac_k) and ac_k.max() > se:
        raise JpegError(f"{sc.name}: corrupt JPEG data (run past the band)")
    ac_blk = np.repeat(np.arange(sc.n_blocks), np.diff(
        np.concatenate([[0], np.asarray(ac_end, np.int64)])))
    return np.asarray(dc_pos, np.int64), np.asarray(ac_pos, np.int64), ac_k, \
        ac_blk


def _dc_refine_bits(sc):
    """Bit positions of a DC refinement scan, which reads one bit a block
    and no Huffman code: block b's bit, counted from the start of its
    restart interval."""
    first = np.arange(sc.n_blocks)
    step = sc.blocks_per_interval
    if step:
        interval = sc.interval()
        restarts = sc.restart_bits()
        starts = np.array([0] + [restarts[b] for b in sorted(restarts)],
                          np.int64)
        first = first - first[interval * step] + starts[interval]
    return first


def _ac_refine(sc, tables, hist):
    """Decode an AC refinement scan over blocks whose band was nonzero
    where `hist` (blocks, band) is True before it: (the bit
    position of each correction bit and the (block, band index) it
    refines, the bit position of each new coefficient's sign and its
    (block, band index)). A symbol's run counts only coefficients that are
    still zero, and every nonzero one it passes reads one correction bit;
    so with each block's running counts of both kinds, one symbol is one
    lookup, and the correction bits are gathered afterwards."""
    n_blocks, band = hist.shape
    nz_cum = np.zeros((n_blocks, band + 1), np.int64)
    np.cumsum(hist, axis=1, out=nz_cum[:, 1:])
    nz_list = nz_cum.reshape(-1).tolist()
    zero_blk, zero_j = np.nonzero(~hist)
    zero_off = np.searchsorted(zero_blk, np.arange(n_blocks + 1)).tolist()
    zero_j = zero_j.tolist()
    peek = sc.peek
    restarts = sc.restart_bits()
    per_mcu = sc.per_mcu
    corr = []  # (block, first band index, end band index, first bit)
    new_pos, new_blk, new_j = [], [], []
    w = band + 1
    p = 0
    eobrun = 0
    try:
        for b in range(n_blocks):
            if b in restarts:
                p = restarts[b]
                eobrun = 0
            act = tables[b % per_mcu]
            row = b * w
            j = 0
            if not eobrun:
                while j < band:
                    c = act[p]
                    s = c >> 8
                    p += c & 255
                    r = s >> 4
                    if not s & 15 and r != 15:
                        eobrun = (1 << r) + (
                            int(peek[p - r]) >> (16 - r) if r else 0)
                        break
                    # the (r + 1)-th coefficient still zero from j on
                    zi = zero_off[b] + (j - nz_list[row + j]) + r
                    if zi >= zero_off[b + 1]:
                        if s & 15:
                            raise JpegError(f"{sc.name}: corrupt JPEG data "
                                            f"(refinement past the band)")
                        t = band
                    else:
                        t = zero_j[zi]
                    n = nz_list[row + t] - nz_list[row + j]
                    corr.append((b, j, t, p))
                    if s & 15:
                        new_pos.append(p - 1)
                        new_blk.append(b)
                        new_j.append(t)
                    p += n
                    j = t + 1
            if eobrun:
                n = nz_list[row + band] - nz_list[row + j]
                corr.append((b, j, band, p))
                p += n
                eobrun -= 1
            if b % per_mcu == per_mcu - 1:
                sc.check_end(p)
    except IndexError:
        raise JpegError(f"{sc.name}: corrupt JPEG entropy data") from None
    # every correction range's nonzero coefficients, in band order
    nz_blk, nz_j = np.nonzero(hist)
    nz_off = np.searchsorted(nz_blk, np.arange(n_blocks))
    corr = np.asarray(corr, np.int64).reshape(-1, 4)
    cb, j0, j1, p0 = corr.T
    first = nz_off[cb] + nz_cum[cb, j0]
    count = nz_cum[cb, j1] - nz_cum[cb, j0]
    k = np.arange(int(count.sum())) - np.repeat(np.cumsum(count) - count,
                                                count)
    at = np.repeat(first, count) + k
    bit_pos = np.repeat(p0, count) + k
    return (bit_pos, nz_blk[at], nz_j[at], np.asarray(new_pos, np.int64),
            np.asarray(new_blk, np.int64), np.asarray(new_j, np.int64))


def _decode_scan(fr, scan_comps, spectral, data, seg_starts, name):
    """Decode one scan into fr.coef (per component, (block rows, block
    cols, 64) zig-zag coefficients): a sequential scan, or a progressive
    scan's DC or AC band, first or refining (spectral = Ss, Se, Ah, Al),
    Huffman- or arithmetic-coded; a lossless scan into fr.samples."""
    if fr.lossless:
        _lossless_scan(fr, scan_comps, spectral, data, seg_starts, name)
        return
    ss, se, ah, al = spectral
    if fr.progressive:
        dc_scan = ss == 0
        if (se != 0 if dc_scan else (ss > se or se > 63
                                     or len(scan_comps) != 1)) \
                or (ah and al != ah - 1) or al > 13:
            raise JpegError(f"{name}: invalid progressive scan (Ss {ss}, "
                            f"Se {se}, Ah {ah}, Al {al})")
    else:
        ss, se, ah, al = 0, 63, 0, 0
    per_mcu, comp_of, rows, cols = _scan_blocks(fr, scan_comps)
    if len(scan_comps) > 1 and per_mcu > 10:
        raise JpegError(f"{name}: {per_mcu} blocks in an MCU (at most 10)")
    coefs = [fr.coef[c["id"]] for c in scan_comps]
    if fr.arithmetic:
        bounds = [int(b) for b in seg_starts] + [len(data)]
        jpeg_arith.decode_scan(
            coefs, comp_of, rows, cols, per_mcu, (ss, se, ah, al),
            fr.progressive, [(c["td"], c["ta"]) for c in scan_comps],
            fr.conditioning, [data[a:b].tobytes() for a, b in
                              zip(bounds[:-1], bounds[1:])], fr.restart)
        if fr.progressive:
            for c in scan_comps:
                fr.coef_bits[c["id"]][ss:se + 1] = al
        return
    sc = _Scan(fr, data, seg_starts, len(comp_of), per_mcu, name)
    tds = np.array([c["td"] for c in scan_comps])
    tas = np.array([c["ta"] for c in scan_comps])

    def scatter(sel_blocks, k, vals, add=False):
        """Write (or add) zig-zag coefficient k of the given scan blocks."""
        for si, coef in enumerate(coefs):
            m = comp_of[sel_blocks] == si
            b = sel_blocks[m]
            kk = k[m] if np.ndim(k) else k
            v = vals[m]
            if add:
                coef[rows[b], cols[b], kk] += v
            else:
                coef[rows[b], cols[b], kk] = v

    blocks = np.arange(sc.n_blocks)
    if ah == 0:
        with_dc = ss == 0
        first_ac = max(ss, 1)
        tables = [(memoryview(sc.table(0, int(tds[si]))) if with_dc else None,
                   memoryview(sc.table(1, int(tas[si]), fr.progressive))
                   if se >= first_ac else None)
                  for si in comp_of[:per_mcu]]
        dc_pos, ac_pos, ac_k, ac_blk = _first_scan(
            sc, tables, with_dc, first_ac, se if se >= first_ac else 0,
            fr.progressive)
        if with_dc:
            diff = sc.values(dc_pos, 0, tds[comp_of])
            dc = _dc_predict(diff, comp_of, sc.interval(), len(scan_comps))
            scatter(blocks, 0, dc << al)
        if len(ac_pos):
            vals = sc.values(ac_pos, 1, tas[comp_of[ac_blk]], fr.progressive)
            scatter(ac_blk, ac_k, vals << al)
    elif ss == 0:
        # DC refinement: one bit a block
        pos = _dc_refine_bits(sc)
        if sc.n_blocks:
            sc.check_end(int(pos[-1]) + 1)
        bits = (sc.peek[pos].astype(np.int64) >> 15) & 1
        scatter(blocks, 0, bits << al, add=True)
    else:
        coef = coefs[0]
        band = coef[rows, cols, ss:se + 1]
        tables = [memoryview(sc.table(1, int(tas[0]), True))]
        bit_pos, cb, cj, new_pos, nb, nj = _ac_refine(sc, tables, band != 0)
        p1 = 1 << al
        bits = (sc.peek[bit_pos].astype(np.int64) >> 15) & 1
        old = band[cb, cj]
        fix = (bits == 1) & ((old & p1) == 0)
        band[cb[fix], cj[fix]] += np.where(old[fix] >= 0, p1, -p1)
        sign = (sc.peek[new_pos].astype(np.int64) >> 15) & 1
        band[nb, nj] = np.where(sign == 1, p1, -p1)
        coef[rows, cols, ss:se + 1] = band
    if fr.progressive:
        for c in scan_comps:
            fr.coef_bits[c["id"]][ss:se + 1] = al


def _lossless_rows(d, psv, init):
    """Runs of rows of a lossless component from their differences `d`
    (runs, rows, cols), each run's first row predicted from the left after
    `init`, its first column from above, the rest by predictor `psv` (T.81
    H.1.2.1, libjpeg's jdlossls.c), modulo 2^16. Predictors 1, 2 and 4 are
    cumulative sums; the others go one anti-diagonal at a time, every run
    at once (a sample's left, upper and upper-left neighbours lie on the
    two diagonals before it)."""
    _, n, w = d.shape
    x = np.empty_like(d)
    x[:, 0] = init + np.cumsum(d[:, 0], axis=-1)
    x[:, 1:, 0] = x[:, :1, 0] + np.cumsum(d[:, 1:, 0], axis=1)
    if psv == 1:
        x[:, 1:, 1:] = x[:, 1:, :1] + np.cumsum(d[:, 1:, 1:], axis=2)
    elif psv == 2:
        x[:, 1:] = x[:, :1] + np.cumsum(d[:, 1:], axis=1)
    elif psv == 4:
        x = init + np.cumsum(np.cumsum(d, axis=1), axis=2)
    else:
        x &= 0xFFFF
        for diag in range(2, n + w - 1):
            i = np.arange(max(1, diag - w + 1), min(n - 1, diag - 1) + 1)
            c = diag - i
            ra, rb, rc = x[:, i, c - 1], x[:, i - 1, c], x[:, i - 1, c - 1]
            pred = {3: rc, 5: ra + ((rb - rc) >> 1),
                    6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[psv]
            x[:, i, c] = (d[:, i, c] + pred) & 0xFFFF
    return x & 0xFFFF


def _lossless_scan(fr, scan_comps, spectral, data, seg_starts, name):
    """Decode one lossless (SOF3) scan into fr.samples, as libjpeg-turbo's
    jdlhuff.c / jddiffct.c / jdlossls.c do: each sample's difference
    (Huffman categories 0-16, 16 meaning 32768 without extra bits), then
    undifferenced row by row by the predictor Ss, scaled by the point
    transform Al. The scan's first row, and the first row of each iMCU
    row in which a restart falls, start over: the initial prediction
    2^(P - Pt - 1), then the left neighbour. libjpeg restarts only at MCU
    row boundaries and refuses other intervals; so does this decoder."""
    psv, se, ah, pt = spectral
    if not 1 <= psv <= 7 or se or ah or pt >= 8:
        raise JpegError(f"{name}: invalid lossless scan (predictor {psv}, "
                        f"Se {se}, Ah {ah}, Pt {pt})")
    one = len(scan_comps) == 1
    per_mcu, comp_of, rows, cols = _scan_blocks(fr, scan_comps, unit=1)
    if not one and per_mcu > 10:
        raise JpegError(f"{name}: {per_mcu} samples in an MCU (at most 10)")
    hmax = max(c["h"] for c in fr.comps)
    mcu_cols = (fr.samples[scan_comps[0]["id"]].shape[1] if one
                else -(-fr.width // hmax))
    if fr.restart % mcu_cols:
        raise NotImplementedError(
            f"{name}: lossless JPEG restart interval of {fr.restart} MCUs, "
            f"not a whole number of MCU rows of {mcu_cols} (PIL refuses it "
            f"too)")
    sc = _Scan(fr, data, seg_starts, len(comp_of), per_mcu, name)
    tds = np.array([c["td"] for c in scan_comps])
    tables = [(memoryview(sc.table(0, int(tds[si]))), None)
              for si in comp_of[:per_mcu]]
    pos = _first_scan(sc, tables, True, 1, 0, False)[0]
    comb = np.zeros(len(pos), np.int64)
    for si, tid in enumerate(tds):
        sel = comp_of == si
        comb[sel] = sc.table(0, int(tid))[pos[sel]]
    size = comb >> 8
    if len(size) and size.max() > 16:
        raise JpegError(f"{name}: corrupt JPEG data (difference category)")
    extra = np.where(size == 16, 0, size)
    bits = sc.peek[pos + (comb & 255) - extra].astype(np.int64) >> (
        16 - extra)
    diff = np.where(size == 16, 32768, np.where(
        bits >= (1 << np.maximum(extra - 1, 0)), bits,
        bits - (1 << extra) + 1))
    restart_rows = fr.restart // mcu_cols
    for si, c in enumerate(scan_comps):
        out = fr.samples[c["id"]]
        n, w = out.shape
        sel = comp_of == si
        grid = np.zeros((rows[sel].max() + 1, cols[sel].max() + 1), np.int64)
        grid[rows[sel], cols[sel]] = diff[sel]
        # the rows that start over: the first, and the first of each iMCU
        # row (v rows of the component) in which a restart falls (an MCU
        # row is one sample row of a single-component scan, v otherwise)
        v = c["v"]
        step = restart_rows * (1 if one else v) or n
        starts = sorted({r // v * v for r in range(0, n, step)}) + [n]
        runs = list(zip(starts[:-1], starts[1:]))
        # every run stacked, the short ones padded below with zeros
        d = np.zeros((len(runs), max(b - a for a, b in runs), w), np.int64)
        for j, (r0, r1) in enumerate(runs):
            d[j, :r1 - r0] = grid[r0:r1, :w]
        x = _lossless_rows(d, psv, 1 << (8 - pt - 1))
        for j, (r0, r1) in enumerate(runs):
            out[r0:r1] = (x[j, :r1 - r0] << pt) & 0xFF


def decode_jpeg(data: bytes, name: str = "<bytes>",
                colour: str | None = None) -> np.ndarray:
    """A JPEG's bytes as (H, W, 3) uint8 RGB, or (H, W) uint8 for a
    greyscale file (see the module docstring for what is read). A file
    cut short or otherwise malformed raises ValueError naming it; a kind
    of file the decoder leaves out raises NotImplementedError naming it.
    `colour` ("grey", "rgb", "ycc", "cmyk", "ycck") sets the colour space
    in place of libjpeg's reading of the markers, as libtiff sets it for a
    JPEG-in-TIFF stream."""
    return _decode(data, name, lambda fr: _reconstruct(fr, name, colour))


def decode_jpeg_planes(data: bytes, name: str = "<bytes>"):
    """A JPEG's component planes as libjpeg gives them raw (no upsampling,
    no colour conversion), each cropped to its share of the image, with
    each component's (h, v) sampling factors: what libtiff's old-style
    JPEG codec reads."""
    return _decode(data, name, _raw_planes)


def _decode(data, name, finish):
    buf = np.frombuffer(bytes(data), np.uint8)
    if bytes(buf[:2]) != SOI:
        raise JpegError(f"{name}: not a JPEG")
    try:
        return finish(_parse(buf, name))
    except (JpegError, NotImplementedError):
        raise
    except (IndexError, KeyError, ValueError, struct.error) as exc:
        raise JpegError(f"{name}: malformed JPEG ({exc})") from None


# SOF markers read: 0xC0 baseline, 0xC1 extended sequential, 0xC2
# progressive, 0xC3 lossless (Huffman), 0xC9 sequential and 0xCA
# progressive (arithmetic). libjpeg-turbo has no hierarchical mode and no
# arithmetic-coded lossless one, so PIL refuses the others, as this does.
_SOF_READ = (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA)
_SOF_REFUSED = {0xC5: "hierarchical (SOF5)", 0xC6: "hierarchical (SOF6)",
                0xC7: "hierarchical (SOF7)",
                0xCB: "arithmetic-coded lossless (SOF11)",
                0xCD: "arithmetic-coded hierarchical (SOF13)",
                0xCE: "arithmetic-coded hierarchical (SOF14)",
                0xCF: "arithmetic-coded hierarchical (SOF15)"}


def _frame_header(fr, marker, body, name):
    prec, h, w, nf = struct.unpack(">BHHB", body[:6])
    if prec != 8:
        raise NotImplementedError(
            f"{name}: {prec}-bit JPEG samples are not decoded (PIL "
            f"refuses them too)")
    if h == 0:
        raise NotImplementedError(
            f"{name}: JPEG height set by DNL is not decoded (PIL refuses "
            f"it too)")
    if nf not in (1, 3, 4):
        raise NotImplementedError(
            f"{name}: JPEG with {nf} components (PIL reads 1, 3 and 4)")
    fr.progressive = marker in (0xC2, 0xCA)
    fr.arithmetic = marker in (0xC9, 0xCA)
    fr.lossless = marker == 0xC3
    fr.width, fr.height = w, h
    for k in range(nf):
        cid, hv, tq = body[6 + 3 * k:9 + 3 * k]
        fr.comps.append(dict(id=cid, h=hv >> 4, v=hv & 15, tq=tq))
    hmax = max(c["h"] for c in fr.comps)
    vmax = max(c["v"] for c in fr.comps)
    if any(not (1 <= c["h"] <= 4 and 1 <= c["v"] <= 4)
           or hmax % c["h"] or vmax % c["v"] for c in fr.comps):
        raise NotImplementedError(
            f"{name}: JPEG sampling factors "
            f"{[(c['h'], c['v']) for c in fr.comps]} (libjpeg reads 1-4 "
            f"that divide the largest)")
    mcux = -(-w // (8 * hmax))
    mcuy = -(-h // (8 * vmax))
    for c in fr.comps:
        if fr.lossless:
            fr.samples[c["id"]] = np.zeros(
                (-(-h * c["v"] // vmax), -(-w * c["h"] // hmax)), np.uint8)
            continue
        fr.coef[c["id"]] = np.zeros((mcuy * c["v"], mcux * c["h"], 64),
                                    np.int64)
        fr.coef_bits[c["id"]] = np.full(64, -1, np.int64)


def _parse(buf, name):
    """Read the markers and decode every scan: the file's _Frame."""
    fr = _Frame()
    i = 2
    n = len(buf)
    while i < n:
        if buf[i] != 0xFF:
            raise JpegError(f"{name}: expected a marker at byte {i}")
        while i < n and buf[i] == 0xFF:
            i += 1
        if i >= n:
            break
        marker = int(buf[i])
        i += 1
        if marker == 0xD9:
            break
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:
            continue
        length = int(buf[i]) << 8 | int(buf[i + 1])
        body = bytes(buf[i + 2:i + length])
        i += length
        if marker in _SOF_READ:
            if fr.width is not None:
                raise JpegError(f"{name}: a second frame header")
            _frame_header(fr, marker, body, name)
        elif marker in _SOF_REFUSED:
            raise NotImplementedError(
                f"{name}: {_SOF_REFUSED[marker]} JPEG is not decoded (PIL "
                f"refuses it too)")
        elif marker == 0xCC:
            for j in range(0, len(body) - 1, 2):
                index, val = body[j], body[j + 1]
                if index >= 32:
                    raise JpegError(f"{name}: bad DAC table index {index}")
                cond = fr.conditioning.setdefault(
                    index & 15, list(jpeg_arith.DEFAULT_CONDITIONING))
                if index >= 16:
                    cond[2] = val
                elif val & 15 > val >> 4:
                    raise JpegError(f"{name}: bad DAC value {val}")
                else:
                    cond[0], cond[1] = val & 15, val >> 4
        elif marker == 0xC4:
            j = 0
            while j < len(body):
                tc_th = body[j]
                counts = list(body[j + 1:j + 17])
                symbols = list(body[j + 17:j + 17 + sum(counts)])
                fr.huff[(tc_th >> 4, tc_th & 15)] = (counts, symbols)
                j += 17 + sum(counts)
        elif marker == 0xDB:
            j = 0
            while j < len(body):
                pq, tq = body[j] >> 4, body[j] & 15
                if pq:
                    vals = np.frombuffer(body[j + 1:j + 129], ">u2")
                    j += 129
                else:
                    vals = np.frombuffer(body[j + 1:j + 65], np.uint8)
                    j += 65
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = vals
                fr.quant[tq] = table
        elif marker == 0xDD:
            fr.restart = struct.unpack(">H", body[:2])[0]
        elif marker == 0xDC:
            raise NotImplementedError(
                f"{name}: JPEG height set by DNL is not decoded (PIL "
                f"refuses it too)")
        elif marker == 0xE0 and body[:5] == b"JFIF\x00":
            fr.jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe":
            fr.adobe_transform = body[11]
        elif marker == 0xDA:
            if fr.width is None:
                raise JpegError(f"{name}: scan before the frame header")
            ns = body[0]
            by_id = {c["id"]: c for c in fr.comps}
            scan_comps = []
            for k in range(ns):
                cid, t = body[1 + 2 * k], body[2 + 2 * k]
                scan_comps.append(dict(by_id[cid], td=t >> 4, ta=t & 15))
            ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
            scan, seg_starts, i = _parse_scan_data(buf, i)
            _decode_scan(fr, scan_comps, (ss, se, a >> 4, a & 15), scan,
                         seg_starts, name)
    if fr.width is None:
        raise JpegError(f"{name}: no frame header")
    return fr


def _colour_space(fr, name):
    """libjpeg's reading of the file's colour space (jdapimin.c
    default_decompress_parms): "grey", "ycc", "rgb", "cmyk" or "ycck"."""
    ids = tuple(c["id"] for c in fr.comps)
    if len(ids) == 1:
        return "grey"
    if len(ids) == 3:
        if fr.jfif:
            return "ycc"
        if fr.adobe_transform is not None:
            return "rgb" if fr.adobe_transform == 0 else "ycc"
        # without a marker libjpeg-turbo takes a lossless file for RGB
        return "rgb" if ids == (82, 71, 66) or fr.lossless else "ycc"
    return "ycck" if fr.adobe_transform not in (None, 0) else "cmyk"


def _muldiv255(a, b):
    t = a * b + 128
    return ((t >> 8) + t) >> 8


def cmyk_to_rgb(cmyk):
    """Decoded CMYK samples -> the RGB of PIL's convert("RGBA"): PIL reads
    a CMYK JPEG inverted (Adobe's polarity, raw mode CMYK;I), then takes
    each channel to k - (255 - c) * k / 255 in its fixed point."""
    c = cmyk.astype(np.int64)
    k = c[..., 3:4]
    return np.clip(k - _muldiv255(255 - c[..., :3], k), 0, 255).astype(
        np.uint8)


# libjpeg-turbo's block smoothing (jdcoefct.c decompress_smooth_data): a
# progressive file whose scans leave any of the zig-zag coefficients 1-9
# not known to full precision gets them estimated, where still zero, from
# the 5x5 neighbourhood of quantized DC values around each block: the
# kernels below, rows top to bottom, keyed by zig-zag index (libjpeg's
# DC01-DC25 read row by row). With no AC bit known at all (every
# coef_bits[1-9] -1) the Gaussian-like "change DC" kernels estimate all
# nine and the DC itself; otherwise the first five take the kernels after
# Section K.8 of T.81.
_K01 = np.array([[0] * 5, [0] * 5, [-7, 50, 0, -50, 7], [0] * 5, [0] * 5])
_K02 = np.array([[0] * 5, [0] * 5, [-1, 13, -24, 13, -1], [0] * 5, [0] * 5])
_SMOOTH_KEEP_DC = {
    1: _K01, 2: _K01.T, 3: _K02.T, 5: _K02,
    4: np.array([[0, -1, 0, 1, 0], [-1, 10, 0, -10, 1], [0] * 5,
                 [1, -10, 0, 10, -1], [0, 1, 0, -1, 0]]),
}
_C01 = np.array([[-1, -1, 0, 1, 1], [-3, 13, 0, -13, 3],
                 [-3, 38, 0, -38, 3], [-3, 13, 0, -13, 3],
                 [-1, -1, 0, 1, 1]])
_C20 = np.array([[0, 0, 1, 0, 0], [0, 2, 7, 2, 0], [0, -5, -14, -5, 0],
                 [0, 2, 7, 2, 0], [0, 0, 1, 0, 0]])
_C03 = np.array([[0] * 5, [0, 1, 0, -1, 0], [0, 2, 0, -2, 0],
                 [0, 1, 0, -1, 0], [0] * 5])
_C12 = np.array([[0] * 5, [0, 1, -3, 1, 0], [0] * 5, [0, -1, 3, -1, 0],
                 [0] * 5])
_SMOOTH_CHANGE_DC = {
    1: _C01, 2: _C01.T, 3: _C20, 5: _C20.T, 6: _C03, 7: _C12, 8: _C12.T,
    9: _C03.T,
    4: np.array([[-1, 0, 0, 0, 1], [0, 9, 0, -9, 0], [0] * 5,
                 [0, -9, 0, 9, 0], [1, 0, 0, 0, -1]]),
    0: np.array([[-2, -6, -8, -6, -2], [-6, 6, 42, 6, -6],
                 [-8, 42, 152, 42, -8], [-6, 6, 42, 6, -6],
                 [-2, -6, -8, -6, -2]]),
}


def _smoothing_rows(n_rows, v, mcu_rows):
    """Per block row, the 5 block rows jdcoefct.c reads around it (two
    above to two below), as its buffer pointers fall: it counts a
    component's rows per iMCU row (v of them, or what is left in the
    last), so below a component that does not fill its last iMCU row the
    rows of the iMCU row before it read the dummy rows under the image,
    and the last iMCU row's first row may take its row above for the one
    two above."""
    out = []
    for r in range(n_rows):
        m, br = divmod(r, v)
        rows = v if m < mcu_rows - 1 else (n_rows % v or v)
        at, count = m * rows + br, rows * mcu_rows
        prev = r - 1 if at > 0 else r
        nxt = r + 1 if at < count - 1 else r
        out.append((r - 2 if at > 1 else prev, prev, r, nxt,
                    r + 2 if at < count - 2 else nxt))
    return np.array(out, np.int64).reshape(-1, 5)


def _smoothing_cols(n_cols):
    """Per block column, the 5 columns of jdcoefct.c's sliding DC registers
    (two left to two right), clamped at the image."""
    return np.clip(np.arange(n_cols)[:, None] + np.arange(-2, 3), 0,
                   n_cols - 1)


def _smoothed(fr, c):
    """Component c's zig-zag coefficients (block rows, block cols, 64)
    after libjpeg-turbo's block smoothing of its real blocks."""
    coef, bits = fr.coef[c["id"]], fr.coef_bits[c["id"]]
    hmax = max(x["h"] for x in fr.comps)
    vmax = max(x["v"] for x in fr.comps)
    n_rows = -(-(-(-fr.height * c["v"] // vmax)) // 8)
    n_cols = -(-(-(-fr.width * c["h"] // hmax)) // 8)
    dc = coef[..., 0]
    win = dc[_smoothing_rows(n_rows, c["v"], -(-fr.height // (8 * vmax)))[
        :, None, :, None], _smoothing_cols(n_cols)[None, :, None, :]]
    q = fr.quant[c["tq"]][ZIGZAG[:10]]
    change_dc = bool((bits[1:10] == -1).all())
    out = coef.copy()
    real = out[:n_rows, :n_cols]
    for k, kern in (_SMOOTH_CHANGE_DC if change_dc
                    else _SMOOTH_KEEP_DC).items():
        num = q[0] * (win * kern).sum(axis=(2, 3))
        pred = (((int(q[k]) << 7) + np.abs(num)) // (int(q[k]) << 8))
        if k == 0:
            real[..., 0] = np.where(num >= 0, pred, -pred)
            continue
        al = int(bits[k])
        if not al:
            continue
        if al > 0:
            pred = np.minimum(pred, (1 << al) - 1)
        keep = real[..., k] != 0
        real[..., k] = np.where(keep, real[..., k],
                                np.where(num >= 0, pred, -pred))
    return out


def _smoothing_ok(fr):
    """jdcoefct.c smoothing_ok: a progressive file in which every
    component's DC is at least partly known, whose quantizers of the DC
    and the first nine AC coefficients are nonzero, and whose scans leave
    any of those nine coefficients not known to full precision."""
    if not fr.progressive:
        return False
    for c in fr.comps:
        q = fr.quant.get(c["tq"])
        if q is None or not q[ZIGZAG[:10]].all() \
                or fr.coef_bits[c["id"]][0] < 0:
            return False
    return any((fr.coef_bits[c["id"]][1:_SMOOTHED_COEFS] != 0).any()
               for c in fr.comps)


def _component_plane(fr, c, smooth, name):
    """One component's samples, cropped to its share of the image."""
    hmax = max(k["h"] for k in fr.comps)
    vmax = max(k["v"] for k in fr.comps)
    dw = -(-fr.width * c["h"] // hmax)
    dh = -(-fr.height * c["v"] // vmax)
    if c["tq"] not in fr.quant:
        raise JpegError(f"{name}: undefined quantization table {c['tq']}")
    coef = _smoothed(fr, c) if smooth else fr.coef[c["id"]]
    by, bx = coef.shape[:2]
    nat = np.zeros((by * bx, 64), np.int64)
    nat[:, ZIGZAG] = coef.reshape(-1, 64)
    pix = idct_islow(nat * fr.quant[c["tq"]])
    plane = pix.reshape(by, bx, 8, 8).swapaxes(1, 2).reshape(by * 8, bx * 8)
    return plane[:dh, :dw]


def _raw_planes(fr):
    if fr.lossless:
        raise JpegError("lossless JPEG has no raw planes")
    smooth = _smoothing_ok(fr)
    return ([_component_plane(fr, c, smooth, "") for c in fr.comps],
            [(c["h"], c["v"]) for c in fr.comps])


def _reconstruct(fr, name, colour=None):
    hmax = max(c["h"] for c in fr.comps)
    vmax = max(c["v"] for c in fr.comps)
    space = colour or _colour_space(fr, name)
    if fr.lossless and space in ("ycc", "ycck"):
        raise NotImplementedError(
            f"{name}: lossless JPEG in {space.upper()} (libjpeg-turbo does "
            f"not convert a lossless file's colours: PIL refuses it too)")
    smooth = _smoothing_ok(fr)
    planes = []
    for c in fr.comps:
        if fr.lossless:
            up = upsample(fr.samples[c["id"]], hmax // c["h"],
                          vmax // c["v"], fancy=False)
            planes.append(up[:fr.height, :fr.width])
            continue
        up = upsample(_component_plane(fr, c, smooth, name),
                      hmax // c["h"], vmax // c["v"])
        planes.append(up[:fr.height, :fr.width])
    if space == "grey":
        return planes[0].astype(np.uint8)
    if space == "rgb":
        return np.stack(planes, -1).astype(np.uint8)
    if space == "ycc":
        return _ycc_to_rgb(*planes)
    if space == "ycck":
        # libjpeg's ycck_cmyk_convert: CMY = 255 - RGB of the YCC planes
        cmy = 255 - _ycc_to_rgb(*planes[:3]).astype(np.int64)
        planes = [cmy[..., 0], cmy[..., 1], cmy[..., 2], planes[3]]
    return cmyk_to_rgb(np.stack(planes, -1))

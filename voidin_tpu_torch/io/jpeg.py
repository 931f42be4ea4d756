"""Baseline JPEG (JFIF) encoder and decoder in numpy, without PIL.

The JAX package writes and reads JPEG through PIL (``io/avi.py``'s
recorder frames, ``io/gltf.py``'s textures). The port's hosts have no PIL,
so this module carries a codec of its own:

* ``encode_jpeg`` writes an RGB image as baseline JFIF (SOF0) as PIL's
  ``Image.save(..., "JPEG", quality=q)`` does: the Annex K quantization
  tables scaled by quality as libjpeg scales them, libjpeg's fixed-point
  RGB -> YCbCr, chroma at 4:2:0 (PIL's default) averaged with libjpeg's
  alternating bias, the standard Annex K Huffman tables. The DCT is float; the entropy coder works on arrays of
  all the symbols of the image at once (no Python loop per coefficient).
* ``decode_jpeg`` reads baseline and extended-sequential 8-bit files
  (SOF0 / SOF1): greyscale and YCbCr at any sampling factors of 1 or 2
  (4:4:4, 4:2:2, 4:2:0), interleaved and single-component scans, restart
  intervals, any size. It follows libjpeg's defaults, so its pixels match
  PIL's: the integer ("islow") IDCT with its range-limit table, "fancy"
  (triangle) chroma upsampling with the edge rows and columns replicated,
  and libjpeg's fixed-point YCbCr -> RGB. Progressive (SOF2), lossless,
  hierarchical, arithmetic-coded, 12-bit and CMYK files raise
  NotImplementedError naming the file.

The Huffman decode walks the symbols in a Python loop, but every bit
position's code length and symbol is looked up for all positions at once
beforehand, so the loop does one table read a symbol.
"""

from __future__ import annotations

import struct

import numpy as np

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


def upsample(plane: np.ndarray, fx: int, fy: int) -> np.ndarray:
    """libjpeg's upsampling of a (downsampled_height, downsampled_width)
    component by (fx, fy): the fancy triangle filters for 2x1, 2x2 and
    1x2 (edges replicated), plain replication otherwise."""
    p = plane.astype(np.int64)
    fancy = p.shape[1] > 2
    if (fx, fy) == (1, 1):
        return p
    if (fx, fy) == (2, 1) and fancy:
        left, right = _clamp_shift(p, 1)
        return _interleave((3 * p + left + 1) >> 2, (3 * p + right + 2) >> 2,
                           1)
    if (fx, fy) == (1, 2):
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


def _decode_lut(counts, symbols, dc: bool):
    """For every 16-bit window: symbol << 8 | bits to advance (the code's
    length plus the magnitude bits that follow it). A window that starts
    no code reads as the symbol _BAD, which no block survives (its run
    carries the coefficient index past 63, its DC size past 11)."""
    lut = np.full(1 << 16, _BAD << 8 | 1, np.int32)
    for s, (code, n) in huffman_codes(counts, symbols).items():
        extra = s if dc else s & 15
        lut[code << (16 - n):(code + 1) << (16 - n)] = s << 8 | (n + extra)
    return lut


class _Frame:
    """What the markers of one file set: tables by id, the restart
    interval, the frame header's size and components, and each
    component's (block rows, block cols, 64) zig-zag coefficients."""

    def __init__(self):
        self.quant = {}  # table id -> (64,) natural order
        self.huff = {}  # (class, id) -> (counts, symbols)
        self.restart = 0
        self.adobe_transform = None
        self.width = self.height = None
        self.comps = []  # dicts id, h, v, tq in frame-header order
        self.coef = {}  # component id -> coefficients


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


def _decode_scan(fr, scan_comps, data, seg_starts, name):
    """Huffman-decode one sequential scan into fr.coef (per component,
    (block rows, block cols, 64) zig-zag coefficients)."""
    single = len(scan_comps) == 1
    hmax = max(c["h"] for c in fr.comps)
    vmax = max(c["v"] for c in fr.comps)
    mcux = -(-fr.width // (8 * hmax))
    mcuy = -(-fr.height // (8 * vmax))
    if single:
        c = scan_comps[0]
        bw = -(-(-(-fr.width * c["h"] // hmax)) // 8)
        bh = -(-(-(-fr.height * c["v"] // vmax)) // 8)
        n_mcu = bw * bh
        layout = [(0, np.arange(bh)[:, None].repeat(bw, 1).reshape(-1, 1),
                   np.arange(bw)[None, :].repeat(bh, 0).reshape(-1, 1))]
        per_mcu = [(0, 0, 0)]
    else:
        n_mcu = mcux * mcuy
        my, mx = np.divmod(np.arange(n_mcu), mcux)
        layout, per_mcu = [], []
        for si, c in enumerate(scan_comps):
            rows, cols = [], []
            for by in range(c["v"]):
                for bx in range(c["h"]):
                    rows.append(my * c["v"] + by)
                    cols.append(mx * c["h"] + bx)
                    per_mcu.append((si, by, bx))
            layout.append((si, np.stack(rows, 1), np.stack(cols, 1)))

    byts = np.concatenate([data, np.zeros(8, np.uint8)]).astype(np.int64)
    win = byts[:-2] << 16 | byts[1:-1] << 8 | byts[2:]
    peek = ((win[:, None] >> (8 - np.arange(8))) & 0xFFFF).reshape(-1)
    peek = peek.astype(np.int32)
    limit = 8 * len(data)
    luts = {}
    for c in scan_comps:
        for cls, tid in ((0, c["td"]), (1, c["ta"])):
            if (cls, tid) not in luts:
                if (cls, tid) not in fr.huff:
                    raise JpegError(f"{name}: scan uses an undefined "
                                     f"Huffman table {(cls, tid)}")
                counts, symbols = fr.huff[(cls, tid)]
                luts[(cls, tid)] = _decode_lut(counts, symbols, cls == 0)[peek]
    views = {k: memoryview(v) for k, v in luts.items()}
    mcu_tables = [(views[(0, scan_comps[si]["td"])],
                   views[(1, scan_comps[si]["ta"])]) for si, _, _ in per_mcu]

    dc_pos, ac_pos, ac_k, ac_end = [], [], [], []
    dc_append, ac_append, k_append = dc_pos.append, ac_pos.append, ac_k.append
    end_append = ac_end.append
    restart = fr.restart
    seg = 0
    p = 0
    try:
        for m in range(n_mcu):
            if restart and m and m % restart == 0:
                seg += 1
                if seg >= len(seg_starts):
                    raise JpegError(f"{name}: restart marker missing")
                p = 8 * int(seg_starts[seg])
            for dct, act in mcu_tables:
                dc_append(p)
                p += dct[p] & 255
                k = 1
                while k < 64:
                    c = act[p]
                    s = c >> 8
                    q = p
                    p += c & 255
                    if s == 0:
                        break
                    if s == 0xF0:
                        k += 16
                        continue
                    k += s >> 4
                    ac_append(q)
                    k_append(k)
                    k += 1
                end_append(len(ac_pos))
            if p > limit:
                raise JpegError(f"{name}: JPEG data ends inside a block")
    except IndexError:
        raise JpegError(f"{name}: corrupt JPEG entropy data") from None

    n_blocks = len(dc_pos)
    blk_tables = np.tile(np.array([[scan_comps[si]["td"],
                                    scan_comps[si]["ta"], si]
                                   for si, _, _ in per_mcu]), (n_mcu, 1))

    def values(pos, cls, tids):
        comb = np.zeros(len(pos), np.int64)
        for tid in np.unique(tids):
            sel = tids == tid
            comb[sel] = luts[(cls, int(tid))][pos[sel]]
        sym = comb >> 8
        if cls == 0 and len(sym) and sym.max() > 11:
            raise JpegError(f"{name}: corrupt JPEG data (DC size)")
        size = sym if cls == 0 else sym & 15
        start = pos + (comb & 255) - size
        bits = peek[start].astype(np.int64) >> (16 - size)
        return np.where(size == 0, 0,
                        np.where(bits >= (1 << np.maximum(size - 1, 0)),
                                 bits, bits - (1 << size) + 1))

    dc_pos = np.asarray(dc_pos, np.int64)
    diff = values(dc_pos, 0, blk_tables[:, 0])
    ac_pos = np.asarray(ac_pos, np.int64)
    ac_k = np.asarray(ac_k, np.int64)
    if len(ac_k) and ac_k.max() > 63:
        raise JpegError(f"{name}: corrupt JPEG data (run past the block)")
    ac_blk = np.repeat(np.arange(n_blocks), np.diff(
        np.concatenate([[0], np.asarray(ac_end, np.int64)])))
    ac_val = values(ac_pos, 1, blk_tables[ac_blk, 1])

    # DC predictors: per component, reset at each restart interval
    blocks_per_mcu = len(per_mcu)
    interval = (np.arange(n_blocks) // blocks_per_mcu) // restart if restart \
        else np.zeros(n_blocks, np.int64)
    zz = np.zeros((n_blocks, 64), np.int64)
    zz[ac_blk, ac_k] = ac_val
    comp_of = blk_tables[:, 2]
    for si in range(len(scan_comps)):
        sel = np.flatnonzero(comp_of == si)
        d = diff[sel]
        cs = np.cumsum(d)
        first = np.ones(len(sel), bool)
        first[1:] = interval[sel][1:] != interval[sel][:-1]
        base = np.maximum.accumulate(np.where(first, np.arange(len(sel)), 0))
        zz[sel, 0] = cs - cs[base] + d[base]
    for si, rows, cols in layout:
        c = scan_comps[si]
        sel = np.flatnonzero(comp_of == si)
        fr.coef[c["id"]][rows.reshape(-1), cols.reshape(-1)] = zz[sel]


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A JPEG's bytes as (H, W, 3) uint8 RGB, or (H, W) uint8 for a
    greyscale file (see the module docstring for what is read). A file
    cut short or otherwise malformed raises ValueError naming it."""
    buf = np.frombuffer(bytes(data), np.uint8)
    if bytes(buf[:2]) != SOI:
        raise JpegError(f"{name}: not a JPEG")
    try:
        return _reconstruct(_parse(buf, name), name)
    except JpegError:
        raise
    except (IndexError, KeyError, ValueError, struct.error) as exc:
        raise JpegError(f"{name}: malformed JPEG ({exc})") from None


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
        if marker in (0xC0, 0xC1):
            prec, h, w, nf = struct.unpack(">BHHB", body[:6])
            if prec != 8:
                raise NotImplementedError(
                    f"{name}: {prec}-bit JPEG samples are not decoded")
            if h == 0:
                raise NotImplementedError(f"{name}: JPEG height set by DNL")
            if nf not in (1, 3):
                raise NotImplementedError(
                    f"{name}: JPEG with {nf} components (only greyscale and "
                    f"YCbCr are decoded)")
            fr.width, fr.height = w, h
            for k in range(nf):
                cid, hv, tq = body[6 + 3 * k:9 + 3 * k]
                fr.comps.append(dict(id=cid, h=hv >> 4, v=hv & 15, tq=tq))
            hmax = max(c["h"] for c in fr.comps)
            vmax = max(c["v"] for c in fr.comps)
            if any(not (1 <= c["h"] <= 2 and 1 <= c["v"] <= 2)
                   or hmax % c["h"] or vmax % c["v"] for c in fr.comps):
                raise NotImplementedError(
                    f"{name}: JPEG sampling factors "
                    f"{[(c['h'], c['v']) for c in fr.comps]}")
            mcux = -(-w // (8 * hmax))
            mcuy = -(-h // (8 * vmax))
            for c in fr.comps:
                fr.coef[c["id"]] = np.zeros((mcuy * c["v"], mcux * c["h"],
                                             64), np.int64)
        elif 0xC2 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            kind = "progressive (SOF2)" if marker == 0xC2 else (
                f"SOF{marker - 0xC0}")
            raise NotImplementedError(
                f"{name}: {kind} JPEG is not decoded (baseline and "
                f"extended-sequential only)")
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
            scan, seg_starts, i = _parse_scan_data(buf, i)
            _decode_scan(fr, scan_comps, scan, seg_starts, name)
    if fr.width is None:
        raise JpegError(f"{name}: no frame header")
    return fr


def _reconstruct(fr, name):
    hmax = max(c["h"] for c in fr.comps)
    vmax = max(c["v"] for c in fr.comps)
    planes = []
    for c in fr.comps:
        if c["tq"] not in fr.quant:
            raise JpegError(f"{name}: undefined quantization table "
                             f"{c['tq']}")
        coef = fr.coef[c["id"]]
        by, bx = coef.shape[:2]
        nat = np.zeros((by * bx, 64), np.int64)
        nat[:, ZIGZAG] = coef.reshape(-1, 64)
        pix = idct_islow(nat * fr.quant[c["tq"]])
        plane = pix.reshape(by, bx, 8, 8).swapaxes(1, 2).reshape(
            by * 8, bx * 8)
        dw = -(-fr.width * c["h"] // hmax)
        dh = -(-fr.height * c["v"] // vmax)
        up = upsample(plane[:dh, :dw], hmax // c["h"], vmax // c["v"])
        planes.append(up[:fr.height, :fr.width])
    if len(planes) == 1:
        return planes[0].astype(np.uint8)
    if fr.adobe_transform == 0:
        return np.stack(planes, -1).astype(np.uint8)
    return _ycc_to_rgb(*planes)

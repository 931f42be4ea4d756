"""WebP decoding to PIL's pixels, with numpy and the standard library.

PIL (12) opens a WebP through libwebp's WebPAnimDecoder and converts the
first frame to RGBA; ``decode_webp`` gives the same (H, W, 4) uint8
words:

- the RIFF container: simple VP8 (lossy) and VP8L (lossless) files, and
  VP8X with ALPH, ICCP / EXIF / XMP (skipped) and ANIM / ANMF, whose first
  frame is drawn at its offset on a canvas of zeros (transparent black:
  the decoder ignores ANIM's background colour); where the file declares
  no alpha, alpha is 255 everywhere, as PIL's RGB mode gives it;
- VP8L: prefix codes (simple and normal, the code-length code, meta codes
  by an entropy image), LZ77 with the 120 plane codes and the colour
  cache, and the four transforms undone in reverse order: predictor modes
  0-13 with libwebp's averaging (Average2 truncates), Select and the
  clamped add-subtract pair, cross colour, subtract green, and colour
  indexing with 1, 2 or 4 bits a pixel packed into a narrowed width;
- VP8 key frames: the boolean decoder, segments (map, quantizer and
  filter deltas, absolute or relative), token partitions, coefficient
  probability updates, skip flags, 16x16, 4x4 and chroma intra prediction
  with libwebp's borders (127 above the frame, 129 left of it, the top-
  right of the rightmost macroblock replicated), the Walsh-Hadamard and
  the integer DCT inverse, the simple and normal loop filters with
  sharpness and mode deltas, and libwebp's YUV to RGB: fancy upsampling
  of the chroma, its 14-bit fixed point VP8YUVToR/G/B and clipping;
- ALPH: raw or VP8L-coded (the green channel) alpha with horizontal,
  vertical and gradient unfiltering; pre-processing and dithering stay
  off, as PIL leaves them.

A file that is not a WebP, or is damaged, raises ValueError naming it.
"""

from __future__ import annotations

import struct

import numpy as np

from . import vp8_tables as T


class _Error(ValueError):
    pass


# --- VP8L -----------------------------------------------------------------

class _Bits:
    """VP8L's bit reader: least significant bit first."""

    def __init__(self, data: bytes):
        self.data = data + bytes(8)
        self.pos = 0
        self.end = 8 * len(data)

    def read(self, n):
        if n == 0:
            return 0
        p = self.pos
        i = p >> 3
        v = int.from_bytes(self.data[i:i + 8], "little") >> (p & 7)
        self.pos = p + n
        if self.pos > self.end + 64:
            raise _Error("VP8L bitstream truncated")
        return v & ((1 << n) - 1)

    def peek(self, n):
        p = self.pos
        i = p >> 3
        return (int.from_bytes(self.data[i:i + 8], "little") >> (p & 7)) & (
            (1 << n) - 1)


class _Prefix:
    """A canonical prefix code read least significant bit first: a lookup
    of the next `max_len` bits."""

    def __init__(self, lengths):
        lengths = [int(x) for x in lengths]
        used = [s for s, n in enumerate(lengths) if n]
        if not used:
            raise _Error("VP8L prefix code without symbols")
        if len(used) == 1:  # a lone symbol costs no bits
            self.single = used[0]
            return
        self.single = None
        max_len = max(lengths)
        count = [0] * (max_len + 1)
        for n in lengths:
            if n:
                count[n] += 1
        nxt = [0] * (max_len + 1)  # the first code of each length
        code = 0
        for n in range(1, max_len + 1):
            nxt[n] = code
            code = (code + count[n]) << 1
        table = [(0, 0)] * (1 << max_len)
        for s in range(len(lengths)):
            n = lengths[s]
            if not n:
                continue
            c = nxt[n]
            nxt[n] += 1
            rev = int(format(c, f"0{n}b")[::-1], 2)
            for fill in range(0, 1 << max_len, 1 << n):
                table[rev | fill] = (s, n)
        self.table = table
        self.max_len = max_len

    def read(self, br):
        if self.single is not None:
            return self.single
        s, n = self.table[br.peek(self.max_len)]
        br.pos += n
        return s


_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12,
                      13, 14, 15)


def _read_prefix(br, alphabet):
    if br.read(1):  # simple code
        n_sym = br.read(1) + 1
        first8 = br.read(1)
        lengths = [0] * alphabet
        s0 = br.read(8 if first8 else 1)
        if s0 >= alphabet:
            raise _Error("VP8L simple code symbol out of range")
        lengths[s0] = 1
        if n_sym == 2:
            s1 = br.read(8)
            if s1 >= alphabet:
                raise _Error("VP8L simple code symbol out of range")
            lengths[s1] = 1
        return _Prefix(lengths)
    n_cl = 4 + br.read(4)
    cl = [0] * 19
    for i in range(n_cl):
        cl[_CODE_LENGTH_ORDER[i]] = br.read(3)
    cl_code = _Prefix(cl)
    if br.read(1):
        length_nbits = 2 + 2 * br.read(3)
        max_symbol = 2 + br.read(length_nbits)
        if max_symbol > alphabet:
            raise _Error("VP8L code length count too large")
    else:
        max_symbol = alphabet
    lengths = [0] * alphabet
    symbol = 0
    prev = 8
    while symbol < alphabet:
        if max_symbol == 0:
            break
        max_symbol -= 1
        c = cl_code.read(br)
        if c < 16:
            lengths[symbol] = c
            symbol += 1
            if c:
                prev = c
        else:
            extra, offset = {16: (2, 3), 17: (3, 3), 18: (7, 11)}[c]
            repeat = br.read(extra) + offset
            if symbol + repeat > alphabet:
                raise _Error("VP8L code lengths overflow")
            val = prev if c == 16 else 0
            lengths[symbol:symbol + repeat] = [val] * repeat
            symbol += repeat
    return _Prefix(lengths)


# (dx, dy) of the 120 plane codes (RFC 9649 4.2.2)
_PLANE = (
    (0, 1), (1, 0), (1, 1), (-1, 1), (0, 2), (2, 0), (1, 2), (-1, 2),
    (2, 1), (-2, 1), (2, 2), (-2, 2), (0, 3), (3, 0), (1, 3), (-1, 3),
    (3, 1), (-3, 1), (2, 3), (-2, 3), (3, 2), (-3, 2), (0, 4), (4, 0),
    (1, 4), (-1, 4), (4, 1), (-4, 1), (3, 3), (-3, 3), (2, 4), (-2, 4),
    (4, 2), (-4, 2), (0, 5), (3, 4), (-3, 4), (4, 3), (-4, 3), (5, 0),
    (1, 5), (-1, 5), (5, 1), (-5, 1), (2, 5), (-2, 5), (5, 2), (-5, 2),
    (4, 4), (-4, 4), (3, 5), (-3, 5), (5, 3), (-5, 3), (0, 6), (6, 0),
    (1, 6), (-1, 6), (6, 1), (-6, 1), (2, 6), (-2, 6), (6, 2), (-6, 2),
    (4, 5), (-4, 5), (5, 4), (-5, 4), (3, 6), (-3, 6), (6, 3), (-6, 3),
    (0, 7), (7, 0), (1, 7), (-1, 7), (5, 5), (-5, 5), (7, 1), (-7, 1),
    (4, 6), (-4, 6), (6, 4), (-6, 4), (2, 7), (-2, 7), (7, 2), (-7, 2),
    (3, 7), (-3, 7), (7, 3), (-7, 3), (5, 6), (-5, 6), (6, 5), (-6, 5),
    (8, 0), (4, 7), (-4, 7), (7, 4), (-7, 4), (8, 1), (8, 2), (6, 6),
    (-6, 6), (8, 3), (5, 7), (-5, 7), (7, 5), (-7, 5), (8, 4), (6, 7),
    (-6, 7), (7, 6), (-7, 6), (8, 5), (7, 7), (-7, 7), (8, 6), (8, 7))


def _copy_length(br, sym):
    if sym < 4:
        return sym + 1
    extra = (sym - 2) >> 1
    offset = (2 + (sym & 1)) << extra
    return offset + br.read(extra) + 1


def _decode_pixels(br, w, h, level0):
    """One entropy-coded image of w x h ARGB words (a list)."""
    cache_bits = br.read(4) if br.read(1) else 0
    if cache_bits > 11:
        raise _Error("VP8L colour cache size")
    meta_bits = 0
    meta = None
    n_groups = 1
    if level0 and br.read(1):
        meta_bits = br.read(3) + 2
        mw = -(-w // (1 << meta_bits))
        mh = -(-h // (1 << meta_bits))
        img = _decode_pixels(br, mw, mh, False)
        meta = [(p >> 8) & 0xFFFF for p in img]
        n_groups = max(meta) + 1
    cache_size = (1 << cache_bits) if cache_bits else 0
    groups = []
    for _ in range(n_groups):
        groups.append([_read_prefix(br, 256 + 24 + cache_size),
                       _read_prefix(br, 256), _read_prefix(br, 256),
                       _read_prefix(br, 256), _read_prefix(br, 40)])
    n = w * h
    out = [0] * n
    cache = [0] * cache_size
    shift = 32 - cache_bits
    last_cached = 0
    pos = 0
    mw = -(-w // (1 << meta_bits)) if meta is not None else 0
    group = groups[0]
    while pos < n:
        if meta is not None:  # the group of the block under pos
            y, x = divmod(pos, w)
            group = groups[meta[(y >> meta_bits) * mw + (x >> meta_bits)]]
        code = group[0].read(br)
        if code < 256:
            red = group[1].read(br)
            blue = group[2].read(br)
            alpha = group[3].read(br)
            out[pos] = (alpha << 24) | (red << 16) | (code << 8) | blue
            pos += 1
        elif code < 280:
            length = _copy_length(br, code - 256)
            dsym = group[4].read(br)
            dcode = _copy_length(br, dsym)
            if dcode > 120:
                dist = dcode - 120
            else:
                dx, dy = _PLANE[dcode - 1]
                dist = dx + dy * w
                if dist < 1:
                    dist = 1
            if dist > pos or pos + length > n:
                raise _Error("VP8L backward reference out of range")
            for k in range(length):
                out[pos + k] = out[pos + k - dist]
            pos += length
        else:
            if not cache_size:
                raise _Error("VP8L colour cache code without a cache")
            while last_cached < pos:
                p = out[last_cached]
                cache[((p * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = p
                last_cached += 1
            out[pos] = cache[code - 280]
            pos += 1
        if cache_size:
            while last_cached < pos:
                p = out[last_cached]
                cache[((p * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = p
                last_cached += 1
    return out


def _argb(words, h, w):
    """ARGB words -> (h, w, 4) int64 planes in (A, R, G, B) order."""
    a = np.asarray(words, np.uint32).reshape(h, w)
    return np.stack([(a >> s) & 0xFF for s in (24, 16, 8, 0)],
                    -1).astype(np.int64)


def _average2(a, b):
    return (a + b) >> 1


def _select(left, top, top_left):
    p_l = np.abs(top - top_left).sum(-1)
    p_t = np.abs(left - top_left).sum(-1)
    return np.where((p_l < p_t)[..., None], left, top)


def _clamp_add_sub_full(a, b, c):
    return np.clip(a + b - c, 0, 255)


def _clamp_add_sub_half(a, b):
    d = a - b
    return np.clip(a + np.trunc(d / 2).astype(np.int64), 0, 255)


def _predict(mode, left, top, top_right, top_left):
    if mode == 0:
        return np.array([255, 0, 0, 0], np.int64)
    if mode == 1:
        return left
    if mode == 2:
        return top
    if mode == 3:
        return top_right
    if mode == 4:
        return top_left
    if mode == 5:
        return _average2(_average2(left, top_right), top)
    if mode == 6:
        return _average2(left, top_left)
    if mode == 7:
        return _average2(left, top)
    if mode == 8:
        return _average2(top_left, top)
    if mode == 9:
        return _average2(top, top_right)
    if mode == 10:
        return _average2(_average2(left, top_left), _average2(top, top_right))
    if mode == 11:
        return _select(left, top, top_left)
    if mode == 12:
        return _clamp_add_sub_full(left, top, top_left)
    if mode == 13:
        return _clamp_add_sub_half(_average2(left, top), top_left)
    return np.array([255, 0, 0, 0], np.int64)  # modes 14, 15: black


def _unpredict(res, bits, modes_img):
    """Predictor transform inverse, row by row (each row needs the one
    above; within a row, pixels of one mode share a vectorised pass that
    walks left to right where the mode reads its left neighbour)."""
    h, w = res.shape[:2]
    out = np.zeros_like(res)
    mode_of = (modes_img[..., 2] & 0xF)  # green channel
    for y in range(h):
        row = res[y]
        if y == 0:
            acc = np.array([255, 0, 0, 0], np.int64)
            for x in range(w):
                acc = (row[x] + acc) & 0xFF
                out[0, x] = acc
            continue
        up = out[y - 1]
        # TR of the rightmost pixel is the leftmost of this row
        for x in range(w):
            if x == 0:
                pred = up[0]
            else:
                mode = int(mode_of[y >> bits, x >> bits])
                left = out[y, x - 1]
                tr = up[x + 1] if x + 1 < w else out[y, 0]
                pred = _predict(mode, left, up[x], tr, up[x - 1])
            out[y, x] = (row[x] + pred) & 0xFF
    return out


def _delta(t, c):
    """ColorTransformDelta: (int8 t * int8 c) >> 5."""
    t = np.where(t >= 128, t - 256, t)
    c = np.where(c >= 128, c - 256, c)
    return (t * c) >> 5


def _uncross(px, bits, elems):
    h, w = px.shape[:2]
    ys = np.arange(h)[:, None] >> bits
    xs = np.arange(w)[None, :] >> bits
    e = elems[ys, xs]  # (h, w, 4) A R G B of the element
    g2r, g2b, r2b = e[..., 3], e[..., 2], e[..., 1]
    g = px[..., 2]
    r = (px[..., 1] + _delta(g2r, g)) & 0xFF
    b = (px[..., 3] + _delta(g2b, g) + _delta(r2b, r)) & 0xFF
    out = px.copy()
    out[..., 1] = r
    out[..., 3] = b
    return out


def _decode_vp8l_stream(br, w, h):
    """A VP8L image of w x h after its header: (h, w, 4) ARGB planes."""
    transforms = []
    xsize = w
    seen = set()
    while br.read(1):
        kind = br.read(2)
        if kind in seen:
            raise _Error("VP8L transform repeated")
        seen.add(kind)
        if kind in (0, 1):
            bits = br.read(3) + 2
            bw, bh = -(-xsize // (1 << bits)), -(-h // (1 << bits))
            data = _argb(_decode_pixels(br, bw, bh, False), bh, bw)
            transforms.append((kind, bits, data, xsize))
        elif kind == 2:
            transforms.append((2, 0, None, xsize))
        else:
            n_colors = br.read(8) + 1
            bits = 0 if n_colors > 16 else 1 if n_colors > 4 else (
                2 if n_colors > 2 else 3)
            pal = _argb(_decode_pixels(br, n_colors, 1, False), 1, n_colors)[0]
            pal = np.cumsum(pal, axis=0) & 0xFF  # delta-coded entries
            transforms.append((3, bits, pal, xsize))
            xsize = -(-xsize // (1 << bits))
    px = _argb(_decode_pixels(br, xsize, h, True), h, xsize)
    for kind, bits, data, width in reversed(transforms):
        if kind == 0:
            px = _unpredict(px, bits, data)
        elif kind == 1:
            px = _uncross(px, bits, data)
        elif kind == 2:
            px = px.copy()
            px[..., 1] = (px[..., 1] + px[..., 2]) & 0xFF
            px[..., 3] = (px[..., 3] + px[..., 2]) & 0xFF
        else:
            idx = px[..., 2]
            if bits:
                per = 1 << bits
                bpp = 8 >> bits
                x = np.arange(width)
                idx = (idx[:, x >> bits] >> ((x & (per - 1)) * bpp)) & (
                    (1 << bpp) - 1)
            full = np.zeros((256, 4), np.int64)
            full[:len(data)] = data[:256]
            px = full[idx]
    return px


def decode_vp8l(data: bytes):
    """A VP8L chunk: ((h, w, 4) RGBA uint8, alpha_is_used)."""
    if len(data) < 5 or data[0] != 0x2F:
        raise _Error("not a VP8L bitstream")
    br = _Bits(data)
    br.read(8)
    w = br.read(14) + 1
    h = br.read(14) + 1
    alpha = br.read(1)
    if br.read(3) != 0:
        raise _Error("VP8L version")
    px = _decode_vp8l_stream(br, w, h)
    return px[..., [1, 2, 3, 0]].astype(np.uint8), bool(alpha)


# --- VP8 ------------------------------------------------------------------

class _Bool:
    """The VP8 boolean decoder (RFC 6386 7.3); zeros past the end."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 2
        self.value = (data[0] << 8 | data[1]) if len(data) >= 2 else (
            data[0] << 8 if data else 0)
        self.range = 255
        self.count = 0

    def bit(self, prob):
        split = 1 + (((self.range - 1) * prob) >> 8)
        big = split << 8
        if self.value >= big:
            self.range -= split
            self.value -= big
            b = 1
        else:
            self.range = split
            b = 0
        while self.range < 128:
            self.value <<= 1
            self.range <<= 1
            self.count += 1
            if self.count == 8:
                self.count = 0
                if self.pos < len(self.data):
                    self.value |= self.data[self.pos]
                self.pos += 1
        return b

    def value_bits(self, n):
        v = 0
        for i in range(n - 1, -1, -1):
            v |= self.bit(128) << i
        return v

    def signed(self, n):
        v = self.value_bits(n)
        return -v if self.bit(128) else v


_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_CAT3456 = ((173, 148, 140), (176, 155, 140, 135),
            (180, 157, 141, 134, 130),
            (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# the key-frame 4x4 mode tree (libwebp kYModesIntra4): >0 a node, <=0 a
# leaf -mode
_YMODES_INTRA4 = (0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8,
                  -9)
DC_PRED, TM_PRED, V_PRED, H_PRED = 0, 1, 2, 3


def _large_value(br, p):
    if not br.bit(p[3]):
        if not br.bit(p[4]):
            return 2
        return 3 + br.bit(p[5])
    if not br.bit(p[6]):
        if not br.bit(p[7]):
            return 5 + br.bit(159)
        v = 7 + 2 * br.bit(165)
        return v + br.bit(145)
    bit1 = br.bit(p[8])
    bit0 = br.bit(p[9 + bit1])
    cat = 2 * bit1 + bit0
    v = 0
    for t in _CAT3456[cat]:
        v += v + br.bit(t)
    return v + 3 + (8 << cat)


def _coeffs(br, probs, ctx, dq, n, out):
    """GetCoeffs: tokens of one 4x4 block from coefficient `n`, dequantised
    into `out` (raster order); returns the index after the last nonzero
    one (16 at most)."""
    p = probs[n][ctx]
    while n < 16:
        if not br.bit(p[0]):
            return n
        while not br.bit(p[1]):
            n += 1
            if n == 16:
                return 16
            p = probs[n][0]
        if not br.bit(p[2]):
            v = 1
            p = probs[n + 1][1]
        else:
            v = _large_value(br, p)
            p = probs[n + 1][2]
        if br.bit(128):
            v = -v
        out[_ZIGZAG[n]] = v * dq[1 if n > 0 else 0]
        n += 1
    return 16


def _wht(dc):
    """The inverse Walsh-Hadamard transform of the 16 Y2 values."""
    i = np.asarray(dc, np.int64).reshape(4, 4)
    a0 = i[0] + i[3]
    a1 = i[1] + i[2]
    a2 = i[1] - i[2]
    a3 = i[0] - i[3]
    t = np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2])  # rows 0-3
    dc_ = t[:, 0] + 3
    b0 = dc_ + t[:, 3]
    b1 = t[:, 1] + t[:, 2]
    b2 = t[:, 1] - t[:, 2]
    b3 = dc_ - t[:, 3]
    out = np.stack([(b0 + b1) >> 3, (b3 + b2) >> 3, (b0 - b1) >> 3,
                    (b3 - b2) >> 3], axis=1)  # [row i] -> blocks 4i..4i+3
    return out.reshape(16)


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def _idct_add(coeffs, pred):
    """TransformOne: the inverse DCT of (..., 16) raster coefficients added
    to (..., 4, 4) predictions, clipped."""
    c = coeffs.reshape(coeffs.shape[:-1] + (4, 4)).astype(np.int64)
    # vertical pass, column by column
    a = c[..., 0, :] + c[..., 2, :]
    b = c[..., 0, :] - c[..., 2, :]
    cc = _mul2(c[..., 1, :]) - _mul1(c[..., 3, :])
    d = _mul1(c[..., 1, :]) + _mul2(c[..., 3, :])
    t = np.stack([a + d, b + cc, b - cc, a - d], axis=-2)  # [k][col]
    # horizontal pass, row by row (row k of the output from t[..., k, :])
    dc = t[..., :, 0] + 4
    a = dc + t[..., :, 2]
    b = dc - t[..., :, 2]
    cc = _mul2(t[..., :, 1]) - _mul1(t[..., :, 3])
    d = _mul1(t[..., :, 1]) + _mul2(t[..., :, 3])
    res = np.stack([a + d, b + cc, b - cc, a - d], axis=-1)  # [row][x]
    return np.clip(pred.astype(np.int64) + (res >> 3), 0, 255)


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _pred4(mode, top, left, tl):
    """A 4x4 intra prediction (libwebp dsp/dec.c): `top` the 8 pixels
    above (4 then the top-right 4), `left` the 4 to the left, `tl` the
    corner. Returns a (4, 4) int array [row][column]."""
    A, B, C, D, E, F, G, H = (int(v) for v in top)
    I, J, K, L = (int(v) for v in left)
    X = int(tl)
    o = [[0] * 4 for _ in range(4)]  # o[y][x]

    def put(cells, v):
        for x, y in cells:
            o[y][x] = v

    if mode == 0:  # DC
        v = (A + B + C + D + I + J + K + L + 4) >> 3
        return np.full((4, 4), v, np.int64)
    if mode == 1:  # TM
        tv = np.array([A, B, C, D])
        lv = np.array([I, J, K, L])
        return np.clip(tv[None, :] + lv[:, None] - X, 0, 255)
    if mode == 2:  # VE
        vals = [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D),
                _avg3(C, D, E)]
        return np.tile(np.array(vals), (4, 1))
    if mode == 3:  # HE
        vals = [_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L),
                _avg3(K, L, L)]
        return np.tile(np.array(vals)[:, None], (1, 4))
    if mode == 4:  # RD
        put([(0, 3)], _avg3(J, K, L))
        put([(1, 3), (0, 2)], _avg3(I, J, K))
        put([(2, 3), (1, 2), (0, 1)], _avg3(X, I, J))
        put([(3, 3), (2, 2), (1, 1), (0, 0)], _avg3(A, X, I))
        put([(3, 2), (2, 1), (1, 0)], _avg3(B, A, X))
        put([(3, 1), (2, 0)], _avg3(C, B, A))
        put([(3, 0)], _avg3(D, C, B))
    elif mode == 5:  # VR
        put([(0, 0), (1, 2)], _avg2(X, A))
        put([(1, 0), (2, 2)], _avg2(A, B))
        put([(2, 0), (3, 2)], _avg2(B, C))
        put([(3, 0)], _avg2(C, D))
        put([(0, 3)], _avg3(K, J, I))
        put([(0, 2)], _avg3(J, I, X))
        put([(0, 1), (1, 3)], _avg3(I, X, A))
        put([(1, 1), (2, 3)], _avg3(X, A, B))
        put([(2, 1), (3, 3)], _avg3(A, B, C))
        put([(3, 1)], _avg3(B, C, D))
    elif mode == 6:  # LD
        put([(0, 0)], _avg3(A, B, C))
        put([(1, 0), (0, 1)], _avg3(B, C, D))
        put([(2, 0), (1, 1), (0, 2)], _avg3(C, D, E))
        put([(3, 0), (2, 1), (1, 2), (0, 3)], _avg3(D, E, F))
        put([(3, 1), (2, 2), (1, 3)], _avg3(E, F, G))
        put([(3, 2), (2, 3)], _avg3(F, G, H))
        put([(3, 3)], _avg3(G, H, H))
    elif mode == 7:  # VL
        put([(0, 0)], _avg2(A, B))
        put([(1, 0), (0, 2)], _avg2(B, C))
        put([(2, 0), (1, 2)], _avg2(C, D))
        put([(3, 0), (2, 2)], _avg2(D, E))
        put([(0, 1)], _avg3(A, B, C))
        put([(1, 1), (0, 3)], _avg3(B, C, D))
        put([(2, 1), (1, 3)], _avg3(C, D, E))
        put([(3, 1), (2, 3)], _avg3(D, E, F))
        put([(3, 2)], _avg3(E, F, G))
        put([(3, 3)], _avg3(F, G, H))
    elif mode == 8:  # HD
        put([(0, 0), (2, 1)], _avg2(I, X))
        put([(0, 1), (2, 2)], _avg2(J, I))
        put([(0, 2), (2, 3)], _avg2(K, J))
        put([(0, 3)], _avg2(L, K))
        put([(3, 0)], _avg3(A, B, C))
        put([(2, 0)], _avg3(X, A, B))
        put([(1, 0), (3, 1)], _avg3(I, X, A))
        put([(1, 1), (3, 2)], _avg3(J, I, X))
        put([(1, 2), (3, 3)], _avg3(K, J, I))
        put([(1, 3)], _avg3(L, K, J))
    else:  # HU
        put([(0, 0)], _avg2(I, J))
        put([(2, 0), (0, 1)], _avg2(J, K))
        put([(2, 1), (0, 2)], _avg2(K, L))
        put([(1, 0)], _avg3(I, J, K))
        put([(3, 0), (1, 1)], _avg3(J, K, L))
        put([(3, 1), (1, 2)], _avg3(K, L, L))
        put([(3, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3)], L)
    return np.array(o, np.int64)


def _pred_block(mode, buf, size, mb_x, mb_y):
    """16x16 or 8x8 prediction from a (size + 1, size + 1 [+ 4]) buffer
    whose row 0 / column 0 hold the borders."""
    top = buf[0, 1:size + 1].astype(np.int64)
    left = buf[1:size + 1, 0].astype(np.int64)
    shift = 4 if size == 16 else 3
    if mode == DC_PRED:
        if mb_x == 0 and mb_y == 0:
            return np.full((size, size), 128, np.int64)
        if mb_y == 0:  # no top
            v = (int(left.sum()) + (size >> 1)) >> shift
        elif mb_x == 0:  # no left
            v = (int(top.sum()) + (size >> 1)) >> shift
        else:
            v = (int(top.sum()) + int(left.sum()) + size) >> (shift + 1)
        return np.full((size, size), v, np.int64)
    if mode == TM_PRED:
        return np.clip(top[None, :] + left[:, None] - int(buf[0, 0]), 0, 255)
    if mode == V_PRED:
        return np.tile(top, (size, 1))
    return np.tile(left[:, None], (1, size))


class _VP8Frame:
    """Key-frame headers and per-macroblock syntax of a VP8 chunk."""

    def __init__(self, data: bytes):
        if len(data) < 10:
            raise _Error("VP8 frame truncated")
        bits = data[0] | data[1] << 8 | data[2] << 16
        if bits & 1:
            raise _Error("VP8 frame is not a key frame")
        part0 = bits >> 5
        if data[3:6] != b"\x9d\x01\x2a":
            raise _Error("VP8 start code")
        self.width = (data[6] | data[7] << 8) & 0x3FFF
        self.height = (data[8] | data[9] << 8) & 0x3FFF
        if 10 + part0 > len(data):
            raise _Error("VP8 first partition truncated")
        br = _Bool(data[10:10 + part0])
        self.br = br
        br.bit(128)  # colour space
        br.bit(128)  # clamping type
        # segment header
        self.use_segment = br.bit(128)
        self.update_map = 0
        self.absolute = 1
        self.seg_q = [0] * 4
        self.seg_f = [0] * 4
        self.seg_probs = [255] * 3
        if self.use_segment:
            self.update_map = br.bit(128)
            if br.bit(128):
                self.absolute = br.bit(128)
                self.seg_q = [br.signed(7) if br.bit(128) else 0
                              for _ in range(4)]
                self.seg_f = [br.signed(6) if br.bit(128) else 0
                              for _ in range(4)]
            if self.update_map:
                self.seg_probs = [br.value_bits(8) if br.bit(128) else 255
                                  for _ in range(3)]
        # filter header
        self.simple = br.bit(128)
        self.level = br.value_bits(6)
        self.sharpness = br.value_bits(3)
        self.use_lf_delta = br.bit(128)
        self.ref_lf = [0] * 4
        self.mode_lf = [0] * 4
        if self.use_lf_delta and br.bit(128):
            for i in range(4):
                if br.bit(128):
                    self.ref_lf[i] = br.signed(6)
            for i in range(4):
                if br.bit(128):
                    self.mode_lf[i] = br.signed(6)
        self.filter_type = 0 if self.level == 0 else (1 if self.simple
                                                      else 2)
        # token partitions
        n_parts = 1 << br.value_bits(2)
        rest = data[10 + part0:]
        sizes_len = 3 * (n_parts - 1)
        if len(rest) < sizes_len:
            raise _Error("VP8 partition table truncated")
        start = sizes_len
        left = len(rest) - sizes_len
        self.parts = []
        for p in range(n_parts - 1):
            psize = rest[3 * p] | rest[3 * p + 1] << 8 | rest[3 * p + 2] << 16
            psize = min(psize, left)
            self.parts.append(_Bool(rest[start:start + psize]))
            start += psize
            left -= psize
        self.parts.append(_Bool(rest[start:]))
        # quantizers
        base = br.value_bits(7)
        dq = [br.signed(4) if br.bit(128) else 0 for _ in range(5)]
        self.quant = []
        for s in range(4):
            if self.use_segment:
                q = self.seg_q[s] + (0 if self.absolute else base)
            else:
                q = base

            def c(v, m=127):
                return 0 if v < 0 else m if v > m else v

            y2ac = int(T.AC_TABLE[c(q + dq[2])]) * 101581 >> 16
            self.quant.append(dict(
                y1=(int(T.DC_TABLE[c(q + dq[0])]), int(T.AC_TABLE[c(q)])),
                y2=(int(T.DC_TABLE[c(q + dq[1])]) * 2, max(y2ac, 8)),
                uv=(int(T.DC_TABLE[c(q + dq[3], 117)]),
                    int(T.AC_TABLE[c(q + dq[4])]))))
        br.bit(128)  # refresh entropy probs: ignored
        probs = T.COEFFS_PROBA0.astype(np.int64).copy()
        upd = T.COEFFS_UPDATE_PROBA
        for t in range(4):
            for b in range(8):
                for ctx in range(3):
                    for p in range(11):
                        if br.bit(int(upd[t, b, ctx, p])):
                            probs[t, b, ctx, p] = br.value_bits(8)
        # per coefficient index n (0..16): [ctx] -> 11 probabilities
        self.probs = [[[list(map(int, probs[t, _BANDS[n], ctx]))
                        for ctx in range(3)] for n in range(17)]
                      for t in range(4)]
        self.use_skip = br.bit(128)
        self.skip_p = br.value_bits(8) if self.use_skip else 0


def _filter_strengths(fr):
    """fstrengths[segment][i4x4] = (limit, ilevel, hev_thresh, inner)."""
    out = []
    for s in range(4):
        if fr.use_segment:
            base = fr.seg_f[s] + (0 if fr.absolute else fr.level)
        else:
            base = fr.level
        row = []
        for i4 in (0, 1):
            level = base
            if fr.use_lf_delta:
                level += fr.ref_lf[0]
                if i4:
                    level += fr.mode_lf[0]
            level = min(max(level, 0), 63)
            if level > 0:
                ilevel = level
                if fr.sharpness > 0:
                    ilevel >>= 2 if fr.sharpness > 4 else 1
                    ilevel = min(ilevel, 9 - fr.sharpness)
                ilevel = max(ilevel, 1)
                row.append((2 * level + ilevel, ilevel,
                            2 if level >= 40 else 1 if level >= 15 else 0,
                            i4))
            else:
                row.append((0, 0, 0, i4))
        out.append(row)
    return out


def _decode_vp8_planes(data: bytes):
    """Y, U, V planes (padded to whole macroblocks, loop-filtered) and the
    frame size of a VP8 key frame."""
    fr = _VP8Frame(data)
    br = fr.br
    mb_w = (fr.width + 15) >> 4
    mb_h = (fr.height + 15) >> 4
    Y = np.zeros((mb_h * 16, mb_w * 16), np.int64)
    U = np.zeros((mb_h * 8, mb_w * 8), np.int64)
    V = np.zeros((mb_h * 8, mb_w * 8), np.int64)
    intra_t = [0] * (4 * mb_w)
    nz_top = [[0] * 9 for _ in range(mb_w)]  # 4 Y, 2 U, 2 V, 1 Y2
    strengths = _filter_strengths(fr)
    finfo = np.zeros((mb_h, mb_w, 4), np.int64)
    top_y = np.full((mb_w, 16), 127, np.int64)
    top_u = np.full((mb_w, 8), 127, np.int64)
    top_v = np.full((mb_w, 8), 127, np.int64)
    for mb_y in range(mb_h):
        intra_l = [0] * 4
        nz_left = [0] * 9
        tokens = fr.parts[mb_y & (len(fr.parts) - 1)]
        ybuf = np.zeros((17, 21), np.int64)
        ubuf = np.zeros((9, 9), np.int64)
        vbuf = np.zeros((9, 9), np.int64)
        for mb_x in range(mb_w):
            # modes (first partition)
            if fr.update_map:
                sp = fr.seg_probs
                segment = (br.bit(sp[1]) if not br.bit(sp[0])
                           else 2 + br.bit(sp[2]))
            else:
                segment = 0
            skip = br.bit(fr.skip_p) if fr.use_skip else 0
            is_i4 = not br.bit(145)
            if not is_i4:
                ymode = ((TM_PRED if br.bit(128) else H_PRED)
                         if br.bit(156) else
                         (V_PRED if br.bit(163) else DC_PRED))
                modes = [ymode]
                intra_t[4 * mb_x:4 * mb_x + 4] = [ymode] * 4
                intra_l = [ymode] * 4
            else:
                modes = [0] * 16
                for y in range(4):
                    ym = intra_l[y]
                    for x in range(4):
                        prob = T.BMODES_PROBA[intra_t[4 * mb_x + x], ym]
                        i = _YMODES_INTRA4[br.bit(int(prob[0]))]
                        while i > 0:
                            i = _YMODES_INTRA4[2 * i + br.bit(int(prob[i]))]
                        ym = -i
                        intra_t[4 * mb_x + x] = ym
                        modes[4 * y + x] = ym
                    intra_l[y] = ym
            uvmode = (DC_PRED if not br.bit(142) else
                      V_PRED if not br.bit(114) else
                      TM_PRED if br.bit(183) else H_PRED)

            # residuals (token partition)
            coeffs = np.zeros((25, 16), np.int64)  # 16 Y, 4 U, 4 V, Y2
            q = fr.quant[segment]
            top = nz_top[mb_x]
            if not skip:
                c = [0] * 16
                if not is_i4:
                    ctx = top[8] + nz_left[8]
                    dc = [0] * 16
                    nz = _coeffs(tokens, fr.probs[1], ctx, q["y2"], 0, dc)
                    top[8] = nz_left[8] = int(nz > 0)
                    coeffs[:16, 0] = _wht(dc)
                    first, ac = 1, fr.probs[0]
                else:
                    first, ac = 0, fr.probs[3]
                for y in range(4):
                    for x in range(4):
                        ctx = nz_left[y] + top[x]
                        c = [0] * 16
                        c[0] = int(coeffs[4 * y + x, 0])
                        nz = _coeffs(tokens, ac, ctx, q["y1"], first, c)
                        flag = int(nz > first)
                        nz_left[y] = top[x] = flag
                        coeffs[4 * y + x] = c
                for ch, base in ((0, 16), (1, 20)):
                    for y in range(2):
                        for x in range(2):
                            ctx = nz_left[4 + 2 * ch + y] + top[4 + 2 * ch + x]
                            c = [0] * 16
                            nz = _coeffs(tokens, fr.probs[2], ctx, q["uv"], 0,
                                         c)
                            flag = int(nz > 0)
                            nz_left[4 + 2 * ch + y] = flag
                            top[4 + 2 * ch + x] = flag
                            coeffs[base + 2 * y + x] = c
                all_zero = not coeffs[:24].any()
            else:
                for k in range(8):
                    top[k] = nz_left[k] = 0
                if not is_i4:
                    top[8] = nz_left[8] = 0
                all_zero = True
            if fr.filter_type:
                lim, il, hev, inner = strengths[segment][int(is_i4)]
                finfo[mb_y, mb_x] = (lim, il, hev, inner | (not all_zero))

            # reconstruction (libwebp's borders)
            if mb_x == 0:
                ybuf[1:, 0] = 129
                ubuf[1:, 0] = 129
                vbuf[1:, 0] = 129
                corner = 129 if mb_y > 0 else 127
                ybuf[0, 0] = ubuf[0, 0] = vbuf[0, 0] = corner
            else:
                ybuf[:, 0] = ybuf[:, 16]
                ubuf[:, 0] = ubuf[:, 8]
                vbuf[:, 0] = vbuf[:, 8]
            if mb_y > 0:
                ybuf[0, 1:17] = top_y[mb_x]
                ubuf[0, 1:9] = top_u[mb_x]
                vbuf[0, 1:9] = top_v[mb_x]
            else:
                ybuf[0, 1:] = 127
                ubuf[0, 1:] = 127
                vbuf[0, 1:] = 127
            if is_i4:
                if mb_y > 0:
                    ybuf[0, 17:21] = (top_y[mb_x, 15] if mb_x == mb_w - 1
                                      else top_y[mb_x + 1, :4])
                for r in (4, 8, 12):
                    ybuf[r, 17:21] = ybuf[0, 17:21]
                for n in range(16):
                    by, bx = divmod(n, 4)
                    r0, c0 = 4 * by, 4 * bx
                    ctx_top = ybuf[r0, c0 + 1:c0 + 9]
                    ctx_left = ybuf[r0 + 1:r0 + 5, c0]
                    pred = _pred4(modes[n], ctx_top, ctx_left,
                                  ybuf[r0, c0])
                    ybuf[r0 + 1:r0 + 5, c0 + 1:c0 + 5] = _idct_add(
                        coeffs[n], pred)
            else:
                pred = _pred_block(modes[0], ybuf, 16, mb_x, mb_y)
                blocks = pred.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3)
                rec = _idct_add(coeffs[:16].reshape(4, 4, 16), blocks)
                ybuf[1:17, 1:17] = rec.transpose(0, 2, 1, 3).reshape(16, 16)
            for buf, base in ((ubuf, 16), (vbuf, 20)):
                pred = _pred_block(uvmode, buf, 8, mb_x, mb_y)
                blocks = pred.reshape(2, 4, 2, 4).transpose(0, 2, 1, 3)
                rec = _idct_add(coeffs[base:base + 4].reshape(2, 2, 16),
                                blocks)
                buf[1:9, 1:9] = rec.transpose(0, 2, 1, 3).reshape(8, 8)
            top_y[mb_x] = ybuf[16, 1:17]
            top_u[mb_x] = ubuf[8, 1:9]
            top_v[mb_x] = vbuf[8, 1:9]
            Y[16 * mb_y:16 * mb_y + 16, 16 * mb_x:16 * mb_x + 16] = \
                ybuf[1:17, 1:17]
            U[8 * mb_y:8 * mb_y + 8, 8 * mb_x:8 * mb_x + 8] = ubuf[1:9, 1:9]
            V[8 * mb_y:8 * mb_y + 8, 8 * mb_x:8 * mb_x + 8] = vbuf[1:9, 1:9]
    if fr.filter_type:
        _loop_filter(Y, U, V, finfo, fr.filter_type)
    return Y, U, V, fr.width, fr.height


# --- the loop filter (libwebp dsp/dec.c), vectorised along each edge ------

def _sclip1(v):
    return np.clip(v, -128, 127)


def _sclip2(v):
    return np.clip(v, -16, 15)


def _clip1(v):
    return np.clip(v, 0, 255)


def _filter2(p1, p0, q0, q1):
    a = 3 * (q0 - p0) + _sclip1(p1 - q1)
    a1 = _sclip2((a + 4) >> 3)
    a2 = _sclip2((a + 3) >> 3)
    return _clip1(p0 + a2), _clip1(q0 - a1)


def _edges(plane, r0, c0, vertical, count, thresh, ithresh, hev_t, kind):
    """Filter one edge in each of n macroblocks at once: `count` lines
    across the edge whose first q0 pixel is at (r0[i], c0[i]); `vertical`
    an edge between rows (pixels stepping down), else between columns.
    `thresh`, `ithresh`, `hev_t` per macroblock; kind 0 simple, 4 inner,
    6 macroblock edge."""
    line = np.arange(count)[None, :, None]
    tap = np.arange(-4, 4)[None, None, :]
    if vertical:
        rows = r0[:, None, None] + tap
        cols = c0[:, None, None] + line
    else:
        rows = r0[:, None, None] + line
        cols = c0[:, None, None] + tap
    seg = plane[rows, cols]  # (n, count, 8): p3 p2 p1 p0 q0 q1 q2 q3
    p3, p2, p1, p0, q0, q1, q2, q3 = (seg[..., i] for i in range(8))
    t2 = (2 * thresh + 1)[:, None]
    mask = (4 * np.abs(p0 - q0) + np.abs(p1 - q1)) <= t2
    np0, nq0 = _filter2(p1, p0, q0, q1)
    out = seg.copy()
    if kind == 0:
        out[..., 3] = np.where(mask, np0, p0)
        out[..., 4] = np.where(mask, nq0, q0)
        plane[rows, cols] = out
        return
    it = ithresh[:, None]
    mask &= ((np.abs(p3 - p2) <= it) & (np.abs(p2 - p1) <= it)
             & (np.abs(p1 - p0) <= it) & (np.abs(q3 - q2) <= it)
             & (np.abs(q2 - q1) <= it) & (np.abs(q1 - q0) <= it))
    ht = hev_t[:, None]
    hev = (np.abs(p1 - p0) > ht) | (np.abs(q1 - q0) > ht)
    if kind == 6:
        a = _sclip1(3 * (q0 - p0) + _sclip1(p1 - q1))
        a1 = (27 * a + 63) >> 7
        a2 = (18 * a + 63) >> 7
        a3 = (9 * a + 63) >> 7
        new = {1: _clip1(p2 + a3), 2: _clip1(p1 + a2), 3: _clip1(p0 + a1),
               4: _clip1(q0 - a1), 5: _clip1(q1 - a2), 6: _clip1(q2 - a3)}
    else:
        a = 3 * (q0 - p0)
        a1 = _sclip2((a + 4) >> 3)
        a2 = _sclip2((a + 3) >> 3)
        a3 = (a1 + 1) >> 1
        new = {2: _clip1(p1 + a3), 3: _clip1(p0 + a2), 4: _clip1(q0 - a1),
               5: _clip1(q1 - a3)}
    # a high edge variance takes the 2-tap filter (p0, q0 only)
    hev_val = {3: np0, 4: nq0}
    for k, nv in new.items():
        old = seg[..., k]
        out[..., k] = np.where(mask, np.where(hev, hev_val.get(k, old), nv),
                               old)
    plane[rows, cols] = out


def _loop_filter(Y, U, V, finfo, kind):
    """libwebp's in-loop filter over the whole frame. Each macroblock runs
    its edges in libwebp's order (left, inner columns, top, inner rows);
    a macroblock reads what its left, upper and upper-right neighbours
    wrote, so those with equal mb_x + 2 mb_y run together, as batches."""
    mb_h, mb_w = finfo.shape[:2]
    ys, xs = np.nonzero(finfo[..., 0])  # limit 0: not filtered
    wave = xs + 2 * ys
    for t in np.unique(wave):
        y, x = ys[wave == t], xs[wave == t]
        limit, ilevel, hev_t, inner = finfo[y, x].T
        inner = inner.astype(bool)
        steps = [(False, 0, x > 0, limit + 4, 6)]
        steps += [(False, k, inner, limit, 4) for k in (4, 8, 12)]
        steps += [(True, 0, y > 0, limit + 4, 6)]
        steps += [(True, k, inner, limit, 4) for k in (4, 8, 12)]
        for vertical, k, sel, thresh, edge_kind in steps:
            if not sel.any():
                continue
            args = (thresh[sel], ilevel[sel], hev_t[sel])
            r0, c0 = 16 * y[sel], 16 * x[sel]
            r0, c0 = (r0 + k, c0) if vertical else (r0, c0 + k)
            _edges(Y, r0, c0, vertical, 16, *args,
                   0 if kind == 1 else edge_kind)
            if kind == 1 or k not in (0, 4):
                continue
            r0, c0 = 8 * y[sel], 8 * x[sel]
            r0, c0 = (r0 + k, c0) if vertical else (r0, c0 + k)
            for P in (U, V):
                _edges(P, r0, c0, vertical, 8, *args, edge_kind)


# --- YUV -> RGB (libwebp dsp/yuv.h, dsp/upsampling.c) ---------------------

def _clip8(v):
    return np.where((v & ~16383) == 0, v >> 6, np.where(v < 0, 0, 255))


def _yuv_to_rgb(y, u, v):
    def hi(a, k):
        return (a * k) >> 8

    r = _clip8(hi(y, 19077) + hi(v, 26149) - 14234)
    g = _clip8(hi(y, 19077) - hi(u, 6419) - hi(v, 13320) + 8708)
    b = _clip8(hi(y, 19077) + hi(u, 33050) - 17685)
    return np.stack([r, g, b], -1)


def _upsample_pair(t, c, width):
    """The fancy upsampler's chroma of a pair of output rows: `t` the
    chroma row above, `c` the current one (each (uv_w,)); returns the
    (top, bottom) full-width rows."""
    top = np.empty(width, np.int64)
    bot = np.empty(width, np.int64)
    top[0] = (3 * t[0] + c[0] + 2) >> 2
    bot[0] = (3 * c[0] + t[0] + 2) >> 2
    last = (width - 1) >> 1
    if last >= 1:
        tl, tt, ll, cc = t[:last], t[1:last + 1], c[:last], c[1:last + 1]
        avg = tl + tt + ll + cc + 8
        d12 = (avg + 2 * (tt + ll)) >> 3
        d03 = (avg + 2 * (tl + cc)) >> 3
        top[1:2 * last:2] = (d12 + tl) >> 1
        top[2:2 * last + 1:2] = (d03 + tt) >> 1
        bot[1:2 * last:2] = (d03 + ll) >> 1
        bot[2:2 * last + 1:2] = (d12 + cc) >> 1
    if width % 2 == 0:
        tl, ll = t[last], c[last]
        top[width - 1] = (3 * tl + ll + 2) >> 2
        bot[width - 1] = (3 * ll + tl + 2) >> 2
    return top, bot


def _fancy_rgb(Y, U, V, w, h):
    """libwebp's EmitFancyRGB over the whole frame: (h, w, 3) RGB."""
    uv_w = (w + 1) >> 1
    U = U[:, :uv_w]
    V = V[:, :uv_w]
    ups = np.empty((h, w), np.int64)
    vps = np.empty((h, w), np.int64)
    ups[0], _ = _upsample_pair(U[0], U[0], w)
    vps[0], _ = _upsample_pair(V[0], V[0], w)
    for k in range(1, (h + 1) // 2 + 1):
        y_top, y_bot = 2 * k - 1, 2 * k
        if y_top >= h:
            break
        if y_bot < h:
            ut, ub = _upsample_pair(U[k - 1], U[k], w)
            vt, vb = _upsample_pair(V[k - 1], V[k], w)
            ups[y_top], ups[y_bot] = ut, ub
            vps[y_top], vps[y_bot] = vt, vb
        else:  # the last row of an even height
            ups[y_top], _ = _upsample_pair(U[k - 1], U[k - 1], w)
            vps[y_top], _ = _upsample_pair(V[k - 1], V[k - 1], w)
    return _yuv_to_rgb(Y[:h, :w], ups, vps).astype(np.uint8)


def decode_vp8(data: bytes) -> np.ndarray:
    """A VP8 key frame as (h, w, 3) uint8 RGB, as libwebp outputs it."""
    Y, U, V, w, h = _decode_vp8_planes(data)
    return _fancy_rgb(Y, U, V, w, h)


# --- ALPH -----------------------------------------------------------------

def _unfilter(a, method):
    h, w = a.shape
    out = np.zeros((h, w), np.int64)
    for y in range(h):
        row = a[y].astype(np.int64)
        prev = out[y - 1] if y else None
        if method == 1 or prev is None:
            pred = 0 if prev is None else int(prev[0])
            out[y] = (np.cumsum(row) + pred) & 0xFF
        elif method == 2:
            out[y] = (row + prev) & 0xFF
        else:  # gradient
            left = int(prev[0])
            tl = int(prev[0])
            for x in range(w):
                t = int(prev[x])
                left = (int(row[x]) + min(max(left + t - tl, 0), 255)) & 0xFF
                tl = t
                out[y, x] = left
    return out.astype(np.uint8)


def decode_alph(data: bytes, w: int, h: int) -> np.ndarray:
    """An ALPH chunk's (h, w) uint8 alpha."""
    if not data:
        raise _Error("empty ALPH chunk")
    method = data[0] & 3
    filt = (data[0] >> 2) & 3
    body = data[1:]
    if method == 0:
        if len(body) < w * h:
            raise _Error("ALPH raw data truncated")
        a = np.frombuffer(body[:w * h], np.uint8).reshape(h, w)
    elif method == 1:
        px = _decode_vp8l_stream(_Bits(body), w, h)
        a = px[..., 2].astype(np.uint8)  # the green channel
    else:
        raise _Error(f"ALPH compression {method}")
    return _unfilter(a, filt) if filt else a.copy()


# --- the container --------------------------------------------------------

def _chunks(data, start, end):
    pos = start
    while pos + 8 <= end:
        tag = data[pos:pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        body = data[pos + 8:pos + 8 + size]
        yield tag, body
        pos += 8 + size + (size & 1)


def _frame(chunks):
    """(RGBA (h, w, 4), has_alpha) of the image chunks of a frame."""
    alph = None
    for tag, body in chunks:
        if tag == b"ALPH":
            alph = body
        elif tag == b"VP8 ":
            rgb = decode_vp8(body)
            h, w = rgb.shape[:2]
            alpha = (decode_alph(alph, w, h) if alph is not None
                     else np.full((h, w), 255, np.uint8))
            return np.concatenate([rgb, alpha[..., None]], -1), (
                alph is not None)
        elif tag == b"VP8L":
            return decode_vp8l(body)
    raise _Error("WebP frame without image data")


def decode_webp(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A WebP file's bytes as (H, W, 4) uint8 RGBA: its first frame as PIL's
    convert("RGBA") gives it."""
    if data[:4] != b"RIFF" or data[8:12] != b"WEBP" or len(data) < 20:
        raise ValueError(f"{name}: not a WebP file")
    end = min(len(data), 8 + struct.unpack_from("<I", data, 4)[0])
    try:
        chunks = list(_chunks(data, 12, end))
        first = chunks[0][0]
        if first != b"VP8X":
            rgba, alpha = _frame(chunks)
            if not alpha:
                rgba[..., 3] = 255
            return rgba
        vp8x = chunks[0][1]
        flags = vp8x[0]
        cw = 1 + int.from_bytes(vp8x[4:7], "little")
        ch = 1 + int.from_bytes(vp8x[7:10], "little")
        has_alpha = bool(flags & 0x10)
        if flags & 0x02:  # animation: the first ANMF on a zero canvas
            for tag, body in chunks:
                if tag != b"ANMF":
                    continue
                fx = 2 * int.from_bytes(body[0:3], "little")
                fy = 2 * int.from_bytes(body[3:6], "little")
                rgba, _ = _frame(_chunks(body, 16, len(body)))
                fh, fw = rgba.shape[:2]
                canvas = np.zeros((ch, cw, 4), np.uint8)
                canvas[fy:fy + fh, fx:fx + fw] = rgba[:max(0, ch - fy),
                                                      :max(0, cw - fx)]
                if not has_alpha:
                    canvas[..., 3] = 255
                return canvas
            raise _Error("animated WebP without frames")
        rgba, lossless_alpha = _frame(chunks[1:])
        images = [t for t, _ in chunks if t in (b"VP8 ", b"VP8L")]
        if images and images[0] == b"VP8L":
            has_alpha = lossless_alpha
        if not has_alpha:
            rgba[..., 3] = 255
        return rgba
    except _Error as e:
        raise ValueError(f"{name}: {e}") from None
    except (IndexError, struct.error) as e:
        raise ValueError(f"{name}: WebP truncated ({e})") from None

"""TIFF decoding to PIL's pixels, with numpy, zlib and the standard
library.

``decode_tiff`` gives the (H, W, 4) uint8 words of PIL's
``Image.open(...).convert("RGBA")`` for the first IFD of a TIFF in the
forms PIL opens, through its own raw reader or through libtiff:

- byte order II and MM, classic TIFF and BigTIFF (version 43: 8-byte
  offsets and counts, 20-byte entries, the types LONG8, SLONG8 and IFD8;
  PIL refuses a big-endian BigTIFF and so does this); strips and tiles
  (edge tiles padded), one plane (PlanarConfiguration 1) or one plane a
  sample (2); FillOrder 2 (the bits of every stored byte reversed before
  anything else, as libtiff and PIL's raw reader both do);
- compression 1 (none), 5 (LZW: TIFF's most-significant-bit-first codes
  that widen one code early, and the old least-significant-bit-first
  style that libtiff still reads), 8 and 32946 (Deflate), 32773
  (PackBits), 34925 (LZMA, one .xz stream a chunk, the standard
  library's lzma), 50000 (ZSTD, io/zstd.py), 2 / 3 / 4 (CCITT modified
  Huffman, T.4 with T4Options 1-D or 2-D and fill bits, T.6;
  io/ccitt.py), 7 (JPEG: each chunk a JPEG stream completed by
  JPEGTables, decoded by io/jpeg.py in the colour space the photometric
  names, photometric 6 converted to RGB by libjpeg as PIL asks libtiff
  to) and 6 (old-style JPEG from one JPEGInterchangeFormat stream: its
  planes as libjpeg gives them raw, converted by libtiff's YCbCr tables);
  predictor 2 (horizontal differencing at 8, 16 and 32 bits) and 3
  (floating point: byte planes, most significant first, differenced byte
  by byte), undone where libtiff undoes a predictor (LZW, Deflate, LZMA,
  ZSTD: not PackBits, and PIL's raw reader never does);
- photometric 0 (WhiteIsZero, inverted at 1-8 bits; PIL reads 16-bit
  WhiteIsZero uninverted) and 1 (grey at 1, 2, 4, 8 bits, 12 and 16
  clamped at 255 as PIL's I;16 converts; grey + unassociated alpha), 2
  (RGB and RGBA at 8 and 16 bits, 16-bit samples keeping their high
  byte; ExtraSamples 0 dropped, 1 (associated alpha) un-premultiplied
  with PIL's rounding, 2 kept), 3 (palette at 1-8 bits, 16-bit ColorMap
  entries divided by 256 as PIL takes them, with an extra alpha or
  unspecified sample), 5 (CMYK at 8 and 16 bits, to RGB as PIL converts
  it), 6 (YCbCr: compressed other than by JPEG, through libtiff's RGBA
  reader as PIL asks for it, each subsampling it has a case for, chroma
  replicated over its block, ReferenceBlackWhite and YCbCrCoefficients
  through TIFFYCbCrToRGBInit's integer tables, YCbCrPositioning ignored;
  one sample, uncompressed, as grey) and 8 (CIELab: PIL's LAB image,
  which convert("RGBA") takes through LittleCMS from a D50 Lab profile
  to sRGB, io/cielab.py; planes keep a* and b* as stored and an alpha of
  0);
- the sample formats of PIL's table: signed 8-bit grey read as unsigned,
  16- and 32-bit signed grey (I;16S, I;32S), 32-bit unsigned grey (II
  only) and 32-bit float grey (photometric 0 or 1), converted as PIL's
  I -> RGBA (clipped) and F -> RGBA (NaN and v <= 0 to 0, v >= 255 to
  255, else truncated) convert them; big-endian words that libtiff
  decodes come back in native order and PIL reads them as big-endian, so
  they are byte-swapped, as PIL gives them;
- the layouts PIL's OPEN_INFO table lists, no more: what it lacks, PIL
  and this module refuse (ValueError naming the file), and what libtiff
  refuses under PIL (a subsampling its RGBA reader has no case for,
  one-sample YCbCr it would convert, CCITT over more than one bit, the
  floating-point predictor on integers, old-style JPEG without a
  JPEGInterchangeFormat stream, WebP-in-TIFF: the libtiff PIL links was
  built without its WebP codec);
- PIL's readers' quirks: uncompressed data goes through PIL's raw
  reader, which lacks bit-reversed raw modes for 8-bit WhiteIsZero and
  sub-byte palettes, reads a chunk from its offset on past its byte
  count (uncompressed YCbCr as RGBX, four bytes a pixel), and reads each
  plane of a planar file by its raw mode's first letter, one byte a
  sample, line after line (planes at 2, 4 and 16 bits and 1-bit
  palettes misread, planar WhiteIsZero uninverted), an edge tile's lines
  a stride apart that it derives from the chunky row (4/3 of a tile's
  width for RGBA planes without ExtraSamples); compressed planar data is
  copied plane by plane by PIL's libtiff decoder, which leaves an LA /
  PA image's alpha 0, un-premultiplies RGBA unless ExtraSamples marks it
  unassociated, and unpacks palette tiles with an extra plane as chunky
  PX pairs of the palette plane alone;
- the Orientation tag, applied as PIL 12's load applies it
  (``ImageOps.exif_transpose``).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import ccitt, cielab, jpeg, zstd
from .gif import lzw_decode
from .jpeg import cmyk_to_rgb

# tags
WIDTH, HEIGHT, BITS, COMPRESSION, PHOTOMETRIC = 256, 257, 258, 259, 262
FILLORDER, STRIP_OFFSETS, ORIENTATION, SPP, ROWS_PER_STRIP = (266, 273, 274,
                                                              277, 278)
STRIP_COUNTS, PLANAR, T4_OPTIONS, PREDICTOR, COLORMAP = 279, 284, 292, 317, 320
TILE_W, TILE_H, TILE_OFFSETS, TILE_COUNTS = 322, 323, 324, 325
EXTRA, SAMPLE_FORMAT, JPEG_TABLES = 338, 339, 347
JPEG_IF, JPEG_IF_LENGTH = 513, 514
YCC_COEFFICIENTS, YCC_SUBSAMPLING, REF_BLACK_WHITE = 529, 530, 532

_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h",
          9: "i", 10: "ii", 11: "f", 12: "d", 13: "I", 16: "Q", 17: "q",
          18: "Q"}

RAW, CCITT, JPEG, OJPEG, WEBP = 1, (2, 3, 4), 7, 6, 50001  # compressions
# compressions whose chunks libtiff inflates to bytes, predictor and all
_BYTE_CODECS = (5, 8, 32946, 32773, 34925, 50000)
_PREDICTED = (5, 8, 32946, 34925, 50000)

_BIT_REVERSE = np.packbits(np.unpackbits(
    np.arange(256, dtype=np.uint8)[:, None], axis=1)[:, ::-1], axis=1)[:, 0]


def _header(data, name):
    """(byte order, BigTIFF, first IFD offset)."""
    if data[:2] == b"II":
        order = "<"
    elif data[:2] == b"MM":
        order = ">"
    else:
        raise ValueError(f"{name}: not a TIFF file")
    version = struct.unpack_from(order + "H", data, 2)[0]
    if version == 42:
        return order, False, struct.unpack_from(order + "I", data, 4)[0]
    if version == 43 and order == ">":
        raise ValueError(f"{name}: big-endian BigTIFF (PIL reads its header "
                         f"as a classic TIFF's and refuses it)")
    if version == 43 and len(data) >= 16 and struct.unpack_from(
            order + "HH", data, 4) == (8, 0):
        return order, True, struct.unpack_from(order + "Q", data, 8)[0]
    raise ValueError(f"{name}: not a TIFF file")


def _ifd(data, order, big, at, name):
    """An IFD's tags: {tag: tuple of values}."""
    count_fmt, entry, field_size = ("Q", 20, 8) if big else ("H", 12, 4)
    head = struct.calcsize(order + count_fmt)
    if at + head > len(data):
        raise ValueError(f"{name}: TIFF IFD offset {at} beyond the file")
    n = struct.unpack_from(order + count_fmt, data, at)[0]
    tags = {}
    for i in range(n):
        pos = at + head + entry * i
        if pos + entry > len(data):
            raise ValueError(f"{name}: TIFF IFD truncated")
        tag, typ, count = struct.unpack_from(
            order + ("HHQ" if big else "HHI"), data, pos)
        field = data[pos + entry - field_size:pos + entry]
        fmt = _TYPES.get(typ)
        if fmt is None:
            continue
        size = struct.calcsize(order + fmt) * count
        body = field if size <= field_size else data[struct.unpack(
            order + ("Q" if big else "I"), field)[0]:][:size]
        if len(body) < size:
            raise ValueError(f"{name}: TIFF tag {tag} truncated")
        vals = struct.unpack(order + fmt * count, body[:size])
        if typ in (5, 10):
            vals = tuple(vals[i] / vals[i + 1] if vals[i + 1] else 0.0
                         for i in range(0, len(vals), 2))
        tags[tag] = vals
    return tags


def _lzw(data, n_out):
    """TIFF LZW: MSB-first codes widening one code early; the old style (a
    stream that opens with a clear code written LSB-first) as GIF codes
    them, which libtiff still reads."""
    old = len(data) >= 2 and data[0] == 0 and data[1] & 1
    return lzw_decode(data, 8, n_out, msb=not old, early=not old)


def _packbits(data, n_out):
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < n_out:
        c = data[i]
        i += 1
        if c < 128:
            out += data[i:i + c + 1]
            i += c + 1
        elif c > 128 and i < n:
            out += bytes((data[i],)) * (257 - c)
            i += 1
    return bytes(out)


def _decompress(raw, compression, n_out, name):
    if compression == 5:
        return _lzw(raw, n_out)
    if compression in (8, 32946):
        d = zlib.decompressobj()
        try:
            return d.decompress(raw, n_out)
        except zlib.error:
            return b""
    if compression == 34925:
        import lzma

        try:
            return lzma.LZMADecompressor().decompress(raw, n_out)
        except lzma.LZMAError as exc:
            raise ValueError(f"{name}: TIFF LZMA chunk ({exc})") from None
    if compression == 50000:
        return zstd.decompress(raw)[:n_out]
    return _packbits(raw, n_out)


def _samples(buf, rows, cols, bits, order):
    """(rows, cols) unsigned samples of a chunk: rows padded to bytes,
    1-16 bits MSB first, 16- and 32-bit words in the file's byte order."""
    row_bytes = (cols * bits + 7) // 8
    need = rows * row_bytes
    raw = np.zeros(need, np.uint8)
    got = np.frombuffer(buf[:need], np.uint8)
    raw[:len(got)] = got
    raw = raw.reshape(rows, row_bytes)
    if bits == 8:
        return raw.astype(np.uint32)
    if bits in (16, 32):
        return raw.view(order + ("u2" if bits == 16 else "u4")).astype(
            np.uint32)
    bitv = np.unpackbits(raw, axis=1)[:, :cols * bits].reshape(rows, cols,
                                                               bits)
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint32)
    return (bitv.astype(np.uint32) * weights).sum(-1, dtype=np.uint32)


def _float_unpredict(buf, rows, cols, per, nbytes):
    """libtiff's fpAcc: undo the byte differencing of each row (stride: the
    samples a pixel) and gather its byte planes, most significant first:
    the rows' samples as unsigned words."""
    need = rows * cols * per * nbytes
    raw = np.zeros(need, np.uint8)
    got = np.frombuffer(buf[:need], np.uint8)
    raw[:len(got)] = got
    a = raw.reshape(rows, -1, per).astype(np.int64)
    a = (np.cumsum(a, axis=1) & 0xFF).astype(np.uint8).reshape(rows, nbytes,
                                                              cols * per)
    words = np.zeros((rows, cols * per), np.uint64)
    for b in range(nbytes):
        words = (words << np.uint64(8)) | a[:, b].astype(np.uint64)
    return words.astype(np.uint32)


def _mode(order, photo, formats, fill, bps, extra):
    """PIL's (kind, bits) for a TIFF key, after its OPEN_INFO table; None
    where PIL has no entry."""
    n = len(bps)
    b = bps[0]
    if any(x != b for x in bps):
        return None
    if formats != (1,):  # PIL's signed and float keys: one grey sample
        if fill != 1 or n != 1 or extra:
            return None
        if formats == (2,) and photo == 1:
            return {8: ("grey", 8), 16: ("I16S", 16),
                    32: ("I32S", 32)}.get(b)
        if formats == (3,) and photo in (0, 1) and b == 32:
            return ("F", 32)
        return None
    if photo in (6, 8) and fill == 1 and not extra:
        if photo == 6 and bps == (8,):
            return ("grey", 8)
        if bps == (8, 8, 8):
            return ("YCC" if photo == 6 else "LAB", 8)
        return None
    if fill == 2:  # only these layouts have a FillOrder 2 entry
        ok = ((photo in (0, 1, 3) and n == 1 and b in (1, 2, 4, 8)
               and not extra)
              or (photo == 1 and n == 1 and b == 16 and order == "<"
                  and not extra)
              or (photo == 2 and bps == (8, 8, 8) and not extra))
        if not ok:
            return None
    if photo in (0, 1) and n == 1 and not extra:
        if b in (1, 2, 4, 8):
            return ("grey", b)
        if b == 12 and photo == 1 and order == "<" and fill == 1:
            return ("grey16", b)
        if b == 16 and (order == "<" or photo == 1):
            return ("grey16", b)
        if b == 32 and photo == 1 and order == "<" and fill == 1:
            return ("I32", b)
        return None
    if photo == 1 and bps == (8, 8) and extra == (2,):
        return ("LA", 8)
    if photo == 2 and b in (8, 16):
        if n == 3 and not extra:
            return ("RGB", b)
        if n == 4 and not extra:
            return ("RGBA", b)
        alpha = {0: "RGB", 1: "RGBa", 2: "RGBA", 999: "RGBA"}
        if extra and extra[0] in alpha and n == 3 + len(extra) \
                and all(e == 0 for e in extra[1:]) \
                and (b == 8 or (n == 4 and extra[0] != 999)):
            return (alpha[extra[0]], b)
        return None
    if photo == 3 and n == 1 and not extra and b in (1, 2, 4, 8):
        return ("P", b)
    if photo == 3 and bps == (8, 8) and extra in ((0,), (2,)):
        return ("PA" if extra == (2,) else "P", 8)
    if photo == 5:
        if b == 8 and n == 4 + len(extra) and len(extra) <= 2 \
                and all(e == 0 for e in extra):
            return ("CMYK", 8)
        if b == 16 and n == 4 and not extra:
            return ("CMYK", 16)
    return None


# PIL's exif_transpose of the loaded image, by Orientation
_ORIENT = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
           4: lambda a: a[::-1], 5: lambda a: a.transpose(1, 0, 2),
           6: lambda a: np.rot90(a, -1), 7: lambda a: np.rot90(a, 2)
           .transpose(1, 0, 2), 8: lambda a: np.rot90(a, 1)}


def _check_raw(name, kind, bits, photo, fill, planar, extra):
    """Uncompressed data goes through PIL's raw reader: it has no
    bit-reversed unpacker for 8-bit WhiteIsZero or palettes under 8 bits,
    and no unpacker for one plane of the modes below. Returns True where
    it reads each plane by its raw mode's first letter as 8-bit samples
    (a misread: _raw_planes)."""
    if fill == 2 and ((photo == 0 and bits == 8)
                      or (photo == 3 and bits < 8)):
        raise ValueError(f"{name}: TIFF FillOrder 2 at {bits} bits, "
                         f"photometric {photo} (PIL has no raw mode for it)")
    if planar != 2:
        return False
    if kind in ("YCC", "LAB"):  # raw modes RGBX and LAB: R, G, B / L, A, B
        return True
    if kind in ("grey16", "LA", "PA", "RGBa", "I16S", "I32S", "I32",
                "F") or (
            kind in ("RGB", "CMYK", "P") and extra) or (
            kind == "RGBA" and extra not in ((), (2,), (999,))):
        raise ValueError(f"{name}: uncompressed planar TIFF of {kind}, extra "
                         f"samples {extra} (PIL has no raw mode for a plane)")
    return not (bits == 1 and kind == "grey")


def _high(v, bits):
    """8-bit samples: 16-bit ones keep their high byte."""
    return (v >> 8 if bits == 16 else v).astype(np.uint8)


def _unpremultiply(rgb, a):
    """PIL's RGBa unpacker: c * 255 / a truncated and clipped, 0 where
    a = 0."""
    c = rgb.astype(np.int64)
    a64 = a.astype(np.int64)[..., None]
    out = np.clip(c * 255 // np.maximum(a64, 1), 0, 255)
    return np.where(a64 == 0, 0, out).astype(np.uint8)


def _read(data, off, need, name):
    """`need` bytes from `off` on, as PIL's raw reader reads a tile: past
    the chunk's byte count into whatever follows it in the file."""
    if off + need > len(data):
        raise ValueError(f"{name}: TIFF truncated (PIL's raw reader runs "
                         f"past the end of the file)")
    return data[off:off + need]


class _Layout:
    """A TIFF's chunks: sizes, offsets, planes."""

    def __init__(self, tags, w, h, spp, planar, name):
        self.tiled = TILE_OFFSETS in tags
        if self.tiled:
            self.cw, self.ch = tags[TILE_W][0], tags[TILE_H][0]
            self.offsets = tags[TILE_OFFSETS]
            self.counts = tags.get(TILE_COUNTS)
        elif STRIP_OFFSETS in tags:
            self.cw = w
            self.ch = min(tags.get(ROWS_PER_STRIP, (h,))[0], h) or h
            self.offsets = tags[STRIP_OFFSETS]
            self.counts = tags.get(STRIP_COUNTS)
        else:
            raise ValueError(f"{name}: TIFF of unknown data organization")
        self.planes = spp if planar == 2 else 1
        self.per = 1 if planar == 2 else spp
        self.across, self.down = -(-w // self.cw), -(-h // self.ch)
        if len(self.offsets) < self.planes * self.across * self.down:
            raise ValueError(f"{name}: TIFF has {len(self.offsets)} chunks of "
                             f"{self.planes * self.across * self.down}")
        self.w, self.h = w, h

    def chunks(self, data):
        """(plane, y0, x0, rows stored, chunk bytes) in file order."""
        k = 0
        for plane in range(self.planes):
            for ty in range(self.down):
                for tx in range(self.across):
                    off = self.offsets[k]
                    size = self.counts[k] if self.counts else len(data) - off
                    k += 1
                    rows = self.ch if self.tiled else min(
                        self.ch, self.h - ty * self.ch)
                    yield (plane, ty * self.ch, tx * self.cw, rows, off,
                           data[off:off + size])

    def place(self, img, plane, y0, x0, s):
        part = s[:min(s.shape[0], self.h - y0), :min(s.shape[1], self.w - x0)]
        img[y0:y0 + part.shape[0], x0:x0 + part.shape[1],
            plane:plane + s.shape[2]] = part


def decode_tiff(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A TIFF or BigTIFF file's bytes as (H, W, 4) uint8 RGBA: its first
    IFD as PIL's convert("RGBA") gives it."""
    order, big, at = _header(data, name)
    tags = _ifd(data, order, big, at, name)

    def one(tag, default=None):
        return tags[tag][0] if tag in tags else default

    compression = one(COMPRESSION, 1)
    photo = one(PHOTOMETRIC, 0)
    if compression == OJPEG:
        photo = 6  # PIL: old-style JPEG is YCbCr, whatever the tag says
    if compression == WEBP:
        raise ValueError(f"{name}: WebP-in-TIFF (compression 50001): the "
                         f"libtiff PIL links was built without its WebP "
                         f"codec, so PIL refuses it")
    if compression not in (RAW, JPEG, OJPEG) + CCITT + _BYTE_CODECS:
        raise ValueError(f"{name}: TIFF compression {compression} unknown")
    if WIDTH not in tags or HEIGHT not in tags:
        raise ValueError(f"{name}: TIFF without dimensions")
    w, h = one(WIDTH), one(HEIGHT)
    fill = one(FILLORDER, 1)
    planar = one(PLANAR, 1)
    spp = one(SPP, 3 if compression == OJPEG and photo in (2, 6) else 1)
    bps = tags.get(BITS, (1,))
    extra = tags.get(EXTRA, ())
    formats = tuple(tags.get(SAMPLE_FORMAT, (1,)))
    if len(formats) > 1 and all(f == 1 for f in formats):
        formats = (1,)
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise ValueError(f"{name}: TIFF of unknown data organization")
    mode = _mode(order, photo, formats, fill, bps, extra)
    if mode is None:
        raise ValueError(f"{name}: TIFF layout PIL does not read (photometric "
                         f"{photo}, sample format {formats}, bits {bps}, "
                         f"extra samples {extra}, fill order {fill})")
    kind, bits = mode
    lay = _Layout(tags, w, h, spp, planar, name)
    if compression == RAW:
        misread = _check_raw(name, kind, bits, photo, fill, planar, extra)
        img = _decode_raw(data, tags, lay, kind, bits, misread, fill, order,
                          name)
        if misread:  # one byte a sample, as read
            bits = 8
        if kind == "YCC":  # PIL's RGB image of misread samples
            if planar != 2:
                return _ORIENT.get(one(ORIENTATION), lambda a: a)(img)
            kind = "RGB"
    elif photo == 6 and compression != JPEG and kind == "grey":
        raise ValueError(f"{name}: one-sample YCbCr TIFF under compression "
                         f"{compression} (libtiff's RGBA reader, which PIL "
                         f"takes for YCbCr, refuses it)")
    elif kind == "YCC" and compression not in (JPEG,):
        img = _decode_ycc_rgba(data, tags, lay, compression, planar, name)
        return _ORIENT.get(one(ORIENTATION), lambda a: a)(img)
    else:
        if planar == 2 and spp > 1 and 0 in extra and not lay.tiled:
            raise ValueError(f"{name}: planar TIFF strips with an "
                             f"unspecified extra sample (PIL's libtiff "
                             f"decoder refuses them)")
        img = _decode_libtiff(data, tags, lay, compression, kind, bits,
                              photo, fill, planar, extra, order, name)
        if kind == "YCC":  # libjpeg converted it to RGB
            kind = "RGB"
    rgba = _to_rgba(img, kind, bits, photo, tags, planar, compression)
    return _ORIENT.get(one(ORIENTATION), lambda a: a)(rgba)


def _decode_raw(data, tags, lay, kind, bits, misread, fill, order, name):
    """Uncompressed chunks as PIL's raw reader reads them: (h, w, spp)
    samples (one byte a sample where it `misread`s the planes), or (h, w,
    4) uint8 RGBA for chunky YCbCr."""
    if kind == "YCC" and lay.planes == 1:
        return _ycc_raw(data, lay, name)
    if misread:
        return _raw_planes(data, tags, lay, name)
    img = np.zeros((lay.h, lay.w, lay.planes * lay.per), np.uint32)
    for plane, y0, x0, rows, off, _ in lay.chunks(data):
        n_out = rows * ((lay.cw * lay.per * bits + 7) // 8)
        raw = _read(data, off, n_out, name)
        if fill == 2:
            raw = _BIT_REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
        s = _samples(raw, rows, lay.cw * lay.per, bits, order)
        lay.place(img, plane, y0, x0, s.reshape(rows, lay.cw, lay.per))
    return img


def _ycc_raw(data, lay, name):
    """Uncompressed YCbCr as PIL reads it: raw mode RGBX, four bytes a
    pixel (the first three kept) from each strip's offset on, whatever the
    subsampling; opaque."""
    out = np.full((lay.h, lay.w, 4), 255, np.uint8)
    for _, y0, x0, rows, off, _ in lay.chunks(data):
        cw = min(lay.cw, lay.w - x0)
        rows = min(rows, lay.h - y0)
        line = 4 * cw
        if lay.tiled and x0 + lay.cw > lay.w:
            line = int(lay.cw * 24 / 8)
        raw = np.frombuffer(_read(data, off, line * (rows - 1) + 4 * cw, name),
                            np.uint8)
        idx = (np.arange(rows)[:, None] * line + np.arange(cw)[None] * 4)
        for c in range(3):
            out[y0:y0 + rows, x0:x0 + cw, c] = raw[idx + c]
    return out


def _raw_planes(data, tags, lay, name):
    """The planes PIL's raw reader misreads: each plane read by its raw
    mode's first letter (L, P, R, G, B, A, C, M, Y, K), one byte a pixel,
    line after line from the chunk's offset; an edge tile's lines `stride`
    bytes apart, the chunky row's bytes over the photometric's bands."""
    bits = tags.get(BITS, (1,))
    photo = tags.get(PHOTOMETRIC, (0,))[0]
    n_bands = (3 if photo in (2, 6, 8) else 4 if photo == 5 else 1) + len(
        tags.get(EXTRA, ()))
    img = np.zeros((lay.h, lay.w, lay.planes), np.uint32)
    for plane, y0, x0, rows, off, _ in lay.chunks(data):
        cw = min(lay.cw, lay.w - x0)
        rows = min(rows, lay.h - y0)
        line = cw
        if lay.tiled and x0 + lay.cw > lay.w:
            line = int(lay.cw * sum(bits[:lay.planes]) / 8 / n_bands)
            if line < cw:
                raise ValueError(f"{name}: planar TIFF tile stride {line} "
                                 f"under its {cw} bytes a line (PIL's raw "
                                 f"reader refuses it)")
        raw = np.frombuffer(_read(data, off, line * (rows - 1) + cw, name),
                            np.uint8)
        idx = np.arange(rows)[:, None] * line + np.arange(cw)[None]
        img[y0:y0 + rows, x0:x0 + cw, plane] = raw[idx]
    return img


def _predictor(tags, compression, bits, kind, name):
    """The predictor libtiff undoes (1 where it undoes none)."""
    p = tags.get(PREDICTOR, (1,))[0] if compression in _PREDICTED else 1
    if p == 2 and bits not in (8, 16, 32):
        raise ValueError(f"{name}: TIFF horizontal differencing at {bits} "
                         f"bits")
    if p == 3 and kind != "F":
        raise ValueError(f"{name}: TIFF floating-point predictor on {kind} "
                         f"samples (libtiff takes it for floats only)")
    if p not in (1, 2, 3):
        raise ValueError(f"{name}: TIFF predictor {p} unknown")
    return p


def _jpeg_tables(tags):
    t = tags.get(JPEG_TABLES)
    return bytes(t) if t else b""


def _jpeg_chunk(raw, tables, space, name):
    """One JPEG-in-TIFF strip or tile: an abbreviated stream completed by
    the JPEGTables stream, decoded in `space`."""
    if tables and raw[:2] == jpeg.SOI and tables[-2:] == b"\xff\xd9":
        raw = tables[:-2] + raw[2:]
    return jpeg.decode_jpeg(raw, name, colour=space)


def _decode_libtiff(data, tags, lay, compression, kind, bits, photo, fill,
                    planar, extra, order, name):
    """Compressed chunks as libtiff hands them to PIL: (h, w, spp)
    samples."""
    img = np.zeros((lay.h, lay.w, lay.planes * lay.per), np.uint32)
    if compression in CCITT and (kind != "grey" or bits != 1):
        raise ValueError(f"{name}: CCITT-compressed TIFF of {bits}-bit "
                         f"{kind} (libtiff decodes bilevel data only)")
    if compression == JPEG:
        space = {"grey": "grey", "RGB": "rgb", "YCC": "ycc"}.get(kind)
        if space is None or bits != 8 or planar != 1 or extra:
            raise ValueError(f"{name}: JPEG-in-TIFF of {kind} at {bits} "
                             f"bits, planar {planar} is not read")
        tables = _jpeg_tables(tags)
    if compression == OJPEG:
        raise ValueError(f"{name}: old-style JPEG-in-TIFF of {kind}")
    predictor = _predictor(tags, compression, bits, kind, name)
    t4 = tags.get(T4_OPTIONS, (0,))[0]
    mask = (1 << bits) - 1
    for plane, y0, x0, rows, off, raw in lay.chunks(data):
        if fill == 2:
            raw = _BIT_REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
        if compression in CCITT:
            s = ccitt.decode(raw, lay.cw, rows, compression, t4)
        elif compression == JPEG:
            s = _jpeg_chunk(raw, tables, space, name)[:rows, :lay.cw]
        else:
            n_out = rows * ((lay.cw * lay.per * bits + 7) // 8)
            buf = _decompress(raw, compression, n_out, name)
            if predictor == 3:
                s = _float_unpredict(buf, rows, lay.cw, lay.per, bits // 8)
            else:
                s = _samples(buf, rows, lay.cw * lay.per, bits, order)
                if predictor == 2:
                    s = s.reshape(rows, lay.cw, lay.per).astype(np.int64)
                    s = np.cumsum(s, axis=1) & mask
        s = np.asarray(s).reshape(s.shape[0], -1, lay.per)
        if kind == "P" and lay.planes == 2:
            if plane == 0:
                lay.place(img, 0, y0, x0, _px_misread(s[..., 0]))
            continue
        lay.place(img, plane, y0, x0, s)
    if order == ">" and kind in ("I16S", "I32S", "F"):
        # libtiff hands big-endian words over in native order, and PIL's
        # raw mode (I;16BS, I;32BS, F;32BF) reads them as big-endian
        img = img.astype(">u4" if bits == 32 else ">u2").view(
            "<u4" if bits == 32 else "<u2").astype(np.uint32)
    return img


def _px_misread(tile):
    """Planar palette tiles with an extra sample as PIL's libtiff decoder
    reads them: the palette plane's tile alone, each row unpacked from its
    start with the chunky raw mode PX (two bytes a pixel, the first kept),
    so a row runs on into the next; past the tile, 0."""
    th, tw = tile.shape
    flat = np.concatenate([tile.reshape(-1), np.zeros(2 * tw, tile.dtype)])
    idx = np.arange(th)[:, None] * tw + 2 * np.arange(tw)[None]
    return flat[idx][..., None]


# libtiff's TIFFYCbCrToRGBInit / TIFFYCbCrtoRGB (tif_color.c)
_SHIFT = 16
_ONE_HALF = 1 << (_SHIFT - 1)


def _fix(x):
    return int(np.float64(np.float32(x) * np.float32(1 << _SHIFT)) + 0.5)


def _code2v(c, rb, rw, cr):
    rb, rw = np.float32(rb), np.float32(rw)
    den = np.float32(rw - rb) if rw - rb != 0 else np.float32(1)
    v = np.float32(np.float32(c - int(rb)) * np.float32(cr)) / den
    return np.float32(v)


def _clampw(f, lo, hi):
    return lo if f < lo else hi if f > hi else f


def ycbcr_tables(ref_bw=(0, 255, 128, 255, 128, 255),
                 luma=(0.299, 0.587, 0.114)):
    """TIFFYCbCrToRGBInit's integer tables: (Y, Cr_r, Cb_b, Cr_g, Cb_g)
    int64 arrays indexed by the 8-bit sample."""
    lr, lg, lb = (np.float32(v) for v in luma)
    f1 = np.float32(2) - np.float32(2) * lr
    d1 = _fix(_clampw(f1, np.float32(0), np.float32(2)))
    f2 = np.float32(lr * f1) / lg
    d2 = -_fix(_clampw(f2, np.float32(0), np.float32(2)))
    f3 = np.float32(2) - np.float32(2) * lb
    d3 = _fix(_clampw(f3, np.float32(0), np.float32(2)))
    f4 = np.float32(lb * f3) / lg
    d4 = -_fix(_clampw(f4, np.float32(0), np.float32(2)))
    rbw = [np.float32(v) for v in ref_bw]
    tabs = np.zeros((5, 256), np.int64)
    lo, hi = np.float32(-128 * 32), np.float32(128 * 32)
    for i in range(256):
        x = i - 128
        cr = int(_clampw(_code2v(x, rbw[4] - np.float32(128),
                                 rbw[5] - np.float32(128), 127), lo, hi))
        cb = int(_clampw(_code2v(x, rbw[2] - np.float32(128),
                                 rbw[3] - np.float32(128), 127), lo, hi))
        tabs[1, i] = (d1 * cr + _ONE_HALF) >> _SHIFT
        tabs[2, i] = (d3 * cb + _ONE_HALF) >> _SHIFT
        tabs[3, i] = d2 * cr
        tabs[4, i] = d4 * cb + _ONE_HALF
        tabs[0, i] = int(_clampw(_code2v(x + 128, rbw[0], rbw[1], 255), lo,
                                 hi))
    return tabs


def ycbcr_to_rgb(y, cb, cr, tabs):
    """TIFFYCbCrtoRGB on 8-bit sample arrays: (..., 3) uint8."""
    yt = tabs[0][y]
    r = yt + tabs[1][cr]
    g = yt + ((tabs[4][cb] + tabs[3][cr]) >> _SHIFT)
    b = yt + tabs[2][cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _ycc_tables_of(tags):
    ref = tags.get(REF_BLACK_WHITE, (0, 255, 128, 255, 128, 255))
    luma = tags.get(YCC_COEFFICIENTS, (0.299, 0.587, 0.114))
    return ycbcr_tables(ref, luma)


# the subsamplings libtiff's RGBA reader converts (tif_getimage.c
# PickContigCase)
_YCC_READ = ((4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1))


def _decode_ycc_rgba(data, tags, lay, compression, planar, name):
    """YCbCr through libtiff's RGBA reader (PIL's path for YCbCr that JPEG
    does not convert): each block's Y samples with its one Cb, Cr pair,
    through TIFFYCbCrtoRGB; opaque."""
    if compression == OJPEG:
        return _decode_ojpeg(data, tags, lay, name)
    if compression in CCITT:
        raise ValueError(f"{name}: YCbCr TIFF under compression "
                         f"{compression} (libtiff decodes none)")
    sh, sv = tags.get(YCC_SUBSAMPLING, (2, 2))[:2]
    if (sh, sv) not in _YCC_READ:
        raise ValueError(f"{name}: YCbCr subsampling {sh}x{sv} (libtiff's "
                         f"RGBA reader has no case for it)")
    if planar == 2 and (sh, sv) != (1, 1):
        raise ValueError(f"{name}: planar subsampled YCbCr (libtiff's RGBA "
                         f"reader refuses it)")
    if _predictor(tags, compression, 8, "YCC", name) != 1:
        raise ValueError(f"{name}: YCbCr with a predictor is not read")
    ycc = np.zeros((lay.h, lay.w, 3), np.int64)
    for plane, y0, x0, rows, off, raw in lay.chunks(data):
        if planar == 2:
            buf = _decompress(raw, compression, rows * lay.cw, name)
            s = _samples(buf, rows, lay.cw, 8, "<").reshape(rows, lay.cw, 1)
            lay.place(ycc, plane, y0, x0, s)
            continue
        by, bx = -(-rows // sv), -(-lay.cw // sh)
        n = sh * sv + 2
        buf = _decompress(raw, compression, by * bx * n, name)
        u = np.zeros(by * bx * n, np.uint8)
        got = np.frombuffer(buf[:by * bx * n], np.uint8)
        u[:len(got)] = got
        u = u.reshape(by, bx, n).astype(np.int64)
        yy = u[..., :sh * sv].reshape(by, bx, sv, sh).transpose(
            0, 2, 1, 3).reshape(by * sv, bx * sh)
        s = np.stack([yy,
                      np.repeat(np.repeat(u[..., -2], sv, 0), sh, 1),
                      np.repeat(np.repeat(u[..., -1], sv, 0), sh, 1)], -1)
        lay.place(ycc, 0, y0, x0, s)
    out = np.full((lay.h, lay.w, 4), 255, np.uint8)
    out[..., :3] = ycbcr_to_rgb(ycc[..., 0], ycc[..., 1], ycc[..., 2],
                                _ycc_tables_of(tags))
    return out


def _decode_ojpeg(data, tags, lay, name):
    """Old-style JPEG from its JPEGInterchangeFormat stream: libjpeg's raw
    component planes, converted as libtiff's RGBA reader converts
    YCbCr."""
    if JPEG_IF not in tags:
        raise ValueError(f"{name}: old-style JPEG-in-TIFF without a "
                         f"JPEGInterchangeFormat stream is not read")
    start = tags[JPEG_IF][0]
    length = tags.get(JPEG_IF_LENGTH, (len(data) - start,))[0]
    planes, factors = jpeg.decode_jpeg_planes(data[start:start + length],
                                              name)
    if len(planes) != 3:
        raise ValueError(f"{name}: old-style JPEG of {len(planes)} "
                         f"components is not read")
    (hy, vy), (hc, vc) = factors[0], factors[1]
    sh, sv = hy // hc, vy // vc
    y = planes[0][:lay.h, :lay.w].astype(np.int64)

    def rep(p):
        return np.repeat(np.repeat(p, sv, 0), sh, 1)[:lay.h, :lay.w].astype(
            np.int64)

    out = np.full((lay.h, lay.w, 4), 255, np.uint8)
    out[..., :3] = ycbcr_to_rgb(y, rep(planes[1]), rep(planes[2]),
                                _ycc_tables_of(tags))
    return out


def _to_rgba(img, kind, bits, photo, tags, planar, compression):
    h, w = img.shape[:2]
    out = np.empty((h, w, 4), np.uint8)
    out[..., 3] = 255
    v = img[..., 0]
    if kind == "grey":
        # PIL's raw reader takes a single plane's raw mode by its first
        # letter: uncompressed planar WhiteIsZero is read uninverted
        inverted = photo == 0 and not (planar == 2 and compression == 1)
        if bits == 1:
            g = np.where((v != 0) != inverted, 255, 0)
        else:
            g = v * (255 // ((1 << bits) - 1))
            if inverted:
                g = 255 - g
        out[..., :3] = g.astype(np.uint8)[..., None]
    elif kind == "grey16":
        out[..., :3] = np.minimum(v, 255).astype(np.uint8)[..., None]
    elif kind in ("I16S", "I32S", "I32"):
        val = v.astype(np.uint32)
        val = {"I16S": val.astype(np.uint16).view(np.int16),
               "I32S": val.view(np.int32), "I32": val}[kind]
        out[..., :3] = np.clip(val.astype(np.int64), 0, 255).astype(
            np.uint8)[..., None]
    elif kind == "F":
        f = v.astype(np.uint32).view(np.float32)
        g = np.where(f >= 255.0, 255, np.where(f > 0.0, np.trunc(
            np.where(f > 0.0, f, 0.0)), 0))
        out[..., :3] = g.astype(np.uint8)[..., None]
    elif kind == "LA":
        out[..., :3] = _high(v, bits)[..., None]
        # a plane copy into PIL's LA image misses its alpha band
        out[..., 3] = 0 if planar == 2 else _high(img[..., 1], bits)
    elif kind in ("RGB", "RGBA", "RGBa"):
        c = _high(img, bits)
        out[..., :3] = c[..., :3]
        if kind != "RGB":
            out[..., 3] = c[..., 3]
        # planes copied by PIL's libtiff decoder come out un-premultiplied
        # unless the alpha is marked unassociated
        planes_assoc = (planar == 2 and compression != 1
                        and tuple(tags.get(EXTRA, ())) != (2,))
        if kind == "RGBa" or (kind == "RGBA" and planes_assoc):
            out[..., :3] = _unpremultiply(c[..., :3], c[..., 3])
    elif kind in ("P", "PA"):
        cmap = np.asarray(tags[COLORMAP], np.int64) // 256
        n = len(cmap) // 3
        pal = np.zeros((256, 3), np.uint8)
        pal[:min(n, 256)] = cmap[:3 * n].reshape(3, n).T[:256]
        out[..., :3] = pal[np.minimum(v, 255)]
        if kind == "PA":
            out[..., 3] = 0 if planar == 2 else img[..., 1]
    elif kind == "LAB":
        # PIL's LAB image holds a* and b* + 128 (its chunky unpacker flips
        # their sign bit; a plane's is copied as it is), converted by
        # LittleCMS (io/cielab.py)
        lab = img[..., :3].astype(np.uint8)
        if planar != 2:
            lab = lab ^ np.array([0, 128, 128], np.uint8)
        out[..., :3] = cielab.lab_to_rgb(lab)
        # the alpha is the LAB image's fourth byte, which only the chunky
        # unpacker sets
        out[..., 3] = 0 if planar == 2 else 255
    else:  # CMYK
        out[..., :3] = cmyk_to_rgb(255 - _high(img[..., :4], bits))
    return out

"""Baseline TIFF decoding to PIL's pixels, with numpy, zlib and the
standard library.

``decode_tiff`` gives the (H, W, 4) uint8 words of PIL's
``Image.open(...).convert("RGBA")`` for the first IFD of a TIFF in the
forms libtiff and PIL's own plugin write:

- byte order II and MM; strips and tiles (edge tiles padded), one plane
  (PlanarConfiguration 1) or one plane a sample (2); FillOrder 2 (the
  bits of every stored byte reversed before anything else, as libtiff
  and PIL's raw reader both do);
- compression 1 (none), 5 (LZW: TIFF's most-significant-bit-first codes
  that widen one code early, and the old least-significant-bit-first
  style that libtiff still reads), 8 and 32946 (Deflate) and 32773
  (PackBits); predictor 1, and 2 (horizontal differencing, per sample at
  8 and 16 bits);
- photometric 0 (WhiteIsZero, inverted at 1-8 bits; PIL reads 16-bit
  WhiteIsZero uninverted) and 1 (grey at 1, 2, 4, 8 bits, 12 and 16
  clamped at 255 as PIL's I;16 converts; grey + unassociated alpha), 2
  (RGB and RGBA at 8 and 16 bits, 16-bit samples keeping their high
  byte; ExtraSamples 0 dropped, 1 (associated alpha) un-premultiplied
  with PIL's rounding, 2 kept), 3 (palette at 1-8 bits, 16-bit ColorMap
  entries divided by 256 as PIL takes them, with an extra alpha or
  unspecified sample) and 5 (CMYK at 8 and 16 bits, to RGB as PIL
  converts it);
- the layouts PIL's OPEN_INFO table lists, no more: what it lacks, PIL
  and this module refuse (ValueError naming the file);
- PIL's two readers' quirks: uncompressed data goes through PIL's raw
  reader, which never undoes a predictor (libtiff undoes it for LZW and
  Deflate only, not PackBits), lacks bit-reversed raw modes for 8-bit
  WhiteIsZero and sub-byte palettes, and reads each plane of a planar
  file by its raw mode's first letter (planar WhiteIsZero uninverted);
  compressed planar data is copied plane by plane by PIL's libtiff
  decoder, which leaves an LA / PA image's alpha 0 and un-premultiplies
  RGBA unless ExtraSamples marks it unassociated;
- the Orientation tag, applied as PIL 12's load applies it
  (``ImageOps.exif_transpose``).

Refused by name (NotImplementedError naming the file, the form and the
tag's value; ROADMAP.md F8): CCITT G3 / G4 (compression 2, 3, 4),
JPEG-in-TIFF (6, 7), LZMA, ZSTD and WebP-in-TIFF (34925, 50000, 50001),
floating-point and signed samples (predictor 3, SampleFormat 2 and 3),
YCbCr and CIELab photometrics (6, 8), BigTIFF, and the planar layouts
PIL misreads (uncompressed planes at 2, 4 and 16 bits, uncompressed
tiled RGBA planes without ExtraSamples, compressed palette tiles with an
extra sample).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .gif import lzw_decode
from .jpeg import cmyk_to_rgb

# tags
WIDTH, HEIGHT, BITS, COMPRESSION, PHOTOMETRIC = 256, 257, 258, 259, 262
FILLORDER, STRIP_OFFSETS, ORIENTATION, SPP, ROWS_PER_STRIP = (266, 273, 274,
                                                              277, 278)
STRIP_COUNTS, PLANAR, PREDICTOR, COLORMAP = 279, 284, 317, 320
TILE_W, TILE_H, TILE_OFFSETS, TILE_COUNTS = 322, 323, 324, 325
EXTRA, SAMPLE_FORMAT = 338, 339

_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h",
          9: "i", 10: "ii", 11: "f", 12: "d"}

# F8: forms PIL reads that this module refuses by name
_REFUSED_COMPRESSION = {2: "CCITT modified Huffman RLE", 3: "CCITT G3 fax",
                        4: "CCITT G4 fax", 6: "old-style JPEG-in-TIFF",
                        7: "JPEG-in-TIFF", 34925: "LZMA", 50000: "ZSTD",
                        50001: "WebP-in-TIFF"}
_REFUSED_PHOTOMETRIC = {6: "YCbCr", 8: "CIELab"}
_REFUSED_FORMAT = {2: "signed integer", 3: "floating-point"}
_COMPRESSIONS = (1, 5, 8, 32946, 32773)

_BIT_REVERSE = np.packbits(np.unpackbits(
    np.arange(256, dtype=np.uint8)[:, None], axis=1)[:, ::-1], axis=1)[:, 0]


def _refuse(name, form, tag, value):
    raise NotImplementedError(
        f"{name}: TIFF {form} ({tag} {value}) is not decoded (PIL reads it "
        f"through libtiff; the port reads baseline TIFF)")


def _ifd(data, order, name):
    """The first IFD's tags: {tag: tuple of values}."""
    at = struct.unpack_from(order + "I", data, 4)[0]
    if at + 2 > len(data):
        raise ValueError(f"{name}: TIFF IFD offset {at} beyond the file")
    n = struct.unpack_from(order + "H", data, at)[0]
    tags = {}
    for i in range(n):
        tag, typ, count, field = struct.unpack_from(order + "HHI4s", data,
                                                    at + 2 + 12 * i)
        fmt = _TYPES.get(typ)
        if fmt is None:
            continue
        size = struct.calcsize(order + fmt) * count
        body = field if size <= 4 else data[
            struct.unpack(order + "I", field)[0]:][:size]
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


def _decompress(raw, compression, n_out):
    if compression == 1:
        return raw
    if compression == 5:
        return _lzw(raw, n_out)
    if compression in (8, 32946):
        d = zlib.decompressobj()
        try:
            return d.decompress(raw, n_out)
        except zlib.error:
            return b""
    return _packbits(raw, n_out)


def _samples(buf, rows, cols, bits, order):
    """(rows, cols) unsigned samples of a chunk: rows padded to bytes,
    1-16 bits MSB first, 16-bit words in the file's byte order."""
    row_bytes = (cols * bits + 7) // 8
    need = rows * row_bytes
    raw = np.zeros(need, np.uint8)
    got = np.frombuffer(buf[:need], np.uint8)
    raw[:len(got)] = got
    raw = raw.reshape(rows, row_bytes)
    if bits == 8:
        return raw.astype(np.uint16)
    if bits == 16:
        return raw.view(order + "u2").astype(np.uint16)
    bitv = np.unpackbits(raw, axis=1)[:, :cols * bits].reshape(rows, cols,
                                                               bits)
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint16)
    return (bitv.astype(np.uint16) * weights).sum(-1, dtype=np.uint16)


def _mode(order, photo, fill, bps, extra):
    """PIL's (mode, layout) for a TIFF key, after its OPEN_INFO table;
    None where PIL has no entry."""
    n = len(bps)
    b = bps[0]
    if any(x != b for x in bps):
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


def _check_raw(name, kind, bits, photo, fill, planar, extra, tiled):
    """Uncompressed data goes through PIL's raw reader: it has no
    bit-reversed unpacker for 8-bit WhiteIsZero or palettes under 8 bits;
    it reads each plane of a planar file with its raw mode's first letter,
    which 8-bit L, P, RGB(A) and CMYK planes and 1-bit planes survive and
    others do not (F8: refused by name); and its edge tiles of a planar
    RGBA without ExtraSamples take a stride of three samples."""
    if fill == 2 and ((photo == 0 and bits == 8)
                      or (photo == 3 and bits < 8)):
        raise ValueError(f"{name}: TIFF FillOrder 2 at {bits} bits, "
                         f"photometric {photo} (PIL has no raw mode for it)")
    if planar != 2:
        return
    if kind in ("grey16", "LA", "PA", "RGBa") or (
            kind in ("RGB", "CMYK", "P") and extra) or (
            kind == "RGBA" and extra not in ((), (2,), (999,))):
        raise ValueError(f"{name}: uncompressed planar TIFF of {kind}, extra "
                         f"samples {extra} (PIL has no raw mode for a plane)")
    if bits not in (1, 8) or (bits == 1 and kind != "grey") or (
            kind == "RGBA" and not extra and tiled):
        _refuse(name, f"uncompressed planar {kind} at {bits} bits", "Planar"
                "Configuration", 2)


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


def decode_tiff(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A TIFF file's bytes as (H, W, 4) uint8 RGBA: its first IFD as PIL's
    convert("RGBA") gives it."""
    head = data[:4]
    if head in (b"II+\x00", b"MM\x00+"):
        _refuse(name, "BigTIFF", "version", 43)
    if head[:2] == b"II":
        order = "<"
    elif head[:2] == b"MM":
        order = ">"
    else:
        raise ValueError(f"{name}: not a TIFF file")
    if struct.unpack_from(order + "H", data, 2)[0] != 42:
        raise ValueError(f"{name}: not a TIFF file")
    tags = _ifd(data, order, name)

    def one(tag, default=None):
        return tags[tag][0] if tag in tags else default

    compression = one(COMPRESSION, 1)
    photo = one(PHOTOMETRIC, 0)
    if compression in _REFUSED_COMPRESSION:
        _refuse(name, _REFUSED_COMPRESSION[compression] + " compression",
                "Compression", compression)
    if photo in _REFUSED_PHOTOMETRIC:
        _refuse(name, _REFUSED_PHOTOMETRIC[photo] + " photometric",
                "PhotometricInterpretation", photo)
    if one(PREDICTOR, 1) == 3:
        _refuse(name, "floating-point predictor", "Predictor", 3)
    formats = tags.get(SAMPLE_FORMAT, (1,))
    for f in formats:
        if f in _REFUSED_FORMAT:
            _refuse(name, _REFUSED_FORMAT[f] + " samples", "SampleFormat", f)
    if compression not in _COMPRESSIONS:
        raise ValueError(f"{name}: TIFF compression {compression} unknown")
    if WIDTH not in tags or HEIGHT not in tags:
        raise ValueError(f"{name}: TIFF without dimensions")
    w, h = one(WIDTH), one(HEIGHT)
    fill = one(FILLORDER, 1)
    planar = one(PLANAR, 1)
    spp = one(SPP, 1)
    bps = tags.get(BITS, (1,))
    extra = tags.get(EXTRA, ())
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise ValueError(f"{name}: TIFF of unknown data organization")
    mode = _mode(order, photo, fill, bps, extra)
    if mode is None:
        raise ValueError(f"{name}: TIFF layout PIL does not read (photometric "
                         f"{photo}, bits {bps}, extra samples {extra}, fill "
                         f"order {fill})")
    kind, bits = mode
    tiled = TILE_OFFSETS in tags
    if compression == 1:
        _check_raw(name, kind, bits, photo, fill, planar, extra, tiled)
    elif planar == 2 and spp > 1 and 0 in extra:
        if not tiled:
            raise ValueError(f"{name}: planar TIFF strips with an "
                             f"unspecified extra sample (PIL's libtiff "
                             f"decoder refuses them)")
        if kind == "P":  # PIL reads the planes of a one-band image as one
            _refuse(name, "planar palette tiles with an extra sample",
                    "PlanarConfiguration", 2)
    # libtiff undoes the predictor for LZW and Deflate only; PIL reads
    # uncompressed data itself and never undoes it
    predictor = one(PREDICTOR, 1) if compression in (5, 8, 32946) else 1
    if predictor == 2 and bits not in (8, 16):
        raise ValueError(f"{name}: TIFF horizontal differencing at {bits} "
                         f"bits")

    if TILE_OFFSETS in tags:
        cw, ch = one(TILE_W), one(TILE_H)
        offsets, counts = tags[TILE_OFFSETS], tags.get(TILE_COUNTS)
    elif STRIP_OFFSETS in tags:
        cw, ch = w, min(one(ROWS_PER_STRIP, h), h) or h
        offsets, counts = tags[STRIP_OFFSETS], tags.get(STRIP_COUNTS)
    else:
        raise ValueError(f"{name}: TIFF of unknown data organization")
    planes = spp if planar == 2 else 1
    per = 1 if planar == 2 else spp
    across, down = -(-w // cw), -(-h // ch)
    if len(offsets) < planes * across * down:
        raise ValueError(f"{name}: TIFF has {len(offsets)} chunks of "
                         f"{planes * across * down}")
    img = np.zeros((h, w, spp), np.uint16)
    mask = (1 << bits) - 1
    k = 0
    for plane in range(planes):
        for ty in range(down):
            for tx in range(across):
                off = offsets[k]
                size = counts[k] if counts else len(data) - off
                k += 1
                raw = data[off:off + size]
                if fill == 2:
                    raw = _BIT_REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
                rows = ch if TILE_OFFSETS in tags else min(ch, h - ty * ch)
                n_out = rows * ((cw * per * bits + 7) // 8)
                s = _samples(_decompress(raw, compression, n_out), rows,
                             cw * per, bits, order)
                if predictor == 2:
                    s = s.reshape(rows, cw, per).astype(np.int64)
                    s = (np.cumsum(s, axis=1) & mask).astype(np.uint16)
                s = s.reshape(rows, cw, per)
                y0, x0 = ty * ch, tx * cw
                part = s[:min(rows, h - y0), :min(cw, w - x0)]
                img[y0:y0 + part.shape[0], x0:x0 + part.shape[1],
                    plane:plane + per] = part
    rgba = _to_rgba(img, kind, bits, photo, tags, planar, compression)
    return _ORIENT.get(one(ORIENTATION), lambda a: a)(rgba)


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
    else:  # CMYK
        out[..., :3] = cmyk_to_rgb(255 - _high(img[..., :4], bits))
    return out

"""Image I/O: PNG screenshots (ScreenshotCtx equivalent) and loading.

Counterpart of ``voidin_tpu/io/image.py``, written with ``zlib`` and
``struct`` alone (no PIL). The JAX package reads every image through PIL
(``Image.open(path).convert("RGBA")``); this module reads what PIL reads
of PNG: every colour type at every bit depth the format allows (grey at
1, 2, 4, 8 and 16 bits, palette at 1-8, RGB, grey + alpha and RGBA at 8
and 16), non-interlaced or Adam7, from a file (``load_image``) or from
bytes (``decode_png``; glTF embeds its images in buffers and data URIs),
and expands each to the RGBA that PIL's ``convert("RGBA")`` gives, PIL's
quirks included (16-bit grey clamped at 255, tRNS keys compared by their
low byte). A layout the format does not define raises ValueError naming
the file. ``decode_image`` and ``load_image`` also read JPEG through
``io/jpeg.py``, WebP through ``io/webp.py``, GIF through ``io/gif.py``,
BMP through ``io/bmp.py`` and TIFF and BigTIFF through ``io/tiff.py`` (see
their docstrings for what each reads and what it refuses).
``encode_png`` gives a PNG's bytes (the web viewer's frames) at a zlib
level of the caller's choice.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import bmp, gif, jpeg, tiff, webp

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels (grey, RGB, palette, grey + alpha, RGBA)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img, level: int = 6) -> bytes:
    """An (H, W, 3|4) float [0, 1] or uint8 image as PNG bytes (floats
    are clipped, NaN is 0, and rounded to the nearest of 256 steps);
    `level` is zlib's (1 fast, 9 small)."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = (np.clip(np.nan_to_num(arr), 0.0, 1.0) * 255.0
               + 0.5).astype(np.uint8)
    if arr.ndim != 3 or arr.shape[2] not in (3, 4):
        raise ValueError(f"save_png takes (H, W, 3|4) images, got "
                         f"{arr.shape}")
    h, w, c = arr.shape
    # filter type 0 (none) on every row
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)],
                         axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def save_png(path: str, img) -> None:
    """Save an (H, W, 3|4) float [0, 1] or uint8 image (encode_png)."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (0 none, 1 sub, 2 up, 3 average,
    4 Paeth) of 8-bit samples, `bpp` bytes a pixel."""
    stride = w * bpp
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        f = int(rows[y, 0])
        line = rows[y, 1:]
        if f == 0:
            cur = line
        elif f == 1:
            cur = (np.cumsum(line.reshape(w, bpp).astype(np.int64), axis=0)
                   & 0xFF).astype(np.uint8).reshape(stride)
        elif f == 2:
            cur = line + prev  # uint8 wraps mod 256
        elif f in (3, 4):
            # sequential along the row: plain Python ints
            a, b, cur = line.tolist(), prev.tolist(), [0] * stride
            for x in range(stride):
                left = cur[x - bpp] if x >= bpp else 0
                up = b[x]
                if f == 3:
                    p = (left + up) >> 1
                else:
                    ul = b[x - bpp] if x >= bpp else 0
                    pa, pb = abs(up - ul), abs(left - ul)
                    pc = abs(left + up - 2 * ul)
                    p = left if pa <= pb and pa <= pc else (
                        up if pb <= pc else ul)
                cur[x] = (a[x] + p) & 0xFF
            cur = np.asarray(cur, np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {f}")
        out[y] = cur
        prev = out[y]
    return out.reshape(h, w, bpp)


def _expand_bits(rows: np.ndarray, w: int, bits: int) -> np.ndarray:
    """(h, ceil(w * bits / 8)) packed samples of `bits` < 8 per pixel,
    most significant first -> (h, w) sample values."""
    per = 8 // bits
    shifts = (8 - bits * (np.arange(per) + 1)).astype(np.uint8)
    vals = (rows[..., None] >> shifts) & np.uint8((1 << bits) - 1)
    return vals.reshape(rows.shape[0], -1)[:, :w]


# Adam7 passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# PNG colour type -> the bit depths the format allows
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}


def _scanline_bytes(w: int, depth: int, chans: int) -> int:
    return -(-w * depth * chans // 8)


def _samples(raw: bytes, h: int, w: int, depth: int, chans: int):
    """The filtered scanlines of one (sub)image -> (h, w, chans) samples:
    uint8 up to 8 bits (low depths unpacked to their values), big-endian
    uint16 at 16."""
    if depth < 8:
        packed = _unfilter(raw, h, _scanline_bytes(w, depth, 1), 1)[..., 0]
        return _expand_bits(packed, w, depth)[..., None]
    rows = _unfilter(raw, h, w, chans * depth // 8)
    if depth == 16:
        pairs = rows.reshape(h, w, chans, 2).astype(np.uint16)
        return pairs[..., 0] << 8 | pairs[..., 1]
    return rows


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A PNG's bytes as (H, W, 4) uint8 RGBA, as PIL's convert("RGBA")
    gives it, for every colour type and bit depth the format allows,
    non-interlaced or Adam7:
    - grey: 1-4-bit values scaled to 0-255, 16-bit ones clamped at 255
      (PIL's I;16 -> RGBA), replicated into RGB;
    - palette indices (1-8 bits) looked up with their tRNS alphas;
    - RGB, grey + alpha and RGBA: 16-bit samples keep their high byte;
    - a grey or RGB tRNS key: alpha 0 where the 8-bit sample (scaled,
      clamped or high byte, as above) equals the key's low byte (at 1 bit:
      the white sample for any nonzero key), as PIL compares them;
    - opaque alpha elsewhere.
    Raises ValueError naming `name` on anything else (decode_image also
    reads JPEG)."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{name}: not a PNG")
    i, idat, header, plte, trns = 8, [], None, None, None
    while i < len(data):
        n = struct.unpack(">I", data[i:i + 4])[0]
        kind, body = data[i + 4:i + 8], data[i + 8:i + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        i += 12 + n
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, ctype, _comp, _filt, interlace = header
    if depth not in _DEPTHS.get(ctype, ()) or interlace not in (0, 1):
        raise ValueError(
            f"{name}: not a PNG layout PIL reads (bit depth {depth}, colour "
            f"type {ctype}, interlace {interlace})")
    chans = _CHANNELS[ctype]
    raw = zlib.decompress(b"".join(idat))
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    sizes = [(-(-(h - y0) // dy), -(-(w - x0) // dx))
             for x0, y0, dx, dy in passes]
    need = sum(ph * (1 + _scanline_bytes(pw, depth, chans))
               for ph, pw in sizes if ph > 0 and pw > 0)
    if len(raw) < need:
        raise ValueError(f"{name}: PNG image data ends early ({len(raw)} "
                         f"of {need} bytes)")
    samples = np.zeros((h, w, chans), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for (x0, y0, dx, dy), (ph, pw) in zip(passes, sizes):
        if ph <= 0 or pw <= 0:
            continue  # an empty Adam7 pass has no scanlines at all
        n = ph * (1 + _scanline_bytes(pw, depth, chans))
        samples[y0::dy, x0::dx] = _samples(raw[pos:pos + n], ph, pw, depth,
                                           chans)
        pos += n
    if ctype == 3:
        if plte is None:
            raise ValueError(f"{name}: palette PNG without a PLTE chunk")
        alpha = np.full(256, 255, np.uint8)
        if trns is not None:
            alpha[:len(trns)] = np.frombuffer(trns, np.uint8)[:256]
        lut = np.zeros((256, 4), np.uint8)
        lut[:len(plte), :3] = plte[:256]
        lut[:, 3] = alpha
        return lut[samples[..., 0]]
    if depth == 16:
        # grey clamps at 255 (PIL's I;16); the other types keep the high
        # byte (PIL's ;16B raw modes)
        samples = (np.minimum(samples, 255) if ctype == 0
                   else samples >> 8).astype(np.uint8)
    elif depth < 8:
        samples = samples * np.uint8(255 // ((1 << depth) - 1))
    if ctype in (0, 4):
        grey = samples[..., 0]
        alpha = (samples[..., 1] if ctype == 4
                 else np.full((h, w), 255, np.uint8))
        if ctype == 0 and trns is not None:
            key = struct.unpack(">H", trns[:2])[0]
            key = (255 if key else 0) if depth == 1 else key & 0xFF
            alpha = np.where(grey == key, np.uint8(0), alpha)
        return np.stack([grey, grey, grey, alpha], axis=-1)
    if ctype == 2:
        alpha = np.full((h, w, 1), 255, np.uint8)
        if trns is not None:
            key = np.array(struct.unpack(">HHH", trns[:6])) & 0xFF
            alpha[(samples == key).all(axis=-1)] = 0
        return np.concatenate([samples, alpha], axis=-1)
    return samples


# The decoders of the formats PIL opens besides PNG and JPEG, by their
# leading bytes
_DECODERS = ((b"RIFF", 8, b"WEBP", webp.decode_webp),
             (b"GIF87a", 0, b"", gif.decode_gif),
             (b"GIF89a", 0, b"", gif.decode_gif),
             (b"BM", 0, b"", bmp.decode_bmp),
             (b"II*\x00", 0, b"", tiff.decode_tiff),
             (b"MM\x00*", 0, b"", tiff.decode_tiff),
             (b"II+\x00", 0, b"", tiff.decode_tiff),
             (b"MM\x00+", 0, b"", tiff.decode_tiff))


def decode_image(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """An image file's bytes as (H, W, 4) uint8 RGBA, as PIL's
    convert("RGBA") gives it, for what the JAX package reads through PIL:
    PNG (decode_png), JPEG (io/jpeg.decode_jpeg, grey replicated into RGB,
    opaque alpha), WebP (io/webp.py: the first frame of lossy, lossless,
    alpha and animated files), GIF (io/gif.py: the first frame), BMP
    (io/bmp.py) and TIFF or BigTIFF (io/tiff.py: the first IFD), each
    found by its leading bytes; a file none of them reads raises
    ValueError naming it."""
    for magic, at, tag, decode in _DECODERS:
        if data[:len(magic)] == magic and data[at:at + len(tag)] == tag:
            return decode(data, name)
    if data[:2] != jpeg.SOI:
        return decode_png(data, name)
    rgb = jpeg.decode_jpeg(data, name)
    if rgb.ndim == 2:
        rgb = np.repeat(rgb[..., None], 3, axis=-1)
    alpha = np.full(rgb.shape[:2] + (1,), 255, np.uint8)
    return np.concatenate([rgb, alpha], axis=-1)


def load_image(path: str) -> np.ndarray:
    """Load a PNG, JPEG, WebP, GIF, BMP or TIFF file as (H, W, 4)
    uint8 RGBA, as PIL's Image.open(path).convert("RGBA") gives it
    (decode_image)."""
    with open(path, "rb") as f:
        return decode_image(f.read(), name=str(path))

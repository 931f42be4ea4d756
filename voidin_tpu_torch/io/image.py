"""Image I/O: PNG screenshots (ScreenshotCtx equivalent) and loading.

Counterpart of ``voidin_tpu/io/image.py``, written with ``zlib`` and
``struct`` alone (no PIL). It reads non-interlaced PNGs of every colour
type at 8 bits (grey, RGB, palette, grey + alpha, RGBA; grey and palette
also at 1, 2 and 4 bits), from a file (``load_image``) or from bytes
(``decode_png``; glTF embeds its images in buffers and data URIs), and
expands each to the RGBA that PIL's ``convert("RGBA")`` gives. 16-bit
and interlaced PNGs are refused with a ValueError. ``decode_image`` and
``load_image`` also read JPEG through ``io/jpeg.py`` (baseline and
extended-sequential; a progressive file raises NotImplementedError).
``encode_png`` gives a PNG's bytes (the web viewer's frames) at a zlib
level of the caller's choice.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import jpeg

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


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A PNG's bytes as (H, W, 4) uint8 RGBA, as PIL's convert("RGBA")
    gives it: grey (bit depths 1-8) replicated into RGB, palette indices
    (1-8 bits) looked up with their tRNS alphas, grey + alpha spread, an
    RGB or grey tRNS key cut to alpha 0, opaque alpha elsewhere. 16-bit
    and interlaced PNGs raise ValueError (decode_image also reads
    JPEG)."""
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
    low_bits = ctype in (0, 3) and depth in (1, 2, 4)
    if (ctype not in _CHANNELS or interlace != 0
            or not (depth == 8 or low_bits)):
        raise ValueError(
            f"{name}: only non-interlaced 8-bit PNGs (and 1-4-bit grey or "
            f"palette ones) are read (bit depth {depth}, colour type "
            f"{ctype}, interlace {interlace})")
    chans = _CHANNELS[ctype]
    raw = zlib.decompress(b"".join(idat))
    if low_bits:
        packed = _unfilter(raw, h, -(-w * depth // 8), 1)[..., 0]
        samples = _expand_bits(packed, w, depth)[..., None]
    else:
        samples = _unfilter(raw, h, w, chans)
    if ctype == 3:
        if plte is None:
            raise ValueError(f"{name}: palette PNG without a PLTE chunk")
        alpha = np.full(256, 255, np.uint8)
        if trns is not None:
            alpha[:len(trns)] = np.frombuffer(trns, np.uint8)
        lut = np.zeros((256, 4), np.uint8)
        lut[:len(plte), :3] = plte
        lut[:, 3] = alpha
        return lut[samples[..., 0]]
    if ctype in (0, 4):
        grey = samples[..., 0]
        if depth < 8:
            grey = grey * np.uint8(255 // ((1 << depth) - 1))
        alpha = (samples[..., 1] if ctype == 4
                 else np.full((h, w), 255, np.uint8))
        if ctype == 0 and trns is not None:
            key = struct.unpack(">H", trns[:2])[0]
            alpha = np.where(samples[..., 0] == key, np.uint8(0), alpha)
        return np.stack([grey, grey, grey, alpha], axis=-1)
    if ctype == 2:
        alpha = np.full((h, w, 1), 255, np.uint8)
        if trns is not None:
            key = np.array(struct.unpack(">HHH", trns[:6]))
            alpha[(samples == key).all(axis=-1)] = 0
        return np.concatenate([samples, alpha], axis=-1)
    return samples


def decode_image(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A PNG's or a JPEG's bytes as (H, W, 4) uint8 RGBA, as PIL's
    convert("RGBA") gives it (JPEG: io/jpeg.decode_jpeg, grey replicated
    into RGB, opaque alpha)."""
    if data[:2] != jpeg.SOI:
        return decode_png(data, name)
    rgb = jpeg.decode_jpeg(data, name)
    if rgb.ndim == 2:
        rgb = np.repeat(rgb[..., None], 3, axis=-1)
    alpha = np.full(rgb.shape[:2] + (1,), 255, np.uint8)
    return np.concatenate([rgb, alpha], axis=-1)


def load_image(path: str) -> np.ndarray:
    """Load a PNG or JPEG file as (H, W, 4) uint8 RGBA (decode_image)."""
    with open(path, "rb") as f:
        return decode_image(f.read(), name=str(path))

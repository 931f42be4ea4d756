"""Image I/O: PNG screenshots (ScreenshotCtx equivalent) and loading.

Counterpart of ``voidin_tpu/io/image.py``, written with ``zlib`` and
``struct`` alone (no PIL): 8-bit RGB and RGBA PNGs without interlacing,
which is what ``save_png`` writes and what the goldens are. Any other PNG
is refused with a ValueError.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}  # PNG colour type -> channels (RGB, RGBA)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def save_png(path: str, img) -> None:
    """Save an (H, W, 3|4) float [0, 1] or uint8 image (floats are
    clipped, NaN is 0, and rounded to the nearest of 256 steps)."""
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
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))


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


def load_image(path: str) -> np.ndarray:
    """Load a PNG as (H, W, 4) uint8 RGBA (opaque alpha for RGB)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    i, idat, header = 8, [], None
    while i < len(data):
        n = struct.unpack(">I", data[i:i + 4])[0]
        kind, body = data[i + 4:i + 8], data[i + 8:i + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        i += 12 + n
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _comp, _filt, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: only 8-bit RGB/RGBA non-interlaced PNGs are read "
            f"(bit depth {depth}, colour type {ctype}, interlace "
            f"{interlace})")
    bpp = _CHANNELS[ctype]
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w, bpp)
    if bpp == 3:
        img = np.concatenate([img, np.full((h, w, 1), 255, np.uint8)],
                             axis=-1)
    return img

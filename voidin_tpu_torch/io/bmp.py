"""BMP decoding to PIL's pixels, with numpy and the standard library.

The JAX package opens textures with PIL (``Image.open(...).convert(
"RGBA")``); ``decode_bmp`` gives the same (H, W, 4) uint8 words for what
PIL's BMP plugin reads:

- headers: OS/2 core (12 bytes, 3-byte palette entries), INFO (40), V2
  (52), V3 (56), OS/2 2.x (64, read as INFO, as PIL reads it), V4 (108)
  and V5 (124); top-down rows where the height is negative; rows padded
  to 4 bytes;
- 1, 4 and 8 bits a pixel through a palette (a palette that is exactly
  the grey ramp makes PIL's "1" / "L" image, whose rows PIL reads as 1-bit
  / 8-bit whatever the depth: so does this module, refusing an "L" image
  under 8 bits as PIL does), 16 (PIL's BGR;15 and
  BGR;16 expansions), 24 and 32 (BI_RGB drops the fourth byte: PIL's
  "RGB" mode);
- BI_BITFIELDS with the masks PIL knows (16: 5-6-5 and 5-5-5; 24: BGR;
  32: eight layouts, those with an alpha mask giving alpha);
- RLE8 and RLE4 with end-of-line, end-of-file and delta escapes, as PIL's
  BmpRleDecoder walks them (its delta reads four bytes and moves by the
  last two; RLE4's absolute runs of odd length drop their last pixel;
  absolute runs realign on the file's even offsets).

What PIL refuses (other depths, bitfield layouts, BI_ALPHABITFIELDS,
JPEG / PNG payloads) raises ValueError naming the file.
"""

from __future__ import annotations

import struct

import numpy as np

RGB, RLE8, RLE4, BITFIELDS = 0, 1, 2, 3
HEADERS = (12, 40, 52, 56, 64, 108, 124)

# 32-bit BI_BITFIELDS (r, g, b, a) masks -> (byte of R, G, B, A or None),
# PIL's MASK_MODES
_MASKS32 = {
    (0xFF0000, 0xFF00, 0xFF, 0x0): (2, 1, 0, None),  # BGRX
    (0xFF000000, 0xFF0000, 0xFF00, 0x0): (3, 2, 1, None),  # XBGR
    (0xFF000000, 0xFF00, 0xFF, 0x0): (3, 1, 0, None),  # BGXR
    (0xFF000000, 0xFF0000, 0xFF00, 0xFF): (3, 2, 1, 0),  # ABGR
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000): (0, 1, 2, 3),  # RGBA
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000): (2, 1, 0, 3),  # BGRA
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000): (3, 1, 0, 2),  # BGAR
    (0x0, 0x0, 0x0, 0x0): (2, 1, 0, 3),  # BGRA
}


def _expand(v, bits):
    """PIL's 5- and 6-bit channel expansion (Unpack.c BGR;15 / BGR;16):
    v * 255 / max, truncated."""
    return (v * 255 // ((1 << bits) - 1)).astype(np.uint8)


def _rows(data, offset, stride, h, name):
    need = offset + stride * h
    if need > len(data):
        raise ValueError(f"{name}: BMP pixel data truncated ({len(data)} of "
                         f"{need} bytes)")
    return np.frombuffer(data, np.uint8, stride * h, offset).reshape(h,
                                                                     stride)


def _rle(data, pos, w, h, rle4):
    """PIL's BmpRleDecoder: the pixel indices in stored row order."""
    out = bytearray()
    x = 0
    n = w * h
    end = len(data)
    while len(out) < n:
        if pos + 2 > end:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:
            if x + count > w:
                count = max(0, w - x)
            if rle4:
                pair = (byte >> 4, byte & 0x0F)
                out += bytes(pair[i % 2] for i in range(count))
            else:
                out += bytes((byte,)) * count
            x += count
        elif byte == 0:  # end of line
            if len(out) % w:
                out += bytes(w - len(out) % w)
            x = 0
        elif byte == 1:  # end of bitmap
            break
        elif byte == 2:  # delta: PIL reads two bytes, then moves by two more
            if pos + 2 > end:
                break
            pos += 2
            if pos + 2 > end:
                raise ValueError("BMP delta escape truncated")
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += bytes(right + up * w)
            x = len(out) % w
        else:  # absolute run
            if rle4:
                nbytes = byte // 2
                chunk = data[pos:pos + nbytes]
                for b in chunk:
                    out += bytes((b >> 4, b & 0x0F))
            else:
                nbytes = byte
                chunk = data[pos:pos + nbytes]
                out += chunk
            pos += len(chunk)
            if len(chunk) < nbytes:
                break
            x += byte
            if pos % 2:
                pos += 1
    flat = np.zeros(n, np.uint8)
    got = np.frombuffer(bytes(out[:n]), np.uint8)
    flat[:len(got)] = got
    return flat.reshape(h, w)


def decode_bmp(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A BMP file's bytes as (H, W, 4) uint8 RGBA, PIL's convert("RGBA")."""
    if data[:2] != b"BM" or len(data) < 18:
        raise ValueError(f"{name}: not a BMP file")
    offset = struct.unpack_from("<I", data, 10)[0]
    hsize = struct.unpack_from("<I", data, 14)[0]
    if hsize not in HEADERS:
        raise ValueError(f"{name}: unsupported BMP header type ({hsize})")
    hdr = data[18:14 + hsize]
    if len(hdr) < hsize - 4:
        raise ValueError(f"{name}: BMP header truncated")
    pos = 14 + hsize
    masks = None
    if hsize == 12:
        w, h, _planes, bits = struct.unpack_from("<HHHH", hdr, 0)
        comp, colors, pad, flip = RGB, 0, 3, False
    else:
        flip = hdr[7] == 0xFF
        w, h = struct.unpack_from("<Ii", hdr, 0)
        h = -h if flip else h
        bits, comp = struct.unpack_from("<HI", hdr, 10)
        colors = struct.unpack_from("<I", hdr, 28)[0]
        pad = 4
        if comp == BITFIELDS:
            if len(hdr) >= 48:
                n = 4 if len(hdr) >= 52 else 3
                masks = struct.unpack_from(f"<{n}I", hdr, 36) + (0,) * (4 - n)
            else:
                masks = struct.unpack_from("<3I", data, pos) + (0,)
                pos += 12
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"{name}: unsupported BMP pixel depth ({bits})")
    if comp == BITFIELDS:
        ok = ((bits == 32 and masks in _MASKS32)
              or (bits == 24 and masks[:3] == (0xFF0000, 0xFF00, 0xFF))
              or (bits == 16 and masks[:3] in ((0xF800, 0x7E0, 0x1F),
                                               (0x7C00, 0x3E0, 0x1F))))
        if not ok:
            raise ValueError(f"{name}: unsupported BMP bitfields layout "
                             f"{tuple(hex(m) for m in masks)}")
    elif comp in (RLE8, RLE4):
        if bits > 8:
            raise ValueError(f"{name}: BMP RLE at {bits} bits a pixel")
    elif comp != RGB:
        raise ValueError(f"{name}: unsupported BMP compression ({comp})")

    palette = grey = None
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise ValueError(f"{name}: unsupported BMP palette size "
                             f"({colors})")
        raw = np.frombuffer(data[pos:pos + pad * colors], np.uint8)
        if len(raw) < pad * colors:
            raise ValueError(f"{name}: BMP palette truncated")
        entries = raw.reshape(colors, pad)[:, 2::-1]  # BGR(X) -> RGB
        ramp = (np.array([0, 255]) if colors == 2 else np.arange(colors))
        if (entries == ramp[:, None]).all():
            grey = "1" if colors == 2 else "L"
        palette = np.zeros((256, 3), np.uint8)
        palette[:min(colors, 256)] = entries[:256]

    if comp in (RLE8, RLE4):
        idx = _rle(data, offset, w, h, comp == RLE4)
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        rows = _rows(data, offset, stride, h, name)
        if grey == "L":  # PIL reads the row bytes as 8-bit grey
            if bits < 8:
                raise ValueError(f"{name}: a {bits}-bit BMP with a grey-ramp "
                                 f"palette (PIL's codec configuration "
                                 f"error)")
            idx = rows[:, :w]
        elif grey == "1":  # and as 1-bit black and white
            idx = np.unpackbits(rows, axis=1)[:, :w]
        elif bits < 8:
            idx = np.unpackbits(rows, axis=1)
            if bits == 4:
                idx = (idx[:, 0::4] << 3 | idx[:, 1::4] << 2
                       | idx[:, 2::4] << 1 | idx[:, 3::4])
            idx = idx[:, :w]
        elif bits == 8:
            idx = rows[:, :w]
        else:
            idx = None
    if not flip:
        rows_order = slice(None, None, -1)
    else:
        rows_order = slice(None)
    out = np.empty((h, w, 4), np.uint8)
    out[..., 3] = 255
    if bits <= 8:
        idx = idx[rows_order]
        if grey == "1":
            v = np.where(idx != 0, 255, 0).astype(np.uint8)
            out[..., :3] = v[..., None]
        elif grey == "L":
            out[..., :3] = idx[..., None]
        else:
            out[..., :3] = palette[idx]
        return out
    px = rows[rows_order]
    if bits == 16:
        v = px[:, :2 * w].reshape(h, w, 2).astype(np.uint32)
        v = v[..., 0] | v[..., 1] << 8
        if masks is not None and masks[0] == 0xF800:
            out[..., 0] = _expand(v >> 11 & 31, 5)
            out[..., 1] = _expand(v >> 5 & 63, 6)
        else:
            out[..., 0] = _expand(v >> 10 & 31, 5)
            out[..., 1] = _expand(v >> 5 & 31, 5)
        out[..., 2] = _expand(v & 31, 5)
        return out
    nb = bits // 8
    v = px[:, :nb * w].reshape(h, w, nb)
    if bits == 32 and masks is not None:
        r, g, b, a = _MASKS32[masks]
        out[..., 0], out[..., 1], out[..., 2] = v[..., r], v[..., g], v[..., b]
        if a is not None:
            out[..., 3] = v[..., a]
        return out
    out[..., :3] = v[..., 2::-1]
    return out

"""GIF decoding to PIL's pixels (the first frame), with numpy and the
standard library.

``decode_gif`` gives the (H, W, 4) uint8 words of PIL's
``Image.open(...).convert("RGBA")`` for a GIF87a / GIF89a file, which is
its first frame:

- LZW codes of 2-12 bits, least significant bit first, the width growing
  when the next free code reaches it, clear and end codes, and a full
  table kept (no entry added) until the encoder clears it;
- the 4-pass interlace; the frame's local palette or else the global one
  (a palette that is exactly the grey ramp 0, 1, 2, ... makes PIL's "L"
  image: the index is the grey value), black where an index lies beyond
  the palette;
- the graphic control extension's transparency index: alpha 0 wherever a
  pixel holds it;
- the canvas: the logical screen, grown to hold the first frame as PIL
  grows it, filled outside the frame with the transparency index where
  there is one and index 0 otherwise, as PIL fills it.

A file that is not a GIF or holds no image raises ValueError naming it.
"""

from __future__ import annotations

import struct

import numpy as np


def _blocks(data, pos):
    """The bytes of the data sub-blocks at `pos` and the position after
    the terminator."""
    out = bytearray()
    while pos < len(data):
        n = data[pos]
        pos += 1
        if n == 0:
            break
        out += data[pos:pos + n]
        pos += n
    return bytes(out), pos


def lzw_decode(stream: bytes, min_bits: int, n_out: int, msb=False,
               early=False) -> bytes:
    """Up to `n_out` bytes of an LZW stream whose codes start at
    min_bits + 1 bits, with clear and end codes, widening when the next
    free code reaches the width (one code `early`, as TIFF's codes do),
    packed least significant bit first (GIF, old-style TIFF) or most
    significant first (`msb`, TIFF). A full table of 4096 entries is kept,
    no entry added, until a clear code."""
    clear = 1 << min_bits
    eoi = clear + 1
    out = bytearray()
    table = [bytes((i,)) for i in range(clear)] + [b"", b""]
    width = min_bits + 1
    grow = int(early)
    prev = None
    acc = nbits = 0
    pos = 0
    n = len(stream)
    while len(out) < n_out:
        while nbits < width and pos < n:
            if msb:
                acc = acc << 8 | stream[pos]
            else:
                acc |= stream[pos] << nbits
            nbits += 8
            pos += 1
        if nbits < width:
            break
        if msb:
            code = acc >> (nbits - width) & ((1 << width) - 1)
            acc &= (1 << (nbits - width)) - 1
        else:
            code = acc & ((1 << width) - 1)
            acc >>= width
        nbits -= width
        if code == clear:
            del table[clear + 2:]
            width = min_bits + 1
            prev = None
            continue
        if code == eoi:
            break
        nxt = len(table)
        if prev is None:
            if code >= nxt:
                break
            entry = table[code]
        else:
            if code < nxt:
                entry = table[code]
            elif code == nxt and nxt < 4096:
                entry = table[prev] + table[prev][:1]
            else:
                break
            if nxt < 4096:
                table.append(table[prev] + entry[:1])
                if nxt + 1 + grow == 1 << width and width < 12:
                    width += 1
        out += entry
        prev = code
    return bytes(out[:n_out])


def _palette(raw):
    """PIL's palette of `raw` RGB triples: None for the grey ramp."""
    p = np.frombuffer(raw, np.uint8).reshape(-1, 3)
    if (p == np.arange(len(p))[:, None]).all():
        return None
    full = np.zeros((256, 3), np.uint8)
    full[:len(p)] = p[:256]
    return full


def decode_gif(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A GIF file's bytes as (H, W, 4) uint8 RGBA: its first frame as PIL's
    convert("RGBA") gives it."""
    if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 13:
        raise ValueError(f"{name}: not a GIF file")
    sw, sh, flags = struct.unpack_from("<HHB", data, 6)
    pos = 13
    global_pal = None
    if flags & 0x80:
        size = 3 << ((flags & 7) + 1)
        global_pal = _palette(data[pos:pos + size])
        pos += size
    trns = None
    while pos < len(data):
        kind = data[pos]
        pos += 1
        if kind == 0x21:  # extension
            label = data[pos]
            block, pos = _blocks(data, pos + 1)
            if label == 0xF9 and len(block) >= 4 and block[0] & 1:
                trns = block[3]
            continue
        if kind != 0x2C:  # ';' or garbage: no image
            break
        x0, y0, fw, fh, lflags = struct.unpack_from("<HHHHB", data, pos)
        pos += 9
        pal = global_pal
        if lflags & 0x80:
            size = 3 << ((lflags & 7) + 1)
            pal = _palette(data[pos:pos + size])
            pos += size
        min_bits = data[pos]
        stream, pos = _blocks(data, pos + 1)
        if not 0 < min_bits <= 12:
            raise ValueError(f"{name}: GIF LZW code size {min_bits}")
        w, h = max(sw, x0 + fw), max(sh, y0 + fh)
        canvas = np.full((h, w), trns or 0, np.uint8)
        idx = np.zeros(fw * fh, np.uint8)
        got = lzw_decode(stream, min_bits, fw * fh)
        idx[:len(got)] = np.frombuffer(got, np.uint8)
        idx = idx.reshape(fh, fw)
        if lflags & 0x40:  # interlaced: rows stored pass by pass
            order = np.concatenate([np.arange(0, fh, 8), np.arange(4, fh, 8),
                                    np.arange(2, fh, 4), np.arange(1, fh, 2)])
            rows = np.empty_like(idx)
            rows[order] = idx
            idx = rows
        canvas[y0:y0 + fh, x0:x0 + fw] = idx
        out = np.empty((h, w, 4), np.uint8)
        out[..., :3] = (canvas[..., None] if pal is None else pal[canvas])
        out[..., 3] = 255
        if trns is not None:
            out[..., 3][canvas == trns] = 0
        return out
    raise ValueError(f"{name}: GIF holds no image")

"""CCITT bilevel decoding for TIFF, as libtiff's tif_fax3.c reads it.

``decode(data, width, rows, compression, t4_options=0)`` gives a (rows,
width) uint8 array of 0 / 1 bits, 1 where a black run (in T.4's terms)
lies, which is what libtiff hands PIL before PhotometricInterpretation
says what a bit means:

- compression 2, modified Huffman (T.4 1-D codes, each row starting on a
  byte boundary, no EOL);
- compression 3, T.4 "Group 3": an EOL before each row (fill bits before
  it skipped); with T4Options bit 0, a tag bit after each EOL picks 1-D or
  2-D coding for the row (ITU-T T.4 4.2);
- compression 4, T.6 "Group 4": every row 2-D coded against the row above
  (an all-white row above the first), no EOL.

FillOrder 2 is the caller's: it reverses the bits of every byte first.
Uncompressed mode (T4Options bit 1, the 2-D extension code) raises
ValueError, as libtiff refuses it. A row whose runs overrun the width is
cut at the width, as libtiff's fill does; a stream that ends early leaves
the rest of the rows white (0), as libtiff leaves them.
"""

from __future__ import annotations

import numpy as np

# T.4 Table 2 and 3: (code, run length)
_WHITE_TERM = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 "
    "001000 000011 110100 110101 101010 101011 0100111 0001100 0001000 "
    "0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 "
    "00000010 00000011 00011010 00011011 00010010 00010011 00010100 "
    "00010101 00010110 00010111 00101000 00101001 00101010 00101011 "
    "00101100 00101101 00000100 00000101 00001010 00001011 01010010 "
    "01010011 01010100 01010101 00100100 00100101 01011000 01011001 "
    "01011010 01011011 01001010 01001011 00110010 00110011 00110100")
_WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 "
    "01101000 01100111 011001100 011001101 011010010 011010011 011010100 "
    "011010101 011010110 011010111 011011000 011011001 011011010 011011011 "
    "010011000 010011001 010011010 011000 010011011")
_BLACK_TERM = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 "
    "0000111 00000100 00000111 000011000 0000010111 0000011000 0000001000 "
    "00001100111 00001101000 00001101100 00000110111 00000101000 "
    "00000010111 00000011000 000011001010 000011001011 000011001100 "
    "000011001101 000001101000 000001101001 000001101010 000001101011 "
    "000011010010 000011010011 000011010100 000011010101 000011010110 "
    "000011010111 000001101100 000001101101 000011011010 000011011011 "
    "000001010100 000001010101 000001010110 000001010111 000001100100 "
    "000001100101 000001010010 000001010011 000000100100 000000110111 "
    "000000111000 000000100111 000000101000 000001011000 000001011001 "
    "000000101011 000000101100 000001011010 000001100110 000001100111")
_BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 "
    "000000110100 000000110101 0000001101100 0000001101101 0000001001010 "
    "0000001001011 0000001001100 0000001001101 0000001110010 "
    "0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 "
    "0000001010101 0000001011010 0000001011011 0000001100100 "
    "0000001100101")
_EXT_MAKEUP = (  # 1792-2560, both colours
    "00000001000 00000001100 00000001101 000000010010 000000010011 "
    "000000010100 000000010101 000000010110 000000010111 000000011100 "
    "000000011101 000000011110 000000011111")
EOL = "000000000001"
# T.4 Table 4: 2-D mode codes -> (mode, vertical offset)
_MODES = {"0001": ("pass", 0), "001": ("horizontal", 0), "1": ("v", 0),
          "011": ("v", 1), "000011": ("v", 2), "0000011": ("v", 3),
          "010": ("v", -1), "000010": ("v", -2), "0000010": ("v", -3),
          "0000001": ("extension", 0)}

PEEK = 13  # the longest run code


def _codes(white):
    term = (_WHITE_TERM if white else _BLACK_TERM).split()
    makeup = (_WHITE_MAKEUP if white else _BLACK_MAKEUP).split()
    out = [(c, n) for n, c in enumerate(term)]
    out += [(c, 64 * (k + 1)) for k, c in enumerate(makeup)]
    out += [(c, 1792 + 64 * k) for k, c in enumerate(_EXT_MAKEUP.split())]
    out.append((EOL, -1))
    return out


def _table(codes, width):
    """(code length, value) for every `width`-bit peek; (0, None) where no
    code matches."""
    lens = [0] * (1 << width)
    vals = [None] * (1 << width)
    for code, value in codes:
        n = len(code)
        base = int(code, 2) << (width - n)
        for k in range(1 << (width - n)):
            lens[base + k] = n
            vals[base + k] = value
    return lens, vals


_RUNS = {True: _table(_codes(True), PEEK), False: _table(_codes(False), PEEK)}
_MODE_TABLE = _table(list(_MODES.items()), 7)


class _Bits:
    """MSB-first bits of a stream with a PEEK-bit window at every bit."""

    def __init__(self, data):
        bits = np.unpackbits(np.frombuffer(bytes(data), np.uint8))
        self.n = bits.size
        padded = np.concatenate([bits, np.zeros(PEEK, np.uint8)])
        peek = np.zeros(self.n + 1, np.int64)
        for k in range(PEEK):
            peek |= padded[k:k + self.n + 1].astype(np.int64) << (PEEK - 1 - k)
        self.peek = peek.tolist()
        self.pos = 0


def _run(b, white):
    """One run length (makeup codes plus a terminating code); -1 at an EOL,
    None where no code matches or the stream has ended."""
    lens, vals = _RUNS[white]
    total = 0
    while True:
        if b.pos >= b.n:
            return None
        v = b.peek[b.pos]
        n = lens[v]
        if n == 0:
            return None
        b.pos += n
        run = vals[v]
        if run < 0:
            return -1
        total += run
        if run < 64:
            return total


def _row_1d(b, width):
    """The changing elements of one 1-D coded row; None on an error."""
    changes = []
    a0, white = 0, True
    while a0 < width:
        run = _run(b, white)
        if run is None or run < 0:
            return None
        a0 = min(a0 + run, width)
        changes.append(a0)
        white = not white
    return changes


def _row_2d(b, width, ref):
    """The changing elements of one 2-D coded row against the row above
    (`ref`, its changing elements); None on an error."""
    ref = ref + [width, width]
    changes = []
    a0, white = -1, True
    i = 0  # ref[i] is the first changing element not left of a0
    lens, vals = _MODE_TABLE
    while a0 < width:
        # b1: the first changing element right of a0 of the colour
        # opposite to a0's (even entries of ref start black runs)
        while ref[i] <= a0 or (i % 2 == 1) == white:
            if ref[i] >= width:
                break
            i += 1
        b1 = ref[i]
        b2 = ref[i + 1] if i + 1 < len(ref) else width
        if b.pos >= b.n:
            return None
        v = b.peek[b.pos] >> (PEEK - 7)
        n = lens[v]
        if n == 0:
            return None
        b.pos += n
        mode, off = vals[v]
        if mode == "pass":
            a0 = b2
        elif mode == "horizontal":
            start = max(a0, 0)
            r1 = _run(b, white)
            r2 = _run(b, not white)
            if r1 is None or r2 is None or r1 < 0 or r2 < 0:
                return None
            a1 = min(start + r1, width)
            a2 = min(a1 + r2, width)
            changes += [a1, a2]
            a0 = a2
        elif mode == "v":
            a1 = min(max(b1 + off, 0), width)
            changes.append(a1)
            a0 = a1
            white = not white
        else:
            raise ValueError("CCITT uncompressed mode (libtiff refuses it)")
        while i > 0 and ref[i - 1] > a0:
            i -= 1
    return changes


def _skip_eol(b):
    """Past fill bits and one EOL; False where no EOL comes."""
    while b.pos < b.n:
        v = b.peek[b.pos]
        if v >> (PEEK - 12) == 1:
            b.pos += 12
            return True
        if v >> (PEEK - 1):
            return False
        b.pos += 1
    return False


def _fill(row, changes, width):
    """Set the black runs (odd runs) of a row from its changing
    elements."""
    for k in range(0, len(changes) - 1, 2):
        row[changes[k]:changes[k + 1]] = 1
    if len(changes) % 2:
        row[changes[-1]:width] = 1


def decode(data, width, rows, compression, t4_options=0):
    """(rows, width) uint8 bits of one strip or tile: 1 in black runs."""
    if compression == 3 and t4_options & 2:
        raise ValueError("CCITT uncompressed mode (libtiff refuses it)")
    out = np.zeros((rows, width), np.uint8)
    b = _Bits(data)
    ref = []
    for y in range(rows):
        if compression == 2:
            b.pos = -(-b.pos // 8) * 8 if y else 0
            changes = _row_1d(b, width)
        elif compression == 3:
            if not _skip_eol(b):
                break
            two_d = bool(t4_options & 1) and not b.peek[b.pos] >> (PEEK - 1)
            if t4_options & 1:
                b.pos += 1
            changes = _row_2d(b, width, ref) if two_d else _row_1d(b, width)
        else:
            changes = _row_2d(b, width, ref)
        if changes is None:
            break
        _fill(out[y], changes, width)
        ref = [c for c in changes if c < width]
    return out

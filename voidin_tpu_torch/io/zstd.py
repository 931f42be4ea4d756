"""Zstandard decompression (RFC 8878) with the standard library alone.

``decompress(data)`` gives the concatenated content of the Zstandard
frames in `data` (skippable frames skipped). It reads what libtiff's ZSTD
codec (TIFF compression 50000, one frame a strip or tile) and any other
dictionary-less encoder writes:

- the frame header (window, frame content size, single segment) and raw,
  RLE and compressed blocks;
- literals raw, RLE or Huffman-coded in 1 or 4 streams, with a tree given
  directly or by FSE-coded weights, and treeless blocks that repeat the
  last tree;
- sequences with the literal-length, match-length and offset codes in
  predefined, RLE, FSE-compressed or repeat mode, and the three repeat
  offsets;
- the optional content checksum (XXH64), skipped, never read as data.

Frames that need a dictionary raise ValueError naming it.
"""

from __future__ import annotations

MAGIC = 0xFD2FB528

# (baseline, extra bits) of literal-length codes 0-35 and match-length
# codes 0-52 (RFC 8878 3.1.1.3.2.1.1)
LL_CODES = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3),
    (48, 4), (64, 6), (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11),
    (4096, 12), (8192, 13), (16384, 14), (32768, 15), (65536, 16)]
ML_CODES = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3),
    (67, 4), (83, 4), (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10),
    (2051, 11), (4099, 12), (8195, 13), (16387, 14), (32771, 15),
    (65539, 16)]
# predefined distributions (RFC 8878 3.1.1.3.2.2)
LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2,
               2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1], 6)
OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, -1, -1, -1, -1, -1], 5)


class ZstdError(ValueError):
    pass


class BackBits:
    """A backward bit stream (the last byte's highest set bit ends it):
    reads n bits at a time from the end toward the start; bits before the
    start read as 0 (`overflow` then tells)."""

    def __init__(self, data, start, end):
        if end <= start or data[end - 1] == 0:
            raise ZstdError("zstd: bit stream without its end mark")
        self.value = int.from_bytes(data[start:end], "little")
        self.pos = (end - start) * 8 - 8 + data[end - 1].bit_length() - 1

    def read(self, n):
        if n == 0:
            return 0
        p = self.pos - n
        self.pos = p
        if p >= 0:
            return (self.value >> p) & ((1 << n) - 1)
        return (self.value << -p) & ((1 << n) - 1)

    @property
    def overflow(self):
        return self.pos < 0


def read_ncount(data, at, max_symbol, max_log):
    """An FSE table description (FSE_readNCount): (normalized counts,
    accuracy log, bytes used)."""
    bits = int.from_bytes(data[at:at + 512], "little")
    pos = 4
    log = (bits & 0xF) + 5
    if log > max_log:
        raise ZstdError(f"zstd: FSE accuracy log {log} above {max_log}")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nb = log + 1
    counts = []
    while remaining > 1 and len(counts) <= max_symbol:
        v = bits >> pos
        low = v & (threshold - 1)
        top = (2 * threshold - 1) - remaining
        if low < top:
            count = low
            pos += nb - 1
        else:
            count = v & (2 * threshold - 1)
            if count >= threshold:
                count -= top
            pos += nb
        count -= 1
        remaining -= -count if count < 0 else count
        counts.append(count)
        if count == 0:
            while True:
                rep = (bits >> pos) & 3
                pos += 2
                counts.extend([0] * rep)
                if rep != 3:
                    break
        while remaining < threshold:
            nb -= 1
            threshold >>= 1
    if remaining != 1 or len(counts) > max_symbol + 1:
        raise ZstdError("zstd: corrupt FSE table description")
    return counts, log, (pos + 7) // 8


def fse_table(counts, log):
    """FSE_buildDTable: per state (symbol, bits to read, base of the next
    state)."""
    size = 1 << log
    sym = [0] * size
    high = size - 1
    nxt = []
    for s, c in enumerate(counts):
        if c == -1:
            sym[high] = s
            high -= 1
            nxt.append(1)
        else:
            nxt.append(c)
    step = (size >> 1) + (size >> 3) + 3
    pos = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            sym[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    if pos != 0:
        raise ZstdError("zstd: FSE counts do not fill the table")
    bits, base = [0] * size, [0] * size
    for u in range(size):
        x = nxt[sym[u]]
        nxt[sym[u]] += 1
        nb = log - (x.bit_length() - 1)
        bits[u] = nb
        base[u] = (x << nb) - size
    return sym, bits, base, log


def rle_table(symbol):
    return [symbol], [0], [0], 0


def huffman_weights_fse(data, at, size):
    """Huffman weights coded with FSE (two interleaved states)."""
    counts, log, used = read_ncount(data, at, 255, 6)
    sym, bits, base, _ = fse_table(counts, log)
    bs = BackBits(data, at + used, at + size)
    s1, s2 = bs.read(log), bs.read(log)
    out = []
    while True:
        if len(out) > 255:
            raise ZstdError("zstd: too many Huffman weights")
        out.append(sym[s1])
        s1 = base[s1] + bs.read(bits[s1])
        if bs.overflow:
            out.append(sym[s2])
            break
        out.append(sym[s2])
        s2 = base[s2] + bs.read(bits[s2])
        if bs.overflow:
            out.append(sym[s1])
            break
    return out


def huffman_table(data, at):
    """A Huffman tree description: ((symbol, bits) per max-bits code,
    max bits), bytes used."""
    head = data[at]
    if head < 128:
        weights = huffman_weights_fse(data, at + 1, head)
        used = 1 + head
    else:
        n = head - 127
        raw = data[at + 1:at + 1 + (n + 1) // 2]
        weights = [raw[i // 2] >> 4 if i % 2 == 0 else raw[i // 2] & 15
                   for i in range(n)]
        used = 1 + (n + 1) // 2
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise ZstdError("zstd: Huffman weights all zero")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1):
        raise ZstdError("zstd: Huffman weights do not complete a tree")
    weights = weights + [rest.bit_length()]
    if max_bits > 11:
        raise ZstdError(f"zstd: Huffman code of {max_bits} bits")
    table_sym = [0] * (1 << max_bits)
    table_bits = [0] * (1 << max_bits)
    pos = 0
    for w in range(1, max_bits + 1):
        span = 1 << (w - 1)
        nb = max_bits + 1 - w
        for s, sw in enumerate(weights):
            if sw == w:
                table_sym[pos:pos + span] = [s] * span
                table_bits[pos:pos + span] = [nb] * span
                pos += span
    return (table_sym, table_bits, max_bits), used


def huffman_stream(data, start, end, table, count):
    """`count` symbols of one backward Huffman stream, peeking max-bits
    codes in windows of the stream so that no shift touches all of it."""
    sym, nbits, max_bits = table
    last = data[end - 1]
    if last == 0:
        raise ZstdError("zstd: bit stream without its end mark")
    pos = (end - start) * 8 - 8 + last.bit_length() - 1
    mask = (1 << max_bits) - 1
    out = bytearray(count)
    i = 0
    while i < count:
        # a window of bytes covering bits [lo_bit, pos)
        lo_byte = max(0, (pos - 4096) // 8)
        window = int.from_bytes(data[start + lo_byte:start + (pos + 7) // 8
                                     + 1], "little")
        base = lo_byte * 8
        floor = base + max_bits if lo_byte > 0 else -max_bits
        while i < count and pos >= floor:
            p = pos - base - max_bits
            peek = (window >> p if p >= 0 else window << -p) & mask
            out[i] = sym[peek]
            pos -= nbits[peek]
            i += 1
        if lo_byte == 0 and i < count:
            raise ZstdError("zstd: Huffman stream too short")
    if pos != 0:
        raise ZstdError("zstd: Huffman stream not consumed exactly")
    return bytes(out)


class _Frame:
    """The state a frame carries from block to block."""

    def __init__(self):
        self.huffman = None
        self.tables = [None, None, None]  # LL, OF, ML
        self.reps = [1, 4, 8]


def _literals(data, at, fr):
    """The literals section: (literals, bytes used)."""
    b0 = data[at]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):
        if fmt in (0, 2):
            size, head = b0 >> 3, 1
        elif fmt == 1:
            size, head = (b0 >> 4) + (data[at + 1] << 4), 2
        else:
            size = (b0 >> 4) + (data[at + 1] << 4) + (data[at + 2] << 12)
            head = 3
        if kind == 0:
            return bytes(data[at + head:at + head + size]), head + size
        return bytes((data[at + head],)) * size, head + 1
    head, nbits = {0: (3, 10), 1: (3, 10), 2: (4, 14), 3: (5, 18)}[fmt]
    h = int.from_bytes(data[at:at + head], "little")
    regen = (h >> 4) & ((1 << nbits) - 1)
    comp = (h >> (4 + nbits)) & ((1 << nbits) - 1)
    p = at + head
    end = p + comp
    if kind == 2:
        fr.huffman, used = huffman_table(data, p)
        p += used
    elif fr.huffman is None:
        raise ZstdError("zstd: treeless literals before any tree")
    if fmt == 0:
        return huffman_stream(data, p, end, fr.huffman,
                                    regen), end - at
    sizes = [int.from_bytes(data[p + 2 * k:p + 2 * k + 2], "little")
             for k in range(3)]
    p += 6
    sizes.append(end - p - sum(sizes))
    seg = (regen + 3) // 4
    parts = []
    for k in range(4):
        n = seg if k < 3 else regen - 3 * seg
        parts.append(huffman_stream(data, p, p + sizes[k], fr.huffman,
                                          n))
        p += sizes[k]
    return b"".join(parts), end - at


def _sequences(data, at, end, fr):
    """The sequences section: [(literal length, offset value, match
    length)]."""
    b0 = data[at]
    p = at + 1
    if b0 == 0:
        return []
    if b0 < 128:
        n = b0
    elif b0 < 255:
        n = ((b0 - 128) << 8) + data[p]
        p += 1
    else:
        n = data[p] + (data[p + 1] << 8) + 0x7F00
        p += 2
    modes = data[p]
    p += 1
    specs = ((6, LL_DEFAULT, 35, 9), (4, OF_DEFAULT, 31, 8),
             (2, ML_DEFAULT, 52, 9))
    for k, (shift, default, max_sym, max_log) in enumerate(specs):
        mode = (modes >> shift) & 3
        if mode == 0:
            fr.tables[k] = fse_table(*default)
        elif mode == 1:
            fr.tables[k] = rle_table(data[p])
            p += 1
        elif mode == 2:
            counts, log, used = read_ncount(data, p, max_sym, max_log)
            fr.tables[k] = fse_table(counts, log)
            p += used
        elif fr.tables[k] is None:
            raise ZstdError("zstd: repeat mode before any table")
    (lsym, lbits, lbase, llog), (osym, obits, obase, olog), \
        (msym, mbits, mbase, mlog) = fr.tables
    bs = BackBits(data, p, end)
    read = bs.read
    ls, os_, ms = read(llog), read(olog), read(mlog)
    out = []
    for i in range(n):
        oc, mc, lc = osym[os_], msym[ms], lsym[ls]
        if oc > 31:
            raise ZstdError(f"zstd: offset code {oc}")
        off = (1 << oc) + read(oc)
        mb, mx = ML_CODES[mc]
        ml = mb + read(mx)
        lb, lx = LL_CODES[lc]
        ll = lb + read(lx)
        out.append((ll, off, ml))
        if i + 1 < n:
            ls = lbase[ls] + read(lbits[ls])
            ms = mbase[ms] + read(mbits[ms])
            os_ = obase[os_] + read(obits[os_])
    if bs.pos != 0:
        raise ZstdError("zstd: sequence stream not consumed exactly")
    return out


def _execute(out, literals, seqs, reps):
    """Appends a block's literals and matches to `out`."""
    lit = 0
    for ll, off, ml in seqs:
        if off > 3:
            offset = off - 3
            reps[:] = [offset, reps[0], reps[1]]
        else:
            idx = off - 1 + (ll == 0)
            if idx == 0:
                offset = reps[0]
            elif idx == 3:
                offset = reps[0] - 1
                reps[:] = [offset, reps[0], reps[1]]
            else:
                offset = reps[idx]
                if idx == 1:
                    reps[:] = [offset, reps[0], reps[2]]
                else:
                    reps[:] = [offset, reps[0], reps[1]]
        out += literals[lit:lit + ll]
        lit += ll
        if offset <= 0 or offset > len(out):
            raise ZstdError(f"zstd: match offset {offset} beyond the output")
        start = len(out) - offset
        if offset >= ml:
            out += out[start:start + ml]
        else:
            piece = bytes(out[start:])
            out += (piece * (ml // offset + 1))[:ml]
    out += literals[lit:]


def decompress(data) -> bytes:
    """The content of every Zstandard frame in `data`, concatenated."""
    data = bytes(data)
    out = bytearray()
    at = 0
    while at + 4 <= len(data):
        magic = int.from_bytes(data[at:at + 4], "little")
        if magic & 0xFFFFFFF0 == 0x184D2A50:  # skippable frame
            at += 8 + int.from_bytes(data[at + 4:at + 8], "little")
            continue
        if magic != MAGIC:
            if out:
                break  # padding after the last frame
            raise ZstdError("zstd: not a Zstandard frame")
        fhd = data[at + 4]
        at += 5
        single = fhd >> 5 & 1
        if fhd & 8:
            raise ZstdError("zstd: reserved frame header bit set")
        if not single:
            at += 1  # window descriptor
        dict_size = (0, 1, 2, 4)[fhd & 3]
        if dict_size and int.from_bytes(data[at:at + dict_size], "little"):
            raise ZstdError("zstd: frame needs a dictionary")
        at += dict_size
        fcs = fhd >> 6
        at += (1 if single else 0, 2, 4, 8)[fcs]
        fr = _Frame()
        while True:
            if at + 3 > len(data):
                raise ZstdError("zstd: truncated block header")
            bh = int.from_bytes(data[at:at + 3], "little")
            at += 3
            last, kind, size = bh & 1, (bh >> 1) & 3, bh >> 3
            if kind == 0:
                out += data[at:at + size]
                at += size
            elif kind == 1:
                out += data[at:at + 1] * size
                at += 1
            elif kind == 2:
                end = at + size
                if end > len(data):
                    raise ZstdError("zstd: truncated block")
                literals, used = _literals(data, at, fr)
                seqs = _sequences(data, at + used, end, fr)
                _execute(out, literals, seqs, fr.reps)
                at = end
            else:
                raise ZstdError("zstd: reserved block type")
            if last:
                break
        if fhd & 4:
            at += 4  # XXH64 content checksum, not verified
    return bytes(out)

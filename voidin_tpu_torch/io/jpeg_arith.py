"""Arithmetic-coded JPEG scans (T.81 Annex D, F.1.4.4 and G.1.3), decoded
as libjpeg(-turbo)'s jdarith.c decodes them, for io/jpeg.py.

``QMDecoder`` is the adaptive binary decoder of Annex D over one restart
interval's unstuffed bytes (zeros once they run out, as libjpeg feeds
zeros past a marker); ``decode_scan`` walks one scan's blocks through it:
sequential (SOF9) scans and the four progressive (SOF10) scan kinds (DC
first and refinement, AC first and refinement), with the statistics
areas of libjpeg: 64 DC bins and 256 AC bins per conditioning table,
zeroed at each scan and each restart, the DC bins conditioned on the
previous difference's class by the DAC marker's L and U, the AC
magnitude bins split at its Kx, and the fixed 0.5 estimate (state 113)
for the AC signs and the refinement bits that carry no statistics.

Each decision is one Python call (the decoder renormalises byte by byte,
as libjpeg does); io/jpeg.py reconstructs the coefficients it fills as it
does a Huffman file's.
"""

from __future__ import annotations

import numpy as np

# T.81 Table D.2 by state: (Qe, Next_Index_LPS, Next_Index_MPS,
# Switch_MPS); state 113 is libjpeg's fixed estimate of 0.5 (jaricom.c,
# after T.851 Table 5).
QE_TABLE = (
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080B, 18, 4, 0), (0x03D8, 20, 5, 0), (0x01DA, 23, 6, 0),
    (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001A, 33, 10, 0), (0x000D, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1),
    (0x3F25, 36, 16, 0), (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0),
    (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0CEF, 43, 21, 0),
    (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01B1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0),
    (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004E, 63, 34, 0), (0x003B, 32, 35, 0), (0x002C, 33, 9, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0),
    (0x2EF1, 67, 40, 0), (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0),
    (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05CD, 48, 51, 0),
    (0x04DE, 50, 52, 0), (0x040F, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02D4, 52, 55, 0), (0x025C, 53, 56, 0), (0x01F8, 54, 57, 0),
    (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0),
    (0x008F, 61, 32, 0), (0x5B12, 65, 65, 1), (0x4D04, 80, 66, 0),
    (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0), (0x2FE8, 83, 69, 0),
    (0x293C, 84, 70, 0), (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0),
    (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119C, 74, 76, 0), (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0),
    (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0),
    (0x34EE, 91, 85, 0), (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0),
    (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0), (0x56A8, 95, 96, 1),
    (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0),
    (0x3C3D, 104, 100, 0), (0x375E, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0), (0x415E, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504F, 111, 107, 0), (0x5A10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0),
)
FIXED_STATE = 113
DC_BINS, AC_BINS = 64, 256
# The DAC marker's defaults (T.81 F.1.4.4.1.4 and F.1.4.4.2.1): L, U, Kx
DEFAULT_CONDITIONING = (0, 1, 5)

# A state's (Qe, Next_Index_LPS | Switch_MPS << 7, Next_Index_MPS), as
# jaricom.c packs them; a bin holds its state | MPS << 7
_STATES = tuple((qe, nl | sw << 7, nm) for qe, nl, nm, sw in QE_TABLE)


class ArithError(ValueError):
    """Corrupt arithmetic-coded data (io/jpeg.py names the file)."""


class QMDecoder:
    """libjpeg's arith_decode over one restart interval's bytes: `decode(bins,
    i)` decodes one decision with statistics bin bins[i] (a list of ints,
    state | MPS << 7) and updates the bin."""

    __slots__ = ("data", "n", "i", "c", "a", "ct")

    def __init__(self, data: bytes):
        self.data, self.n, self.i = data, len(data), 0
        self.c, self.a, self.ct = 0, 0, -16  # ct -16: read two bytes first

    def decode(self, bins, k):
        a = self.a
        if a < 0x8000:
            # renormalise (D.2.6), a byte in whenever the counter runs out
            c, ct = self.c, self.ct
            while a < 0x8000:
                ct -= 1
                if ct < 0:
                    i = self.i
                    c = c << 8 | (self.data[i] if i < self.n else 0)
                    self.i = i + 1
                    ct += 8
                    if ct < 0:
                        ct += 1
                        if ct == 0:  # the first two bytes are in
                            a = 0x8000
                a <<= 1
            self.c, self.ct = c, ct
        sv = bins[k]
        qe, nl, nm = _STATES[sv & 0x7F]
        a -= qe
        temp = a << self.ct
        if self.c >= temp:
            self.c -= temp
            if a < qe:
                bins[k] = (sv & 0x80) ^ nm
            else:
                bins[k] = (sv & 0x80) ^ nl
                sv ^= 0x80
            a = qe
        elif a < 0x8000:
            if a < qe:
                bins[k] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                bins[k] = (sv & 0x80) ^ nm
        self.a = a
        return sv >> 7


def _magnitude(dec, st, k, m, x1):
    """The rest of a nonzero value once its first magnitude decision at
    st[k] gave m (Figures F.23, F.24): the magnitude category's decisions
    from bin x1 on, then its bits 14 bins later. Returns |v| - 1."""
    if m:
        k = x1
        while dec.decode(st, k):
            m <<= 1
            if m == 0x8000:
                raise ArithError("corrupt arithmetic-coded data (magnitude)")
            k += 1
    v = m
    k += 14
    while m > 1:
        m >>= 1
        if dec.decode(st, k):
            v |= m
    return v


def _dc_diff(dec, st, ctx, lower, upper):
    """One DC difference (Figure F.19) from the bins at context `ctx`:
    (difference, the next block's context by the class of this one)."""
    if not dec.decode(st, ctx):
        return 0, 0
    sign = dec.decode(st, ctx + 1)
    k = ctx + 2 + sign
    v = _magnitude(dec, st, k, dec.decode(st, k), 20)
    m = 1 << v.bit_length() >> 1  # the magnitude category's top bit
    v += 1
    if m < (1 << lower) >> 1:
        ctx = 0
    elif m > (1 << upper) >> 1:
        ctx = 12 + 4 * sign
    else:
        ctx = 4 + 4 * sign
    return (-v if sign else v), ctx


def _ac_first(dec, st, fixed, ss, se, kx, b_out, out):
    """One block's band ss..se (Figure F.20): its index `b_out`, the
    zig-zag index and the value of each nonzero coefficient appended to
    the three lists of `out`."""
    k = ss
    while k <= se:
        b = 3 * (k - 1)
        if dec.decode(st, b):  # end of block
            return
        while not dec.decode(st, b + 1):
            b += 3
            k += 1
            if k > se:
                raise ArithError("corrupt arithmetic-coded data (spectral "
                                 "overflow)")
        sign = dec.decode(fixed, 0)
        b += 2
        m = dec.decode(st, b)
        if m and dec.decode(st, b):
            v = _magnitude(dec, st, b, 2, 189 if k <= kx else 217) + 1
        else:
            v = m + 1
        out[0].append(b_out)
        out[1].append(k)
        out[2].append(-v if sign else v)
        k += 1


def _ac_refine(dec, st, fixed, ss, se, block, p1):
    """One block's refinement of band ss..se (Figure G.10 as jdarith.c
    decodes it): `block` (64 zig-zag ints) updated in place."""
    kex = se
    while kex > 0 and not block[kex]:
        kex -= 1
    k = ss - 1
    while k < se:
        b = 3 * k
        if k >= kex and dec.decode(st, b):  # end of block
            return
        while True:
            v = block[k + 1]
            if v:  # nonzero before: one correction bit
                if dec.decode(st, b + 2):
                    block[k + 1] = v - p1 if v < 0 else v + p1
                break
            if dec.decode(st, b + 1):  # newly nonzero
                block[k + 1] = -p1 if dec.decode(fixed, 0) else p1
                break
            b += 3
            k += 1
            if k >= se:
                raise ArithError("corrupt arithmetic-coded data (spectral "
                                 "overflow)")
        k += 1


def decode_scan(coefs, comp_of, rows, cols, per_mcu, spectral, progressive,
                tables, conditioning, segments, interval_mcus):
    """Decode one arithmetic-coded scan into `coefs` (per scan component,
    its (block rows, block cols, 64) zig-zag coefficients, updated in
    place).

    comp_of, rows, cols: each block's scan component and place, in stream
    order (io/jpeg.py _scan_blocks), per_mcu blocks an MCU; spectral: (Ss,
    Se, Ah, Al), validated by the caller, (0, 63, 0, 0) for a sequential
    scan; tables: per scan component its (DC, AC) conditioning table ids;
    conditioning: {table id: (L, U, Kx)}; segments: each restart
    interval's unstuffed bytes; interval_mcus: the restart interval in
    MCUs (0: none)."""
    ss, se, ah, al = spectral
    n_comps = len(coefs)
    dc_first = ss == 0 and ah == 0
    with_ac = se > 0 if not progressive else ss > 0
    n_blocks = len(comp_of)
    step = interval_mcus * per_mcu or n_blocks
    comp_list = comp_of.tolist()
    fixed = [FIXED_STATE]
    dc_out = np.zeros(n_blocks, np.int64)
    ac = ([], [], [])  # block, zig-zag index, value
    refine = progressive and ah and ss > 0
    if refine:
        c0 = coefs[0]
        blocks = c0[rows, cols].tolist()
    bits = np.zeros(n_blocks, np.int64) if progressive and ah and ss == 0 \
        else None
    p1 = 1 << al
    conds = [(conditioning.get(t[0], DEFAULT_CONDITIONING),
              conditioning.get(t[1], DEFAULT_CONDITIONING)) for t in tables]
    for start in range(0, n_blocks, step):
        seg = start // step
        if seg >= len(segments):
            raise ArithError("restart marker missing")
        dec = QMDecoder(segments[seg])
        # every statistics area the scan uses starts at zero (state 0,
        # MPS 0), the DC predictions and contexts too
        dc_stats = {t[0]: [0] * DC_BINS for t in tables}
        ac_stats = {t[1]: [0] * AC_BINS for t in tables}
        last = [0] * n_comps
        ctx = [0] * n_comps
        for b in range(start, min(start + step, n_blocks)):
            si = comp_list[b]
            tdc, tac = tables[si]
            if bits is not None:  # DC refinement: one fixed-estimate bit
                bits[b] = dec.decode(fixed, 0)
                continue
            if dc_first:
                lower, upper, _ = conds[si][0]
                diff, ctx[si] = _dc_diff(dec, dc_stats[tdc], ctx[si], lower,
                                         upper)
                last[si] = (last[si] + diff) & 0xFFFF
                dc_out[b] = last[si]
            if refine:
                _ac_refine(dec, ac_stats[tac], fixed, ss, se, blocks[b], p1)
            elif with_ac:
                _ac_first(dec, ac_stats[tac], fixed, max(ss, 1), se,
                          conds[si][1][2], b, ac)
    blk_idx = np.arange(n_blocks)

    def scatter(sel, k, vals, op):
        for si, coef in enumerate(coefs):
            m = comp_of[sel] == si
            b = sel[m]
            kk = k[m] if np.ndim(k) else k
            if op == "or":
                coef[rows[b], cols[b], kk] |= vals[m]
            else:
                coef[rows[b], cols[b], kk] = vals[m]

    if bits is not None:
        scatter(blk_idx, 0, bits << al, "or")
    elif refine:
        c0[rows, cols] = np.asarray(blocks, np.int64).reshape(-1, 64)
    else:
        if dc_first:
            # libjpeg keeps the prediction modulo 2^16 and stores it shifted
            # by Al into a 16-bit coefficient
            dc = ((dc_out ^ 0x8000) - 0x8000) << al
            scatter(blk_idx, 0, ((dc + 0x8000) & 0xFFFF) - 0x8000, "set")
        if ac[0]:
            blk, k, val = (np.asarray(a, np.int64) for a in ac)
            scatter(blk, k, val << al, "set")

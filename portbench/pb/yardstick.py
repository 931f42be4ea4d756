"""The yardstick's peaks and work counts: frozen copies of chip_smoke.py's
bound_ms, k1_bound, ltc_rect_bound and shadow_bound (with the packing
kernel's count of chip_smoke.shadow_pack_check), kept here so that a
change to the program cannot move them.

A kernel's least time is the larger of its bytes over the H100's
published HBM rate and its FP32 operations over its published FP32
rate outside the tensor cores (NVIDIA data sheet, SXM part, 700 W). The
counts come from the work that the frame's inputs to the kernel need
(records, pixels, rays and tables), not from how a kernel does it.
"""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound_ms(n_bytes, n_ops):
    """Least time in ms: max(bytes / HBM rate, FP32 ops / FP32 peak)."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S) * 1e3


def k1_bound(pairs, nt, n_out, tile_bytes=8, px_bytes=0):
    """K1 reads each of the frame's `pairs` valid (triangle, tile) records
    once (64 B) and each of its `nt` tiles' start and count (8 B), and
    writes n_out f32 per pixel of its 128-pixel tiles (plus px_bytes for
    a payload); each record-pixel test evaluates three edge planes (12
    FP32 ops)."""
    return bound_ms(pairs * 64 + nt * tile_bytes
                    + nt * 128 * (4 * n_out + px_bytes), pairs * 128 * 12)


def ltc_rect_bound(n_px, n_lights):
    """The fused LTC rect kernel reads each pixel's normal, view vector,
    position (12 B each) and roughness (4 B) and the two (64, 64, 4)
    tables once, and writes diff and spec (4 B each) per pixel and light.
    FP32 operations counted from its source: 192 per pixel, and per light
    32 plus two evaluations of 251 plus 1 (at the cheaper branch, so the
    bound stays a lower bound)."""
    return bound_ms(n_px * (40 + 8 * n_lights) + 2 * 64 * 64 * 4 * 4,
                    n_px * (192 + n_lights * (32 + 2 * 251 + 1)))


def shadow_bound(n_lanes, n_rays, table_words, inst_words, tri_words,
                 n_ops=None):
    """The shadow walk reads each lane's active byte and writes its hit
    byte, reads each active ray (24 B) and the node, instance and
    triangle tables once. Its FP32 operations are 12 a node visit, 30 an
    instance entry, 40 a triangle test; without a walk to count them,
    `n_ops` defaults to the one root test every active ray makes, so the
    bound stays a lower bound."""
    n_bytes = n_lanes * 2 + n_rays * 24 + 4 * (table_words + inst_words
                                                + tri_words)
    return bound_ms(n_bytes, 12 * n_rays if n_ops is None else n_ops)


def shadow_pack_bound(in_words, out_words, n_tri_rows):
    """The packing kernel moves each input and output word once (4 B) and
    does 6 FP32 operations a triangle row."""
    return bound_ms(4 * (in_words + out_words), 6 * n_tri_rows)

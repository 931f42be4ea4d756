"""PIL's LAB -> RGB conversion, word for word, with numpy.

PIL converts a LAB image to RGB(A) through LittleCMS (``ImageCms``): a
transform from ``cmsCreateLab2Profile(NULL)`` (D50 Lab) to
``cmsCreate_sRGBProfile()``, 8-bit Lab in, 8-bit RGB out, perceptual
intent. LittleCMS optimizes that transform into a 33x33x33 table of
16-bit RGB sampled from its floating-point pipeline, and evaluates every
pixel by tetrahedral interpolation in fixed point. ``lab_to_rgb`` builds
the same table the same way and interpolates it the same way:

- the nodes: 16-bit inputs ``_cmsQuantizeVal``, as float32 in [0, 1];
  V4 Lab (L * 100, a, b * 255 - 128); ``cmsLab2XYZ`` at D50 in double,
  over 1 + 32767/32768 and to float32; sRGB's colorants (Rec. 709
  primaries at D65, Bradford-adapted to D50, as cmsCreateRGBProfile builds
  them) inverted and scaled back, in double, to float32; sRGB's
  parametric curve inverted (type -4) in double, to float32; then to 16
  bits by ``_cmsQuickSaturateWord``;
- a pixel: its 8-bit samples times 257, ``TetrahedralInterp16`` (the six
  tetrahedra chosen by LittleCMS's comparisons, ties included, its
  rounding of the fractional sum), and 16 -> 8 bits as ``FROM_16_TO_8``.

Checked against PIL 12.1 with LittleCMS 2.17 on all 16,777,216 inputs
(tests/test_torch_tiff_f8.py holds it on a sample and on the fixtures).
The samples are PIL's LAB image's: L, then a and b offset by 128 (PIL's
TIFF reader takes a TIFF's signed a* and b* that way).
"""

from __future__ import annotations

import numpy as np

GRID = 33  # LittleCMS's grid for a 3-channel input
MAX_XYZ = 1.0 + 32767.0 / 32768.0  # PCS XYZ in 1.15 fixed point
D50 = (0.9642, 1.0, 0.8249)
BRADFORD = ((0.8951, 0.2664, -0.1614), (-0.7502, 1.7135, 0.0367),
            (0.0389, -0.0685, 1.0296))
_clut = None


def _inverse(a):
    """_cmsMAT3inverse, in its order of operations."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return [[c0 / det, (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det,
             (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det],
            [c1 / det, (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det,
             (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det],
            [c2 / det, (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det,
             (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det]]


def _mul(a, b):
    return [[a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j]
             for j in range(3)] for i in range(3)]


def _eval(a, v):
    return [a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2]
            for i in range(3)]


def _xyz(x, y):
    return [(x / y) * 1.0, 1.0, ((1 - x - y) / y) * 1.0]


def _adaptation(src, dst):
    """_cmsAdaptationMatrix with the Bradford cone matrix."""
    cs, cd = _eval(BRADFORD, src), _eval(BRADFORD, dst)
    cone = [[cd[0] / cs[0], 0.0, 0.0], [0.0, cd[1] / cs[1], 0.0],
            [0.0, 0.0, cd[2] / cs[2]]]
    return _mul(_inverse(BRADFORD), _mul(cone, BRADFORD))


def srgb_colorants():
    """cmsCreate_sRGBProfile's RGB -> XYZ (D50) matrix
    (_cmsBuildRGB2XYZtransferMatrix)."""
    xn, yn = 0.3127, 0.3290
    (xr, yr), (xg, yg), (xb, yb) = (0.64, 0.33), (0.30, 0.60), (0.15, 0.06)
    prim = [[xr, xg, xb], [yr, yg, yb],
            [(1 - xr - yr), (1 - xg - yg), (1 - xb - yb)]]
    coef = _eval(_inverse(prim), [xn / yn, 1.0, (1.0 - xn - yn) / yn])
    m = [[coef[0] * xr, coef[1] * xg, coef[2] * xb],
         [coef[0] * yr, coef[1] * yg, coef[2] * yb],
         [coef[0] * (1.0 - xr - yr), coef[1] * (1.0 - xg - yg),
          coef[2] * (1.0 - xb - yb)]]
    return _mul(_adaptation(_xyz(xn, yn), list(D50)), m)


def _f_1(t):
    """cmsLab2XYZ's inverse of the Lab companding."""
    return np.where(t <= 24.0 / 116.0, (108.0 / 841.0) * (t - 16.0 / 116.0),
                    t * t * t)


def _inverse_trc(r):
    """sRGB's parametric curve (type 4) inverted (type -4), in double."""
    g, a, b, c, d = 2.4, 1.0 / 1.055, 0.055 / 1.055, 1.0 / 12.92, 0.04045
    disc = (a * d + b) ** g
    r = r.astype(np.float64)
    hi = (np.power(np.maximum(r, 0.0), 1.0 / g) - b) / a
    return np.where(r >= disc, hi, r / c)


def _saturate_word(d):
    """_cmsQuickSaturateWord: + 0.5, then the floor of the value rounded
    to 2^-16 (_cmsQuickFloorWord's magic-number floor), clamped."""
    d = d + 0.5
    q = np.floor(np.round((d - 32767.0) * 65536.0) / 65536.0) + 32767.0
    return np.where(d <= 0, 0, np.where(d >= 65535.0, 65535, q)).astype(
        np.int64)


def clut():
    """The (GRID, GRID, GRID, 3) 16-bit table LittleCMS samples, indexed
    by the L, a, b grid nodes."""
    global _clut
    if _clut is not None:
        return _clut
    f32 = np.float32
    q = _saturate_word(np.arange(GRID) * 65535.0 / (GRID - 1))
    node = (q / 65535.0).astype(f32).astype(np.float64)
    lum, a, b = np.meshgrid(node, node, node, indexing="ij")
    y = (lum * 100.0 + 16.0) / 116.0
    x = y + 0.002 * (a * 255.0 - 128.0)
    z = y - 0.005 * (b * 255.0 - 128.0)
    xyz = [(_f_1(t) * w / MAX_XYZ).astype(f32).astype(np.float64)
           for t, w in zip((x, y, z), D50)]
    inv = [[v * MAX_XYZ for v in row] for row in _inverse(srgb_colorants())]
    out = []
    for row in inv:
        lin = ((xyz[0] * row[0] + xyz[1] * row[1]) + xyz[2] * row[2]).astype(
            f32)
        rgb = _inverse_trc(lin).astype(f32).astype(np.float64)
        out.append(_saturate_word(rgb * 65535.0))
    _clut = np.stack(out, -1)
    return _clut


# TetrahedralInterp16's six tetrahedra: (which, path of vertices, axis of
# each step), chosen by its comparisons of the fractions rx, ry, rz
_TETRA = (((1, 0, 0), (1, 1, 0), (1, 1, 1)), (0, 1, 2)), \
    (((0, 0, 1), (1, 0, 1), (1, 1, 1)), (2, 0, 1)), \
    (((1, 0, 0), (1, 0, 1), (1, 1, 1)), (0, 2, 1)), \
    (((0, 1, 0), (1, 1, 0), (1, 1, 1)), (1, 0, 2)), \
    (((0, 1, 0), (0, 1, 1), (1, 1, 1)), (1, 2, 0)), \
    (((0, 0, 1), (0, 1, 1), (1, 1, 1)), (2, 1, 0))


def lab_to_rgb(lab):
    """(..., 3) uint8 samples of PIL's LAB image (L, a + 128, b + 128) as
    (..., 3) uint8 RGB, as PIL's convert("RGB") gives them."""
    table = clut()
    v = lab.reshape(-1, 3).astype(np.int64) * 257
    a = v * (GRID - 1)
    fixed = a + (a + 0x7FFF) // 0xFFFF  # _cmsToFixedDomain
    base, r = fixed >> 16, fixed & 0xFFFF
    step = (v != 0xFFFF).astype(np.int64)
    rx, ry, rz = r[:, 0], r[:, 1], r[:, 2]
    case = np.where(
        rx >= ry,
        np.where(ry >= rz, 0, np.where(rz >= rx, 1, 2)),
        np.where(rx >= rz, 3, np.where(ry >= rz, 4, 5)))

    def node(d):
        i = base + np.asarray(d) * step
        return table[i[:, 0], i[:, 1], i[:, 2]]

    c0 = node((0, 0, 0))
    out = np.zeros_like(c0)
    for k, (path, axes) in enumerate(_TETRA):
        m = case == k
        if not m.any():
            continue
        prev, rest = c0[m], np.zeros_like(c0[m])
        for d, ax in zip(path, axes):
            cur = node(d)[m]
            rest = rest + (cur - prev) * r[m, ax][:, None]
            prev = cur
        rest = (rest + 0x8001 + (1 << 31)) % (1 << 32) - (1 << 31)  # int32
        out[m] = c0[m] + ((rest + (rest >> 16)) >> 16)
    out &= 0xFFFF
    return (((out * 65281 + 8388608) >> 24) & 0xFF).astype(
        np.uint8).reshape(lab.shape)

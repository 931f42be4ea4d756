"""Port parity: the image files the JAX package reads through PIL
(``Image.open(path).convert("RGBA")``) and the port decodes itself
(voidin_tpu_torch/io/image.py, io/jpeg.py), held to PIL's pixels.

- PNG, word for word: every colour type at every bit depth the format
  allows, non-interlaced and Adam7, at sizes down to 1x1 (Adam7 passes
  with no columns or rows), with tRNS keys; 16-bit grey clamps at 255 and
  keys compare by their low byte, as in PIL.
- Progressive JPEG, within one level (the baseline bound of
  tests/test_torch_recorder.py): qualities 50 / 75 / 92 / 100 x
  subsampling 0 / 1 / 2, greyscale, optimize=True, restart markers by
  blocks and by rows, and sizes 1x1, 9x5 and 33x65; each prints how many
  values differ.
- JPEG layouts PIL reads but cannot write, made by
  tests/torch_image_writers.py: sampling factors 1-4 (true 4:1:1, 4:4:0,
  mixed, one scan a component), Adobe RGB, CMYK and YCCK; CMYK as PIL
  writes it too.
- Lossless JPEG (SOF3), word for word, each predictor: greyscale at point
  transforms 0 and 2 (PIL and the port give the source samples at 0),
  RGB at 4:4:4 and 4:2:0 with restarts, one scan a component at mixed
  factors, CMYK.
- Arithmetic-coded JPEG (SOF9 and SOF10), with and without a DAC marker
  and restarts: PIL decodes each word for word as the Huffman file of the
  same coefficients (so the writer is right), and the port's decode
  equals its decode of that Huffman file and PIL's within one level.
- Block smoothing: progressive files whose scans leave coefficients 1-9
  unrefined (PIL's file cut after each of its scans, DC-only files, bands
  never refined, arithmetic-coded, components two blocks wide and
  components short of their last iMCU row), within one level of PIL.
- Refusal parity: what PIL refuses (12-bit samples, hierarchical SOF5-7
  and SOF13-15, arithmetic lossless SOF11, 12-bit lossless, a lossless
  file in YCbCr or YCCK or with restarts inside an MCU row, a height set
  by DNL, 2 components, interleaved MCUs of more than 10 blocks) the port
  refuses with an error naming the file; PIL's own WebP, GIF, BMP and
  TIFF files, once refused by name, decode to PIL's pixels (those
  formats in depth: tests/test_torch_image_more.py).
- The committed fixtures of tools/torch_image_fixtures.py: PIL still gives
  the stored pixels, and the port decodes each to them.
"""

import glob
import io
import os
import struct

import numpy as np
import pytest
from PIL import Image

from voidin_tpu_torch.io import jpeg
from voidin_tpu_torch.io.image import decode_image, decode_png, load_image

import chip_smoke
from tests.test_torch_recorder import sample_image
from tests.torch_image_writers import (arith_jpeg_bytes, jpeg_bytes,
                                       lossless_jpeg_bytes, png_bytes,
                                       progressive_jpeg_bytes, set_height,
                                       set_precision, set_sof,
                                       simple_progression)

FIXTURES = os.path.join(os.path.dirname(__file__), "data", "torch_images")
PIXELS = ".rgba.png"


def pil_rgba(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def pil_jpeg(img, mode=None, **kw):
    im = Image.fromarray(img)
    if mode:
        im = im.convert(mode)
    b = io.BytesIO()
    im.save(b, format="JPEG", **kw)
    return b.getvalue()


def assert_jpeg_like_pil(data, label):
    want = pil_rgba(data).astype(np.int64)
    got = decode_image(data, label).astype(np.int64)
    assert got.shape == want.shape, (got.shape, want.shape)
    print(f"{label}: {(got != want).sum()} values differ, max "
          f"{np.abs(got - want).max()}")
    assert np.abs(got - want).max() <= 1


# ------------------------------------------------------------------- PNG

PNG_LAYOUTS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
               (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8),
               (6, 16)]
PNG_SIZES = [(1, 1), (3, 5), (9, 13), (17, 8), (1, 20), (20, 1), (33, 17)]
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_cases(ctype, depth, h, w, rng):
    """(keyword sets of png_bytes) for one layout: plain, and with the
    tRNS chunks the colour type takes (a key present in the image, one
    that differs only above its low byte, a palette's alphas)."""
    top = 1 << depth
    s = rng.integers(0, top, (h, w, CHANNELS[ctype]))
    if (ctype, depth) == (0, 16):
        s[s > 4000] //= 150  # values on both sides of PIL's clamp at 255
    cases = [dict()]
    if ctype == 3:
        n = min(top, 256)
        cases = [dict(plte=rng.integers(0, 256, (n, 3))),
                 dict(plte=rng.integers(0, 256, (n, 3)),
                      trns=bytes(rng.integers(0, 256, n // 2 + 1)
                                 .astype(np.uint8)))]
    elif ctype == 0:
        v = int(s.reshape(-1)[0])
        scaled = v * (255 // (top - 1)) if depth < 8 else v
        cases += [dict(trns=struct.pack(">H", v)),
                  dict(trns=struct.pack(">H", scaled)),
                  dict(trns=struct.pack(">H", 255)),
                  dict(trns=struct.pack(">H", (scaled + 256) & 0xFFFF))]
    elif ctype == 2:
        v = s.reshape(-1, 3)[0]
        cases += [dict(trns=struct.pack(">HHH", *v)),
                  dict(trns=struct.pack(">HHH", *(v >> 8 if depth == 16
                                                  else v + 256)))]
    return s, cases


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("ctype, depth", PNG_LAYOUTS,
                         ids=[f"type{c}-{d}bit" for c, d in PNG_LAYOUTS])
def test_png_matches_pil(ctype, depth, interlace):
    rng = np.random.default_rng(ctype * 100 + depth)
    n = 0
    for h, w in PNG_SIZES:
        s, cases = _png_cases(ctype, depth, h, w, rng)
        for kw in cases:
            data = png_bytes(s, depth, ctype, interlace, seed=n, **kw)
            want = pil_rgba(data)
            got = decode_png(data, "x.png")
            assert got.dtype == np.uint8 and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w} {kw}")
            n += 1


def test_png_refuses_layouts_pil_refuses():
    """A bit depth the colour type does not allow, an unknown interlace
    method, and a file whose image data ends early."""
    good = png_bytes(np.zeros((3, 4, 3), np.uint8), 8, 2)
    for depth, ctype, interlace in ((4, 2, 0), (16, 3, 0), (8, 2, 2)):
        data = bytearray(good)
        data[24], data[25], data[28] = depth, ctype, interlace
        with pytest.raises(Exception):
            pil_rgba(bytes(data))
        with pytest.raises(ValueError, match="bad.png"):
            decode_png(bytes(data), "bad.png")
    short = png_bytes(np.zeros((3, 4, 3), np.uint8), 8, 2)
    data = bytearray(short)
    data[16:20] = struct.pack(">I", 9)  # taller than its data
    with pytest.raises(ValueError, match="short.png"):
        decode_png(bytes(data), "short.png")


# ------------------------------------------------------- progressive JPEG


@pytest.mark.parametrize("sub", [0, 1, 2])
@pytest.mark.parametrize("quality", [50, 75, 92, 100])
def test_progressive_jpeg_matches_pil(quality, sub):
    data = pil_jpeg(sample_image(45, 67), quality=quality, subsampling=sub,
                    progressive=True)
    assert_jpeg_like_pil(data, f"progressive q{quality} subsampling {sub}")


PROGRESSIVE_CASES = {
    "grey": (sample_image(33, 65)[..., 0], dict(quality=85)),
    "optimize": (sample_image(33, 65), dict(optimize=True, quality=70)),
    "restart_blocks": (sample_image(33, 65),
                       dict(restart_marker_blocks=3, quality=85)),
    "restart_rows": (sample_image(33, 65),
                     dict(restart_marker_rows=1, subsampling=1)),
    "restart_grey": (sample_image(33, 65)[..., 2],
                     dict(restart_marker_blocks=1)),
    "size_1x1": (sample_image(1, 1), {}),
    "size_9x5": (sample_image(9, 5), {}),
    "size_33x65": (sample_image(33, 65), dict(quality=95)),
}


@pytest.mark.parametrize("case", sorted(PROGRESSIVE_CASES))
def test_progressive_jpeg_cases(case):
    img, kw = PROGRESSIVE_CASES[case]
    assert_jpeg_like_pil(pil_jpeg(img, progressive=True, **kw), case)


def _scans(data):
    return [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]


@pytest.mark.parametrize("n_scans", range(1, 10))
def test_cut_progressive_file_smoothed(n_scans):
    """PIL's progressive file cut after its first n scans (of libjpeg's
    ten) and closed: its scans leave coefficients 1-9 unrefined, so
    libjpeg smooths its blocks (jdcoefct.c decompress_smooth_data), and so
    does the port."""
    data = pil_jpeg(sample_image(40, 56), progressive=True, quality=80)
    sos = _scans(data)
    assert len(sos) == 10  # libjpeg's YCbCr progression script
    assert_jpeg_like_pil(data[:sos[n_scans]] + b"\xff\xd9",
                         f"cut after {n_scans} scans")


EVERY = [0, 1, 2]
SMOOTHING_CASES = {
    # (image size, factors, scan script, arithmetic-coded)
    "dc_only_420": ((33, 41), [(2, 2), (1, 1), (1, 1)],
                    [(EVERY, 0, 0, 0, 0)], False),
    "dc_only_444_al2": ((21, 30), [(1, 1)] * 3, [(EVERY, 0, 0, 0, 2)],
                        False),
    "dc_refined": ((26, 35), [(2, 1), (1, 1), (1, 1)],
                   [(EVERY, 0, 0, 0, 2), (EVERY, 0, 0, 2, 1),
                    (EVERY, 0, 0, 1, 0)], False),
    "bands_never_refined": ((33, 41), [(2, 2), (1, 1), (1, 1)],
                            [(EVERY, 0, 0, 0, 1), ([0], 1, 5, 0, 2),
                             ([0], 6, 63, 0, 1), ([1], 1, 63, 0, 1),
                             ([2], 1, 2, 0, 3)], False),
    "luma_only_ac": ((24, 40), [(1, 2), (1, 1), (1, 1)],
                     [(EVERY, 0, 0, 0, 0), ([0], 1, 63, 0, 0)], False),
    "two_blocks_wide": ((16, 16), [(1, 1)] * 3,
                        [(EVERY, 0, 0, 0, 1), ([0], 1, 9, 0, 1)], False),
    "short_last_imcu_row": ((55, 30), [(2, 2), (1, 1), (1, 1)],
                            [(EVERY, 0, 0, 0, 0)], False),
    "arithmetic_dc_only": ((29, 37), [(2, 2), (1, 1), (1, 1)],
                           [(EVERY, 0, 0, 0, 1)], True),
    "arithmetic_unrefined": ((29, 37), [(1, 1)] * 3,
                             [(EVERY, 0, 0, 0, 1), ([0], 1, 63, 0, 2),
                              ([1], 1, 63, 0, 1)], True),
}


@pytest.mark.parametrize("case", sorted(SMOOTHING_CASES))
def test_unrefined_scripts_smoothed(case):
    """Progressive scripts that stop short: DC alone (the DC too is then
    estimated), successive-approximation bands never refined, the AC of
    one component only; components two blocks wide and components whose
    last iMCU row is short (libjpeg reads the dummy rows under them)."""
    size, factors, script, arith = SMOOTHING_CASES[case]
    ycc = _planes(*size)[1]
    data = (arith_jpeg_bytes(ycc, factors, 85, script=script) if arith
            else progressive_jpeg_bytes(ycc, factors, script, quality=85))
    assert_jpeg_like_pil(data, case)


# --------------------------------------- JPEG layouts PIL cannot write


def _planes(h=45, w=67):
    img = sample_image(h, w)
    return img, list(jpeg._rgb_to_ycc(img))


FACTORS = {
    "444": [(1, 1)] * 3,
    "420": [(2, 2), (1, 1), (1, 1)],
    "411": [(4, 1), (1, 1), (1, 1)],
    "440": [(1, 2), (1, 1), (1, 1)],
    "422": [(2, 1), (1, 1), (1, 1)],
    "4x2": [(4, 2), (1, 1), (1, 1)],
    "2x4": [(2, 4), (1, 1), (1, 1)],
    "1x4": [(1, 4), (1, 1), (1, 1)],
    "3x1": [(3, 1), (1, 1), (1, 1)],
    "3x2": [(3, 2), (1, 1), (1, 1)],
    "mixed": [(2, 2), (1, 2), (2, 1)],
    "4x4_chroma2x2": [(4, 4), (2, 2), (2, 2)],
}


@pytest.mark.parametrize("interleaved", [True, False],
                         ids=["one_scan", "scan_a_component"])
@pytest.mark.parametrize("name", sorted(FACTORS))
def test_sampling_factors_match_pil(name, interleaved):
    """libjpeg-turbo's upsampler choice: the fancy filters for h2v1 and
    h2v2 on components wider than 2 and for h1v2, replication otherwise
    (true 4:1:1 replicates 4x1). An interleaved MCU of more than 10 blocks
    is refused, as libjpeg refuses it."""
    _, ycc = _planes()
    data = jpeg_bytes(ycc, FACTORS[name], interleaved=interleaved)
    label = f"factors {name}.jpg"
    if interleaved and sum(h * v for h, v in FACTORS[name]) > 10:
        with pytest.raises(Exception):
            pil_rgba(data)
        with pytest.raises(ValueError, match=label):
            decode_image(data, label)
        return
    assert_jpeg_like_pil(data, label)


@pytest.mark.parametrize("size", [(1, 1), (9, 5), (2, 3), (17, 33)])
def test_sampling_factors_at_small_sizes(size):
    """Components 1 or 2 samples wide take the replicating upsamplers."""
    _, ycc = _planes(*size)
    for name in ("420", "422", "440", "411", "mixed"):
        assert_jpeg_like_pil(jpeg_bytes(ycc, FACTORS[name]),
                             f"{name} {size}")


COLOUR_CASES = {
    "adobe_rgb": (lambda img, ycc, k: [img[..., i] for i in range(3)],
                  dict(adobe=0, jfif=False)),
    "ids_rgb": (lambda img, ycc, k: [img[..., i] for i in range(3)],
                dict(jfif=False, ids=[82, 71, 66])),
    "jfif_over_adobe": (lambda img, ycc, k: ycc, dict(adobe=0)),
    "adobe_ycc": (lambda img, ycc, k: ycc, dict(adobe=1, jfif=False)),
    "unknown_ids": (lambda img, ycc, k: ycc, dict(jfif=False,
                                                  ids=[5, 6, 7])),
    "cmyk_adobe": (lambda img, ycc, k: [img[..., 0], img[..., 1],
                                        img[..., 2], k],
                   dict(adobe=0, jfif=False)),
    "cmyk_no_marker": (lambda img, ycc, k: [img[..., 0], img[..., 1],
                                            img[..., 2], k],
                       dict(jfif=False)),
    "ycck": (lambda img, ycc, k: ycc + [k], dict(adobe=2, jfif=False)),
}


@pytest.mark.parametrize("subsampled", [False, True], ids=["444", "420"])
@pytest.mark.parametrize("case", sorted(COLOUR_CASES))
def test_colour_spaces_match_pil(case, subsampled):
    """libjpeg's reading of the colour space (JFIF, then the Adobe
    transform, then the component ids) and PIL's CMYK: read inverted, as
    Adobe writes it, then CMYK -> RGBA in PIL's fixed point."""
    img, ycc = _planes()
    k = np.linspace(0, 255, img.shape[1]).astype(np.uint8)[None].repeat(
        img.shape[0], 0)
    make, kw = COLOUR_CASES[case]
    planes = make(img, ycc, k)
    factors = [(1, 1)] * len(planes)
    if subsampled:
        factors[0] = (2, 2)
        factors[-1] = (2, 2) if len(planes) == 4 else (1, 1)
    assert_jpeg_like_pil(jpeg_bytes(planes, factors, **kw), case)


@pytest.mark.parametrize("kw", [dict(quality=85), dict(progressive=True),
                                dict(progressive=True, optimize=True,
                                     quality=60)],
                         ids=["baseline", "progressive", "optimized"])
def test_pil_cmyk_matches_pil(kw):
    assert_jpeg_like_pil(pil_jpeg(sample_image(30, 41), "CMYK", **kw),
                         f"cmyk {kw}")


# ---------------------------------------------------- lossless JPEG


def _lossless(**kw):
    img = sample_image(17, 23)
    return lossless_jpeg_bytes([img[..., i] for i in range(3)], **kw)


LOSSLESS_LAYOUTS = {
    "rgb": dict(),
    "rgb_ids": dict(ids=[82, 71, 66]),
    "adobe_rgb": dict(adobe=0, pt=1),
    "rgb_420_restart": dict(factors=[(2, 2), (1, 1), (1, 1)],
                            restart_rows=2),
    "rgb_422_restart_every_row": dict(factors=[(2, 1), (1, 1), (1, 1)],
                                      restart_rows=1, pt=3),
    "scan_a_component": dict(factors=[(1, 2), (1, 1), (2, 1)],
                             interleaved=False, restart_rows=3),
    "scan_a_component_411": dict(factors=[(4, 1), (1, 1), (1, 1)],
                                 interleaved=False),
}


@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_matches_pil(predictor):
    """Every layout at this predictor, word for word: greyscale at point
    transforms 0 (the source samples, in PIL and in the port) and 2, RGB
    (libjpeg-turbo takes a lossless file without a marker for RGB and
    upsamples it by replication), and CMYK."""
    grey = sample_image(13, 17)[..., 0]
    for pt in (0, 2):
        data = lossless_jpeg_bytes([grey], predictor=predictor, pt=pt)
        want = pil_rgba(data)
        np.testing.assert_array_equal(want[..., 0], grey >> pt << pt)
        np.testing.assert_array_equal(decode_image(data, "grey"), want)
    for name, kw in LOSSLESS_LAYOUTS.items():
        data = _lossless(predictor=predictor, **kw)
        np.testing.assert_array_equal(decode_image(data, name),
                                      pil_rgba(data), err_msg=name)
    img = sample_image(17, 23)
    k = np.linspace(0, 255, 23).astype(np.uint8)[None].repeat(17, 0)
    data = lossless_jpeg_bytes([img[..., i] for i in range(3)] + [k],
                               [(2, 2), (1, 1), (1, 1), (2, 2)], predictor,
                               adobe=0)
    np.testing.assert_array_equal(decode_image(data, "cmyk"),
                                  pil_rgba(data))


# ------------------------------------------------- arithmetic coding

ARITH_MODES = {
    "sof9": dict(),
    "sof9_dac": dict(conditioning=(2, 5, 3)),
    "sof9_restart": dict(restart=2),
    "sof9_dac_restart": dict(conditioning=(0, 0, 63), restart=1),
    "sof10": dict(script=simple_progression(3)),
    "sof10_dac_restart": dict(script=simple_progression(3), restart=3,
                              conditioning=(1, 3, 10)),
    "sof10_spectral_only": dict(script=[(EVERY, 0, 0, 0, 0),
                                        ([0], 1, 9, 0, 0),
                                        ([0], 10, 63, 0, 0),
                                        ([1], 1, 63, 0, 0),
                                        ([2], 1, 63, 0, 0)]),
}


@pytest.mark.parametrize("mode", sorted(ARITH_MODES))
def test_arithmetic_matches_pil(mode):
    """At 4:4:4, 4:2:0 and mixed factors: PIL decodes the file word for
    word as the Huffman file of the same coefficients (the writer's
    check), the port's decode equals its decode of that Huffman file, and
    PIL's pixels within one level."""
    _, ycc = _planes(37, 45)
    for factors in ([(1, 1)] * 3, [(2, 2), (1, 1), (1, 1)],
                    [(2, 1), (1, 1), (1, 2)]):
        data = arith_jpeg_bytes(ycc, factors, 85, **ARITH_MODES[mode])
        huffman = jpeg_bytes(ycc, factors, 85)
        label = f"{mode} {factors}"
        np.testing.assert_array_equal(pil_rgba(data), pil_rgba(huffman),
                                      err_msg=label)
        np.testing.assert_array_equal(jpeg.decode_jpeg(data, label),
                                      jpeg.decode_jpeg(huffman, label))
        assert_jpeg_like_pil(data, label)


def test_arithmetic_grey_and_cmyk_match_pil():
    """One component (libjpeg's greyscale script) and four (CMYK without
    a marker, the fourth at 2x2 like the first): as the Huffman file."""
    img = sample_image(30, 19)
    k = np.linspace(0, 255, 19).astype(np.uint8)[None].repeat(30, 0)
    cmyk = [img[..., 0], img[..., 1], img[..., 2], k]
    every = [0, 1, 2, 3]
    cases = [([img[..., 1]], [(1, 1)], dict()),
             ([img[..., 1]], [(1, 1)],
              dict(script=simple_progression(1), restart=2)),
             (cmyk, [(2, 2), (1, 1), (1, 1), (2, 2)], dict(jfif=False)),
             (cmyk, [(1, 1)] * 4, dict(jfif=False, restart=4, script=[
                 (every, 0, 0, 0, 1)] + [([c], 1, 63, 0, 0) for c in every]
                 + [(every, 0, 0, 1, 0)]))]
    for planes, factors, kw in cases:
        data = arith_jpeg_bytes(planes, factors, 90, **kw)
        huffman = jpeg_bytes(planes, factors, 90, jfif=kw.get("jfif", True))
        np.testing.assert_array_equal(pil_rgba(data), pil_rgba(huffman))
        np.testing.assert_array_equal(jpeg.decode_jpeg(data, "a"),
                                      jpeg.decode_jpeg(huffman, "h"))
        assert_jpeg_like_pil(data, f"{len(planes)} components {list(kw)}")


# ------------------------------------------------------------- refusals


def _baseline():
    return pil_jpeg(sample_image(16, 24), quality=80)


def _restart_inside_row(data):
    """A lossless file whose restart interval (7 MCUs) ends inside an MCU
    row of 23."""
    i = data.index(b"\xff\xdd")
    return data[:i + 4] + struct.pack(">H", 7) + data[i + 6:]


REFUSED_BY_PIL = {
    "12bit": lambda d: set_precision(d, 12),
    "sof5": lambda d: set_sof(d, 0xC5),
    "sof6": lambda d: set_sof(d, 0xC6),
    "sof7": lambda d: set_sof(d, 0xC7),
    "sof11": lambda d: set_sof(_lossless(), 0xCB),
    "sof13": lambda d: set_sof(d, 0xCD),
    "sof14": lambda d: set_sof(d, 0xCE),
    "sof15": lambda d: set_sof(d, 0xCF),
    "lossless_12bit": lambda d: set_precision(_lossless(), 12),
    "lossless_jfif_ycc": lambda d: _lossless(jfif=True),
    "lossless_adobe_ycc": lambda d: _lossless(adobe=1),
    "lossless_ycck": lambda d: lossless_jpeg_bytes(
        list(_planes(9, 11)[1]) + [np.full((9, 11), 40, np.uint8)],
        adobe=2),
    "lossless_restart_inside_row": lambda d: _restart_inside_row(
        _lossless(restart_rows=1)),
    "dnl": lambda d: set_height(d, 0),
    "2_components": lambda d: jpeg_bytes(list(_planes()[1][:2]),
                                         [(1, 1)] * 2),
}


@pytest.mark.parametrize("case", sorted(REFUSED_BY_PIL))
def test_refuses_what_pil_refuses(case):
    data = REFUSED_BY_PIL[case](_baseline())
    with pytest.raises(Exception):
        Image.open(io.BytesIO(data)).load()
    with pytest.raises((NotImplementedError, ValueError),
                       match=f"{case}.jpg"):
        decode_image(data, f"{case}.jpg")


@pytest.mark.parametrize("fmt", ["WEBP", "GIF", "BMP", "TIFF"])
def test_other_formats_refused_by_name(fmt):
    """Formats PIL opens for the JAX package (a glTF image, a texture file)
    besides PNG and JPEG, which the port refused by name until it decoded
    them: PIL's own file of each now decodes to PIL's pixels word for
    word, found by its leading bytes, not taken for a broken PNG (the
    forms it still refuses by name: tests/test_torch_image_more.py)."""
    b = io.BytesIO()
    Image.fromarray(sample_image(8, 8)).save(b, format=fmt)
    assert pil_rgba(b.getvalue()).shape == (8, 8, 4)
    np.testing.assert_array_equal(decode_image(b.getvalue(), "x.img"),
                                  pil_rgba(b.getvalue()))


def test_damaged_progressive_files():
    """Every prefix and a few flipped bytes of a progressive file either
    decode or raise ValueError / NotImplementedError naming it."""
    data = pil_jpeg(sample_image(20, 30), progressive=True,
                    restart_marker_blocks=2)
    rng = np.random.default_rng(2)
    damaged = [data[:cut] for cut in range(3, len(data), 23)]
    for _ in range(40):
        b = bytearray(data)
        b[int(rng.integers(2, len(b)))] = int(rng.integers(0, 256))
        damaged.append(bytes(b))
    for d in damaged:
        try:
            jpeg.decode_jpeg(d, "damaged.jpg")
        except (ValueError, NotImplementedError) as exc:
            assert "damaged.jpg" in str(exc)


def test_damaged_lossless_and_arithmetic_files():
    """The same for lossless and arithmetic-coded files (sequential and
    progressive, with restarts)."""
    _, ycc = _planes(20, 30)
    rng = np.random.default_rng(3)
    for data in (_lossless(restart_rows=2, predictor=5),
                 arith_jpeg_bytes(ycc, [(2, 2), (1, 1), (1, 1)], restart=2),
                 arith_jpeg_bytes(ycc, [(1, 1)] * 3, restart=3,
                                  script=simple_progression(3))):
        damaged = [data[:cut] for cut in range(3, len(data), 41)]
        for _ in range(25):
            b = bytearray(data)
            b[int(rng.integers(2, len(b)))] = int(rng.integers(0, 256))
            damaged.append(bytes(b))
        for d in damaged:
            try:
                jpeg.decode_jpeg(d, "damaged.jpg")
            except (ValueError, NotImplementedError) as exc:
                assert "damaged.jpg" in str(exc)


# ------------------------------------------------------------- fixtures


def fixture_bound(path):
    """The largest difference from PIL's pixels a fixture's decode may
    have: one level for lossy JPEG (JPEG-in-TIFF too), none for PNG,
    lossless JPEG, WebP, GIF, BMP and other TIFF
    (chip_smoke.fixture_bound)."""
    return chip_smoke.fixture_bound(os.path.basename(path))


def fixture_files():
    return sorted(p for p in glob.glob(os.path.join(FIXTURES, "*"))
                  if not p.endswith(PIXELS))


def test_fixture_set_is_whole():
    names = [os.path.basename(p) for p in fixture_files()]
    assert len(names) == 84 and "progressive_420_512.jpg" in names
    assert "arith_progressive_420_512.jpg" in names
    assert "webp_lossy_512.webp" in names
    assert {n.rsplit(".", 1)[1] for n in names} == {"jpg", "png", "webp",
                                                    "gif", "bmp", "tif"}
    assert all(os.path.exists(os.path.join(FIXTURES, n + PIXELS))
               for n in names)
    assert sum(os.path.getsize(p) for p in glob.glob(
        os.path.join(FIXTURES, "*"))) < 1_700_000


@pytest.mark.parametrize("path", fixture_files(), ids=os.path.basename)
def test_fixture_matches_pil_and_port(path):
    """PIL still gives the stored pixels (so they cannot drift from PIL),
    and the port decodes the file to them through load_image: lossy JPEG
    within one level, every other file word for word."""
    with open(path, "rb") as f:
        data = f.read()
    stored = load_image(path + PIXELS)
    np.testing.assert_array_equal(pil_rgba(data), stored)
    got = load_image(path).astype(np.int64)
    assert got.shape == stored.shape
    diff = np.abs(got - stored)
    print(f"{os.path.basename(path)}: {(diff > 0).sum()} values differ")
    assert diff.max() <= fixture_bound(path)


def test_progressive_512_fixture_shape():
    path = os.path.join(FIXTURES, "progressive_420_512.jpg")
    with open(path, "rb") as f:
        data = f.read()
    i = data.index(b"\xff\xc2")
    h, w = struct.unpack(">HH", data[i + 5:i + 9])
    comps = [data[i + 11 + 3 * c] for c in range(3)]
    assert (h, w) == (512, 512) and comps == [0x22, 0x11, 0x11]


def test_arithmetic_512_fixture_shape():
    """The 512x512 file that phase 18 of chip_smoke.py times: arithmetic
    progressive (SOF10), 4:2:0, libjpeg's ten-scan script."""
    path = os.path.join(FIXTURES, "arith_progressive_420_512.jpg")
    with open(path, "rb") as f:
        data = f.read()
    i = data.index(b"\xff\xca")
    h, w = struct.unpack(">HH", data[i + 5:i + 9])
    comps = [data[i + 11 + 3 * c] for c in range(3)]
    assert (h, w) == (512, 512) and comps == [0x22, 0x11, 0x11]
    assert len(_scans(data)) == 10

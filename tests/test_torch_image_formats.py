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
- Refusal parity: what PIL refuses (12-bit samples, SOF5-7, a height set
  by DNL, 2 components, interleaved MCUs of more than 10 blocks) the port
  refuses with an error naming the file; arithmetic-coded and lossless
  files stay refused by name.
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

from tests.test_torch_recorder import sample_image
from tests.torch_image_writers import (jpeg_bytes, png_bytes, set_height,
                                       set_precision, set_sof)

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


def test_unrefined_progressive_file_refused():
    """A file whose scans stop before its low AC coefficients are refined
    (here cut after the first three of libjpeg's ten scans) is one libjpeg
    smooths (jdcoefct.c do_block_smoothing): the port refuses it by name
    rather than give other pixels. A whole file leaves nothing unrefined,
    so smoothing never acts on it (the tests above hold it to PIL)."""
    data = pil_jpeg(sample_image(40, 56), progressive=True, quality=80)
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    assert len(sos) == 10  # libjpeg's YCbCr progression script
    cut = data[:sos[3]] + b"\xff\xd9"
    with pytest.raises(NotImplementedError, match="cut.jpg.*unrefined"):
        jpeg.decode_jpeg(cut, "cut.jpg")


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


# ------------------------------------------------------------- refusals


def _baseline():
    return pil_jpeg(sample_image(16, 24), quality=80)


REFUSED_BY_PIL = {
    "12bit": lambda d: set_precision(d, 12),
    "sof5": lambda d: set_sof(d, 0xC5),
    "sof6": lambda d: set_sof(d, 0xC6),
    "sof7": lambda d: set_sof(d, 0xC7),
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


@pytest.mark.parametrize("marker", [0xC3, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE,
                                    0xCF])
def test_lossless_and_arithmetic_refused(marker):
    """No tool here writes these files, so no test can hold them to PIL:
    they stay refused, by name."""
    with pytest.raises(NotImplementedError, match="x.jpg.*(lossless|arith)"):
        jpeg.decode_jpeg(set_sof(_baseline(), marker), "x.jpg")


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


# ------------------------------------------------------------- fixtures


def fixture_files():
    return sorted(p for p in glob.glob(os.path.join(FIXTURES, "*"))
                  if not p.endswith(PIXELS))


def test_fixture_set_is_whole():
    names = [os.path.basename(p) for p in fixture_files()]
    assert len(names) == 18 and "progressive_420_512.jpg" in names
    assert all(os.path.exists(os.path.join(FIXTURES, n + PIXELS))
               for n in names)
    assert sum(os.path.getsize(p) for p in glob.glob(
        os.path.join(FIXTURES, "*"))) < 400_000


@pytest.mark.parametrize("path", fixture_files(), ids=os.path.basename)
def test_fixture_matches_pil_and_port(path):
    """PIL still gives the stored pixels (so they cannot drift from PIL),
    and the port decodes the file to them: PNG word for word, JPEG within
    one level, through load_image."""
    with open(path, "rb") as f:
        data = f.read()
    stored = load_image(path + PIXELS)
    np.testing.assert_array_equal(pil_rgba(data), stored)
    got = load_image(path).astype(np.int64)
    assert got.shape == stored.shape
    diff = np.abs(got - stored)
    print(f"{os.path.basename(path)}: {(diff > 0).sum()} values differ")
    assert diff.max() <= (0 if path.endswith(".png") else 1)


def test_progressive_512_fixture_shape():
    path = os.path.join(FIXTURES, "progressive_420_512.jpg")
    with open(path, "rb") as f:
        data = f.read()
    i = data.index(b"\xff\xc2")
    h, w = struct.unpack(">HH", data[i + 5:i + 9])
    comps = [data[i + 11 + 3 * c] for c in range(3)]
    assert (h, w) == (512, 512) and comps == [0x22, 0x11, 0x11]

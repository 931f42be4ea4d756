"""Port parity: WebP, GIF, BMP and baseline TIFF, which the JAX package
opens through PIL (``Image.open(...).convert("RGBA")``) and the port
decodes itself (voidin_tpu_torch/io/webp.py, gif.py, bmp.py, tiff.py),
held to PIL's pixels word for word on files made here from seeds:

- WebP: lossy at several qualities and methods (segments, the normal loop
  filter, 4x4 and 16x16 intra modes, odd sizes down to 1x1), lossy with
  alpha (filtered, lossless-coded and quantized ALPH), lossless at several
  efforts (every transform, the colour cache, meta prefix codes, palettes
  of 2 to 256 colours), animations (PIL's, and the writer's first frame
  at an offset over a background colour), and lossy files re-coded by the
  writer with the simple loop filter, sharpness, loop-filter deltas,
  token partitions and relative segment values;
- GIF: global and local palettes, the interlace, transparency, a first
  frame smaller or larger than the screen, palettes shorter than the
  indices, LZW tables cleared when full and kept full (deferred clear);
- BMP: every header size, 1 / 4 / 8-bit palettes (grey ramps included),
  16 / 24 / 32 bits, bitfields, RLE8 / RLE4 with deltas, top-down rows,
  and what PIL refuses refused naming the file;
- TIFF: photometric 0-3 and 5 at 1-16 bits, extra samples, II / MM,
  strips and tiles, chunky and planar, FillOrder 2, every baseline
  compression and predictor 2, and Orientation (the forms of ROADMAP.md
  F8: tests/test_torch_tiff_f8.py).
"""

import io

import numpy as np
import pytest
from PIL import Image

from voidin_tpu_torch.io.image import decode_image

from tests.torch_image_writers import (bmp_bytes, gif_bytes, riff_chunks,
                                       tiff_bytes, vp8_variant,
                                       webp_anim_bytes)
from tools.torch_image_fixtures import smooth_image, textured_image

H, W = 37, 53


def pil_rgba(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def assert_like_pil(data, name="x.img"):
    want = pil_rgba(data)
    got = decode_image(data, name)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def pil_bytes(img, fmt, **kw):
    b = io.BytesIO()
    Image.fromarray(img).save(b, format=fmt, **kw)
    return b.getvalue()


def _tex(h=H, w=W, seed=0):
    return textured_image(h, w, seed)


def _rgba(h=H, w=W, seed=0):
    alpha = (np.indices((h, w)).sum(0) * 7 % 256).astype(np.uint8)
    alpha[: h // 4] = 255
    alpha[-2:] = 0
    return np.concatenate([_tex(h, w, seed), alpha[..., None]], -1)


# ------------------------------------------------------------------ WebP

WEBP_LOSSY = {
    "q5": dict(quality=5), "q50": dict(quality=50), "q90": dict(quality=90),
    "q100": dict(quality=100), "m0": dict(quality=70, method=0),
    "m6": dict(quality=70, method=6),
}


@pytest.mark.parametrize("case", sorted(WEBP_LOSSY))
def test_webp_lossy_matches_pil(case):
    assert_like_pil(pil_bytes(_tex(), "WEBP", **WEBP_LOSSY[case]))


@pytest.mark.parametrize("size", [(1, 1), (9, 17), (16, 16), (33, 18)])
def test_webp_lossy_sizes_match_pil(size):
    h, w = size
    assert_like_pil(pil_bytes(_tex(48, 48)[:h, :w].copy(), "WEBP",
                              quality=75))


@pytest.mark.parametrize("case", ["default", "m0", "m6", "aq50", "aq10"])
def test_webp_lossy_alpha_matches_pil(case):
    kw = {"default": {}, "m0": dict(method=0), "m6": dict(method=6),
          "aq50": dict(alpha_quality=50), "aq10": dict(alpha_quality=10)}
    assert_like_pil(pil_bytes(_rgba(), "WEBP", quality=70, **kw[case]))


@pytest.mark.parametrize("case", ["q0", "q50", "q100", "m0", "m6", "alpha",
                                  "exact_alpha", "noise", "big"])
def test_webp_lossless_matches_pil(case):
    rng = np.random.default_rng(4)
    img = {"alpha": _rgba(), "exact_alpha": _rgba(),
           "noise": rng.integers(0, 256, (24, 31, 4), dtype=np.uint8),
           "big": _tex(96, 120, 3)}.get(case, _tex())
    kw = {"q0": dict(quality=0), "q50": dict(quality=50),
          "q100": dict(quality=100), "m0": dict(method=0, quality=90),
          "m6": dict(method=6), "exact_alpha": dict(exact=True)}.get(case,
                                                                    {})
    assert_like_pil(pil_bytes(img, "WEBP", lossless=True, **kw))


@pytest.mark.parametrize("colours", [2, 3, 4, 11, 16, 17, 256])
def test_webp_lossless_palettes_match_pil(colours):
    """Colour indexing at 1, 2, 4 and 8 bits a pixel."""
    rng = np.random.default_rng(colours)
    pal = rng.integers(0, 256, (colours, 3), dtype=np.uint8)
    idx = rng.integers(0, colours, (H, W))
    idx[10:20] = np.arange(W) % colours
    assert_like_pil(pil_bytes(pal[idx], "WEBP", lossless=True))


@pytest.mark.parametrize("lossless", [True, False])
def test_webp_animation_matches_pil(lossless):
    frames = [Image.fromarray(_rgba()), Image.fromarray(_rgba(seed=1))]
    b = io.BytesIO()
    kw = dict(lossless=True) if lossless else dict(quality=60)
    frames[0].save(b, format="WEBP", save_all=True, append_images=frames[1:],
                   duration=50, **kw)
    assert_like_pil(b.getvalue())


@pytest.mark.parametrize("lossless,alpha", [(True, True), (False, True),
                                            (True, False), (False, False)])
def test_webp_first_frame_at_an_offset(lossless, alpha):
    """The first frame at (6, 4) on a 53x37 canvas: zeros around it
    (transparent black), ANIM's red background ignored as libwebp's
    WebPAnimDecoder ignores it; without the alpha flag alpha is 255."""
    kw = dict(lossless=True) if lossless else dict(quality=70)
    chunks = [c for c in riff_chunks(pil_bytes(_rgba(20, 30), "WEBP", **kw))
              if c[0] in (b"ALPH", b"VP8 ", b"VP8L")]
    data = webp_anim_bytes([(chunks, (6, 4), (30, 20))], (W, H),
                           background=(255, 0, 0, 255), alpha=alpha)
    assert_like_pil(data)
    got = decode_image(data)
    assert (got[0, 0] == (0, 0, 0, 0 if alpha else 255)).all()


VP8_VARIANTS = {
    "simple": dict(simple=True), "simple_sharp7": dict(simple=True,
                                                       sharpness=7),
    "sharp2": dict(sharpness=2), "sharp6": dict(sharpness=6),
    "parts2": dict(n_parts=2), "parts8": dict(n_parts=8),
    "lf_deltas": dict(lf_deltas=((-12, 3, 0, 1), (20, -5, 1, 0))),
    "relative_segments": dict(relative_segments=True, sharpness=1),
}


@pytest.mark.parametrize("case", sorted(VP8_VARIANTS))
def test_webp_vp8_header_variants_match_pil(case):
    """Lossy files re-coded with VP8 header fields libwebp's encoder does
    not set through PIL (tests/torch_image_writers.vp8_variant)."""
    src = pil_bytes(_tex(64, 80, 5), "WEBP", quality=55)
    assert_like_pil(vp8_variant(src, **VP8_VARIANTS[case]))


def test_webp_512_lossy_matches_pil():
    assert_like_pil(pil_bytes(smooth_image(256, 256), "WEBP", quality=90))


def test_webp_damaged_files_raise_naming_them():
    data = pil_bytes(_tex(), "WEBP", lossless=True)
    for cut in (13, 20, 30, len(data) // 2):
        try:
            decode_image(data[:cut], "cut.webp")
        except ValueError as exc:
            assert "cut.webp" in str(exc)


# ------------------------------------------------------------------- GIF

def _gif_cases():
    rng = np.random.default_rng(6)
    pal = rng.integers(0, 256, (16, 3))
    idx = rng.integers(0, 16, (H, W))
    idx[8:20, 5:40] = 9
    ramp = np.repeat(np.arange(16)[:, None], 3, 1)
    big = rng.integers(0, 256, (96, 120))
    pal8 = rng.integers(0, 256, (256, 3))
    return {
        "global": gif_bytes(idx, 4, global_palette=pal),
        "local_interlaced": gif_bytes(idx, 4, local_palette=pal,
                                      interlace=True),
        "transparency": gif_bytes(idx, 4, global_palette=pal,
                                  transparency=9),
        "small_frame_trns": gif_bytes(idx[:20, :30], 4,
                                      global_palette=pal,
                                      local_palette=pal[::-1],
                                      screen=(W, H), origin=(7, 9),
                                      transparency=5),
        "small_frame": gif_bytes(idx[:20, :30], 4, global_palette=pal,
                                 screen=(W, H), origin=(7, 9)),
        "frame_beyond_screen": gif_bytes(idx, 4, global_palette=pal,
                                         screen=(40, 30), origin=(3, 2)),
        "short_palette": gif_bytes(rng.integers(0, 256, (H, W)), 8,
                                   global_palette=pal[:4]),
        "no_palette": gif_bytes(idx, 4),
        "grey_ramp_trns": gif_bytes(idx, 4, global_palette=ramp,
                                    transparency=2),
        "tiny_interlaced": gif_bytes(idx[:3, :5], 4, global_palette=pal,
                                     interlace=True),
        "two_bits": gif_bytes(rng.integers(0, 4, (H, W)), 2,
                              global_palette=pal[:4]),
        "table_cleared": gif_bytes(big, 8, global_palette=pal8),
        "table_kept_full": gif_bytes(big, 8, global_palette=pal8,
                                     deferred_clear=True, interlace=True),
        "gif87a_two_frames": gif_bytes(idx, 4, global_palette=pal,
                                       version=b"GIF87a",
                                       second_frame=idx[::-1]),
        "pil": pil_bytes(pal8[big].astype(np.uint8), "GIF"),
        "pil_transparency": pil_bytes(idx.astype(np.uint8), "GIF",
                                      transparency=3),
    }


GIF_CASES = _gif_cases()


@pytest.mark.parametrize("case", sorted(GIF_CASES))
def test_gif_matches_pil(case):
    assert_like_pil(GIF_CASES[case])


# ------------------------------------------------------------------- BMP

def _bmp_cases():
    rng = np.random.default_rng(8)
    out = {}
    for bits in (1, 4, 8):
        n = 1 << bits
        pal = rng.integers(0, 256, (n, 3))
        idx = rng.integers(0, n, (H, W))
        idx[3:9] = n - 1
        for hdr in (12, 40, 52, 56, 64, 108, 124):
            out[f"pal{bits}_h{hdr}"] = bmp_bytes(idx, bits, header=hdr,
                                                 palette=pal)
        out[f"pal{bits}_topdown"] = bmp_bytes(idx, bits, palette=pal,
                                              top_down=True)
        out[f"pal{bits}_short"] = bmp_bytes(idx, bits,
                                            palette=pal[:max(1, n // 2)])
    out["pal1_black_white"] = bmp_bytes(rng.integers(0, 2, (H, W)), 1,
                                        palette=[[0] * 3, [255] * 3])
    out["pal8_grey_ramp"] = bmp_bytes(rng.integers(0, 256, (H, W)), 8,
                                      palette=np.repeat(
                                          np.arange(256)[:, None], 3, 1))
    out["pal8_black_white"] = bmp_bytes(rng.integers(0, 2, (H, W)), 8,
                                        palette=[[0] * 3, [255] * 3])
    pal = rng.integers(0, 256, (256, 3))
    idx = rng.integers(0, 4, (H, W))
    idx[:, 10:30] = 7
    mixed = rng.integers(0, 16, (H, W))
    out["rle8"] = bmp_bytes(idx, 8, compression=1, palette=pal)
    out["rle8_delta"] = bmp_bytes(idx, 8, compression=1, palette=pal,
                                  delta_row=5)
    out["rle8_mixed"] = bmp_bytes(mixed, 8, compression=1, palette=pal)
    out["rle4"] = bmp_bytes(idx, 4, compression=2, palette=pal[:16])
    out["rle4_delta"] = bmp_bytes(idx, 4, compression=2, palette=pal[:16],
                                  delta_row=3)
    out["rle4_mixed"] = bmp_bytes(mixed, 4, compression=2, palette=pal[:16])
    v16 = rng.integers(0, 65536, (H, W))
    out["rgb555"] = bmp_bytes(v16, 16)
    out["bitfields_565"] = bmp_bytes(v16, 16, compression=3,
                                     masks=(0xF800, 0x7E0, 0x1F))
    out["bitfields_555_v3"] = bmp_bytes(v16, 16, header=56, compression=3,
                                        masks=(0x7C00, 0x3E0, 0x1F, 0))
    rgb = rng.integers(0, 256, (H, W, 3))
    out["rgb24"] = bmp_bytes(rgb, 24)
    out["rgb24_os2"] = bmp_bytes(rgb, 24, header=12)
    out["rgb24_topdown"] = bmp_bytes(rgb, 24, top_down=True)
    out["rgb24_bitfields"] = bmp_bytes(rgb, 24, compression=3,
                                       masks=(0xFF0000, 0xFF00, 0xFF))
    v32 = rng.integers(0, 2 ** 32, (H, W), dtype=np.uint64)
    out["rgb32"] = bmp_bytes(v32, 32)
    for k, m in enumerate(((0xFF0000, 0xFF00, 0xFF, 0),
                           (0xFF000000, 0xFF0000, 0xFF00, 0),
                           (0xFF000000, 0xFF00, 0xFF, 0),
                           (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
                           (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                           (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                           (0xFF000000, 0xFF00, 0xFF, 0xFF0000),
                           (0, 0, 0, 0))):
        out[f"bitfields32_{k}"] = bmp_bytes(v32, 32, header=124,
                                            compression=3, masks=m)
    out["bitfields32_header40"] = bmp_bytes(v32, 32, compression=3,
                                            masks=(0xFF0000, 0xFF00, 0xFF))
    out["width1"] = bmp_bytes(rng.integers(0, 2, (5, 1)), 1,
                              palette=pal[:2])
    for mode in ("1", "L", "P", "RGB", "RGBA"):
        img = Image.fromarray(_rgba()).convert(mode)
        b = io.BytesIO()
        img.save(b, format="BMP")
        out[f"pil_{mode}"] = b.getvalue()
    return out


BMP_CASES = _bmp_cases()


@pytest.mark.parametrize("case", sorted(BMP_CASES))
def test_bmp_matches_pil(case):
    assert_like_pil(BMP_CASES[case])


@pytest.mark.parametrize("case", ["alphabitfields", "bitfields_444",
                                  "pal4_grey_ramp", "depth_2"])
def test_bmp_refused_as_pil_refuses(case):
    rng = np.random.default_rng(9)
    data = {
        "alphabitfields": lambda: bmp_bytes(
            rng.integers(0, 2 ** 32, (H, W), dtype=np.uint64), 32,
            header=124, compression=6,
            masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
        "bitfields_444": lambda: bmp_bytes(
            rng.integers(0, 65536, (H, W)), 16, compression=3,
            masks=(0xF00, 0xF0, 0xF)),
        "pal4_grey_ramp": lambda: bmp_bytes(
            rng.integers(0, 16, (H, W)), 4,
            palette=np.repeat(np.arange(16)[:, None], 3, 1)),
        "depth_2": lambda: bmp_bytes(rng.integers(0, 4, (H, W)), 2,
                                     palette=rng.integers(0, 256, (4, 3))),
    }[case]()
    with pytest.raises(Exception):
        Image.open(io.BytesIO(data)).convert("RGBA")
    with pytest.raises(ValueError, match="x.bmp"):
        decode_image(data, "x.bmp")


# ------------------------------------------------------------------ TIFF

# (photometric, bits, samples, extra samples)
TIFF_LAYOUTS = {
    "white_is_zero_1": (0, 1, 1, None), "grey_1": (1, 1, 1, None),
    "white_is_zero_2": (0, 2, 1, None), "grey_4": (1, 4, 1, None),
    "white_is_zero_8": (0, 8, 1, None), "grey_8": (1, 8, 1, None),
    "grey_12": (1, 12, 1, None), "white_is_zero_16": (0, 16, 1, None),
    "grey_16": (1, 16, 1, None), "grey_alpha": (1, 8, 2, (2,)),
    "rgb": (2, 8, 3, None), "rgba_no_extra": (2, 8, 4, None),
    "rgbx": (2, 8, 4, (0,)), "rgba_associated": (2, 8, 4, (1,)),
    "rgba": (2, 8, 4, (2,)), "rgba_associated_x": (2, 8, 5, (1, 0)),
    "rgb16": (2, 16, 3, None), "rgba16_associated": (2, 16, 4, (1,)),
    "rgba16": (2, 16, 4, (2,)), "palette_1": (3, 1, 1, None),
    "palette_4": (3, 4, 1, None), "palette_8": (3, 8, 1, None),
    "palette_alpha": (3, 8, 2, (2,)), "cmyk": (5, 8, 4, None),
    "cmyk_x": (5, 8, 5, (0,)), "cmyk16": (5, 16, 4, None),
}
TIFF_OPTIONS = {
    "strips_of_5": dict(rows_per_strip=5), "tiles": dict(tile=(16, 16)),
    "planar": dict(planar=2), "fill_order_2": dict(fillorder=2),
    "predictor": dict(predictor=2),
}


def _tiff(layout, byteorder="II", compression=1, **kw):
    photo, bits, spp, extra = TIFF_LAYOUTS[layout]
    rng = np.random.default_rng(len(layout) * 31 + bits)
    s = rng.integers(0, 1 << bits, (H, W, spp))
    if extra and extra[0] == 1:  # associated: colour <= alpha
        a = s[..., spp - len(extra):spp - len(extra) + 1]
        s[..., :spp - len(extra)] = (s[..., :spp - len(extra)] * a) >> bits
    cmap = rng.integers(0, 65536, (3, 1 << bits)) if photo == 3 else None
    return tiff_bytes(s, bits, photo, byteorder=byteorder,
                      compression=compression, extra=extra, colormap=cmap,
                      **kw)


@pytest.mark.parametrize("layout", sorted(TIFF_LAYOUTS))
@pytest.mark.parametrize("byteorder,compression", [
    ("II", 1), ("MM", 5), ("II", 8), ("MM", 32773)])
def test_tiff_layouts_match_pil(layout, byteorder, compression):
    """Each layout in each byte order and compression: PIL's pixels where
    PIL reads it (its table has no big-endian 12-bit or WhiteIsZero 16-bit
    entry); where PIL refuses it, the port refuses it naming the file."""
    _like_pil_or_refused(_tiff(layout, byteorder, compression))


def _like_pil_or_refused(data):
    try:
        want = pil_rgba(data)
    except Exception:
        with pytest.raises((ValueError, NotImplementedError), match="x.tif"):
            decode_image(data, "x.tif")
        return
    np.testing.assert_array_equal(decode_image(data, "x.tif"), want)


@pytest.mark.parametrize("option", sorted(TIFF_OPTIONS))
@pytest.mark.parametrize("layout", ["grey_8", "rgb", "rgba", "palette_8",
                                    "cmyk", "grey_16"])
@pytest.mark.parametrize("compression", [1, 5, 32946])
def test_tiff_options_match_pil(option, layout, compression):
    """Strips, tiles, planes, FillOrder 2 and the predictor (which PIL
    undoes for LZW and Deflate only), each where PIL reads the file; where
    PIL refuses it, the port refuses it naming the file."""
    _like_pil_or_refused(_tiff(layout, "II", compression,
                               **TIFF_OPTIONS[option]))


@pytest.mark.parametrize("orientation", [1, 2, 3, 4, 5, 6, 7, 8])
def test_tiff_orientation_as_pil_applies_it(orientation):
    rng = np.random.default_rng(orientation)
    assert_like_pil(tiff_bytes(rng.integers(0, 256, (H, W, 3)), 8, 2,
                               compression=5, orientation=orientation))


def test_tiff_old_style_lzw_and_full_tables():
    rng = np.random.default_rng(12)
    big = rng.integers(0, 256, (90, 110, 3))
    for old in (False, True):
        assert_like_pil(tiff_bytes(big, 8, 2, compression=5, old_lzw=old))


@pytest.mark.parametrize("mode,compression", [
    ("RGB", "raw"), ("RGBA", "tiff_lzw"), ("L", "tiff_adobe_deflate"),
    ("1", "packbits"), ("P", "tiff_lzw"), ("CMYK", "raw"), ("LA", "raw"),
    ("I;16", "tiff_lzw")])
def test_tiff_pil_written_match_pil(mode, compression):
    img = Image.fromarray(_rgba()).convert(mode)
    b = io.BytesIO()
    img.save(b, format="TIFF", compression=compression)
    assert_like_pil(b.getvalue())


def test_tiff_unknown_layouts_refused_naming_the_file():
    rng = np.random.default_rng(14)
    for data in (tiff_bytes(rng.integers(0, 8, (H, W)), 3, 1),
                 tiff_bytes(rng.integers(0, 2, (H, W)), 1, 4),
                 tiff_bytes(rng.integers(0, 256, (H, W, 2)), 8, 1,
                            extra=(1,))):
        with pytest.raises(Exception):
            pil_rgba(data)
        with pytest.raises(ValueError, match="odd.tif"):
            decode_image(data, "odd.tif")

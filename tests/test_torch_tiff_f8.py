"""Port parity: the TIFF forms PIL opens through libtiff beyond baseline
TIFF (ROADMAP.md F8), which the JAX package reads through PIL
(``Image.open(...).convert("RGBA")``) and the port decodes itself
(voidin_tpu_torch/io/tiff.py, zstd.py, ccitt.py, jpeg.py), held to PIL's
pixels on files made here from seeds (JPEG-in-TIFF within one level, as
the port's JPEG tests hold lossy JPEG; everything else word for word):

- BigTIFF in PIL's form and the writer's (strips, tiles, planes, LONG8
  offsets); big-endian BigTIFF refused, as PIL refuses it;
- signed and floating-point samples (8-, 16-, 32-bit signed, 32-bit
  unsigned, 32-bit float at photometric 0 and 1), both byte orders,
  uncompressed and through libtiff, whose big-endian words PIL misreads;
- predictor 2 at 32 bits and the floating-point predictor 3;
- LZMA and ZSTD (PIL's files of every mode it writes; a 512x512 ZSTD
  file whose blocks hold Huffman literals and FSE-coded sequences);
- CCITT modified Huffman, T.4 1-D and 2-D (fill bits, FillOrder 2) and
  T.6, photometric 0 and 1, runs past 1,728 pixels;
- JPEG-in-TIFF: PIL's RGB and grey files, the writer's YCbCr files at
  each subsampling (tables in JPEGTables or in each strip, strips and
  tiles) and old-style JPEG from a JPEGInterchangeFormat stream;
- YCbCr through libtiff's RGBA reader (every subsampling it has a case
  for, ReferenceBlackWhite, YCbCrCoefficients, planes) and through PIL's
  raw reader (RGBX), and what either refuses;
- CIELab through LittleCMS's Lab -> sRGB table as PIL converts it
  (io/cielab.py), word for word;
- the planar layouts PIL's raw reader misreads, with PIL's words;
- the committed F8 fixtures (tools/torch_image_fixtures.py f8_formats)
  and what PIL refuses (WebP-in-TIFF here), refused naming the file.

Run on the CPU: ``python -m pytest tests/test_torch_tiff_f8.py -q``.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from voidin_tpu_torch.io import cielab, zstd
from voidin_tpu_torch.io.image import decode_image, load_image

from tests.torch_image_writers import (jpeg_tiff_bytes, ojpeg_tiff_bytes,
                                       tiff_bytes, webp_tiff_bytes)
from tools.torch_image_fixtures import (F8_SIZE, PIXELS, smooth_image,
                                        textured_image)

H, W = 37, 53
FIXTURES = os.path.join(os.path.dirname(__file__), "data", "torch_images")


def pil_rgba(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def pil_save(img, mode=None, **kw):
    im = Image.fromarray(img)
    if mode:
        im = im.convert(mode)
    b = io.BytesIO()
    im.save(b, format="TIFF", **kw)
    return b.getvalue()


def like_pil(data, bound=0):
    want = pil_rgba(data)
    got = decode_image(data, "f8.tif")
    assert got.shape == want.shape
    assert np.abs(got.astype(np.int64) - want).max() <= bound


def like_pil_or_refused(data):
    """PIL's pixels where PIL reads the file; a ValueError naming the file
    where PIL refuses it."""
    try:
        want = pil_rgba(data)
    except Exception:
        with pytest.raises(ValueError, match="f8.tif"):
            decode_image(data, "f8.tif")
        return False
    np.testing.assert_array_equal(decode_image(data, "f8.tif"), want)
    return True


def _tex(seed=0, h=H, w=W):
    return textured_image(h, w, seed)


# ---------------------------------------------------------------- BigTIFF

BIGTIFF = {
    "strips": dict(rows_per_strip=5), "tiles": dict(tile=(16, 16)),
    "planar": dict(planar=2), "lzw": dict(compression=5),
    "deflate_tiles": dict(compression=8, tile=(32, 16)),
    "zip_planar_rows": dict(compression=32946, planar=2, rows_per_strip=7),
}


@pytest.mark.parametrize("case", sorted(BIGTIFF))
def test_bigtiff_matches_pil(case):
    assert like_pil_or_refused(tiff_bytes(_tex(1), 8, 2, bigtiff=True,
                                          **BIGTIFF[case]))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "1", "I;16", "P"])
def test_pil_bigtiff_matches_pil(mode):
    rgba = np.concatenate([_tex(2), _tex(3)[..., :1]], -1)
    like_pil(pil_save(rgba, mode, big_tiff=True, compression="tiff_lzw"))


def test_big_endian_bigtiff_refused_as_pil_refuses_it():
    data = tiff_bytes(_tex(4), 8, 2, byteorder="MM", bigtiff=True)
    with pytest.raises(Exception):
        pil_rgba(data)
    with pytest.raises(ValueError, match="f8.tif: big-endian BigTIFF"):
        decode_image(data, "f8.tif")


# --------------------------------------------------- sample formats, etc.

def _samples(kind, rng):
    if kind == "float":
        return rng.normal(60, 200, (H, W)).astype(np.float32), 32, 3
    if kind == "int32":
        return rng.integers(-500, 500, (H, W)).astype(np.int32), 32, 2
    if kind == "uint32":
        return rng.integers(0, 600, (H, W)).astype(np.uint32), 32, None
    bits = {"int8": 8, "int16": 16}[kind]
    return rng.integers(0, 1 << bits, (H, W)), bits, 2


@pytest.mark.parametrize("kind", ["int8", "int16", "int32", "uint32",
                                  "float"])
@pytest.mark.parametrize("byteorder", ["II", "MM"])
@pytest.mark.parametrize("compression", [1, 5, 34925])
def test_sample_formats_match_pil(kind, byteorder, compression):
    """Signed grey read as PIL's I (8-bit as unsigned L), float as F, each
    clipped as PIL converts them; big-endian words that libtiff hands
    over in native order are byte-swapped as PIL misreads them. PIL's
    table has no big-endian unsigned 32-bit entry: refused."""
    s, bits, fmt = _samples(kind, np.random.default_rng(len(kind)))
    read = like_pil_or_refused(tiff_bytes(
        s, bits, 1, byteorder=byteorder, compression=compression,
        sample_format=fmt))
    assert read == (kind != "uint32" or byteorder == "II")


@pytest.mark.parametrize("byteorder", ["II", "MM"])
def test_float_whiteiszero_and_special_values_match_pil(byteorder):
    f = np.random.default_rng(5).normal(60, 200, (H, W)).astype(np.float32)
    f.reshape(-1)[:6] = [np.nan, np.inf, -np.inf, 254.99, 255.0, -0.5]
    like_pil(tiff_bytes(f, 32, 0, byteorder=byteorder, compression=8,
                        sample_format=3))


@pytest.mark.parametrize("predictor", [2, 3])
@pytest.mark.parametrize("byteorder", ["II", "MM"])
@pytest.mark.parametrize("compression", [1, 5, 8, 34925])
def test_float_predictors_match_pil(predictor, byteorder, compression):
    """Predictor 2 on 32-bit words and the floating-point predictor 3,
    undone by libtiff for LZW, Deflate and LZMA, never by PIL's raw
    reader."""
    f = np.random.default_rng(6).normal(60, 200, (H, W)).astype(np.float32)
    like_pil(tiff_bytes(f, 32, 1, byteorder=byteorder,
                        compression=compression, sample_format=3,
                        predictor=predictor, rows_per_strip=8))


def test_float_predictor_on_integers_refused_as_libtiff_refuses_it():
    data = tiff_bytes(np.random.default_rng(7).integers(0, 256, (H, W)), 8,
                      1, compression=5, predictor=3)
    assert not like_pil_or_refused(data)


# ---------------------------------------------------------- LZMA and ZSTD

@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "1", "I;16", "P",
                                  "CMYK", "I", "F", "LA"])
@pytest.mark.parametrize("compression", ["lzma", "zstd"])
def test_pil_lzma_zstd_match_pil(mode, compression):
    rgba = np.concatenate([_tex(8), _tex(9)[..., :1]], -1)
    like_pil(pil_save(rgba, mode, compression=compression))


@pytest.mark.parametrize("compression", ["lzma", "zstd"])
def test_lzma_zstd_predictor_and_tiles_match_pil(compression):
    like_pil(pil_save(_tex(10), compression=compression,
                      tiffinfo={317: 2, 322: 16, 323: 16}))


def test_zstd_512_holds_huffman_literals_and_fse_sequences(monkeypatch):
    """The 512x512 ZSTD fixture exercises the decoder's compressed paths:
    Huffman-coded literals (trees by FSE-coded weights or direct) and
    sequences with FSE-compressed tables, and decodes to PIL's pixels."""
    seen = {"tree": 0, "fse": 0}
    real_tree, real_ncount = zstd.huffman_table, zstd.read_ncount

    def tree(*a):
        seen["tree"] += 1
        return real_tree(*a)

    def ncount(*a):
        seen["fse"] += 1
        return real_ncount(*a)

    monkeypatch.setattr(zstd, "huffman_table", tree)
    monkeypatch.setattr(zstd, "read_ncount", ncount)
    path = os.path.join(FIXTURES, "f8_zstd_512.tif")
    got = load_image(path)
    assert got.shape == (F8_SIZE, F8_SIZE, 4)
    np.testing.assert_array_equal(got, load_image(path + PIXELS))
    assert seen["tree"] > 0 and seen["fse"] > seen["tree"]


def test_zstd_frames_of_every_block_kind():
    """Raw, RLE and compressed blocks (PIL's files of a constant, a random
    and a smooth image), skippable frames and a checksum flag skipped."""
    for img in (np.full((H, W), 7, np.uint8),
                np.random.default_rng(11).integers(0, 256, (H, W)).astype(
                    np.uint8), smooth_image(H, W)[..., 0]):
        like_pil(pil_save(img, compression="zstd"))
    frame = bytes.fromhex("28b52ffd2403190000616263") + b"\0\0\0\0"
    skip = (0x184D2A50).to_bytes(4, "little") + (3).to_bytes(4, "little")
    assert zstd.decompress(skip + b"xyz" + frame) == b"abc"


def test_zstd_with_a_dictionary_refused_by_name():
    with pytest.raises(ValueError, match="dictionary"):
        zstd.decompress(bytes.fromhex("28b52ffd2101") + b"\x05" * 8)


# ------------------------------------------------------------------ CCITT

CCITT = {
    "rle": ("tiff_ccitt", {}), "g3_1d": ("group3", {}),
    "g3_2d": ("group3", {292: 1}), "g3_fill_bits": ("group3", {292: 4}),
    "g3_2d_fill_lsb": ("group3", {292: 5, 266: 2}),
    "g4": ("group4", {}), "g4_lsb": ("group4", {266: 2}),
    "g4_whiteiszero": ("group4", {262: 0}),
    "g3_whiteiszero_strips": ("group3", {262: 0, 292: 1, 278: 5}),
    "rle_strips": ("tiff_ccitt", {278: 8}),
}


@pytest.mark.parametrize("case", sorted(CCITT))
@pytest.mark.parametrize("image", ["noise", "dithered"])
def test_ccitt_matches_pil(case, image):
    compression, info = CCITT[case]
    if image == "noise":
        img = (np.random.default_rng(12).random((H, W)) < 0.3) * 255
    else:
        img = _tex(13)
    like_pil(pil_save(img.astype(np.uint8), "1", compression=compression,
                      tiffinfo=info))


@pytest.mark.parametrize("compression", ["tiff_ccitt", "group3", "group4"])
def test_ccitt_runs_past_1728_match_pil(compression):
    """Runs of 1,792 pixels and more take the extended makeup codes."""
    a = np.zeros((9, 2700), np.uint8)
    a[1, 100:2650] = a[3, :1800] = a[5, 2000:] = a[8, 1:2600] = 255
    a[7, ::2] = 255
    like_pil(pil_save(a, "1", compression=compression, tiffinfo={292: 1}
                      if compression == "group3" else {}))


def test_ccitt_of_grey_samples_refused():
    data = tiff_bytes(np.random.default_rng(14).integers(0, 256, (H, W)), 8,
                      1, compression=4)
    assert not like_pil_or_refused(data)


# ----------------------------------------------------------- JPEG-in-TIFF

@pytest.mark.parametrize("mode", ["RGB", "L"])
@pytest.mark.parametrize("quality", [50, 90])
def test_pil_jpeg_in_tiff_within_one_level(mode, quality):
    like_pil(pil_save(_tex(15), mode, compression="jpeg", quality=quality),
             bound=1)


YCC_FACTORS = {"420": ((2, 2), (1, 1), (1, 1)),
               "444": ((1, 1), (1, 1), (1, 1)),
               "422": ((2, 1), (1, 1), (1, 1)),
               "440": ((1, 2), (1, 1), (1, 1))}


@pytest.mark.parametrize("factors", sorted(YCC_FACTORS))
@pytest.mark.parametrize("layout", ["tables", "inline", "one_strip",
                                    "tiles"])
def test_jpeg_ycbcr_in_tiff_within_one_level(factors, layout):
    """Photometric 6: PIL asks libtiff for RGB, so libjpeg upsamples and
    converts each strip or tile (an abbreviated stream completed by
    JPEGTables, or a whole one)."""
    fac = YCC_FACTORS[factors]
    ycc = np.asarray(Image.fromarray(_tex(16)).convert("YCbCr"))
    planes = [ycc[..., k] for k in range(3)]
    rps = 8 * fac[0][1]
    kw = {"tables": dict(), "inline": dict(split_tables=False),
          "one_strip": dict(), "tiles": dict(tile=(16, 16))}[layout]
    like_pil(jpeg_tiff_bytes(planes, 6, H if layout == "one_strip" else rps,
                             fac, **kw), bound=1)


@pytest.mark.parametrize("photometric", [1, 2])
def test_jpeg_rgb_and_grey_in_tiff_within_one_level(photometric):
    tex = _tex(17)
    planes = [tex[..., 0]] if photometric == 1 else [tex[..., k]
                                                     for k in range(3)]
    like_pil(jpeg_tiff_bytes(planes, photometric, 16), bound=1)


@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_old_style_jpeg_within_one_level(subsampling):
    """Compression 6 from a JPEGInterchangeFormat stream (a PIL JPEG):
    libjpeg's raw planes converted by libtiff's YCbCr tables, chroma
    replicated."""
    b = io.BytesIO()
    Image.fromarray(_tex(18)).save(b, format="JPEG", quality=85,
                                   subsampling=subsampling)
    sub = {0: (1, 1), 1: (2, 1), 2: (2, 2)}[subsampling]
    like_pil(ojpeg_tiff_bytes(b.getvalue(), W, H, sub), bound=1)


def test_old_style_jpeg_without_its_stream_refused_by_name():
    data = tiff_bytes(_tex(19), 8, 2, compression=6)
    with pytest.raises(ValueError, match="f8.tif: old-style JPEG"):
        decode_image(data, "f8.tif")


def test_webp_in_tiff_refused_as_pil_refuses_it():
    """libtiff under this PIL was built without its WebP codec (PIL's
    writer crashes on compression="webp"): PIL refuses the form, and the
    port refuses it by name. PIL's probe runs in a subprocess."""
    b = io.BytesIO()
    Image.fromarray(_tex(20)).save(b, format="WEBP", lossless=True)
    data = webp_tiff_bytes([b.getvalue()], W, H, H)
    probe = subprocess.run(
        [sys.executable, "-c", "import io, sys\nfrom PIL import Image\n"
         "Image.open(io.BytesIO(sys.stdin.buffer.read())).convert('RGBA')"],
        input=data, capture_output=True, check=False)
    assert probe.returncode != 0
    with pytest.raises(ValueError, match="f8.tif: WebP-in-TIFF"):
        decode_image(data, "f8.tif")


# ------------------------------------------------------------------ YCbCr

YCC_READ = [(1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4), (1, 2)]


@pytest.mark.parametrize("sub", YCC_READ, ids=str)
@pytest.mark.parametrize("compression", [5, 8, 34925])
def test_ycbcr_through_libtiff_rgba_matches_pil(sub, compression):
    ycc = np.random.default_rng(21).integers(0, 256, (H, W, 3))
    like_pil(tiff_bytes(ycc, 8, 6, compression=compression, ycbcr=sub,
                        rows_per_strip=4 * sub[1]))


@pytest.mark.parametrize("tags", [
    {532: (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])},
    {529: (5, [2126, 10000, 7152, 10000, 722, 10000]), 531: (3, [2])},
    {532: (5, [0, 1, 255, 1, 128, 1, 255, 1, 128, 1, 255, 1]),
     529: (5, [299, 1000, 587, 1000, 114, 1000])}], ids=str)
def test_ycbcr_reference_black_white_and_coefficients_match_pil(tags):
    ycc = np.random.default_rng(22).integers(0, 256, (H, W, 3))
    like_pil(tiff_bytes(ycc, 8, 6, compression=8, ycbcr=(2, 1), tags=tags))


@pytest.mark.parametrize("compression", [1, 5])
def test_ycbcr_planes_match_pil(compression):
    ycc = np.random.default_rng(23).integers(0, 256, (H, W, 3))
    like_pil(tiff_bytes(ycc, 8, 6, compression=compression, planar=2,
                        tags={530: (3, [1, 1])}))


@pytest.mark.parametrize("sub", [(1, 1), (2, 2), (4, 1)], ids=str)
@pytest.mark.parametrize("rows_per_strip", [6, H])
def test_uncompressed_ycbcr_read_as_pil_misreads_it(sub, rows_per_strip):
    """PIL's raw reader takes uncompressed YCbCr as RGBX, four bytes a
    pixel from each strip's offset on, into whatever follows."""
    ycc = np.random.default_rng(24).integers(0, 256, (H, W, 3))
    data = tiff_bytes(ycc, 8, 6, ycbcr=sub, rows_per_strip=rows_per_strip)
    like_pil_or_refused(data)  # PIL may run off the file's end
    assert like_pil_or_refused(data + bytes(range(256)) * 40)


@pytest.mark.parametrize("case", ["sub_2x4", "sub_1x4", "one_sample_lzw"])
def test_ycbcr_that_libtiff_refuses_refused(case):
    ycc = np.random.default_rng(25).integers(0, 256, (H, W, 3))
    data = {"sub_2x4": lambda: tiff_bytes(ycc, 8, 6, compression=5,
                                          ycbcr=(2, 4)),
            "sub_1x4": lambda: tiff_bytes(ycc, 8, 6, compression=8,
                                          ycbcr=(1, 4)),
            "one_sample_lzw": lambda: tiff_bytes(ycc[..., 0], 8, 6,
                                                 compression=5)}[case]()
    assert not like_pil_or_refused(data)


def test_one_sample_ycbcr_uncompressed_read_as_grey():
    ycc = np.random.default_rng(26).integers(0, 256, (H, W))
    assert like_pil_or_refused(tiff_bytes(ycc, 8, 6))


@pytest.mark.parametrize("planar", [1, 2])
@pytest.mark.parametrize("byteorder", ["II", "MM"])
@pytest.mark.parametrize("compression", [1, 5, 34925])
def test_cielab_matches_pil(planar, byteorder, compression):
    """Photometric 8: PIL's LAB image (a* and b* flipped to unsigned by
    the chunky unpacker, copied as they are from planes, whose alpha byte
    stays 0) through LittleCMS's Lab -> sRGB table (io/cielab.py)."""
    lab = np.random.default_rng(27).integers(0, 256, (H, W, 3))
    like_pil(tiff_bytes(lab, 8, 8, compression=compression, planar=planar,
                        byteorder=byteorder, rows_per_strip=8))


@pytest.mark.parametrize("compression", ["raw", "tiff_lzw", "zstd"])
def test_pil_cielab_matches_pil(compression):
    like_pil(pil_save(_tex(30), "LAB", compression=compression))


def test_lab_to_rgb_is_littlecms_word_for_word():
    """cielab.lab_to_rgb against PIL's LittleCMS transform on 2^20 Lab
    triples: a random quarter of the cube's L planes, whole, and every
    grid node and its neighbours (the table's edges and the interpolation
    ties). The port's own check of all 2^24 inputs took ~40 s."""
    rng = np.random.default_rng(31)
    planes = np.sort(rng.choice(256, 16, replace=False))
    g = np.stack(np.meshgrid(planes, np.arange(256), np.arange(256),
                             indexing="ij"), -1).reshape(-1, 3)
    nodes = np.unique(np.clip(np.round(np.arange(33) * 255 / 32)[:, None]
                              + np.arange(-1, 2), 0, 255))
    g = np.concatenate([g, np.stack(np.meshgrid(nodes, nodes, nodes,
                                                indexing="ij"),
                                    -1).reshape(-1, 3)]).astype(np.uint8)
    im = Image.frombytes("LAB", (g.shape[0], 1),
                         (g ^ np.array([0, 128, 128], np.uint8)).tobytes())
    np.testing.assert_array_equal(
        cielab.lab_to_rgb(g), np.asarray(im.convert("RGB"))[0])


# --------------------------------------------------- planes PIL misreads

PLANAR = {
    "grey2": (2, 1, 1), "grey4": (4, 1, 1), "whiteiszero2": (2, 0, 1),
    "palette1": (1, 3, 1), "palette2": (2, 3, 1), "palette4": (4, 3, 1),
    "rgb16": (16, 2, 3), "rgba16": (16, 2, 4), "cmyk16": (16, 5, 4),
}


@pytest.mark.parametrize("case", sorted(PLANAR))
@pytest.mark.parametrize("tile", [None, (16, 16)], ids=str)
@pytest.mark.parametrize("byteorder", ["II", "MM"])
def test_uncompressed_planes_read_as_pil_misreads_them(case, tile,
                                                       byteorder):
    """Each plane read by its raw mode's first letter, one byte a pixel,
    line after line; an edge tile's lines a stride apart that PIL derives
    from the chunky row (too short a stride: refused, as PIL refuses
    it)."""
    bits, photo, spp = PLANAR[case]
    rng = np.random.default_rng(bits * 7 + photo)
    s = rng.integers(0, 1 << bits, (H, W, spp))
    cmap = rng.integers(0, 65536, (3, 1 << bits)) if photo == 3 else None
    extra = (2,) if spp == 4 and photo == 2 else None
    like_pil_or_refused(tiff_bytes(s, bits, photo, planar=2, tile=tile,
                                   colormap=cmap, extra=extra,
                                   byteorder=byteorder) + bytes(4096))


@pytest.mark.parametrize("tile", [(16, 16), (32, 8), (48, 16)], ids=str)
def test_rgba_planes_without_extra_samples_read_as_pil_misreads_them(tile):
    """Tiled RGBA planes without ExtraSamples: an edge tile's lines 4/3 of
    the tile's width apart (PIL divides the chunky row by three bands)."""
    s = np.random.default_rng(28).integers(0, 256, (H, W, 4))
    like_pil(tiff_bytes(s, 8, 2, planar=2, tile=tile))


@pytest.mark.parametrize("compression", [5, 8])
def test_palette_tiles_with_an_extra_plane_read_as_pil_misreads_them(
        compression):
    """PIL's libtiff decoder unpacks the palette plane's tile alone with
    the chunky raw mode PX, each row from its start: every other byte,
    running on into the next row. The image stays inside one row of tiles
    (12 rows of 16), so PIL never reads past a tile's buffer."""
    rng = np.random.default_rng(29)
    like_pil(tiff_bytes(rng.integers(0, 256, (12, W, 2)), 8, 3, planar=2,
                        tile=(16, 16), colormap=rng.integers(
                            0, 65536, (3, 256)), extra=(0,),
                        compression=compression))


# --------------------------------------------------------------- fixtures

F8_FIXTURES = sorted(n for n in os.listdir(FIXTURES)
                     if n.startswith("f8_") and not n.endswith(PIXELS))


def test_f8_fixture_set():
    assert len(F8_FIXTURES) == 20
    assert {"f8_zstd_512.tif", "f8_lzma_512.tif", "f8_g4_512.tif",
            "f8_jpeg_512.tif"} <= set(F8_FIXTURES)


@pytest.mark.parametrize("name", F8_FIXTURES)
def test_f8_fixture_matches_pil_and_port(name):
    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as f:
        data = f.read()
    stored = load_image(path + PIXELS)
    np.testing.assert_array_equal(pil_rgba(data), stored)
    bound = 1 if name.startswith(("f8_jpeg", "f8_ojpeg")) else 0
    assert np.abs(load_image(path).astype(np.int64) - stored).max() <= bound

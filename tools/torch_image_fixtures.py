"""Write the image fixtures of the port's decoders, with PIL's pixels.

    python3 tools/torch_image_fixtures.py [--check]

The JAX package reads every texture through PIL
(``Image.open(path).convert("RGBA")``); the port decodes PNG, JPEG, WebP,
GIF, BMP and baseline TIFF itself (voidin_tpu_torch/io/image.py, jpeg.py,
webp.py, gif.py, bmp.py, tiff.py). The host of the card
has no PIL, so this script writes, where PIL exists, one file of each
class the port reads beyond baseline JPEG and plain PNG into
``tests/data/torch_images/``, and beside each ``<file>`` the RGBA
pixels PIL's ``convert("RGBA")`` gives it as ``<file>.rgba.png`` (8-bit
RGBA, every row Sub-filtered; the port's decode_png reads it exactly):

- progressive JPEG (4:2:0 at 512x512 from a smooth procedural image, 4:4:4
  with restart markers, greyscale, optimized 4:2:2), written by PIL;
- CMYK JPEG (Adobe marker, baseline and progressive), written by PIL;
- YCCK, true 4:1:1 (luma 4x1), 4:4:0 (luma 1x2), mixed factors and Adobe
  RGB JPEGs, which PIL cannot write: tests/torch_image_writers.py's
  baseline writer makes them, PIL decodes them;
- Adam7 and 16-bit PNGs of every colour type (16-bit grey clamped at 255,
  16-bit RGB with a tRNS key), written by the same test module;
- lossless JPEG (SOF3: grey at predictor 7; RGB at 4:2:0 with a restart
  interval) and arithmetic-coded JPEG (SOF9 at 4:2:0 with a DAC marker
  and restarts; SOF10 at 4:4:4, and at 4:2:0 and 512x512), which PIL
  reads but cannot write: the same test module writes them;
- progressive JPEGs that libjpeg's block smoothing acts on: PIL's own
  progressive file cut after 3 of its 10 scans, a DC-only file, and one
  whose Al > 0 bands are never refined;
- WebP (more_formats): PIL's lossy, lossy with alpha, lossless, lossless
  with alpha, palette, animated and 512x512 lossy files, the writer's
  animation whose first frame sits at an offset over a background
  colour, and PIL's lossy file re-coded by the writer with the simple
  loop filter and sharpness, and with 4 token partitions, loop-filter
  deltas and relative segment values (``vp8_variant``);
- GIF: PIL's (global palette; transparency) and the writer's (a local
  palette and a first frame smaller than the screen, the interlace, a
  palette shorter than the indices);
- BMP: PIL's (8-bit palette, 24-bit, 1-bit) and the writer's (RLE8 with
  a delta, RLE4, 5-6-5 bitfields, 16-bit BI_RGB, the OS/2 core header, a
  top-down V5 with alpha bitfields, 32-bit BI_RGB);
- TIFF: PIL's with each compression it writes (none, LZW, Deflate,
  PackBits) and the writer's (tiles with predictor 2, big-endian planar
  Deflate strips, old-style LZW, a 4-bit palette, CMYK, big-endian 16-bit
  grey with predictor 2, 1-bit WhiteIsZero with FillOrder 2, associated
  alpha, 16-bit RGB with Orientation 6).

The files are made from fixed seeds. ``--check`` writes nothing: it
re-decodes every fixture there with PIL and exits non-zero where PIL's
pixels differ from the stored ones (tests/test_torch_image_formats.py
does the same, and holds the port's decoders to them). Rerun the script
after a change of PIL that moves its pixels, and commit the files.
"""

import argparse
import glob
import io
import os
import struct
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_DIR = os.path.join(HERE, "tests", "data", "torch_images")
PIXELS = ".rgba.png"


def smooth_image(h, w):
    """A smooth procedural RGB field (u8)."""
    y, x = np.mgrid[0:h, 0:w] / np.float32(max(h, w))
    img = np.stack([0.5 + 0.45 * np.sin(7 * x + 3 * y),
                    0.5 + 0.45 * np.cos(5 * y - 4 * x),
                    0.2 + 0.7 * x * y], -1)
    return (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)


def textured_image(h, w, seed):
    """A smooth field with a hard-edged patch and a little noise (u8)."""
    rng = np.random.default_rng(seed)
    img = smooth_image(h, w).astype(np.float64)
    img[h // 3:h // 2, w // 4:w // 2] = [230, 50, 25]
    img += rng.normal(0, 3, img.shape)
    return np.clip(img + 0.5, 0, 255).astype(np.uint8)


def fixtures():
    """{file name: bytes} of every fixture."""
    from PIL import Image

    from tests.torch_image_writers import (arith_jpeg_bytes, jpeg_bytes,
                                           lossless_jpeg_bytes, png_bytes,
                                           progressive_jpeg_bytes,
                                           simple_progression)
    from voidin_tpu_torch.io.jpeg import _rgb_to_ycc

    def pil_jpeg(img, mode=None, **kw):
        im = Image.fromarray(img)
        if mode:
            im = im.convert(mode)
        b = io.BytesIO()
        im.save(b, format="JPEG", **kw)
        return b.getvalue()

    tex = textured_image(37, 53, 0)
    ycc = list(_rgb_to_ycc(tex))
    k = np.linspace(0, 255, 53).astype(np.uint8)[None].repeat(37, 0)
    rng = np.random.default_rng(1)
    rgb = [tex[..., i] for i in range(3)]
    every = [0, 1, 2]
    pil_progressive = pil_jpeg(tex, progressive=True, quality=80)
    sos = [i for i in range(len(pil_progressive) - 1)
           if pil_progressive[i:i + 2] == b"\xff\xda"]
    out = {
        "progressive_420_512.jpg": pil_jpeg(smooth_image(512, 512),
                                            progressive=True, quality=90),
        "progressive_444_restart.jpg": pil_jpeg(
            tex, progressive=True, quality=75, subsampling=0,
            restart_marker_blocks=3),
        "progressive_grey.jpg": pil_jpeg(tex[..., 1], progressive=True,
                                         quality=92),
        "progressive_422_optimized.jpg": pil_jpeg(
            tex, progressive=True, optimize=True, quality=50, subsampling=1),
        "cmyk_adobe.jpg": pil_jpeg(tex, "CMYK", quality=85),
        "cmyk_progressive.jpg": pil_jpeg(tex, "CMYK", progressive=True),
        "ycck.jpg": jpeg_bytes(ycc + [k], [(2, 2), (1, 1), (1, 1), (2, 2)],
                               adobe=2, jfif=False),
        "sampling_411.jpg": jpeg_bytes(ycc, [(4, 1), (1, 1), (1, 1)]),
        "sampling_440.jpg": jpeg_bytes(ycc, [(1, 2), (1, 1), (1, 1)]),
        "sampling_mixed_scans.jpg": jpeg_bytes(
            ycc, [(2, 2), (1, 2), (2, 1)], interleaved=False),
        "adobe_rgb.jpg": jpeg_bytes([tex[..., i] for i in range(3)],
                                    [(1, 1)] * 3, adobe=0, jfif=False),
        "rgba8_adam7.png": png_bytes(
            np.concatenate([tex, rng.integers(0, 256, (37, 53, 1))], -1),
            8, 6, interlace=True, seed=2),
        "grey16.png": png_bytes(rng.integers(0, 600, (21, 19, 1)), 16, 0,
                                seed=3),
        "rgb16_trns_adam7.png": png_bytes(
            tex.astype(np.uint16) * 257, 16, 2, interlace=True,
            trns=struct.pack(">HHH", *(tex[0, 0].astype(int) * 257)),
            seed=4),
        "grey_alpha16.png": png_bytes(rng.integers(0, 65536, (13, 7, 2)),
                                      16, 4, seed=5),
        "rgba16_adam7.png": png_bytes(rng.integers(0, 65536, (9, 11, 4)),
                                      16, 6, interlace=True, seed=6),
        "grey2_trns_adam7.png": png_bytes(
            rng.integers(0, 4, (15, 6, 1)), 2, 0, interlace=True,
            trns=struct.pack(">H", 170), seed=7),
        "palette4_adam7.png": png_bytes(
            rng.integers(0, 16, (10, 23, 1)), 4, 3, interlace=True,
            plte=rng.integers(0, 256, (16, 3)),
            trns=bytes(rng.integers(0, 256, 9).astype(np.uint8)), seed=8),
        "lossless_grey_p7.jpg": lossless_jpeg_bytes([tex[..., 1]],
                                                    predictor=7),
        "lossless_420_restart.jpg": lossless_jpeg_bytes(
            rgb, [(2, 2), (1, 1), (1, 1)], predictor=6, pt=1,
            restart_rows=2),
        "arith_420_dac.jpg": arith_jpeg_bytes(
            ycc, [(2, 2), (1, 1), (1, 1)], quality=80,
            conditioning=(1, 4, 12), restart=3),
        "arith_progressive_444.jpg": arith_jpeg_bytes(
            ycc, [(1, 1)] * 3, quality=85, script=simple_progression(3)),
        "arith_progressive_420_512.jpg": arith_jpeg_bytes(
            list(_rgb_to_ycc(smooth_image(512, 512))),
            [(2, 2), (1, 1), (1, 1)], quality=90,
            script=simple_progression(3)),
        "smooth_cut3.jpg": pil_progressive[:sos[3]] + b"\xff\xd9",
        "smooth_dc_only.jpg": progressive_jpeg_bytes(
            ycc, [(2, 2), (1, 1), (1, 1)], [(every, 0, 0, 0, 0)],
            quality=75),
        "smooth_unrefined_al.jpg": progressive_jpeg_bytes(
            ycc, [(2, 1), (1, 1), (1, 1)],
            [(every, 0, 0, 0, 1), ([0], 1, 5, 0, 2), ([0], 6, 63, 0, 1),
             ([1], 1, 63, 0, 1), ([2], 1, 63, 0, 2)], quality=85),
    }
    out.update(more_formats(tex))
    out.update(f8_formats(tex))
    return out


def more_formats(tex):
    """{file name: bytes} of the WebP, GIF, BMP and TIFF fixtures: PIL's
    own writer where it writes the form, tests/torch_image_writers.py
    where it does not."""
    from PIL import Image

    from tests.torch_image_writers import (bmp_bytes, gif_bytes, riff_chunks,
                                           tiff_bytes, vp8_variant,
                                           webp_anim_bytes)

    rng = np.random.default_rng(7)
    h, w = tex.shape[:2]
    alpha = (np.indices((h, w)).sum(0) * 5 % 256).astype(np.uint8)
    rgba = np.concatenate([tex, alpha[..., None]], -1)

    def pil(img, fmt, mode=None, **kw):
        im = Image.fromarray(img)
        if mode:
            im = im.convert(mode)
        b = io.BytesIO()
        im.save(b, format=fmt, **kw)
        return b.getvalue()

    def still(img, **kw):
        return [c for c in riff_chunks(pil(img, "WEBP", **kw))
                if c[0] in (b"ALPH", b"VP8 ", b"VP8L")]

    frames = [Image.fromarray(rgba), Image.fromarray(rgba[::-1])]
    b = io.BytesIO()
    frames[0].save(b, format="WEBP", save_all=True, append_images=frames[1:],
                   duration=80, quality=70)
    pal16 = rng.integers(0, 256, (16, 3))
    idx16 = rng.integers(0, 16, (h, w))
    idx16[5:15, 10:40] = 3
    pal256 = rng.integers(0, 256, (256, 3))
    assoc = rgba.astype(np.int64)
    assoc[..., :3] = assoc[..., :3] * assoc[..., 3:] // 255
    out = {
        # WebP: PIL writes each still form and the animation
        "webp_lossy.webp": pil(tex, "WEBP", quality=80),
        "webp_lossy_alpha.webp": pil(rgba, "WEBP", quality=75),
        "webp_lossless.webp": pil(tex, "WEBP", lossless=True),
        "webp_lossless_alpha.webp": pil(rgba, "WEBP", lossless=True,
                                        exact=True),
        "webp_lossless_palette.webp": pil(
            pal16[idx16 % 5].astype(np.uint8), "WEBP", lossless=True),
        "webp_animated.webp": b.getvalue(),
        "webp_lossy_512.webp": pil(smooth_image(512, 512), "WEBP",
                                   quality=90),
        # an animation whose first frame sits at an offset on a larger
        # canvas, over a background colour decoders ignore
        # VP8 header fields PIL's encoder never sets, re-coded from PIL's
        # lossy file by the writer: the simple loop filter with sharpness,
        # and 4 token partitions with loop-filter deltas and relative
        # segment values
        "webp_vp8_simple_filter.webp": vp8_variant(
            pil(tex, "WEBP", quality=60), simple=True, sharpness=5),
        "webp_vp8_partitions_deltas.webp": vp8_variant(
            pil(tex, "WEBP", quality=60), n_parts=4, sharpness=2,
            lf_deltas=((-9, 2, 0, 1), (14, -3, 0, 2)),
            relative_segments=True),
        "webp_anim_offset.webp": webp_anim_bytes(
            [(still(rgba[:20, :30], lossless=True), (6, 4), (30, 20)),
             (still(rgba, quality=60), (0, 0), (w, h))], (w, h),
            background=(255, 0, 0, 255)),
        # GIF: PIL's (global palette; transparency), then the writer's
        "gif_pil.gif": pil(pal256[idx16].astype(np.uint8), "GIF"),
        "gif_pil_transparency.gif": pil(idx16.astype(np.uint8), "GIF",
                                        transparency=3),
        "gif_local_small_frame.gif": gif_bytes(
            idx16[:20, :30], 4, global_palette=pal16[::-1],
            local_palette=pal16, screen=(w, h), origin=(9, 7),
            transparency=5),
        "gif_interlaced.gif": gif_bytes(idx16, 4, global_palette=pal16,
                                        interlace=True),
        "gif_short_palette.gif": gif_bytes(
            rng.integers(0, 256, (h, w)), 8, global_palette=pal16[:4]),
        # BMP: PIL's (8-bit palette, 24-bit, 1-bit), then the writer's
        "bmp_pil_palette.bmp": pil(pal256[idx16].astype(np.uint8), "BMP",
                                   mode="P"),
        "bmp_pil_rgb.bmp": pil(tex, "BMP"),
        "bmp_pil_1bit.bmp": pil(tex, "BMP", mode="1"),
        "bmp_rle8.bmp": bmp_bytes(idx16, 8, compression=1, palette=pal256,
                                  delta_row=6),
        "bmp_rle4.bmp": bmp_bytes(idx16, 4, compression=2, palette=pal16),
        "bmp_bitfields_565.bmp": bmp_bytes(
            rng.integers(0, 65536, (h, w)), 16, compression=3,
            masks=(0xF800, 0x7E0, 0x1F)),
        "bmp_rgb555.bmp": bmp_bytes(rng.integers(0, 65536, (h, w)), 16),
        "bmp_os2.bmp": bmp_bytes(idx16, 4, header=12, palette=pal16),
        "bmp_v5_topdown_alpha.bmp": bmp_bytes(
            rgba[..., 3].astype(np.uint32) << 24
            | rgba[..., 0].astype(np.uint32) << 16
            | rgba[..., 1].astype(np.uint32) << 8 | rgba[..., 2], 32,
            header=124, compression=3,
            masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000), top_down=True),
        "bmp_32_rgb.bmp": bmp_bytes(rng.integers(0, 2 ** 32, (h, w),
                                                 dtype=np.uint64), 32),
        # TIFF: PIL's writer with each compression it writes, then the
        # writer's layouts
        "tiff_pil_raw.tif": pil(tex, "TIFF"),
        "tiff_pil_lzw.tif": pil(rgba, "TIFF", compression="tiff_lzw"),
        "tiff_pil_deflate.tif": pil(tex, "TIFF",
                                    compression="tiff_adobe_deflate"),
        "tiff_pil_packbits.tif": pil(tex, "TIFF", mode="L",
                                     compression="packbits"),
        "tiff_tiles_predictor.tif": tiff_bytes(tex, 8, 2, compression=5,
                                               predictor=2, tile=(16, 16)),
        "tiff_planar_mm.tif": tiff_bytes(tex, 8, 2, byteorder="MM",
                                         compression=8, planar=2,
                                         rows_per_strip=8),
        "tiff_old_lzw.tif": tiff_bytes(tex, 8, 2, compression=5,
                                       old_lzw=True),
        "tiff_palette4.tif": tiff_bytes(
            idx16, 4, 3, compression=32773,
            colormap=rng.integers(0, 65536, (3, 16))),
        "tiff_cmyk.tif": tiff_bytes(rng.integers(0, 256, (h, w, 4)), 8, 5,
                                    compression=5),
        "tiff_grey16_mm.tif": tiff_bytes(rng.integers(0, 600, (h, w)), 16,
                                         1, byteorder="MM", compression=8,
                                         predictor=2),
        "tiff_miniswhite_1bit.tif": tiff_bytes(
            rng.integers(0, 2, (h, w)), 1, 0, fillorder=2),
        "tiff_rgba_associated.tif": tiff_bytes(assoc, 8, 2, compression=8,
                                               extra=(1,)),
        "tiff_rgb16_orientation.tif": tiff_bytes(
            rng.integers(0, 65536, (h, w, 3)), 16, 2, compression=5,
            orientation=6),
    }
    return out


F8_SIZE = 512  # the files phase 18 of chip_smoke.py times per megapixel


def f8_formats(tex):
    """The TIFF forms PIL opens through libtiff beyond baseline TIFF
    (ROADMAP.md F8): PIL's files where PIL writes the form, the writer's
    where it cannot; 512x512 ZSTD, LZMA, G4 and JPEG-in-TIFF files of the
    smooth field, which phase 18 times."""
    from PIL import Image

    from tests.torch_image_writers import (jpeg_tiff_bytes,
                                           ojpeg_tiff_bytes, tiff_bytes)

    rng = np.random.default_rng(14)
    h, w = tex.shape[:2]

    def pil(img, mode=None, **kw):
        im = Image.fromarray(img)
        if mode:
            im = im.convert(mode)
        b = io.BytesIO()
        im.save(b, format="TIFF", **kw)
        return b.getvalue()

    big = smooth_image(F8_SIZE, F8_SIZE)
    ycc = np.asarray(Image.fromarray(tex).convert("YCbCr"))
    b = io.BytesIO()
    Image.fromarray(tex).save(b, format="JPEG", quality=85)
    floats = (rng.normal(100, 120, (h, w))).astype(np.float32)
    return {
        "f8_zstd_512.tif": pil(big, "L", compression="zstd"),
        "f8_lzma_512.tif": pil(big, "L", compression="lzma"),
        "f8_g4_512.tif": pil(big, "1", compression="group4"),
        "f8_jpeg_512.tif": pil(big, compression="jpeg", quality=85),
        "f8_pil_bigtiff.tif": pil(tex, compression="tiff_lzw",
                                    big_tiff=True),
        "f8_bigtiff_tiles.tif": tiff_bytes(
            tex, 8, 2, compression=8, tile=(16, 16), bigtiff=True),
        "f8_float_pred3_zstd.tif": pil(floats, "F", compression="zstd",
                                         tiffinfo={317: 3}),
        "f8_int32_lzma.tif": pil(floats.astype(np.int32), "I",
                                   compression="lzma"),
        "f8_signed16_mm.tif": tiff_bytes(
            rng.integers(0, 65536, (h, w)), 16, 1, byteorder="MM",
            compression=5, sample_format=2),
        "f8_g3_2d_fill2.tif": pil(tex, "1", compression="group3",
                                    tiffinfo={292: 5, 266: 2}),
        "f8_ccitt_rle_whiteiszero.tif": pil(
            tex, "1", compression="tiff_ccitt", tiffinfo={262: 0}),
        "f8_jpeg_ycbcr_tables.tif": jpeg_tiff_bytes(
            [ycc[..., k] for k in range(3)], 6, 16,
            ((2, 2), (1, 1), (1, 1))),
        "f8_ojpeg_420.tif": ojpeg_tiff_bytes(b.getvalue(), w, h, (2, 2)),
        "f8_ycbcr_lzw_42.tif": tiff_bytes(
            ycc, 8, 6, compression=5, ycbcr=(4, 2),
            tags={532: (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240,
                            1])}),
        # uncompressed YCbCr, which PIL's raw reader reads as RGBX,
        # running on past the strip into the bytes after it
        "f8_ycbcr_raw_misread.tif": tiff_bytes(
            ycc, 8, 6, ycbcr=(2, 2)) + bytes(range(256)) * 24,
        "f8_cielab_lzw.tif": tiff_bytes(
            rng.integers(0, 256, (h, w, 3)), 8, 8, compression=5),
        "f8_planar_rgb16_tiles.tif": tiff_bytes(
            rng.integers(0, 65536, (h, w, 3)), 16, 2, planar=2,
            tile=(16, 16)),
        "f8_planar_grey4.tif": tiff_bytes(
            rng.integers(0, 16, (h, w)), 4, 1, planar=2) + bytes(2048),
        "f8_planar_rgba_tiles.tif": tiff_bytes(
            np.concatenate([tex, tex[..., :1]], -1), 8, 2, planar=2,
            tile=(16, 16)),
        "f8_planar_palette_extra.tif": tiff_bytes(
            rng.integers(0, 256, (12, w, 2)), 8, 3, planar=2, tile=(16, 16),
            colormap=rng.integers(0, 65536, (3, 256)), extra=(0,),
            compression=8),
    }


def pil_pixels(data):
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def fixture_files():
    """The fixture files (not their stored pixels)."""
    return sorted(p for p in glob.glob(os.path.join(FIXTURE_DIR, "*"))
                  if not p.endswith(PIXELS))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    from tests.torch_image_writers import png_bytes

    if args.check:
        from voidin_tpu_torch.io.image import load_image

        bad = 0
        for path in fixture_files():
            with open(path, "rb") as f:
                want = pil_pixels(f.read())
            stored = load_image(path + PIXELS)
            ok = want.shape == stored.shape and (want == stored).all()
            bad += not ok
            print(f"{os.path.basename(path)}: {'ok' if ok else 'DIFFERS'}")
        sys.exit(1 if bad else 0)
    os.makedirs(FIXTURE_DIR, exist_ok=True)
    total = 0
    for name, data in fixtures().items():
        pixels = png_bytes(pil_pixels(data), 8, 6, filter_type=1)
        for path, body in ((name, data), (name + PIXELS, pixels)):
            with open(os.path.join(FIXTURE_DIR, path), "wb") as f:
                f.write(body)
            total += len(body)
        print(f"{name}: {len(data)} B, PIL pixels {len(pixels)} B")
    print(f"{total} B in {FIXTURE_DIR}")


if __name__ == "__main__":
    main()

"""Write the image fixtures of the port's decoders, with PIL's pixels.

    python3 tools/torch_image_fixtures.py [--check]

The JAX package reads every texture through PIL
(``Image.open(path).convert("RGBA")``); the port decodes PNG and JPEG
itself (voidin_tpu_torch/io/image.py, io/jpeg.py). The host of the card
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
  whose Al > 0 bands are never refined.

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
    return out


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

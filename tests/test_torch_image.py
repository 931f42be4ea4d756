"""Port parity: image I/O (voidin_tpu_torch.io.image, written with zlib
and struct, no PIL) against the JAX package's PIL-based io/image.py.

save_png: the port's file decodes (with PIL) to the same array as the
JAX package's file of the same image, for float images (clipped, NaN as
0, rounded to 256 steps) and uint8 RGB and RGBA. load_image: every golden
image reads as JAX's load_image reads it, and what the port writes reads
back unchanged. Anything but 8-bit RGB/RGBA non-interlaced PNG is refused.
"""

import glob
import os

import numpy as np
import pytest
from PIL import Image

from voidin_tpu.io import image as j_image

from voidin_tpu_torch.io import image as t_image

from tests.test_golden import GOLDEN_DIR


def _images():
    rng = np.random.default_rng(0)
    f = rng.uniform(-0.2, 1.2, (17, 23, 3)).astype(np.float32)
    f[0, 0, 0], f[1, 1, 1] = np.nan, np.inf
    return dict(
        float_rgb=f,
        float_rgba=rng.uniform(0, 1, (9, 5, 4)),
        u8_rgb=rng.integers(0, 256, (12, 30, 3)).astype(np.uint8),
        u8_rgba=rng.integers(0, 256, (31, 7, 4)).astype(np.uint8),
    )


@pytest.mark.parametrize("name", sorted(_images()))
def test_save_png_decodes_like_jax(tmp_path, name):
    img = _images()[name]
    port, jax_file = tmp_path / "port.png", tmp_path / "jax.png"
    t_image.save_png(str(port), img)
    j_image.save_png(str(jax_file), img)
    got = np.asarray(Image.open(port))
    np.testing.assert_array_equal(got, np.asarray(Image.open(jax_file)))
    np.testing.assert_array_equal(t_image.load_image(str(port)),
                                  j_image.load_image(str(jax_file)))


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(GOLDEN_DIR,
                                                               "*.png"))),
                         ids=os.path.basename)
def test_load_image_reads_goldens_like_jax(path):
    got = t_image.load_image(path)
    assert got.dtype == np.uint8 and got.shape[-1] == 4
    np.testing.assert_array_equal(got, j_image.load_image(path))


def test_load_image_reads_every_filter(tmp_path):
    """A PIL-written PNG (adaptive filters: sub, up, average, Paeth)."""
    rng = np.random.default_rng(1)
    img = np.cumsum(rng.integers(0, 9, (40, 50, 4)), axis=1).astype(np.uint8)
    path = tmp_path / "pil.png"
    Image.fromarray(img).save(path, optimize=True)
    np.testing.assert_array_equal(t_image.load_image(str(path)), img)


@pytest.mark.parametrize("mode", ["L", "P", "I;16"])
def test_refuses_other_pngs(tmp_path, mode):
    path = tmp_path / "other.png"
    Image.new(mode, (4, 3)).save(path)
    with pytest.raises(ValueError):
        t_image.load_image(str(path))


def test_save_png_refuses_other_shapes(tmp_path):
    with pytest.raises(ValueError):
        t_image.save_png(str(tmp_path / "x.png"), np.zeros((4, 4)))

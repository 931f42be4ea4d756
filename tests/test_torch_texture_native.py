"""Port parity: the native texture packer (voidin_tpu_torch/native,
texture_packer.cpp) and the pool TexturePool.host_arrays builds with it,
against the JAX package's TexturePool.device().

- The port's default pool equals JAX's default pool word for word: on
  random RGBA textures of 1x1, 48x80, 200x130 (odd sizes down the mip
  chain, where the two packers part), 37x11 and 256x256, and on configs 6
  and 7 at the reduced arguments of tests/test_torch_presets.py.
- The port's numpy packer (_pack_numpy) equals JAX's numpy packer word for
  word on the same textures.
- The port's native pool against its numpy pool under the gates of
  tests/test_io.py:128-165: mip levels 0-3 exact, deeper levels within 3
  u8 steps.
- packer() says "numpy" under VOIDIN_NATIVE=0, and the pool is then the
  numpy one; the library's name hashes both C++ sources; pack_texture
  refuses input the C packer would write past its rows for.
"""

import numpy as np
import pytest
import torch

import voidin_tpu.native
from voidin_tpu.framework import presets as j_presets
from voidin_tpu.scene import texture as j_texture

from voidin_tpu_torch import native as t_native
from voidin_tpu_torch.framework import presets as t_presets
from voidin_tpu_torch.scene import texture as t_texture

from tests.test_torch_presets import SMALL
from tests.test_torch_scene import load_jax_native

torch.set_num_threads(2)

SHAPES = {"1x1": (1, 1), "48x80": (48, 80), "200x130": (200, 130),
          "37x11": (37, 11), "256x256": (256, 256)}


def _texture(name):
    rng = np.random.default_rng(sorted(SHAPES).index(name))
    return rng.integers(0, 256, SHAPES[name] + (4,), dtype=np.uint8)


def _pools(img):
    jp, tp = j_texture.TexturePool(1024), t_texture.TexturePool(1024)
    jp.add(img)
    tp.add(img)
    return jp, tp


def _jax_quads(pool):
    return np.asarray(pool.device(blocks=False).quads)


@pytest.fixture
def native_lib():
    if t_native.load() is None or load_jax_native() is None:
        pytest.fail("no host C++ compiler: the native packers are absent")


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_default_pool_matches_jax_default(name, native_lib):
    jp, tp = _pools(_texture(name))
    assert t_native.packer() == "native"
    want = _jax_quads(jp)
    got = tp.host_arrays()["quads"]
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [6, 7])
def test_textured_preset_pools_match_jax_default(n, native_lib):
    jp = j_presets.PRESETS[n](16 / 9, **SMALL[n])
    tp = t_presets.PRESETS[n](16 / 9, **SMALL[n])
    want = _jax_quads(jp.world.textures)
    got = tp.world.textures.host_arrays()
    np.testing.assert_array_equal(got["quads"], want)
    js = jp.world.textures.device(blocks=False)
    for k in ("size", "max_lod", "srgb"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(js, k)))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_numpy_pool_matches_jax_numpy(name, monkeypatch):
    jp, tp = _pools(_texture(name))
    monkeypatch.setattr(voidin_tpu.native, "pack_texture",
                        lambda *a, **k: None)
    monkeypatch.setattr(t_native, "pack_texture", lambda *a, **k: None)
    np.testing.assert_array_equal(tp.host_arrays()["quads"], _jax_quads(jp))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_native_packer_within_numpy_gates(name, native_lib):
    """tests/test_io.py:128-165's gates on the port's two packers, per
    texture: every word within 3 steps, and levels 0-3 exact in each
    level's own texels (bytes 0-15 of a row). The parent's resample
    (bytes 16-31) is float32 in C++ and float64 in numpy, so where a level
    halves an odd size it may part at a fine level too: 200x130's level 1
    (100x65, its parent 50x32) does, in both packages alike. Printed, the
    words where the packers part, by level."""
    img = _texture(name)
    S = 1
    while S < max(img.shape[:2]):
        S *= 2
    sizes = t_texture._mip_sizes(S)
    total = sum(s * s for s in sizes)
    native = t_native.pack_texture(img, S, total).astype(np.int32)
    plain = t_texture._pack_numpy(img, S).astype(np.int32)
    fine = sum(s * s for s in sizes[:4])
    np.testing.assert_array_equal(native[:fine, :16], plain[:fine, :16])
    diff = np.abs(native - plain)
    offsets = np.cumsum([0] + [s * s for s in sizes])
    parted = {li: int((diff[offsets[li]:offsets[li + 1]] > 0).sum())
              for li in range(len(sizes))}
    print(f"{name}: words that part by level "
          f"{ {k: v for k, v in parted.items() if v} }, max {diff.max()}")
    assert diff.max() <= 3
    # the JAX package's two packers part at the same words
    jp = j_texture.TexturePool(1024)
    jp.add(img)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(voidin_tpu.native, "pack_texture", lambda *a, **k: None)
        jax_plain = _jax_quads(jp)
    jax_native = _jax_quads(jp)
    np.testing.assert_array_equal(
        np.flatnonzero(jax_native != jax_plain),
        np.flatnonzero(np.concatenate([np.zeros((4 * total, 32), np.int32),
                                       diff]) != 0))


def test_packer_under_voidin_native_0(monkeypatch, native_lib):
    img = _texture("200x130")
    _, tp = _pools(img)
    native = tp.host_arrays()["quads"]
    monkeypatch.setenv("VOIDIN_NATIVE", "0")
    assert t_native.packer() == "numpy"
    total = sum(s * s for s in t_texture._mip_sizes(256))
    assert t_native.pack_texture(img, 256, total) is None
    plain = tp.host_arrays()["quads"]
    np.testing.assert_array_equal(plain[-total:],
                                  t_texture._pack_numpy(img, 256))
    assert (plain != native).any()  # 200x130's deep levels part
    monkeypatch.delenv("VOIDIN_NATIVE")
    assert t_native.packer() == "native"


def test_library_name_hashes_both_sources(tmp_path, monkeypatch):
    """An edit to either C++ source, or to the flags, names another
    library, so the next load builds it anew."""
    srcs = []
    for src in t_native._SRCS:
        copy = tmp_path / src.rsplit("/", 1)[-1]
        copy.write_bytes(open(src, "rb").read())
        srcs.append(str(copy))
    monkeypatch.setattr(t_native, "_SRCS", srcs)
    names = {t_native.library_path()}
    for src in srcs:
        with open(src, "a") as f:
            f.write("\n// edited\n")
        names.add(t_native.library_path())
    monkeypatch.setattr(t_native, "FLAGS", t_native.FLAGS + ["-g"])
    names.add(t_native.library_path())
    assert len(names) == 4


def test_pack_texture_refuses_what_overruns_its_rows(native_lib):
    """The C packer writes a level's texels into rows sized by `base`: a
    texture larger than base, a base that is no power of two, a row count
    that is not base's, or a texture that is not (h, w, 4) never reaches
    it."""
    total = sum(s * s for s in t_texture._mip_sizes(64))
    ok = np.zeros((64, 40, 4), np.uint8)
    assert t_native.pack_texture(ok, 64, total).shape == (total, 32)
    for img, base, rows in ((np.zeros((65, 8, 4), np.uint8), 64, total),
                            (ok, 48, total), (ok, 64, total - 1),
                            (np.zeros((8, 8, 3), np.uint8), 64, total)):
        with pytest.raises(ValueError, match="pack_texture"):
            t_native.pack_texture(img, base, rows)

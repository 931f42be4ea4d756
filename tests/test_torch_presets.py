"""Port parity: the BASELINE presets (voidin_tpu_torch.framework.presets)
against the JAX package's (voidin_tpu/framework/presets.py).

- Every preset of PRESETS builds the same World in both packages: every
  host leaf (meshes with their LOD tables and BLASes, instances,
  materials, lights, textures, skins) equal word for word, with both
  packages pinned to one BVH builder as tests/test_torch_bvh.py pins them,
  and the same Preset fields and camera uniform. Configs 6 and 7 run at
  the reduced arguments of tests/test_stress.py and tests/test_oracle.py.
- The device-bytes arithmetic of tests/test_stress.py on the port's
  pool_device_bytes, and config 6's procedural fallback.

The frames of the presets against the JAX frames and the numpy oracle are
in tests/test_torch_preset_frames.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import voidin_tpu as vt
import voidin_tpu.native
from voidin_tpu.framework import presets as j_presets

from voidin_tpu_torch.framework import presets as t_presets
from voidin_tpu_torch.scene.skin import skin_statics
from voidin_tpu_torch.scene.texture import pool_device_bytes

from tests.test_torch_bvh import builder  # noqa: F401 (fixture)
from tests.test_torch_scene import jax_leaves

torch.set_num_threads(2)

# The reduced arguments of tests/test_stress.py:52 (config 6) and
# tests/test_oracle.py:265 (config 7); the others at their defaults.
SMALL = {6: dict(base_size=64, n_textures=12, n_knots=2,
                 knot_detail=(48, 8)),
         7: dict(n_textures=8, base_size=64, detail=0.15)}

# The fields both packages' Presets hold (the JAX one also holds the TPU's
# edge capacities and traversal switches, which the port leaves out).
SHARED_FIELDS = ("moving_ids", "enable_cull", "enable_taa",
                 "enable_rt_shadows", "rt_shadow_scale", "with_tlas",
                 "tri_capacity", "pair_capacity", "tile_tri_capacity")


def assert_worlds_equal(jax_world, port_world, with_tlas=False):
    """Every host leaf of the port's World equal to the JAX World's leaf of
    the same name (dtype, shape and words), and the same statics."""
    js = jax_world.device(with_tlas=with_tlas, tap_blocks=False)
    jl = jax_leaves(js)
    pl = port_world.host_leaves(with_tlas=with_tlas)
    assert any(k.startswith("skins.") for k in pl) == bool(js.skins)
    for k, v in pl.items():
        if k in ("meshes.indices", "meshes.vertex_offset"):
            # host streams only: no SceneData leaf carries them
            a = np.asarray(jax_world.meshes.host_arrays()[k[7:]])
        else:
            assert k in jl, k
            a = np.asarray(jl[k])
        b = np.asarray(v)
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype,
                                                           b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)
    for k, v in port_world.statics().items():
        want = getattr(js, k)
        if k == "skins":
            want = tuple(skin_statics(s) for s in want)
        assert want == v, k


@pytest.fixture
def numpy_textures(monkeypatch):
    """The JAX texture pool on its numpy packer, as the port packs."""
    monkeypatch.setattr(voidin_tpu.native, "pack_texture",
                        lambda *a, **k: None)


@pytest.mark.parametrize("n", sorted(t_presets.PRESETS))
def test_preset_world_matches_jax(n, builder, numpy_textures):  # noqa: F811
    assert sorted(t_presets.PRESETS) == sorted(j_presets.PRESETS)
    aspect = 16 / 9
    jp = j_presets.PRESETS[n](aspect, **SMALL.get(n, {}))
    tp = t_presets.PRESETS[n](aspect, **SMALL.get(n, {}))
    assert_worlds_equal(jp.world, tp.world, with_tlas=tp.with_tlas)
    for f in SHARED_FIELDS:
        assert getattr(jp, f) == getattr(tp, f), f
    assert (jp.animator is None) == (tp.animator is None)
    ju, tu = jp.camera.uniform(), tp.camera.uniform()
    for f in dataclasses.fields(tu):
        np.testing.assert_array_equal(np.asarray(getattr(ju, f.name)),
                                      np.asarray(getattr(tu, f.name)),
                                      err_msg=f.name)


@pytest.mark.parametrize("t", [0.0, 0.35, 0.7, 2.9])
def test_clapper_joint_mats_match_jax(t):
    np.testing.assert_array_equal(j_presets.clapper_joint_mats(t),
                                  t_presets.clapper_joint_mats(t))


def test_config2_lod_chain():
    """Config 2's knot carries the 3-level LOD chain of presets.py:105,
    in the LOD table that emit_draws reads."""
    p = t_presets.config2_instanced_cull(16 / 9, n_instances=10)
    h = p.world.meshes.host_arrays()
    np.testing.assert_array_equal(h["lod_table"][4], [4, 5, 6, 7])
    np.testing.assert_array_equal(h["lod_thresh"][4], [0.0, 5.0, 12.0, 24.0])
    assert (h["lod_table"][5:, 1:] == -1).all()
    assert len(p.world.instances) == 10


@pytest.mark.parametrize("cells", [1, 3, 8, 24])
def test_decimate_grid_matches_jax(cells):
    """decimate_grid of both packages gives the same mesh word for word;
    tests/test_raster.py:567's knot at 8 cells, two more grids and the
    one-cell grid, where every triangle collapses and one is kept."""
    from voidin_tpu.scene import mesh as j_mesh
    from voidin_tpu_torch.scene import mesh as t_mesh

    knot = j_mesh.make_torus_knot(segments=96, sides=16)
    jm = j_mesh.decimate_grid(knot, cells)
    tm = t_mesh.decimate_grid(t_mesh.make_torus_knot(segments=96, sides=16),
                              cells)
    for f in ("vertices", "normals", "tangents", "uvs", "indices"):
        a, b = getattr(jm, f), getattr(tm, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert jm.indices.size < knot.indices.size


@pytest.mark.parametrize("ratios, cells", [((6.0, 16.0), (12, 7)),
                                           ((10.0, 25.0), (24, 10)),
                                           ((4.0, 9.0, 30.0), (48, 2, 1))])
def test_auto_lods_match_jax(ratios, cells, builder):  # noqa: F811
    """MeshPool.add_with_auto_lods of both packages builds the same pool:
    tests/test_raster.py:567's call, the defaults, and a chain whose
    48-cell level does not reduce the knot and is skipped. Every host
    leaf (LOD table and thresholds, BLASes) equal word for word."""
    from voidin_tpu.scene import mesh as j_mesh
    from voidin_tpu_torch.scene import mesh as t_mesh

    worlds = []
    for pkg, mesh in ((vt, j_mesh), (t_presets, t_mesh)):
        w = pkg.World()
        base = w.meshes.add_with_auto_lods(
            mesh.make_torus_knot(segments=96, sides=16), ratios=ratios,
            cells=cells)
        w.instances.add(np.eye(4, dtype=np.float32), base, 0)
        worlds.append((w, base))
    (jw, jbase), (tw, tbase) = worlds
    assert jbase == tbase
    assert jw.meshes.mesh_info[jbase].get("lods") == \
        tw.meshes.mesh_info[tbase].get("lods")
    assert_worlds_equal(jw, tw)


def test_sponza_pool_budget():
    """tests/test_stress.py's budget arithmetic on the port's
    pool_device_bytes: the ~108-slot 1024^2 pool of config 6 (one 32 B
    quad row per texel over the mip chain, ~44.7 MB a slot) fits one H100
    (80 GB) beside a frame's working set. The port builds no tap-block
    tables, so the JAX budget's other side (the 3x block tables) has no
    counterpart here."""
    n_slots = 104 + 4
    plain = pool_device_bytes(n_slots, 1024)
    assert plain < (80 << 30) - (4 << 30), f"{plain / 2**30:.1f} GiB"
    per_slot = pool_device_bytes(1, 1024)
    assert abs(per_slot - (4 / 3) * 1024 * 1024 * 32) / per_slot < 0.01
    assert per_slot == 1398101 * 32
    assert pool_device_bytes(4, 64) == 4 * 5461 * 32
    # the JAX function without its split twins and tap blocks
    from voidin_tpu.scene.texture import pool_device_bytes as j_bytes
    for n, s in ((108, 1024), (12, 64), (1, 1)):
        assert pool_device_bytes(n, s) == j_bytes(n, s, blocks=False)


def test_config6_procedural_fallback(monkeypatch):
    """Without the asset root the preset still builds (procedural
    textures), so the stress configuration runs anywhere; the device pool
    holds exactly pool_device_bytes of quads, sized to its largest image
    (64^2 here, the preset's base size)."""
    monkeypatch.setattr(t_presets, "find_asset", lambda rel: None)
    p = t_presets.config6_sponza_textures(16 / 9, base_size=64,
                                          n_textures=8, n_knots=1)
    assert len(p.world.textures.images) == 4 + 8
    scene = p.world.device("cpu")
    assert scene.textures.base_size == 64
    assert scene.textures.quads.numel() == pool_device_bytes(12, 64)


def test_sponza_texture_set_refuses_jpeg(tmp_path, monkeypatch):
    """With Sponza's texture directory present, PNG and baseline JPEG
    files load through io/image.py (the JPEG to PIL's pixels), and a
    progressive JPEG raises NotImplementedError naming it."""
    import io

    from PIL import Image

    from voidin_tpu_torch.io.image import save_png

    d = tmp_path / "glTF-Sample-Models" / "2.0" / "Sponza" / "glTF"
    d.mkdir(parents=True)
    img = np.zeros((8, 8, 3), np.uint8)
    img[::2] = 200
    save_png(str(d / "a.png"), img)
    monkeypatch.setattr(t_presets, "_ASSET_ROOTS", [str(tmp_path)])
    w = t_presets.World(texture_base_size=64)
    ids = t_presets._sponza_texture_set(w, 3, 64)
    assert len(ids) == 3
    np.testing.assert_array_equal(w.textures.images[ids[0]][..., :3], img)
    Image.fromarray(img).save(d / "b.jpg", quality=90)
    w = t_presets.World(texture_base_size=64)
    ids = t_presets._sponza_texture_set(w, 3, 64)
    want = np.asarray(Image.open(d / "b.jpg").convert("RGBA"))
    np.testing.assert_array_equal(w.textures.images[ids[1]], want)
    b = io.BytesIO()
    Image.fromarray(img).save(b, format="JPEG", progressive=True)
    (d / "a.jpg").write_bytes(b.getvalue())
    with pytest.raises(NotImplementedError, match="a.jpg"):
        t_presets._sponza_texture_set(t_presets.World(), 3, 64)


def test_find_asset_reads_voidin_assets(tmp_path, monkeypatch):
    assert t_presets._ASSET_ROOTS == j_presets._ASSET_ROOTS[:1]
    (tmp_path / "x").mkdir()
    monkeypatch.setattr(t_presets, "_ASSET_ROOTS", ["", str(tmp_path)])
    assert t_presets.find_asset("x") == str(tmp_path / "x")
    assert t_presets.find_asset("y") is None

"""The port stands without JAX (and opens no file of the JAX package),
carries every RasterConfig option of the JAX package, and never falls
back to the CPU when asked for (or defaulting to) a CUDA device."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import voidin_tpu_torch as pt
from voidin_tpu_torch.framework.renderer import Renderer, build_world
from voidin_tpu_torch.ops import closest_hit as t_ch
from voidin_tpu_torch.ops import fine_raster as t_fr
from voidin_tpu_torch.ops import ltc_rect as t_ltc
from voidin_tpu_torch.ops import ltc_ring as t_ring
from voidin_tpu_torch.ops import lut_fetch as t_lut
from voidin_tpu_torch.ops import shadow_trace as t_st
from voidin_tpu_torch.passes.raster import RasterConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_renders_with_jax_and_flax_unimportable():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["flax"] = None
        import numpy as np, torch
        torch.set_num_threads(2)
        import voidin_tpu_torch as pt
        from voidin_tpu_torch.framework.renderer import Renderer, build_world
        from voidin_tpu_torch.passes.raster import RasterConfig
        world, moving = build_world(60, seed=1)
        cfg = RasterConfig(width=64, height=32, tri_capacity=1 << 13,
                           pair_capacity=1 << 13)
        r = Renderer(world.device("cpu"), cfg, moving_ids=moving)
        img = r.render(pt.Camera(position=[0.0, 2.0, 30.0], pitch=-5.0,
                                 aspect=2.0)).numpy()
        assert img.shape == (32, 64, 3) and np.isfinite(img).all()
        assert img.std() > 0 and int(r.aux["overflow"]) == 0
        assert not any(m == "voidin_tpu" or m.startswith("voidin_tpu.")
                       for m in sys.modules)
        print("OK", img.mean())
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("OK")


def test_rt_frame_and_bvh_builds_open_nothing_of_the_jax_package():
    """With jax unimportable: a raytraced-shadow frame and BLAS builds with
    the numpy builder (VOIDIN_NATIVE=0) and the native one. An audit hook
    records every file opened and library loaded; none lies under
    voidin_tpu/ (the LTC tables come from the port's own assets)."""
    code = textwrap.dedent("""
        import os, sys
        sys.modules["jax"] = None
        sys.modules["flax"] = None
        opened = []

        def hook(event, args):
            if (event in ("open", "ctypes.dlopen") and args
                    and isinstance(args[0], (str, bytes, os.PathLike))):
                opened.append(os.path.abspath(os.fsdecode(args[0])))
            elif event == "subprocess.Popen":
                opened.extend(os.path.abspath(str(a)) for a in args[1]
                              if str(a).endswith((".cpp", ".cu")))

        sys.addaudithook(hook)
        import numpy as np, torch
        torch.set_num_threads(2)
        import voidin_tpu_torch as pt
        from voidin_tpu_torch import native
        from voidin_tpu_torch.framework.renderer import Renderer
        from voidin_tpu_torch.passes.raster import RasterConfig
        from voidin_tpu_torch.rt import bvh
        from voidin_tpu_torch.scene import mesh
        w = pt.World()
        w.lights.add_point_light([0, 2.5, 0], 14.0, [1.0, 0.95, 0.9])
        w.instances.add(np.eye(4, dtype=np.float32), mesh.SPHERE_1_MESH, 0)
        ground = np.diag([20.0, 1.0, 20.0, 1.0]).astype(np.float32)
        ground[1, 3] = -1.0
        w.instances.add(ground, mesh.HORIZONTAL_PLANE_MESH, 0)
        cfg = RasterConfig(width=64, height=32, tri_capacity=1 << 12,
                           pair_capacity=1 << 13)
        r = Renderer(w.device("cpu", with_tlas=True), cfg,
                     enable_taa=False, enable_rt_shadows=True)
        img = r.render(pt.Camera(position=[0.0, 2.0, 4.0], pitch=-20.0,
                                 aspect=2.0)).numpy()
        assert img.shape == (32, 64, 3) and np.isfinite(img).all()
        assert int(r.aux["rt_exhausted"]) == 0 and int(r.aux["rt_rays"]) > 0
        m = mesh.make_uv_sphere(1.0, 2)
        os.environ["VOIDIN_NATIVE"] = "0"
        assert native.builder() == "numpy"
        nodes_np, _ = bvh.build_blas(m.vertices, m.indices)
        os.environ["VOIDIN_NATIVE"] = "1"
        builder = native.builder()
        nodes_nat, _ = bvh.build_blas(m.vertices, m.indices)
        assert nodes_np["count"].sum() == nodes_nat["count"].sum()
        assert not any(k == "voidin_tpu" or k.startswith("voidin_tpu.")
                       for k in sys.modules)
        jax_pkg = os.path.join(ROOT, "voidin_tpu") + os.sep
        bad = [p for p in opened if p.startswith(jax_pkg)]
        assert not bad, bad
        assert any(p.endswith(os.path.join("voidin_tpu_torch", "assets",
                                           "ltc_tables.npz")) for p in opened)
        print("OK", builder)
    """).replace("ROOT", repr(ROOT))
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("OK")


def test_examples_and_skinned_frame_open_nothing_of_the_jax_package(
        tmp_path):
    """With jax unimportable, under the same audit hook: both example
    modules write their PNGs on the CPU, and a skinned frame with
    raytraced shadows renders through Renderer.render(joint_mats=...)."""
    code = textwrap.dedent("""
        import os, sys
        sys.modules["jax"] = None
        sys.modules["flax"] = None
        opened = []

        def hook(event, args):
            if (event in ("open", "ctypes.dlopen") and args
                    and isinstance(args[0], (str, bytes, os.PathLike))):
                opened.append(os.path.abspath(os.fsdecode(args[0])))

        sys.addaudithook(hook)
        import dataclasses
        import numpy as np, torch
        torch.set_num_threads(2)
        import voidin_tpu_torch as pt
        from voidin_tpu_torch.examples import bvh_trace, ring_light
        from voidin_tpu_torch.io.image import load_image
        import chip_smoke
        for mod, name in ((bvh_trace, "bvh"), (ring_light, "ring")):
            out = os.path.join(TMP, name + ".png")
            mod.main(["--cpu", "--width", "48", "--height", "32", "--out",
                      out])
            img = load_image(out)
            assert img.shape == (32, 48, 4) and img[..., :3].std() > 0
        p = dataclasses.replace(chip_smoke.config5_preset(pt, True, 2.0),
                                pair_capacity=1 << 15)
        r = chip_smoke.preset_renderer(
            p, p.world.device("cpu", with_tlas=True), 64, 32)
        img = r.render(p.camera,
                       joint_mats=chip_smoke.knot_joint_mats(1)).numpy()
        assert np.isfinite(img).all() and img.std() > 0
        assert int(r.aux["overflow"]) == 0 and int(r.aux["rt_exhausted"]) == 0
        assert not any(k == "voidin_tpu" or k.startswith("voidin_tpu.")
                       for k in sys.modules)
        jax_pkg = os.path.join(ROOT, "voidin_tpu") + os.sep
        bad = [p for p in opened if p.startswith(jax_pkg)]
        assert not bad, bad
        print("OK")
    """).replace("ROOT", repr(ROOT)).replace("TMP", repr(str(tmp_path)))
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "OK" in out.stdout


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    world, _ = build_world(20, seed=0)
    with pytest.raises((RuntimeError, AssertionError)):
        world.device("cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        t_fr.fine_raster_pairs(torch.zeros(384, 16, device="cuda"),
                               torch.zeros(8, dtype=torch.int32),
                               torch.zeros(8, dtype=torch.int32))
    with pytest.raises((RuntimeError, AssertionError)):
        t_fr.fine_raster_blocks(torch.zeros(8, 64, 16, device="cuda"),
                                torch.zeros(8, dtype=torch.int32))
    with pytest.raises((RuntimeError, AssertionError)):
        t_ltc.ltc_rect_terms(*_ltc_inputs("cuda"))
    with pytest.raises((RuntimeError, AssertionError)):
        t_ring.ltc_ring_terms(*_ring_inputs("cuda"))
    with pytest.raises((RuntimeError, AssertionError)):
        t_st.occluded(*_trace_inputs("cuda"))
    with pytest.raises((RuntimeError, AssertionError)):
        t_ch.closest_hit(*_closest_inputs("cuda"))


def _ltc_inputs(device):
    """(nor, rd, pos, roughness, area_points, ltc1, ltc2) of 4x6 pixels
    and one light on `device`."""
    def z(*shape):
        return torch.zeros(*shape, device=device)

    return (z(4, 6, 3), z(4, 6, 3), z(4, 6, 3), z(4, 6), z(1, 4, 3),
            z(64, 64, 4), z(64, 64, 4))


def _ring_inputs(device):
    """(nor, rd, pos, roughness, points, ltc1, ltc2) of 4x6 pixels and the
    ring demo's disks on `device`."""
    def z(*shape):
        return torch.zeros(*shape, device=device)

    points = t_ring.ring_points3([0, 4, -2], [1, 0, 0], [0, 0.2, -1], 2.5,
                                 2.5)
    return (z(4, 6, 3), z(4, 6, 3), z(4, 6, 3), 0.3, points, z(64, 64, 4),
            z(64, 64, 4))


def _trace_inputs(device):
    """(table, n_tlas, instance_rows, tri_pos, origins, directions) of one
    node, one instance and one triangle, for 4 rays, on `device`."""
    def z(*shape):
        return torch.zeros(*shape, device=device)

    return z(1, 16), 1, z(1, 24), z(1, 9), z(4, 3), z(4, 3)


def _closest_inputs(device):
    """(tlas_rows, blas_rows, instance_rows, tri_pos, origins, directions)
    of one node each, one instance and one triangle, for 4 rays."""
    def z(*shape):
        return torch.zeros(*shape, device=device)

    return z(1, 8), z(1, 8), z(1, 24), z(1, 9), z(4, 3), z(4, 3)


def test_wrappers_take_no_other_device():
    rec = torch.zeros(384, 16, device="meta")
    st = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        t_fr.fine_raster_pairs(rec, st, st)
    with pytest.raises(ValueError):
        t_fr.fine_raster_blocks(torch.zeros(8, 64, 16, device="meta"), st)
    with pytest.raises(ValueError):
        t_lut.lut_fetch([torch.zeros(64, 64, device="meta")],
                        torch.zeros(4, 2, device="meta"))
    with pytest.raises(ValueError):
        t_ltc.ltc_rect_terms(*_ltc_inputs("meta"))
    with pytest.raises(ValueError):
        t_ring.ltc_ring_terms(*_ring_inputs("meta"))
    with pytest.raises(ValueError):
        t_st.occluded(*_trace_inputs("meta"))
    with pytest.raises(ValueError):
        t_ch.closest_hit(*_closest_inputs("meta"))


# The JAX package's RasterConfig fields of the TAA quad-block samplers
# and their defaults (voidin_tpu/passes/raster.py:149-163).
SAMPLER_FIELDS = dict(taa_quad_history=False, taa_edge_capacity=0,
                      taa_inwindow=False, taa_block_capacity=0,
                      taa_quad_where=False)


def _sampler_frames(**opts):
    """Three TAA frames (64x32) of a textured scene with moving spheres
    under RasterConfig `opts`: (the images, the overflow of each)."""
    from voidin_tpu_torch.core import mathx
    from voidin_tpu_torch.scene import mesh as t_mesh

    rng = np.random.default_rng(4)
    w = pt.World()
    noise = w.textures.add(rng.integers(0, 256, (32, 32, 3), np.uint8),
                           srgb=True)
    mat = w.materials.add(albedo=noise)
    moving = [w.instances.add(np.asarray(mathx.from_translation(
        [1.5 * i - 2.0, 0.6, -5.0])), t_mesh.SPHERE_1_MESH, mat)
        for i in range(4)]
    w.instances.add(np.asarray(mathx.from_translation([0, -1, -5])
                               @ mathx.from_scale(8.0)),
                    t_mesh.HORIZONTAL_PLANE_MESH, mat)
    w.lights.add_point_light([1, 4, -2], 20.0, [1, 1, 1])
    r = Renderer(w.device("cpu"), RasterConfig(
        width=64, height=32, tri_capacity=1 << 12, pair_capacity=1 << 13,
        **opts), moving_ids=moving)
    imgs, ovf = [], []
    for _ in range(3):
        imgs.append(r.render(pt.Camera(position=[0, 1.5, 0], pitch=-15.0,
                                       aspect=2.0)).numpy())
        ovf.append(int(r.aux["overflow"]))
    return imgs, ovf


@pytest.mark.parametrize("opts", [
    dict(taa_quad_history=True),
    dict(taa_quad_history=True, taa_quad_where=True),
    dict(taa_inwindow=True),
], ids=["taa_quad_history", "taa_quad_where", "taa_inwindow"])
def test_renderer_renders_every_option(opts):
    """The options the port once refused: RasterConfig holds the five
    fields of the TAA quad-block samplers with the JAX package's defaults
    (and not the JAX package's quad-rate albedo tap, whose words its one
    tap gives), and the Renderer renders with each sampler on, every frame
    word for word the default frame (the history has motion from the
    second frame on), overflow 0."""
    cfg = RasterConfig()
    assert {k: getattr(cfg, k) for k in SAMPLER_FIELDS} == SAMPLER_FIELDS
    with pytest.raises(TypeError):
        RasterConfig(tap_block=True)
    base, base_ovf = _sampler_frames()
    got, ovf = _sampler_frames(**opts)
    assert base_ovf == ovf == [0, 0, 0]
    for a, b in zip(base, got):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    assert base[2].std() > 0.02


def test_renderer_renders_alpha_masked_scene():
    """The scene the port once refused: a fully cut-out material. The
    Renderer switches the runner-up raster on and renders it; the cut quad
    in front of the camera leaves the background."""
    w = pt.World()
    tex = w.textures.add(np.zeros((4, 4, 4), np.uint8))
    mat = w.materials.add(albedo=tex)
    w.instances.add(np.eye(4, dtype=np.float32), 1, mat)
    scene = w.device("cpu")
    assert scene.alpha_masked
    r = Renderer(scene, RasterConfig(width=32, height=16, tri_capacity=1 << 8,
                                     pair_capacity=1 << 10))
    assert r.config.alpha_mask
    img = r.render(pt.Camera(position=[0.0, 0.0, -3.0], yaw=180.0,
                             aspect=2.0)).numpy()
    assert img.shape == (16, 32, 3) and np.isfinite(img).all()
    assert int(r.aux["overflow"]) == 0
    assert int(r.aux["vis_coverage"]) > 0  # the quad rasterized ...
    assert int((r.aux["depth"] > 0).sum()) == 0  # ... and was cut


def test_world_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    with pytest.raises((RuntimeError, AssertionError)):
        pt.World().device()


def test_presets_and_import_open_nothing_of_the_jax_package(tmp_path):
    """With jax, flax and PIL unimportable, under the audit hook: every
    preset builds (configs 6 and 7 reduced) and config 4 renders a frame;
    chip_smoke's glTF (.glb and .gltf) and OBJ files import, with the
    palette PNG decoded by io/image.py, and render posed by GltfAnimator;
    a snapshot saves and loads. No module of the JAX package is imported
    and no file under voidin_tpu/ is opened."""
    code = textwrap.dedent("""
        import os, sys
        for name in ("jax", "flax", "PIL"):
            sys.modules[name] = None
        opened = []

        def hook(event, args):
            if (event in ("open", "ctypes.dlopen") and args
                    and isinstance(args[0], (str, bytes, os.PathLike))):
                opened.append(os.path.abspath(os.fsdecode(args[0])))

        sys.addaudithook(hook)
        import numpy as np, torch
        torch.set_num_threads(2)
        import voidin_tpu_torch as pt
        from voidin_tpu_torch.framework import presets
        from voidin_tpu_torch.framework.renderer import Renderer
        from voidin_tpu_torch.io import gltf, obj, snapshot
        from voidin_tpu_torch.passes.raster import RasterConfig
        import chip_smoke
        small = {6: dict(base_size=64, n_textures=6, n_knots=2,
                         knot_detail=(48, 8)),
                 7: dict(n_textures=4, base_size=32, detail=0.1)}
        for n, make in presets.PRESETS.items():
            p = make(2.0, **small.get(n, {}))
            assert len(p.world.instances) > 0
        p = presets.config4_animated_taa(2.0)
        r = chip_smoke.preset_renderer(p, p.world.device("cpu"), 64, 32)
        img = r.render(p.camera, joint_mats=p.animator(r.time)).numpy()
        assert np.isfinite(img).all() and img.std() > 0
        assert int(r.aux["overflow"]) == 0
        paths = chip_smoke.write_import_scene(TMP)
        for kind in ("glb", "gltf"):
            world, doc = chip_smoke.import_world(pt, paths, kind)
            assert len(world.skins) == 1 and len(world.textures) == 8
        an = gltf.GltfAnimator(doc)
        r = Renderer(world.device("cpu"),
                     RasterConfig(width=64, height=32, tri_capacity=1 << 12,
                                  pair_capacity=1 << 13))
        img = r.render(pt.Camera(**chip_smoke.IMPORT_CAMERA, aspect=2.0),
                       joint_mats=chip_smoke.import_joint_mats(an, 3)).numpy()
        assert np.isfinite(img).all() and img.std() > 0
        path = os.path.join(TMP, "scene.npz")
        snapshot.save_scene(path, world.device("cpu"))
        scene, cam = snapshot.load_scene(path, "cpu")
        assert cam is None and scene.skins == ()
        bad_mods = [k for k, m in sys.modules.items() if m is not None
                    and (k.split(".")[0] in ("voidin_tpu", "PIL"))]
        assert not bad_mods, bad_mods
        jax_pkg = os.path.join(ROOT, "voidin_tpu") + os.sep
        bad = [p for p in opened if p.startswith(jax_pkg)]
        assert not bad, bad
        print("OK")
    """).replace("ROOT", repr(ROOT)).replace("TMP", repr(str(tmp_path)))
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "OK" in out.stdout


def test_decoders_and_texture_packer_open_nothing_of_the_jax_package():
    """With jax, flax and PIL unimportable, under the audit hook: every
    committed image fixture (progressive, CMYK, YCCK, 4:1:1 and 4:4:0,
    lossless, arithmetic-coded and block-smoothed JPEGs, Adam7 and 16-bit
    PNGs, WebP, GIF, BMP and TIFF, the TIFF long tail's ZSTD, CCITT,
    JPEG-in-TIFF and CIELab among them) decodes through load_image to its
    stored PIL pixels (lossy JPEG and JPEG-in-TIFF within one level, every
    other file word for word), and a texture pool packs through the
    native packer (its library compiled from the port's own C++ sources)
    and through numpy under VOIDIN_NATIVE=0. No module of the JAX package or PIL is imported
    and no file under voidin_tpu/ is opened."""
    code = textwrap.dedent("""
        import glob, os, sys
        for name in ("jax", "flax", "PIL"):
            sys.modules[name] = None
        opened, compiled = [], []

        def hook(event, args):
            if (event in ("open", "ctypes.dlopen") and args
                    and isinstance(args[0], (str, bytes, os.PathLike))):
                opened.append(os.path.abspath(os.fsdecode(args[0])))
            elif event == "subprocess.Popen":
                compiled.extend(os.path.abspath(str(a)) for a in args[1]
                                if str(a).endswith(".cpp"))

        sys.addaudithook(hook)
        import numpy as np, torch
        torch.set_num_threads(2)
        from voidin_tpu_torch import native
        from voidin_tpu_torch.io import (bmp, ccitt, cielab, gif, tiff,
                                         vp8_tables, webp, zstd)
        from voidin_tpu_torch.io.image import load_image
        from voidin_tpu_torch.ops import ltc_ring
        from voidin_tpu_torch.scene.texture import TexturePool
        fixtures = sorted(p for p in glob.glob(os.path.join(
            ROOT, "tests", "data", "torch_images", "*"))
            if not p.endswith(".rgba.png"))
        assert len(fixtures) == 84
        for path in fixtures:
            got = load_image(path).astype(np.int64)
            want = load_image(path + ".rgba.png").astype(np.int64)
            assert got.shape == want.shape, path
            name = os.path.basename(path)
            lossy = (path.endswith(".jpg") and not name.startswith("lossless")
                     or name.startswith(("f8_jpeg", "f8_ojpeg")))
            assert np.abs(got - want).max() <= (1 if lossy else 0), path
        pool = TexturePool(256)
        pool.add(np.random.default_rng(0).integers(0, 256, (200, 130, 4),
                                                   dtype=np.uint8))
        assert native.packer() == "native"
        quads = pool.host_arrays()["quads"]
        os.environ["VOIDIN_NATIVE"] = "0"
        assert native.packer() == "numpy"
        plain = pool.host_arrays()["quads"]
        assert np.abs(quads.astype(int) - plain).max() <= 3
        port = os.path.join(ROOT, "voidin_tpu_torch") + os.sep
        lib = native.library_path()
        assert lib in opened and lib.startswith(port)
        assert all(p.startswith(port) for p in compiled), compiled
        bad_mods = [k for k, m in sys.modules.items() if m is not None
                    and (k.split(".")[0] in ("voidin_tpu", "PIL", "jax"))]
        assert not bad_mods, bad_mods
        jax_pkg = os.path.join(ROOT, "voidin_tpu") + os.sep
        bad = [p for p in opened if p.startswith(jax_pkg)]
        assert not bad, bad
        print("OK")
    """).replace("ROOT", repr(ROOT))
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "OK" in out.stdout


APP_MODULES = (
    "core.hash", "framework.app", "framework.input", "framework.pipeline",
    "framework.profiler", "framework.recorder", "framework.viewer",
    "framework.webviewer", "io.avi", "io.jpeg", "passes.blit",
    "passes.hud", "examples.trig", "examples.spheres",
    "examples.raytraced_shadows", "examples.fractal", "examples.bvh_cpu",
    "examples.model", "examples.viewer", "examples.web_viewer")


def test_app_layer_opens_nothing_of_the_jax_package(tmp_path):
    """With jax, flax and PIL unimportable, under the audit hook: every
    module of the app layer imports; an App runs frames, records them as
    an MJPEG-AVI (no ffmpeg) whose frames the port's own decoder reads
    back, profiles a frame and serves one to the web viewer; a JPEG
    texture loads. No module of the JAX package or PIL is imported and no
    file under voidin_tpu/ is opened."""
    code = textwrap.dedent("""
        import importlib, os, shutil, sys, threading
        for name in ("jax", "flax", "PIL"):
            sys.modules[name] = None
        opened = []

        def hook(event, args):
            if (event in ("open", "ctypes.dlopen") and args
                    and isinstance(args[0], (str, bytes, os.PathLike))):
                opened.append(os.path.abspath(os.fsdecode(args[0])))

        sys.addaudithook(hook)
        import numpy as np, torch
        torch.set_num_threads(2)
        for m in MODULES:
            importlib.import_module("voidin_tpu_torch." + m)
        from voidin_tpu_torch.examples import viewer
        from voidin_tpu_torch.framework import profiler, recorder
        from voidin_tpu_torch.framework.webviewer import run_web
        from voidin_tpu_torch.io import jpeg
        from voidin_tpu_torch.io.image import load_image
        import chip_smoke
        recorder.shutil.which = lambda name: None
        app = viewer.make_app(48, 32, "cpu")
        app.run(3, record_path=os.path.join(TMP, "clip.mp4"), hud=True)
        data = open(os.path.join(TMP, "clip.avi"), "rb").read()
        frames = [jpeg.decode_jpeg(f) for f in chip_smoke.avi_frames(data)]
        assert len(frames) == 3 and frames[0].shape == (32, 48, 3)
        rows = profiler.profile_frame(app.renderer.scene,
                                      app.state.camera.uniform(), app.config)
        assert all(ms > 0 for _, ms in rows)
        assert run_web(app, port=0, max_frames=1) == 1
        path = os.path.join(TMP, "t.jpg")
        open(path, "wb").write(jpeg.encode_jpeg(frames[0]))
        assert load_image(path).shape == (32, 48, 4)
        bad_mods = [k for k, m in sys.modules.items() if m is not None
                    and (k.split(".")[0] in ("voidin_tpu", "PIL", "jax"))]
        assert not bad_mods, bad_mods
        jax_pkg = os.path.join(ROOT, "voidin_tpu") + os.sep
        bad = [p for p in opened if p.startswith(jax_pkg)]
        assert not bad, bad
        print("OK")
    """).replace("ROOT", repr(ROOT)).replace("TMP", repr(str(tmp_path)))
    code = code.replace("MODULES", repr(APP_MODULES))
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "OK" in out.stdout


def test_app_without_a_card_raises():
    """App's device defaults to the card: without one it raises (as
    World.device() does) unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    from voidin_tpu_torch.examples import model, viewer
    from voidin_tpu_torch.framework.app import App, Example

    with pytest.raises((RuntimeError, AssertionError)):
        App(Example(), config=RasterConfig(width=32, height=16))
    with pytest.raises((RuntimeError, AssertionError)):
        viewer.make_app(32, 16, "cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        model.main(["--width", "32", "--height", "16", "--frames", "1"])
    app = App(Example(), config=RasterConfig(width=32, height=16),
              device="cpu")
    assert app.renderer.device.type == "cpu"


def test_load_scene_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    from voidin_tpu_torch.io.snapshot import load_scene, save_scene

    path = str(tmp_path / "scene.npz")
    save_scene(path, pt.World().device("cpu"))
    with pytest.raises((RuntimeError, AssertionError)):
        load_scene(path)

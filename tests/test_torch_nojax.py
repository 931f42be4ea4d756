"""The port stands without JAX (and opens no file of the JAX package),
refuses what it does not carry, and never falls back to the CPU when asked
for (or defaulting to) a CUDA device."""

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
        t_st.occluded(*_trace_inputs("meta"))
    with pytest.raises(ValueError):
        t_ch.closest_hit(*_closest_inputs("meta"))


@pytest.mark.parametrize("kwargs", [
    dict(fused_resolve_rec=True),
    dict(area_light_scale=2),
    dict(mesh="rows"),
    dict(debug_bounds=True),
    dict(planar_resolve=True),
    dict(taa_quad_history=True),
])
def test_renderer_refuses_what_is_not_ported(kwargs):
    scene = pt.World().device("cpu")
    with pytest.raises(NotImplementedError):
        Renderer(scene, RasterConfig(width=32, height=16), **kwargs)


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

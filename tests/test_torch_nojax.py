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


@pytest.mark.parametrize("kwargs", [
    dict(fused_resolve_rec=True),
    dict(area_light_scale=2),
    dict(mesh="rows"),
    dict(skins=("skin",)),
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

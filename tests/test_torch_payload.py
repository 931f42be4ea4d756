"""Port parity for the slim resolve record (RasterConfig.slim_rec) and
kernel K1's winner-payload variant (RasterConfig.kernel_payload) against
the JAX package.

Scenes: tests/test_kernel_payload.py's three — the slim-envelope ring of
knots and spheres (192x96, `_slim_world()`), its full-frame variant
(`_slim_world(n=5, seed=3)`) and the 40 overlapping spheres whose tiles
span several 128-record chunks (128x64) — bridged into the port.

Tolerances: the f16 instance record, the slim resolve record and the
payload image are bit-identical (u32 views) to the JAX stages run op by
op, the payload against JAX's Pallas kernel (interpret); resolve gives a
bit-identical GBuffer and material fields within 1e-6
(tests/test_torch_alpha.py's tolerances); a payload frame equals the
frame without it exactly; the slim frame is within sRGB mean 5e-3 of the
JAX slim frame (tests/test_torch_frame.py's budget).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import voidin_tpu as vt
from voidin_tpu.core import mathx
from voidin_tpu.framework.renderer import FrameState as JaxFrameState
from voidin_tpu.framework.renderer import Globals as JaxGlobals
from voidin_tpu.framework.renderer import render_frame as jax_render_frame
from voidin_tpu.passes import cull as j_cull
from voidin_tpu.passes import raster as j_raster
from voidin_tpu.passes import resolve as j_resolve

import voidin_tpu_torch as pt
from voidin_tpu_torch.core.encoding import as_u32_np
from voidin_tpu_torch.framework.renderer import Renderer
from voidin_tpu_torch.passes import cull as t_cull
from voidin_tpu_torch.passes import raster as t_raster
from voidin_tpu_torch.passes import resolve as t_resolve
from voidin_tpu_torch.passes.gbuffer import VisBuffer

from tests import test_kernel_payload as tkp
from tests.test_torch_raster import MIN_ID_AGREEMENT
from tests.test_torch_scene import port_scene, unpermuted_worlds

torch.set_num_threads(2)
BUDGET = 5e-3


def _multi_chunk_world():
    """test_kernel_payload.py's deep-tile scene: 40 overlapping spheres."""
    w = vt.World()
    sphere = w.meshes.add(vt.mesh.make_uv_sphere(1.2, 4))
    mat = w.materials.add()
    rng = np.random.default_rng(7)
    for i in range(40):
        t = mathx.from_translation(
            [float(rng.uniform(-0.8, 0.8)), float(rng.uniform(0, 1.5)),
             -6.0 - 0.05 * i])
        w.instances.add(np.asarray(t), sphere, mat)
    w.lights.add_point_light([2, 4, -2], 15.0, [1, 1, 1])
    return w


RING = dict(width=192, height=96, tri_capacity=1 << 13,
            pair_capacity=1 << 14)
SCENES = {
    "ring": (tkp._slim_world, RING,
             dict(position=[0, 2.5, 0], pitch=-15.0)),
    "frame": (functools.partial(tkp._slim_world, n=5, seed=3), RING,
              dict(position=[0, 2.5, 0], pitch=-15.0)),
    "multi_chunk": (_multi_chunk_world,
                    dict(width=128, height=64, tri_capacity=1 << 16,
                         pair_capacity=1 << 17),
                    dict(position=[0, 1, -2], pitch=-10.0)),
}


def _case(name, **options):
    """JAX and port scenes, configs (slim_rec + `options`), camera and
    draws of one scene."""
    build, size, cam = SCENES[name]
    with unpermuted_worlds():
        js = build().device(tap_blocks=False)
    ts = port_scene(js)
    jcfg = j_raster.RasterConfig(**size, slim_rec=True, interpret=True,
                                 **options)
    tcfg = t_raster.RasterConfig(**size, slim_rec=True, **options)
    ucam = vt.Camera(**cam, aspect=size["width"] / size["height"]).uniform()
    return dict(js=js, ts=ts, jcfg=jcfg, tcfg=tcfg, cam=ucam,
                jd=j_cull.emit_draws(js.meshes, js.instances, ucam),
                td=t_cull.emit_draws(ts.meshes, ts.instances, ucam))


def _port_vis(c, cfg=None):
    ts = c["ts"]
    return t_raster.rasterize(ts.meshes, ts.instances, c["td"], c["cam"],
                              cfg or c["tcfg"], materials=ts.materials,
                              inst_rec=t_resolve._inst_rec_f16(ts))


def _jax_vis_op_by_op(c, cfg):
    js = c["js"]
    return j_raster.rasterize(js.meshes, js.instances, c["jd"], c["cam"],
                              cfg, materials=js.materials,
                              inst_rec=j_resolve._inst_rec_f16(js))


def _bits(x):
    return np.asarray(x).view(np.int32)


@pytest.fixture(scope="module")
def ring():
    c = _case("ring", kernel_payload=True)
    c["jvis"] = _jax_vis_op_by_op(c, c["jcfg"])
    c["tvis"] = _port_vis(c)
    return c


def test_inst_rec_f16_bit_identical(ring):
    want = _bits(j_resolve._inst_rec_f16(ring["js"]))
    got = t_resolve._inst_rec_f16(ring["ts"])
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(want, got.numpy())


def test_slim_record_bit_identical(ring):
    c = ring
    js, ts = c["js"], c["ts"]
    jsetup = j_raster.triangle_setup(js.meshes, js.instances, c["jd"],
                                     c["cam"], c["jcfg"],
                                     materials=js.materials,
                                     inst_rec=j_resolve._inst_rec_f16(js))
    tsetup = t_raster.triangle_setup(ts.meshes, ts.instances, c["td"],
                                     c["cam"], c["tcfg"],
                                     materials=ts.materials,
                                     inst_rec=t_resolve._inst_rec_f16(ts))
    want, got = _bits(jsetup["resolve_rec"]), _bits(tsetup["resolve_rec"])
    assert got.shape == want.shape and got.shape[1] == 24
    np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(_bits(jsetup["raster_rec"]),
                                  _bits(tsetup["raster_rec"]))
    with pytest.raises(ValueError, match="inst_rec"):
        t_raster.triangle_setup(ts.meshes, ts.instances, c["td"], c["cam"],
                                c["tcfg"], materials=ts.materials)


@pytest.mark.parametrize("name", ["ring", "frame", "multi_chunk"])
def test_payload_img_equals_record_gather(name):
    c = _case(name, kernel_payload=True)
    vis = _port_vis(c)
    assert vis.payload_img is not None and vis.payload_img.shape == (
        c["tcfg"].height, c["tcfg"].width, 24)
    want = vis.resolve_rec[torch.clamp(vis.tri_id.long(), min=0)]
    np.testing.assert_array_equal(_bits(want), _bits(vis.payload_img))
    assert int(vis.overflow) == 0
    assert (vis.tri_id >= 0).float().mean() > 0.05
    if name == "multi_chunk":  # tiles span several 128-record chunks
        ts = c["ts"]
        setup = t_raster.triangle_setup(
            ts.meshes, ts.instances, c["td"], c["cam"], c["tcfg"],
            materials=ts.materials, inst_rec=t_resolve._inst_rec_f16(ts))
        _, _, counts, _ = t_raster.bin_triangles_pairs(setup, c["tcfg"])
        assert int(counts.max()) > 2 * 128


def test_payload_twin_matches_pallas(ring):
    """K1's payload twin against the Pallas kernel (interpret) through
    rasterize: the same winners, and the same payload words."""
    jvis, tvis = ring["jvis"], ring["tvis"]
    jt, tt = np.asarray(jvis.tri_id), tvis.tri_id.numpy()
    agree = jt == tt
    print(f"payload raster vs Pallas (interpret): flipped ids "
          f"{(~agree).sum()} of {agree.size}")
    assert agree.mean() >= MIN_ID_AGREEMENT
    jp, tp = _bits(jvis.payload_img), _bits(tvis.payload_img)
    np.testing.assert_array_equal(jp[agree], tp[agree])
    np.testing.assert_array_equal(_bits(jvis.resolve_rec),
                                  _bits(tvis.resolve_rec))


@pytest.mark.parametrize("payload", [False, True])
def test_slim_resolve_matches_jax(ring, payload):
    """JAX's slim resolve (dense, op by op) against the port's on the same
    visibility buffer, with and without the payload image."""
    jvis = ring["jvis"]
    jcfg = dataclasses.replace(ring["jcfg"], kernel_payload=payload)
    if not payload:
        jvis = jvis.replace(payload_img=None)
    tvis = VisBuffer(
        tri_id=torch.from_numpy(np.array(jvis.tri_id)),
        depth=torch.from_numpy(np.array(jvis.depth)),
        resolve_rec=torch.from_numpy(np.array(jvis.resolve_rec)),
        overflow=torch.tensor(int(jvis.overflow)),
        payload_img=(torch.from_numpy(np.array(jvis.payload_img))
                     if payload else None),
    )
    jg, ja = j_resolve.resolve_gbuffer(ring["js"], jvis, ring["cam"], jcfg)
    tg, ta = t_resolve.resolve_gbuffer(
        ring["ts"], tvis, dataclasses.replace(ring["tcfg"],
                                              kernel_payload=payload))
    np.testing.assert_array_equal(np.asarray(jg.normal_uv),
                                  as_u32_np(tg.normal_uv))
    np.testing.assert_array_equal(np.asarray(jg.material),
                                  tg.material.numpy())
    np.testing.assert_array_equal(np.asarray(jg.depth), tg.depth.numpy())
    for field in ("albedo", "emissive", "mr"):
        np.testing.assert_allclose(getattr(ta, field).numpy(),
                                   np.asarray(getattr(ja, field)), rtol=0,
                                   atol=1e-6, err_msg=field)
    assert (tg.material.numpy() > 0).any() or (tg.depth > 0).any()


def test_payload_frame_equals_slim_frame_and_jax():
    """test_kernel_payload.py:81-101 on the port: a slim_rec frame with
    kernel_payload equals the one without, pixel for pixel; and the slim
    frame agrees with the JAX slim frame."""
    c = _case("frame")
    cam = dict(position=[0, 2.5, 0], pitch=-15.0,
               aspect=RING["width"] / RING["height"])
    frames = {}
    for payload in (False, True):
        r = Renderer(c["ts"], dataclasses.replace(c["tcfg"],
                                                  kernel_payload=payload),
                     enable_taa=False)
        frames[payload] = r.render(pt.Camera(**cam)).numpy()
        assert int(r.aux["overflow"]) == 0
    np.testing.assert_array_equal(frames[False], frames[True])
    assert frames[True].std() > 0.02
    w, h = RING["width"], RING["height"]
    img, _st, _sc, aux = jax_render_frame(
        c["js"], vt.Camera(**cam).uniform(), JaxGlobals.make(w, h),
        JaxFrameState.initial(w, h), jnp.zeros(0, jnp.int32), c["jcfg"],
        enable_taa=False)
    diff = np.abs(frames[True] - np.asarray(img)).mean()
    print(f"slim + payload frame: mean abs diff vs JAX slim frame "
          f"{diff:.3e}")
    assert int(aux["overflow"]) == 0 and diff < BUDGET


def test_renderer_refuses_slim_outside_its_envelope():
    """Outside slim_rec's envelope (here a normal map) the Renderer
    declines slim_rec and kernel_payload and falls back as the JAX
    package's Renderer does on the same World, to fused_resolve_rec +
    inst_rec_f16: its frame is word for word the port's frame of that
    config."""
    from voidin_tpu.framework.renderer import Renderer as JaxRenderer

    def world(pkg):
        w = pkg.World()
        normal = w.textures.add(np.full((4, 4, 3), 128, np.uint8))
        w.instances.add(np.eye(4, dtype=np.float32), 1,
                        w.materials.add(normal=normal))
        return w

    scene = world(pt).device("cpu")
    assert not scene.no_normal_maps
    cfg = t_raster.RasterConfig(width=32, height=16, tri_capacity=1 << 8,
                                pair_capacity=1 << 10)
    r = Renderer(scene, dataclasses.replace(cfg, slim_rec=True,
                                            kernel_payload=True),
                 enable_taa=False)
    jr = JaxRenderer(world(vt).device(tap_blocks=False),
                     j_raster.RasterConfig(width=32, height=16,
                                           slim_rec=True, interpret=True),
                     enable_taa=False)
    for k, v in dict(slim_rec=False, kernel_payload=False,
                     fused_resolve_rec=True, inst_rec_f16=True).items():
        assert getattr(r.config, k) == getattr(jr.config, k) == v, k
    cam = pt.Camera(position=[0.0, 0.0, -3.0], yaw=180.0, aspect=2.0)
    explicit = dataclasses.replace(cfg, fused_resolve_rec=True,
                                   inst_rec_f16=True)
    got = r.render(cam).numpy()
    np.testing.assert_array_equal(
        got, Renderer(scene, explicit, enable_taa=False).render(cam).numpy())


@pytest.mark.parametrize("options", [
    dict(kernel_payload=True),
    dict(kernel_payload=True, slim_rec=True, backend="xla"),
])
def test_kernel_payload_needs_slim_and_the_pair_path(options):
    ts = pt.World().device("cpu")
    cfg = t_raster.RasterConfig(width=32, height=16, tri_capacity=1 << 8,
                                pair_capacity=1 << 10, **options)
    draws = t_cull.DrawList(instance=torch.zeros(1, dtype=torch.int32),
                            count=torch.tensor(0))
    cam = pt.Camera(position=[0.0, 0.0, 3.0], aspect=2.0).uniform()
    with pytest.raises(ValueError, match="kernel_payload"):
        t_raster.rasterize(ts.meshes, ts.instances, draws, cam, cfg,
                           materials=ts.materials,
                           inst_rec=t_resolve._inst_rec_f16(ts))

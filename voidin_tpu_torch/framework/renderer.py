"""The Renderer: the north-star frame over device-resident scene state.

Counterpart of ``voidin_tpu/framework/renderer.py`` (reference App + frame
loop, crates/app/src/app.rs:292-358). ``render_frame`` runs the frame's
passes in order on the scene's device — update, cull + LOD select,
raster (setup, binning, fine raster kernel K1 or K2), resolve, shade (the
fused LTC kernel; with enable_rt_shadows the raytraced variant and its
shadow-ray kernel), TAA, postprocess, sRGB — eagerly; ``Renderer`` owns the
per-frame host state (jitter schedule, previous camera uniform, TAA
history) around it.

The Renderer switches the runner-up raster and the alpha fallback on for
an alpha-masked scene (RasterConfig.alpha_mask, from
SceneData.alpha_masked). A scene with skinning regions (SceneData.skins)
is skinned each frame from the joint matrices ``Renderer.render`` takes,
and its BLAS and TLAS refit; rendering it without them raises ValueError,
as does a frame with raytraced shadows on a scene without a TLAS. With
a ``pipeline_cache`` (framework/pipeline.PipelineCache) the frame routes
through its entry "frame", rebuilt from the live modules when one of
``frame_sources()`` changes on disk (hot reload).

``Renderer(mesh=make_mesh(devices=[...]))`` (parallel/sharding.py) renders
the row-sharded frame: one slab of tile rows per device of the mesh (a
device may repeat), K1 once per slab, the image gathered on the mesh's
first device, word for word the unsharded frame. ``area_light_scale=s``
evaluates the area lights on every s-th pixel (the JAX package's
documented deviation). ``RasterConfig.debug_bounds`` checks every
data-dependent gather of the frame (core/checks.py) and raises an
IndexError naming it. slim_rec on a scene outside its envelope (normal
maps, sampled emissive or metallic-roughness, alpha masking, ids not
exact in f16) falls back as the JAX package's does, to fused_resolve_rec +
inst_rec_f16 (kernel_payload, which rides the slim record, goes off).
The quad-block samplers of the TAA history (taa_quad_history,
taa_quad_where, taa_inwindow) run where the config names them: their edge
batches' overflow adds to aux["overflow"], and the sharded frame turns
them off as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import checks, mathx
from ..core.camera import Camera, CameraUniform
from ..core.jitter import JitterSequence
from ..parallel import sharding as shard_mod
from ..passes import cull as cull_pass
from ..passes import postprocess as post_pass
from ..passes import raster as raster_pass
from ..passes import resolve as resolve_pass
from ..passes import shading as shading_pass
from ..passes import taa as taa_pass
from ..passes import update as update_pass
from ..passes.gbuffer import GBuffer, VisBuffer
from ..passes.raster import RasterConfig
from ..scene import mesh as mesh_mod
from ..scene import skin as skin_mod
from ..scene.scene import SceneData, World
from ..scene.texture import linear_to_srgb
from . import profiler


@dataclasses.dataclass
class Globals:
    """Per-frame globals (global_ubo.rs Uniform)."""

    resolution: tuple
    frame: int
    time: float
    dt: float
    custom: float = 0.0

    @classmethod
    def make(cls, width, height, frame=0, time=0.0, dt=0.0, custom=0.0):
        return cls((float(width), float(height)), int(frame),
                   float(np.float32(time)), float(np.float32(dt)),
                   float(custom))


@dataclasses.dataclass
class FrameState:
    """Render state carried across frames (ViewTarget ping-pong + TAA
    history in the reference). ``history`` is updated in place."""

    history: torch.Tensor  # (H, W, 3) f32 TAA history color
    history_valid: bool = False  # False on the first frame

    @classmethod
    def initial(cls, width, height, device):
        return cls(
            history=torch.zeros(height, width, 3, dtype=torch.float32,
                                device=device),
            history_valid=False,
        )


def frame_state_from_numpy(history, history_valid, device) -> FrameState:
    """FrameState on `device` from a TAA history carried across as numpy
    (for instance the leaves of the JAX package's FrameState)."""
    return FrameState(
        history=torch.as_tensor(np.array(history, np.float32), device=device),
        history_valid=bool(history_valid),
    )


def render_frame(scene: SceneData, camera: CameraUniform, globals_: Globals,
                 state: FrameState, moving_ids: torch.Tensor,
                 config: RasterConfig, enable_cull: bool = True,
                 enable_taa: bool = True, enable_post: bool = True,
                 enable_rt_shadows: bool = False, rt_shadow_scale: int = 1,
                 area_light_scale: int = 1, mesh=None, joint_mats=None,
                 replicas=None):
    """Full frame. Returns (srgb_image, state, scene, aux). The moving
    instances' transforms and the TAA history update in place. Without
    post the frame is the sRGB of the HDR (no sharpen, no tonemap). With
    raytraced shadows aux also holds rt_exhausted (shadow rays still
    walking at the step limit) and rt_rays (shadow rays traced).
    `joint_mats` ((J, 4, 4) world-joint @ inverse-bind, composed on the
    host each frame) drives the scene's skinning regions: the returned
    scene holds the skinned pool tables and the refit BLAS and TLAS.
    `area_light_scale=s` evaluates the area lights on every s-th pixel
    (shading.shade). With `mesh` (parallel/sharding.RowMesh) the frame
    runs row-sharded (_render_frame_sharded); `replicas` ({device:
    SceneData}, sharding.replicated) are the scene's copies it updates,
    made from `scene` where not given."""
    if mesh is not None:
        return _render_frame_sharded(
            scene, camera, globals_, state, moving_ids, config, enable_cull,
            enable_taa, enable_post, enable_rt_shadows, rt_shadow_scale,
            area_light_scale, mesh, joint_mats, replicas)
    # 1. compute_update + skinning; 2. emit_draws
    scene = _update_scene(scene, moving_ids, globals_, joint_mats)
    draws = _emit_draws(scene, camera, enable_cull)
    # 3. visibility raster + G-buffer resolve
    inst_rec = frame_inst_rec(scene, config)
    vis = raster_pass.rasterize(scene.meshes, scene.instances, draws, camera,
                                config, materials=scene.materials,
                                inst_rec=inst_rec)
    gbuffer, aux_r = resolve_pass.resolve_gbuffer(scene, vis, config)
    # 4. deferred shading (HDR); optionally with TLAS-traced shadows
    rt = None
    if enable_rt_shadows:
        hdr, rt = shading_pass.shade_raytraced(
            scene, gbuffer, camera, aux_r, shadow_scale=rt_shadow_scale)
    else:
        hdr = shading_pass.shade(scene, gbuffer, camera, aux_r,
                                 area_light_scale=area_light_scale)
    # 5. TAA (reproject + resolve into history)
    taa_overflow = None
    if enable_taa:
        hdr, state, taa_overflow = taa_pass.taa(
            hdr, gbuffer, camera, state,
            quad_history=config.taa_quad_history,
            edge_capacity=config.taa_edge_capacity,
            inwindow=config.taa_inwindow,
            block_capacity=config.taa_block_capacity,
            quad_select="where" if config.taa_quad_where else "einsum")
    # 6. postprocess (sharpen + tonemap) + sRGB encode
    with profiler.scope("post"):
        ldr = post_pass.postprocess(hdr) if enable_post else hdr
        with profiler.scope("post.srgb"):
            srgb = linear_to_srgb(ldr)
        del ldr
    with profiler.scope("frame.end"):
        overflow = vis.overflow
        if aux_r.overflow is not None:
            overflow = overflow + aux_r.overflow  # alpha-fallback capacity
        if taa_overflow is not None:
            overflow = overflow + taa_overflow  # TAA history edge batches
        aux = dict(
            draw_count=draws.count,
            overflow=overflow,
            depth=gbuffer.depth,
            vis_coverage=(vis.tri_id >= 0).sum(),
        )
        if aux_r.cut is not None:
            aux.update(alpha_cut=aux_r.cut, alpha_fallback=aux_r.fallback)
        if rt is not None:
            aux.update(rt_exhausted=rt["exhausted"], rt_rays=rt["rays"])
        profiler.count("covered_px", aux["vis_coverage"])
    return srgb, state, scene, aux


def frame_inst_rec(scene, config):
    """The f16 instance record the frame threads through setup: slim_rec
    folds it into the slim record, fused_inst_rec into the resolve record
    (which needs fused_resolve_rec + inst_rec_f16, else ValueError);
    otherwise None."""
    if config.slim_rec:
        return resolve_pass._inst_rec_f16(scene)
    if config.fused_inst_rec:
        if not (config.fused_resolve_rec and config.inst_rec_f16):
            raise ValueError(
                "fused_inst_rec requires fused_resolve_rec + inst_rec_f16")
        return resolve_pass._inst_rec_f16(scene)
    return None


@profiler.scoped("update")
def _update_scene(scene, moving_ids, globals_, joint_mats):
    """compute_update (moving instances, in place) and skinning: the
    skinned pool ranges recomputed from the joint matrices, the BLAS
    refit inside apply_skins and the TLAS refit so traced shadows follow
    the pose. Returns the frame's scene."""
    dev = scene.device
    update_pass.compute_update(scene.instances, moving_ids.to(dev),
                               globals_.time, globals_.dt)
    if scene.skins and joint_mats is not None:
        with profiler.scope("update.skin"):
            scene = dataclasses.replace(scene, meshes=skin_mod.apply_skins(
                scene.meshes, scene.skins, joint_mats.to(dev),
                batch=scene.skin_batch))
        if scene.tlas is not None:
            with profiler.scope("update.refit"):
                scene = dataclasses.replace(scene, tlas=skin_mod.refit_tlas(
                    scene.tlas, scene.meshes, scene.instances))
    return scene


def _emit_draws(scene, camera, enable_cull):
    """Frustum cull + LOD select + compaction, or every instance."""
    if enable_cull:
        return cull_pass.emit_draws(scene.meshes, scene.instances, camera)
    with profiler.scope("cull"):
        n = scene.instances.count
        draws = cull_pass.DrawList(
            instance=torch.arange(n, dtype=torch.int32, device=scene.device),
            count=torch.tensor(n, device=scene.device),
        )
        profiler.count("draws", draws.count)
    return draws


def _shard_vis(mesh, vis, bounds):
    """A whole-frame VisBuffer as one VisBuffer per slab (the block path
    of the sharded frame, as the JAX package shards its images)."""
    fields = [f for f in ("tri_id", "depth", "tri_id2", "depth2")
              if getattr(vis, f) is not None]
    split = {f: shard_mod.shard_rows(mesh, getattr(vis, f), bounds=bounds)
             for f in fields}
    recs = {dev: vis.resolve_rec.to(dev) for dev in mesh.distinct}
    return [VisBuffer(resolve_rec=recs[dev], overflow=vis.overflow.to(dev),
                      **{f: split[f][d] for f in fields})
            for d, dev in enumerate(mesh.devices)]


def _rows(x, r):
    """Rows r (a slice) of a G-buffer or ResolveAux's per-pixel fields."""
    if isinstance(x, GBuffer):
        return GBuffer(normal_uv=x.normal_uv[r], material=x.material[r],
                       depth=x.depth[r])
    return dataclasses.replace(x, albedo=x.albedo[r], emissive=x.emissive[r],
                               mr=x.mr[r])


def _render_frame_sharded(scene, camera, globals_, state, moving_ids, config,
                          enable_cull, enable_taa, enable_post,
                          enable_rt_shadows, rt_shadow_scale,
                          area_light_scale, mesh, joint_mats, replicas):
    """The row-sharded frame (JAX render_frame with a mesh, :90-266),
    each slab's work on its own device (parallel/sharding.py):

    * update, skinning and refits run replicated on every distinct
      device, the cull once on mesh.devices[0];
    * resolve takes no quad or slot fetch, TAA no quad-block or
      in-window history fetch (their compactions are the whole image's),
      as the JAX package's sharded frame does: the same words;
      planar_resolve stays;
    * the pair path rasterizes row-partitioned (rasterize_sharded: one
      K1 launch per slab); the block path rasterizes whole on
      mesh.devices[0] and splits the images, as the JAX package does;
    * resolve and shade run on each slab alone, on a window of rows: one
      row of halo below for the mip level's finite difference, and with
      area_light_scale = s one subsampled row of halo on each side for
      the upsample; raytraced shadows trace one launch per slab and point
      light, the fused LTC kernel runs once per slab;
    * TAA and postprocess read 3x3 neighbourhoods: each slab takes one
      halo row from each neighbour before each of them. TAA reprojection
      reads the history anywhere, so every distinct device holds the
      whole history, gathered from the slabs after each frame
      (state.history, on the history's device);
    * the sRGB image is gathered on mesh.devices[0].

    Every slab computes the words of its rows of the unsharded frame. The
    lazy alpha fallback is a compaction: each slab gets the whole frame's
    alpha_fallback_capacity, so it overflows only where the whole frame
    would (its window holds no more cut pixels than the frame)."""
    devs = mesh.devices
    primary = devs[0]
    bounds = shard_mod.slab_bounds(mesh, config)
    H = config.height
    if replicas is None:
        replicas = shard_mod.replicated(mesh, scene)
    scenes = {dev: _update_scene(sc, moving_ids, globals_, joint_mats)
              for dev, sc in replicas.items()}
    scene0 = scenes[primary]
    draws = _emit_draws(scene0, camera, enable_cull)
    inst_rec = frame_inst_rec(scene0, config)
    if config.backend == "pallas":
        vis = shard_mod.rasterize_sharded(
            scene0.meshes, scene0.instances, draws, camera, config, mesh,
            materials=scene0.materials, inst_rec=inst_rec, replicas=scenes)
    else:
        vis = _shard_vis(mesh, raster_pass.rasterize(
            scene0.meshes, scene0.instances, draws, camera, config,
            materials=scene0.materials, inst_rec=inst_rec), bounds)

    # resolve + shade per slab, on its window of rows
    config = dataclasses.replace(config, quad_rate_resolve=False,
                                 slot_resolve=False, taa_quad_history=False,
                                 taa_inwindow=False)
    s = 1 if enable_rt_shadows else area_light_scale
    fields = [f for f in ("tri_id", "depth", "tri_id2", "depth2")
              if getattr(vis[0], f) is not None]
    gbs, auxs, hdrs, rts = [], [], [], []
    for d, dev in enumerate(devs):
        r0, r1 = bounds[d]
        if s > 1:
            a = max(0, (r0 // s - 1) * s)
            b = min(H, ((r1 - 1) // s + 1) * s + 1)
        else:
            a, b = r0, min(H, r1 + 1)
        vis_w = VisBuffer(
            resolve_rec=vis[d].resolve_rec, overflow=vis[d].overflow,
            **{f: shard_mod.take_rows([getattr(v, f) for v in vis], bounds,
                                      a, b, dev) for f in fields})
        sc = scenes[dev]
        gb, aux_r = resolve_pass.resolve_gbuffer(
            sc, vis_w, config, row0=a, height=H, rows=(r0 - a, r1 - a))
        own = slice(r0 - a, r1 - a)
        if enable_rt_shadows:
            hdr, rt = shading_pass.shade_raytraced(
                sc, _rows(gb, own), camera, _rows(aux_r, own),
                shadow_scale=rt_shadow_scale, row0=r0, height=H)
            rts.append(rt)
        elif s > 1:
            hdr = shading_pass.shade(sc, gb, camera, aux_r,
                                     area_light_scale=s, row0=a,
                                     height=H)[own]
        else:
            hdr = shading_pass.shade(sc, _rows(gb, own), camera,
                                     _rows(aux_r, own), row0=r0, height=H)
        gbs.append(_rows(gb, own))
        auxs.append(aux_r)
        hdrs.append(hdr)

    def halo(slabs, d):
        """Slab d with one row of each neighbour: (rows, first row)."""
        r0, r1 = bounds[d]
        a, b = max(0, r0 - 1), min(H, r1 + 1)
        return shard_mod.take_rows(slabs, bounds, a, b, devs[d]), r0 - a

    if enable_taa:
        with profiler.scope("taa"):
            if state.history_valid:
                hist = {dev: state.history.to(dev) for dev in mesh.distinct}
                quads = {dev: taa_pass.history_quads(h)
                         for dev, h in hist.items()}
                outs = []
                for d, dev in enumerate(devs):
                    depth_w, top = halo([g.depth for g in gbs], d)
                    color_w, _ = halo(hdrs, d)
                    with profiler.scope("taa.reproject"):
                        motion = taa_pass.reproject(
                            GBuffer(normal_uv=None, material=None,
                                    depth=depth_w),
                            camera, row0=bounds[d][0] - top, height=H)
                    out, _ = taa_pass.taa_resolve(
                        color_w, hist[dev], motion, row0=bounds[d][0] - top,
                        quads=quads[dev])
                    outs.append(out[top:top + hdrs[d].shape[0]])
                    profiler.count("taa.eager_px",
                                   outs[-1].shape[0] * outs[-1].shape[1])
                hdrs = outs
            # the history after every slab has read it
            for (r0, r1), out in zip(bounds, hdrs):
                state.history[r0:r1].copy_(out)
            state.history_valid = True

    with profiler.scope("post"):
        srgbs = []
        for d in range(len(devs)):
            if enable_post:
                hdr_w, top = halo(hdrs, d)
                ldr = post_pass.postprocess(hdr_w)[top:top
                                                   + hdrs[d].shape[0]]
            else:
                ldr = hdrs[d]
            with profiler.scope("post.srgb"):
                srgbs.append(linear_to_srgb(ldr))
        srgb = shard_mod.gather_rows(srgbs, primary)

    def total(xs):
        return sum(x.to(primary) for x in xs)

    with profiler.scope("frame.end"):
        overflow = vis[0].overflow
        if auxs[0].overflow is not None:
            overflow = overflow + total(a.overflow for a in auxs)
        aux = dict(
            draw_count=draws.count,
            overflow=overflow,
            depth=shard_mod.gather_rows([g.depth for g in gbs], primary),
            vis_coverage=total((v.tri_id >= 0).sum() for v in vis),
        )
        if auxs[0].cut is not None:
            aux.update(alpha_cut=total(a.cut for a in auxs),
                       alpha_fallback=total(a.fallback for a in auxs))
        if rts:
            aux.update(rt_exhausted=total(r["exhausted"] for r in rts),
                       rt_rays=total(r["rays"] for r in rts))
        profiler.count("covered_px", aux["vis_coverage"])
    return srgb, state, scene0, aux


def frame_sources():
    """Source files whose edits must rebuild the frame pipeline — the
    import_mapping of the frame 'shader' (pipeline.rs:35-36): the pass
    modules, parallel/sharding.py, scene/skin.py and this module. No ops/
    module and no csrc/ file is listed: reloading an ops module would
    reset its launch counters and the kernel library's handle, and a CUDA
    source is rebuilt at the next process start, not hot-reloaded."""
    mods = [
        cull_pass, post_pass, raster_pass, resolve_pass, shading_pass,
        taa_pass, update_pass, shard_mod, skin_mod,
    ]
    files = [m.__file__ for m in mods if getattr(m, "__file__", None)]
    files.append(__file__)
    return files


class Renderer:
    """Host-side frame loop: owns the scene, the per-frame state and the
    jitter schedule."""

    def __init__(
        self,
        scene: SceneData,
        config: Optional[RasterConfig] = None,
        enable_cull: bool = True,
        enable_taa: bool = True,
        enable_post: bool = True,
        enable_rt_shadows: bool = False,
        rt_shadow_scale: int = 1,
        area_light_scale: int = 1,
        moving_ids: Optional[np.ndarray] = None,
        mesh=None,
        pipeline_cache=None,
    ):
        self.scene = scene
        config = config or RasterConfig()
        if config.slim_rec and not _slim_fits(scene):
            # outside slim's envelope, the JAX package's fallback: the
            # general records of the same gathers (kernel_payload rides
            # the slim record, so it goes too)
            config = dataclasses.replace(config, slim_rec=False,
                                         kernel_payload=False,
                                         fused_resolve_rec=True,
                                         inst_rec_f16=True)
        # runner-up tracking only when the scene has per-texel alpha-masked
        # materials (visibility.wgsl:79-81 semantics)
        self.config = dataclasses.replace(config,
                                          alpha_mask=scene.alpha_masked)
        self.enable_cull = enable_cull
        self.enable_taa = enable_taa
        self.enable_post = enable_post
        self.enable_rt_shadows = enable_rt_shadows
        self.rt_shadow_scale = rt_shadow_scale
        self.area_light_scale = area_light_scale
        self.mesh = mesh
        self._replicas = None
        if mesh is not None:
            shard_mod.slab_bounds(mesh, self.config)  # raises on odd slabs
            self._replicas = shard_mod.replicated(mesh, scene)
        # the frame's device: the mesh's first, where the image gathers
        self.device = scene.device if mesh is None else mesh.devices[0]
        self.state = FrameState.initial(self.config.width, self.config.height,
                                        self.device)
        self.moving_ids = torch.as_tensor(
            np.asarray(moving_ids if moving_ids is not None else [],
                       np.int32),
            device=self.device,
        )
        self.jitter = JitterSequence()
        self.frame_count = 0
        self.time = 0.0
        self._prev_uniform = None
        self.aux = None
        self._fn = None
        if pipeline_cache is not None:
            self._fn = pipeline_cache.register("frame", self._build_frame,
                                               sources=frame_sources())

    def _build_frame(self):
        """The frame function over this Renderer's options, with
        render_frame resolved from the live module, so a reload of any
        pass module (or this one) is picked up at rebuild time — the
        PipelineArena hot-swap semantics (app/pipeline.rs:253-351)."""
        import importlib

        rf = importlib.import_module(__name__).render_frame

        def frame(scene, uniform, globals_, state, moving_ids, joint_mats):
            # the bounds mode for this frame only, on this thread
            with checks.bounds(self.config.debug_bounds):
                return rf(scene, uniform, globals_, state, moving_ids,
                          self.config, enable_cull=self.enable_cull,
                          enable_taa=self.enable_taa,
                          enable_post=self.enable_post,
                          enable_rt_shadows=self.enable_rt_shadows,
                          rt_shadow_scale=self.rt_shadow_scale,
                          area_light_scale=self.area_light_scale,
                          mesh=self.mesh, joint_mats=joint_mats,
                          replicas=self._replicas)

        return frame

    def render(self, camera: Camera, dt: float = 1.0 / 60.0,
               joint_mats=None) -> torch.Tensor:
        """One frame at `camera`; `joint_mats` ((J, 4, 4), array or
        tensor) poses the scene's skins and is required when it has
        any. The Renderer's scene keeps the rest pose: every frame skins
        it anew. The frame runs in the profiler's scope "frame", numbered
        by frame_count."""
        with profiler.scope("frame", frame=self.frame_count):
            with profiler.scope("frame.begin"):
                if self.scene.skins:
                    if joint_mats is None:
                        raise ValueError("scene has skinning regions: pass "
                                         "joint_mats")
                    jm = torch.as_tensor(joint_mats, dtype=torch.float32,
                                         device=self.device)
                else:
                    jm = torch.zeros(0, 4, 4, device=self.device)
                if self.enable_taa:
                    camera.jitter = self.jitter.get_jitter(
                        self.frame_count, self.config.width,
                        self.config.height)
                uniform = camera.uniform(previous=self._prev_uniform)
                self._prev_uniform = uniform
                globals_ = Globals.make(self.config.width,
                                        self.config.height,
                                        frame=self.frame_count,
                                        time=self.time, dt=dt)
            frame = self._fn or self._build_frame()
            img, self.state, _, self.aux = frame(
                self.scene, uniform, globals_, self.state, self.moving_ids,
                jm)
            self.frame_count += 1
            self.time += dt
        return img


def _slim_fits(scene: SceneData) -> bool:
    """RasterConfig.slim_rec's envelope: no normal maps, const-folded 1x1
    emissive and metallic-roughness textures, no alpha masking, and
    material and texture ids exact in f16."""
    return (scene.no_normal_maps and scene.emissive_const and scene.mr_const
            and not scene.alpha_masked
            and scene.materials.albedo.shape[0] <= 2048
            and scene.textures.size.shape[0] <= 2048)


def build_world(n_instances=10_000, seed=0):
    """The north-star scene (a copy of bench.build_world on the port's
    World): 10k instances of LOD'd spheres and cubes with two 256^2
    textures in a 400x400 field, a ground plane, 2 rect area lights and
    1 point light. Returns (world, moving instance ids)."""
    rng = np.random.default_rng(seed)
    w = World()
    w.lights.add_point_light([0, 10.0, 0], 40.0, [1.0, 0.95, 0.9])
    w.add_area_light(
        [1, 1, 1], 7.0, (5.0, 8.0),
        np.asarray(mathx.from_translation([0, 18, 10])
                   @ mathx.from_rotation_x(np.float32(-np.pi / 4))),
    )
    w.add_area_light(
        [1, 0.8, 0.6], 5.0, (6.0, 6.0),
        np.asarray(mathx.from_translation([0, 18, -40])
                   @ mathx.from_rotation_x(np.float32(-3 * np.pi / 4))),
    )
    yy, xx = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    checker = ((xx // 16 + yy // 16) % 2 * 155 + 100).astype(np.uint8)
    tex_checker = w.textures.add(
        np.stack([checker, checker // 2 + 64, checker // 3 + 42], -1),
        srgb=True,
    )
    noise = rng.integers(60, 220, (256, 256, 3)).astype(np.uint8)
    tex_noise = w.textures.add(noise, srgb=True)
    mat_checker = w.materials.add(albedo=tex_checker)
    mat_noise = w.materials.add(albedo=tex_noise)

    sphere2 = w.meshes.add(mesh_mod.make_uv_sphere(1.0, 2))
    sphere3 = w.meshes.add(mesh_mod.make_uv_sphere(1.0, 3))
    cube = w.meshes.add(mesh_mod.make_cube_mesh(1.5))
    meshes = [sphere2, cube, sphere3, mesh_mod.SPHERE_1_MESH]
    sphere1 = mesh_mod.SPHERE_1_MESH
    w.meshes.set_lods(sphere3, [(sphere2, 8.0), (sphere1, 20.0)])
    w.meshes.set_lods(sphere2, [(sphere1, 14.0)])

    moving = []
    for i in range(n_instances - len(w.instances)):
        x = rng.uniform(-200, 200)
        z = rng.uniform(-200, 200)
        y = rng.uniform(-2, 6)
        t = mathx.from_translation([x, y, z]) @ mathx.from_scale(
            float(rng.uniform(0.5, 1.5))
        )
        mid = int(rng.integers(0, len(meshes)))
        idx = w.instances.add(
            np.asarray(t), meshes[mid], mat_checker if i % 2 else mat_noise
        )
        if i % 50 == 0:
            moving.append(idx)
    w.instances.add(
        np.asarray(mathx.from_translation([0, -3, 0])
                   @ mathx.from_scale(500.0)),
        mesh_mod.HORIZONTAL_PLANE_MESH,
        0,
    )
    return w, np.asarray(moving, np.int32)

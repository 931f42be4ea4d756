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
``frame_sources()`` changes on disk (hot reload). It raises
NotImplementedError for what the port does not carry:
area_light_scale > 1, a device mesh, the JAX package's gather-economy
RasterConfig options, and slim_rec on a scene outside its envelope (where
the JAX package falls back to fused_resolve_rec + inst_rec_f16).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import mathx
from ..core.camera import Camera, CameraUniform
from ..core.jitter import JitterSequence
from ..passes import cull as cull_pass
from ..passes import postprocess as post_pass
from ..passes import raster as raster_pass
from ..passes import resolve as resolve_pass
from ..passes import shading as shading_pass
from ..passes import taa as taa_pass
from ..passes import update as update_pass
from ..passes.raster import RasterConfig
from ..scene import mesh as mesh_mod
from ..scene import skin as skin_mod
from ..scene.scene import SceneData, World
from ..scene.texture import linear_to_srgb


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
                 joint_mats=None):
    """Full frame. Returns (srgb_image, state, scene, aux). The moving
    instances' transforms and the TAA history update in place. Without
    post the frame is the sRGB of the HDR (no sharpen, no tonemap). With
    raytraced shadows aux also holds rt_exhausted (shadow rays still
    walking at the step limit) and rt_rays (shadow rays traced).
    `joint_mats` ((J, 4, 4) world-joint @ inverse-bind, composed on the
    host each frame) drives the scene's skinning regions: the returned
    scene holds the skinned pool tables and the refit BLAS and TLAS."""
    # 1. compute_update: animate moving instances; skinning recomputes the
    # skinned pool ranges from the joint matrices
    update_pass.compute_update(scene.instances, moving_ids, globals_.time,
                               globals_.dt)
    if scene.skins and joint_mats is not None:
        scene = dataclasses.replace(scene, meshes=skin_mod.apply_skins(
            scene.meshes, scene.skins, joint_mats))
        if scene.tlas is not None:
            # the skinned AABBs moved: refit the TLAS so traced shadows
            # follow the pose (the BLAS refit ran in apply_skins)
            scene = dataclasses.replace(scene, tlas=skin_mod.refit_tlas(
                scene.tlas, scene.meshes, scene.instances))
    # 2. emit_draws: frustum cull + LOD select + compaction
    if enable_cull:
        draws = cull_pass.emit_draws(scene.meshes, scene.instances, camera)
    else:
        n = scene.instances.count
        draws = cull_pass.DrawList(
            instance=torch.arange(n, dtype=torch.int32, device=scene.device),
            count=torch.tensor(n, device=scene.device),
        )
    # 3. visibility raster + G-buffer resolve; slim_rec threads the f16
    # instance record through setup into the slim resolve record
    inst_rec = resolve_pass._inst_rec_f16(scene) if config.slim_rec else None
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
        hdr = shading_pass.shade(scene, gbuffer, camera, aux_r)
    # 5. TAA (reproject + resolve into history)
    if enable_taa:
        hdr, state = taa_pass.taa(hdr, gbuffer, camera, state)
    # 6. postprocess (sharpen + tonemap) + sRGB encode
    srgb = linear_to_srgb(post_pass.postprocess(hdr) if enable_post
                          else hdr)
    overflow = vis.overflow
    if aux_r.overflow is not None:
        overflow = overflow + aux_r.overflow  # alpha-fallback capacity
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
    return srgb, state, scene, aux


def frame_sources():
    """Source files whose edits must rebuild the frame pipeline — the
    import_mapping of the frame 'shader' (pipeline.rs:35-36): the pass
    modules, scene/skin.py and this module. The JAX package also lists
    parallel/sharding.py, which the port does not have. No ops/ module
    and no csrc/ file is listed: reloading an ops module would reset its
    launch counters and the kernel library's handle, and a CUDA source is
    rebuilt at the next process start, not hot-reloaded."""
    mods = [
        cull_pass, post_pass, raster_pass, resolve_pass, shading_pass,
        taa_pass, update_pass, skin_mod,
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
        **options,
    ):
        unsupported = []
        if area_light_scale != 1:
            unsupported.append("area_light_scale > 1")
        if mesh is not None:
            unsupported.append("a device mesh")
        for k, v in options.items():
            if k not in raster_pass.UNSUPPORTED_OPTIONS:
                raise TypeError(f"unknown Renderer option {k!r}")
            if v:
                unsupported.append(k)
        if config is not None and config.slim_rec and not _slim_fits(scene):
            # the JAX package switches to fused_resolve_rec + inst_rec_f16
            # here; the port carries neither
            unsupported.append(
                "slim_rec outside its envelope (the fallback "
                "fused_resolve_rec + inst_rec_f16)")
        if unsupported:
            raise NotImplementedError(
                "not ported to voidin_tpu_torch: " + ", ".join(unsupported)
            )
        self.scene = scene
        # runner-up tracking only when the scene has per-texel alpha-masked
        # materials (visibility.wgsl:79-81 semantics)
        self.config = dataclasses.replace(config or RasterConfig(),
                                          alpha_mask=scene.alpha_masked)
        self.enable_cull = enable_cull
        self.enable_taa = enable_taa
        self.enable_post = enable_post
        self.enable_rt_shadows = enable_rt_shadows
        self.rt_shadow_scale = rt_shadow_scale
        self.device = scene.device
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
            return rf(scene, uniform, globals_, state, moving_ids,
                      self.config, enable_cull=self.enable_cull,
                      enable_taa=self.enable_taa,
                      enable_post=self.enable_post,
                      enable_rt_shadows=self.enable_rt_shadows,
                      rt_shadow_scale=self.rt_shadow_scale,
                      joint_mats=joint_mats)

        return frame

    def render(self, camera: Camera, dt: float = 1.0 / 60.0,
               joint_mats=None) -> torch.Tensor:
        """One frame at `camera`; `joint_mats` ((J, 4, 4), array or
        tensor) poses the scene's skins and is required when it has
        any. The Renderer's scene keeps the rest pose: every frame skins
        it anew."""
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
                self.frame_count, self.config.width, self.config.height
            )
        uniform = camera.uniform(previous=self._prev_uniform)
        self._prev_uniform = uniform
        globals_ = Globals.make(self.config.width, self.config.height,
                                frame=self.frame_count, time=self.time, dt=dt)
        frame = self._fn or self._build_frame()
        img, self.state, _, self.aux = frame(
            self.scene, uniform, globals_, self.state, self.moving_ids, jm)
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

"""Application framework: the Example protocol + headless runner.

Counterpart of ``voidin_tpu/framework/app.py``: the reference's L5 API
(crates/app/src/lib.rs:47-205). An Example implements init / setup_scene /
update / resize hooks, and `run()` drives the fixed-timestep loop
(UPDATES_PER_SECOND = 60, MAX_FRAME_TIME clamp, lib.rs:41-43). The runner
is headless: frames go to the recorder (mp4 via ffmpeg, MJPEG-AVI without
it), to PNG screenshots, or nowhere (benchmarking); the terminal and web
viewers drive `App.step()` themselves.

The App's scene and frames live on `device`: the card unless the caller
asks for another ("cpu" in the tests); without a card, the default raises
as World.device() does. `step` returns the frame as a tensor on that
device; `run` copies each recorded frame to the host once.
"""

from __future__ import annotations

import dataclasses as _dc
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..core.camera import Camera
from ..passes.raster import RasterConfig
from ..scene.scene import World
from .pipeline import PipelineCache
from .recorder import Recorder
from .renderer import Renderer

UPDATES_PER_SECOND = 60  # lib.rs:41
FIXED_TIME_STEP = 1.0 / UPDATES_PER_SECOND
MAX_FRAME_TIME = 15 * FIXED_TIME_STEP  # lib.rs:43


@dataclass
class AppState:
    """Host simulation state (app/state.rs:15-85)."""

    camera: Camera = field(default_factory=lambda: Camera(position=[0.0, 0.0, 5.0]))
    frame_count: int = 0
    total_time: float = 0.0
    dt: float = FIXED_TIME_STEP


class FpsCounter:
    """8-frame moving average (fps_counter.rs:19-25) of the host time
    between ticks."""

    def __init__(self, window: int = 8):
        self.times = []
        self.window = window
        self._last = None

    def tick(self) -> float:
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
            self.times = self.times[-self.window :]
        self._last = now
        if not self.times:
            return 0.0
        return len(self.times) / sum(self.times)


class Example:
    """Override points for applications (Example trait, lib.rs:47-59)."""

    name = "example"

    def init(self, app: "App") -> None:  # construct passes / settings
        pass

    def setup_scene(self, app: "App") -> None:  # populate app.world
        pass

    def update(self, app: "App", state: AppState) -> None:  # per fixed tick
        pass

    def resize(self, app: "App", width: int, height: int) -> None:
        pass


class App:
    """Owns the world, renderer and frame loop (App struct, app.rs:58-81)."""

    def __init__(
        self,
        example: Example,
        camera: Optional[Camera] = None,
        config: Optional[RasterConfig] = None,
        with_tlas: bool = False,
        enable_rt_shadows: bool = False,
        enable_taa: bool = True,
        device="cuda",
    ):
        self.example = example
        self.device = device
        self.config = config or RasterConfig(width=1280, height=1024)
        self.world = World()
        self.state = AppState(
            camera=camera or Camera(position=[0.0, 0.0, 5.0])
        )
        self.state.camera.aspect = self.config.width / self.config.height
        self.moving_ids: list = []
        self.recorder = Recorder(self.config.width, self.config.height)
        self.fps = FpsCounter()
        self._with_tlas = with_tlas or enable_rt_shadows
        self._rt = enable_rt_shadows
        self._taa = enable_taa
        self.renderer: Optional[Renderer] = None
        # Live pipeline registry: the frame fn and any user post hooks route
        # through it, so editing a pass module mid-run rebuilds the live
        # renderer's frame (PipelineArena + Watcher, app/pipeline.rs:253-351).
        self.pipelines = PipelineCache()
        self.post_hooks: list = []  # (H,W,3)->(H,W,3) callables on the frame
        # (J, 4, 4) joint matrices for skinned scenes; examples update this
        # in Example.update (e.g. via io.gltf.GltfAnimator).
        self.joint_mats = None

        example.init(self)
        example.setup_scene(self)
        self._freeze()

    def _freeze(self):
        # the old Renderer (its scene and frame state) goes before the new
        # one is built: neither App.renderer nor the cache's "frame" entry
        # keeps it
        self.renderer = None
        self.pipelines.discard("frame")
        scene = self.world.device(self.device, with_tlas=self._with_tlas)
        self.renderer = Renderer(
            scene,
            self.config,
            enable_taa=self._taa,
            enable_rt_shadows=self._rt,
            moving_ids=np.asarray(self.moving_ids, np.int32),
            pipeline_cache=self.pipelines,
        )

    def resize(self, width: int, height: int):
        """Recreate the frame pipeline at a new resolution (App::resize,
        app.rs:360-377: GBuffer/ViewTarget recreate + camera aspect)."""
        if (width, height) == (self.config.width, self.config.height):
            return
        self.config = _dc.replace(self.config, width=width, height=height)
        self.state.camera.aspect = width / height
        self.recorder = Recorder(width, height)
        self._freeze()
        self.example.resize(self, width, height)

    def add_area_light(self, color, intensity, wh, transform):
        self.world.add_area_light(color, intensity, wh, transform)

    def step(self):
        """One fixed-timestep update + render; returns the frame tensor on
        the App's device."""
        self.pipelines.poll()  # hot reload: file events, lib.rs:196-198
        self.state.camera.update(FIXED_TIME_STEP)
        self.example.update(self, self.state)
        img = self.renderer.render(
            self.state.camera, dt=FIXED_TIME_STEP,
            joint_mats=self.joint_mats,
        )
        for hook in self.post_hooks:
            img = hook(img)
        self.state.frame_count += 1
        self.state.total_time += FIXED_TIME_STEP
        self.state.dt = FIXED_TIME_STEP
        return img

    def screenshot(self, path: str):
        from ..io.image import save_png

        save_png(path, self.step().cpu().numpy())

    def run(self, frames: int, record_path: Optional[str] = None,
            hud: bool = False):
        """Headless loop: `frames` fixed-timestep frames; optional video.

        `hud=True` burns an FPS readout into recorded frames (host-side —
        the egui debug window equivalent, model.rs:221-228). Returns the
        last FPS reading."""
        fps = 0.0
        if record_path:
            self.recorder.start(record_path)
        try:
            for _ in range(frames):
                img = self.step()
                fps = self.fps.tick()
                if record_path:
                    frame = img.detach().to("cpu", copy=True).numpy()
                    if hud:
                        from ..passes.hud import draw_hud_np

                        frame = draw_hud_np(frame, f"fps: {fps:5.1f}")
                    self.recorder.push(frame)
            return fps
        finally:
            if record_path:
                self.recorder.finish()

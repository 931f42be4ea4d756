"""The system under test: the port's Renderer over a configuration's
scene, built the way a user of voidin_tpu_torch builds it."""

import numpy as np


def make_renderer(config, scene, device):
    """The port's Renderer for `config` and the benchmark's `scene` on
    `device`, at the configuration's width and height."""
    from voidin_tpu_torch.framework.renderer import Renderer
    from voidin_tpu_torch.passes.raster import RasterConfig

    from . import scene as sc

    world = sc.to_world(scene)
    data = world.device(device, with_tlas=bool(config["with_tlas"]))
    cfg = RasterConfig(width=config["width"], height=config["height"],
                       **config["raster"])
    r = config["renderer"]
    renderer = Renderer(data, cfg, moving_ids=np.asarray(scene.moving,
                                                         np.int32), **r)
    return renderer


def camera(pose, width, height):
    from voidin_tpu_torch.core.camera import Camera

    pos, yaw, pitch = pose
    return Camera(position=list(pos), yaw=yaw, pitch=pitch,
                  aspect=width / height)

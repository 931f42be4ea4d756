"""Scene snapshot: a SceneData and a camera in one ``.npz``.

The feature of ``voidin_tpu/io/snapshot.py`` (deterministic replay and
image-diff validation: a scene saved once renders the same frame when
loaded), not its format: that one is a flat stream of a flax pytree's
leaves, full of the TPU's tables. This one holds the scene's named host
leaves and statics (``scene.scene_to_numpy``, the names of
``World.host_leaves``) and the camera:

* ``leaf:<dotted name>``: each leaf, typed as the host holds it;
* ``statics``: the static flags as UTF-8 JSON bytes;
* ``camera``: position, yaw, pitch, aspect (f64, so that a Python float
  such as the aspect 16 / 9 comes back exactly), when one is given;
* ``version``: SNAPSHOT_VERSION.

As in the JAX package, skins are not snapshotted (they are rebuilt from
their assets; a loaded scene has none), and a file of another version, or
without the marker, is refused with a ValueError.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import numpy as np

from ..core.camera import Camera
from ..scene.scene import SceneData, scene_from_numpy, scene_to_numpy

# v1: named host leaves + JSON statics (the first format of this package)
# v2: as v1; files saved before the port dropped the pool's tap-block
#     tables also carry statics["tap_blocks"], which scene_from_numpy
#     ignores
SNAPSHOT_VERSION = 2


def save_scene(path: str, scene: SceneData,
               camera: Optional[Camera] = None) -> None:
    # skins are rebuilt from their assets, as in the JAX package
    leaves, statics = scene_to_numpy(dataclasses.replace(scene, skins=()))
    payload = {f"leaf:{k}": v for k, v in leaves.items()}
    payload["statics"] = np.frombuffer(json.dumps(statics).encode("utf-8"),
                                       np.uint8)
    payload["version"] = np.asarray([SNAPSHOT_VERSION], np.int64)
    if camera is not None:
        payload["camera"] = np.asarray(
            [*camera.position, camera.yaw, camera.pitch, camera.aspect],
            np.float64)
    np.savez_compressed(path, **payload)


def load_scene(path: str, device="cuda"
               ) -> Tuple[SceneData, Optional[Camera]]:
    """(scene on `device`, camera or None) from a snapshot; the card
    unless the caller asks for another device."""
    with np.load(path, allow_pickle=False) as data:
        if "version" not in data:
            raise ValueError(
                f"snapshot {path!r} has no version marker; this build reads "
                f"voidin_tpu_torch snapshots of v{SNAPSHOT_VERSION}")
        version = int(data["version"][0])
        if version != SNAPSHOT_VERSION:
            raise ValueError(
                f"snapshot {path!r} is format v{version}, this build reads "
                f"v{SNAPSHOT_VERSION}; re-save the scene with this build")
        leaves = {k[len("leaf:"):]: data[k] for k in data.files
                  if k.startswith("leaf:")}
        statics = json.loads(bytes(data["statics"]).decode("utf-8"))
        cam = data["camera"] if "camera" in data else None
    scene = scene_from_numpy(leaves, statics, device)
    camera = None
    if cam is not None:
        camera = Camera(position=cam[:3], yaw=float(cam[3]),
                        pitch=float(cam[4]), aspect=float(cam[5]))
    return scene, camera

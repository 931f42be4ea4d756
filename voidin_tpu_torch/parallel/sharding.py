"""Multi-device sharding: screen-row data parallelism.

Counterpart of ``voidin_tpu/parallel/sharding.py``. The natural
multi-device mapping of this workload is sort-middle screen-space
partitioning: scene state replicated, the per-pixel passes (fine raster,
G-buffer resolve, shading, TAA, postprocess) split over tile rows. The
JAX package writes that as sharding constraints inside one jitted frame
and shard_map for the raster, one program driving every device; the port
drives a ``RowMesh``, a list of devices, from one process the same way:
each slab's work is issued to its own device in turn, so on several cards
the slabs run at once. A mesh may name one device more than once (the
counterpart of the JAX tests' --xla_force_host_platform_device_count):
one card then runs every slab's code path in turn, and the frame is the
same. ``make_mesh`` never repeats a device on its own.

``rasterize_sharded`` is the row-PARTITIONED raster: setup slot-sliced
per device and all-gathered, then one binning and one launch of K1 per
slab over that slab's tile rows only. The per-pixel passes of the sharded
frame are framework/renderer.py's; ``shard_rows``, ``gather_rows`` and
``take_rows`` move row slabs, ``replicated`` the scene.

The JAX module's ``shard_map_unchecked`` is a shim over JAX versions and
has no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..framework import profiler

ROW_AXIS = "rows"


def local_pair_capacity(pair_capacity: int, n_dev: int) -> int:
    """Per-device pair capacity of the row-partitioned raster: the slab
    clamp leaves each device ~1/N of the multi-tile extras, so the extras
    window EB = pair_capacity // 4 shrinks to EB / N (floor: one K1 chunk
    of records)."""
    from ..ops.fine_raster import CHUNK

    eb = max(CHUNK, -(-(pair_capacity // 4) // n_dev))
    return 4 * eb


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


@dataclasses.dataclass(frozen=True)
class RowMesh:
    """The devices of a row-sharded frame, slab d on devices[d]."""

    devices: tuple
    axis_names = (ROW_AXIS,)

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices",
                           tuple(_device(d) for d in self.devices))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> tuple:
        """The devices the mesh names, each once, in order."""
        return tuple(dict.fromkeys(self.devices))


def make_mesh(n_devices: Optional[int] = None, devices=None) -> RowMesh:
    """A RowMesh over `devices` (any torch devices; one may repeat) or,
    without them, over the first `n_devices` visible CUDA devices (all of
    them by default). Asking for more cards than are visible raises, as
    the JAX package's make_mesh does."""
    if devices is not None:
        devices = tuple(devices)
        if n_devices is not None and n_devices != len(devices):
            raise ValueError(f"n_devices={n_devices} but {len(devices)} "
                             "devices named")
        return RowMesh(devices)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n_devices is None else n_devices
    if n < 1 or have < n:
        raise RuntimeError(
            f"need {max(n, 1)} CUDA devices, have {have} (to run {max(n, 1)} "
            f"slabs on one card name it for each: make_mesh(devices="
            f"[torch.device(\"cuda:0\")] * {max(n, 1)}))")
    return RowMesh(tuple(torch.device("cuda", i) for i in range(n)))


def slab_bounds(mesh: RowMesh, config):
    """[(first row, end row)] of each slab of a `config` frame: tiles_y /
    N tile rows each, the last cut at the image's height. Raises where the
    tile rows do not divide evenly (the port keeps the JAX package's rule
    and has no uneven slabs)."""
    n, TY = mesh.size, config.tiles_y
    if TY % n:
        raise ValueError(
            f"tiles_y={TY} must divide evenly across {n} devices "
            f"(pad height to a multiple of {config.tile_h * n})")
    rows = TY // n * config.tile_h
    return [(d * rows, min((d + 1) * rows, config.height)) for d in range(n)]


def shard_rows(mesh: Optional[RowMesh], *arrays, bounds=None):
    """Split (H, ...) tensors into row slabs, slab d on mesh.devices[d]:
    `bounds` ([(first, end)] per slab, slab_bounds) or H / N rows each.
    Returns one list of slabs per array (the list alone for one array);
    without a mesh, the arrays unchanged."""
    if mesh is None:
        return arrays if len(arrays) > 1 else arrays[0]
    out = []
    for a in arrays:
        if bounds is None:
            if a.shape[0] % mesh.size:
                raise ValueError(f"{a.shape[0]} rows do not split evenly "
                                 f"across {mesh.size} devices")
            h = a.shape[0] // mesh.size
            bds = [(d * h, (d + 1) * h) for d in range(mesh.size)]
        else:
            bds = bounds
        out.append([a[r0:r1].to(dev)
                    for (r0, r1), dev in zip(bds, mesh.devices)])
    return tuple(out) if len(out) > 1 else out[0]


def gather_rows(slabs, device=None) -> torch.Tensor:
    """The image of its row slabs, on `device` (default the first slab's)."""
    device = slabs[0].device if device is None else device
    return torch.cat([s.to(device) for s in slabs])


def take_rows(slabs, bounds, a: int, b: int, device) -> torch.Tensor:
    """Image rows [a, b) from the slabs that hold them, on `device`: a
    slab with the rows of its neighbours around it (a halo exchange)."""
    parts = [s[max(a, r0) - r0:min(b, r1) - r0].to(device)
             for s, (r0, r1) in zip(slabs, bounds) if r0 < b and a < r1]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def replicated(mesh: Optional[RowMesh], scene):
    """{device: the scene on it}, one copy per distinct device of the
    mesh; `scene` itself serves its own device. Without a mesh, {its
    device: scene}."""
    from ..scene.scene import scene_from_numpy, scene_to_numpy

    if mesh is None:
        return {scene.device: scene}
    host = None
    out = {}
    for dev in mesh.distinct:
        if dev == _device(scene.device):
            out[dev] = scene
            continue
        host = host or scene_to_numpy(scene)
        out[dev] = scene_from_numpy(*host, dev)
    return out


@profiler.scoped("raster")
def rasterize_sharded(meshes, instances, draws, camera, config, mesh,
                      materials=None, inst_rec=None, replicas=None):
    """Row-PARTITIONED raster: each device bins and fine-rasterizes ONLY
    its own tile rows (sort-middle parallel rasterization), as the JAX
    package's shard_map body does (:109-217):

    * setup_draw_records once, on the draws' device;
    * setup_work_slice(lo=d * cap / N, num=cap / N) on each shard's
      device: 1/N of the transform work;
    * the parts concatenated in slot order onto every distinct device
      (the tiled all_gather), then setup_finalize once per distinct
      device, so every device holds the whole packed stream, the same
      words as the unsharded setup's;
    * per shard, bin_triangles_pairs(ty_range=(d * rows, rows)) at
      local_pair_capacity, and ONE launch of K1 (track2 when
      config.alpha_mask) on the shard's device over its slab's tiles;
    * the bin overflows summed, plus the setup overflow.

    `replicas` ({device: SceneData}, framework/renderer.py) supplies each
    device's pool tables; without it they are copied there. Returns one
    VisBuffer per shard on its device: the slab's rows of the images
    (slab_bounds), the device's resolve records, and the whole frame's
    overflow (as the JAX package's psum leaves it on every device). K1
    hands over no payload here (RasterConfig.kernel_payload): resolve
    gathers the rows, which is bit-identical."""
    from ..ops import fine_raster as fr
    from ..passes import raster as raster_pass
    from ..passes.gbuffer import VisBuffer

    if config.kernel_payload and not config.slim_rec:
        raise ValueError("kernel_payload requires slim_rec")
    n_dev = mesh.size
    bounds = slab_bounds(mesh, config)
    cap = config.tri_capacity
    if cap % n_dev:
        raise ValueError(
            f"tri_capacity={cap} must divide evenly across {n_dev} devices")
    local_cfg = dataclasses.replace(
        config,
        pair_capacity=local_pair_capacity(config.pair_capacity, n_dev))
    TX, th, tw = config.tiles_x, config.tile_h, config.tile_w
    slots_per = cap // n_dev
    rows_per = config.tiles_y // n_dev
    track2 = config.alpha_mask

    def pool(dev):
        m = meshes if replicas is None else replicas[dev].meshes
        tri_attr = (m.tri_attr_packed
                    if config.slim_rec or config.fused_resolve_rec else None)
        return (m.tri_pos.to(dev),
                None if tri_attr is None else tri_attr.to(dev))

    with profiler.scope("raster.setup"):
        draw_rec, n_tris, cum_draws = raster_pass.setup_draw_records(
            meshes, instances, draws, camera, config, materials=materials,
            inst_rec=inst_rec)
        parts = []
        for d, dev in enumerate(mesh.devices):
            tri_pos, tri_attr = pool(dev)
            parts.append(raster_pass.setup_work_slice(
                tri_pos, tri_attr, draw_rec.to(dev), n_tris.to(dev), config,
                lo=d * slots_per, num=slots_per))
        setups = {}
        for dev in mesh.distinct:
            gathered = {k: torch.cat([p[k].to(dev) for p in parts])
                        for k in parts[0]}
            setups[dev] = raster_pass.setup_finalize(gathered,
                                                     cum_draws.to(dev),
                                                     config)
        profiler.count("overflow.setup",
                       setups[mesh.distinct[0]]["setup_overflow"])

    slabs, overflows = [], []
    for d, dev in enumerate(mesh.devices):
        with profiler.scope("raster.bin"):
            rec_sorted, starts, counts, overflow = \
                raster_pass.bin_triangles_pairs(
                    setups[dev], local_cfg, ty_range=(d * rows_per,
                                                      rows_per))
            raster_pass.count_bins(counts, overflow)
        with profiler.scope("raster.k1"):
            outs = fr.fine_raster_pairs(rec_sorted, starts, counts,
                                        track2=track2)
        r0, r1 = bounds[d]

        def untile(a):
            return (a[:rows_per * TX].reshape(rows_per, TX, th, tw)
                    .permute(0, 2, 1, 3)
                    .reshape(rows_per * th, TX * tw)[:r1 - r0,
                                                     :config.width])

        slabs.append([untile(o) for o in outs])
        overflows.append(overflow)
    vis = []
    for d, dev in enumerate(mesh.devices):
        outs = slabs[d]
        total = sum(o.to(dev) for o in overflows)
        vis.append(VisBuffer(
            tri_id=outs[1].to(torch.int32),
            depth=outs[0],
            resolve_rec=setups[dev]["resolve_rec"],
            overflow=total + setups[dev]["setup_overflow"],
            tri_id2=outs[3].to(torch.int32) if track2 else None,
            depth2=outs[2] if track2 else None,
        ))
    return vis

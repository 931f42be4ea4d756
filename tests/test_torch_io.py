"""Port parity: scene import and snapshots (voidin_tpu_torch.io: gltf, obj,
snapshot, image) against the JAX package's io modules.

- glTF: chip_smoke.write_import_scene's scene, as .glb (buffer and image
  in the BIN chunk) and as .gltf (data URIs), imported by both packages
  into identical pools, materials, textures, instances and skins; the
  node-transform document of tests/test_skin.py:219 through
  scene_instances; GltfAnimator's joint matrices equal to JAX's at several
  times, on that scene and on tests/test_skin.py's synthetic skeleton; the
  skinned glTF frame within 5e-3 of JAX's; a progressive JPEG image
  refused with NotImplementedError naming it, a missing image file
  replaced by WHITE with a warning, as JAX does.
- PNG: colour types 0 (grey), 3 (palette, with and without tRNS) and 4
  (grey + alpha) decode to the RGBA of PIL's convert("RGBA") (PIL exists
  here, not on the card's host).
- OBJ: negative indices, the .mtl colours, material groups; equal pools.
- Snapshots: the leaves and statics round trip word for word with the
  camera; a file of another version or without the marker is refused; a
  loaded scene renders the identical frame on the CPU.
"""

import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import voidin_tpu as vt
from voidin_tpu.framework.renderer import Renderer as JaxRenderer
from voidin_tpu.io import gltf as j_gltf
from voidin_tpu.io import obj as j_obj
from voidin_tpu.passes.raster import RasterConfig as JaxRasterConfig

import voidin_tpu_torch as pt
from voidin_tpu_torch.core import mathx
from voidin_tpu_torch.framework import presets as t_presets
from voidin_tpu_torch.framework.renderer import Renderer
from voidin_tpu_torch.io import gltf as t_gltf
from voidin_tpu_torch.io import obj as t_obj
from voidin_tpu_torch.io.image import decode_png, load_image
from voidin_tpu_torch.io.snapshot import (SNAPSHOT_VERSION, load_scene,
                                          save_scene)
from voidin_tpu_torch.passes.raster import RasterConfig
from voidin_tpu_torch.scene.scene import scene_to_numpy

import chip_smoke
from tests.test_skin import _synthetic_gltf
from tests.test_torch_presets import assert_worlds_equal

torch.set_num_threads(2)
BUDGET = 5e-3


@pytest.fixture
def numpy_builders(monkeypatch):
    """Both packages on the numpy BVH builder and texture packer."""
    import voidin_tpu.native

    monkeypatch.setenv("VOIDIN_NATIVE", "0")
    monkeypatch.setattr(voidin_tpu.native, "pack_texture",
                        lambda *a, **k: None)


@pytest.fixture
def scene_files(tmp_path):
    return chip_smoke.write_import_scene(str(tmp_path))


@pytest.mark.parametrize("kind", ["glb", "gltf"])
def test_gltf_import_matches_jax(kind, scene_files, numpy_builders):
    jw, jdoc = chip_smoke.import_world(vt, scene_files, kind)
    tw, tdoc = chip_smoke.import_world(pt, scene_files, kind)
    assert tdoc.mesh_ids == jdoc.mesh_ids == {(0, 0): 4, (1, 0): 5,
                                              (2, 0): 6}
    assert tdoc.material_ids == jdoc.material_ids
    assert_worlds_equal(jw, tw)
    # 4 reserved + the image as sRGB albedo / emissive and as linear
    # normal map + the two OBJ colours
    assert len(tw.textures) == 8 and len(tw.skins) == 1
    # reference quirk: base_color.w is the alpha cutoff (0.5 by default)
    assert tw.materials.base_color[4][3] == 0.5
    # the skinned primitive's instance sits at the root; the boxes under
    # the translated parent
    inst = [(m, t) for t, m in zip(tw.instances.transforms,
                                   tw.instances.mesh_ids)]
    np.testing.assert_array_equal(dict(inst)[5], np.eye(4, dtype=np.float32))
    # the two boxes: TRS child at z -7, matrix child at -7 + 0.5
    assert sorted(float(t[2, 3]) for m, t in inst if m == 4) == [-7.0, -6.5]


def test_scene_instances_ignore_the_skinned_node_transform():
    """tests/test_skin.py:219's document on the port: the skinned
    primitive's instance is the root alone, a plain node's the whole
    hierarchy."""
    doc = {
        "scenes": [{"nodes": [0, 3]}],
        "scene": 0,
        "nodes": [
            {"translation": [5, 0, 0], "children": [1]},
            {"mesh": 0, "skin": 0, "translation": [0, 2, 0]},
            {},
            {"mesh": 1, "translation": [1, 0, 0]},
        ],
        "meshes": [{"primitives": [{"attributes": {}}]},
                   {"primitives": [{"attributes": {}}]}],
        "skins": [{"joints": [2]}],
    }
    jv = np.zeros((3, 4), np.int32)
    wv = np.zeros((3, 4), np.float32)
    wv[:, 0] = 1.0
    root = np.asarray(mathx.from_translation([0, 0, -3]), np.float32)
    out = {}
    for mod in (j_gltf, t_gltf):
        gdoc = mod.GltfDocument(doc=doc, mesh_ids={(0, 0): 10, (1, 0): 11},
                                material_ids=[], skinned={(0, 0): (jv, wv)},
                                buffers=[])
        out[mod] = {m: t for t, m, _ in gdoc.scene_instances(root)}
    np.testing.assert_array_equal(out[t_gltf][10], root)
    np.testing.assert_array_equal(
        out[t_gltf][11],
        root @ np.asarray(mathx.from_translation([1, 0, 0]), np.float32))
    for k in (10, 11):
        np.testing.assert_array_equal(out[t_gltf][k], out[j_gltf][k])


@pytest.mark.parametrize("t", [0.0, 0.4, 1.0, 1.55, 2.0, 3.3])
def test_gltf_animator_matches_jax(t, scene_files):
    jw, jdoc = chip_smoke.import_world(vt, scene_files, "glb")
    tw, tdoc = chip_smoke.import_world(pt, scene_files, "glb")
    ja, ta = j_gltf.GltfAnimator(jdoc), t_gltf.GltfAnimator(tdoc)
    assert ta.duration == ja.duration == 2.0
    np.testing.assert_array_equal(ta.joint_matrices(0, t),
                                  ja.joint_matrices(0, t))
    np.testing.assert_array_equal(ta.joint_matrices(0, t, loop=False),
                                  ja.joint_matrices(0, t, loop=False))
    # tests/test_skin.py:166's synthetic skeleton
    j = _synthetic_gltf()
    port = t_gltf.GltfDocument(doc=j.doc, mesh_ids={}, material_ids=[],
                               skinned={}, buffers=j.buffers)
    np.testing.assert_array_equal(
        t_gltf.GltfAnimator(port).joint_matrices(0, t),
        j_gltf.GltfAnimator(j).joint_matrices(0, t))


def test_skinned_gltf_frame_matches_jax(scene_files, numpy_builders):
    """The import scene at 160x96, two frames posed by GltfAnimator (TAA
    on, so the second reprojects the first): the port's frame within 5e-3
    of the JAX frame; the pose changes the frame."""
    w, h = 160, 96
    caps = dict(tri_capacity=1 << 12, pair_capacity=1 << 14)
    jw, jdoc = chip_smoke.import_world(vt, scene_files, "glb")
    tw, tdoc = chip_smoke.import_world(pt, scene_files, "glb")
    jr = JaxRenderer(jw.device(tap_blocks=False),
                     JaxRasterConfig(width=w, height=h, interpret=True,
                                     **caps))
    tr = Renderer(tw.device("cpu"), RasterConfig(width=w, height=h, **caps))
    an = t_gltf.GltfAnimator(tdoc)
    frames = []
    for i in (2, 6):
        jm = chip_smoke.import_joint_mats(an, i)
        want = np.asarray(jr.render(vt.Camera(**chip_smoke.IMPORT_CAMERA,
                                              aspect=w / h), joint_mats=jm))
        got = tr.render(pt.Camera(**chip_smoke.IMPORT_CAMERA, aspect=w / h),
                        joint_mats=jm).numpy()
        assert int(jr.aux["overflow"]) == 0 and int(tr.aux["overflow"]) == 0
        frames.append(got)
    diff = float(np.abs(got - want).mean())
    print(f"skinned glTF {w}x{h}: mean abs diff vs JAX {diff:.3e}")
    assert np.isfinite(got).all() and got.std() > 0.02
    assert diff < BUDGET
    assert np.abs(frames[1] - frames[0]).max() > 0.05


def _with_image(scene_files, tmp_path, image):
    """The .gltf of the import scene with its image replaced by `image`
    (a dict of the glTF image entry); returns the new file's path."""
    with open(scene_files["gltf"]) as f:
        doc = json.load(f)
    doc["images"] = [image]
    path = str(tmp_path / "other.gltf")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def test_gltf_jpeg_image_refused(scene_files, tmp_path):
    """The port decodes baseline JPEG (io/jpeg.py) but refuses a
    progressive one, naming the file, in the glTF importer and in
    load_image."""
    b = io.BytesIO()
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(
        b, format="JPEG", progressive=True)
    with open(tmp_path / "albedo.jpg", "wb") as f:
        f.write(b.getvalue())
    path = _with_image(scene_files, tmp_path, {"uri": "albedo.jpg"})
    with pytest.raises(NotImplementedError, match="albedo.jpg"):
        t_gltf.GltfDocument.import_file(pt.World(), path)
    with pytest.raises(NotImplementedError, match="progressive"):
        load_image(str(tmp_path / "albedo.jpg"))


def test_gltf_missing_image_falls_back_to_white(scene_files, tmp_path):
    path = _with_image(scene_files, tmp_path, {"uri": "gone.png"})
    for mod, pkg in ((t_gltf, pt), (j_gltf, vt)):
        w = pkg.World()
        with pytest.warns(UserWarning, match="gone.png"):
            doc = mod.GltfDocument.import_file(w, path)
        assert len(w.textures) == 4
        assert w.materials.albedo[doc.material_ids[0]] == 0  # WHITE


def _pil_png(img, **kw):
    b = io.BytesIO()
    img.save(b, format="PNG", **kw)
    return b.getvalue()


def _pil_cases():
    rng = np.random.default_rng(5)
    g = rng.integers(0, 256, (11, 13), dtype=np.uint8)
    rgb = Image.fromarray(rng.integers(0, 256, (11, 13, 3), dtype=np.uint8))
    return {
        "grey": (Image.fromarray(g, "L"), {}),
        "grey_trns": (Image.fromarray(g, "L"), dict(transparency=int(g[2, 3]))),
        "grey_1bit": (Image.fromarray(g > 100), {}),
        "palette": (rgb.quantize(200), {}),
        "palette_trns": (rgb.quantize(200),
                         dict(transparency=bytes(range(0, 250, 5)))),
        "palette_4bit": (rgb.quantize(12), dict(transparency=3)),
        "palette_1bit": (rgb.quantize(2), {}),
        "grey_alpha": (Image.fromarray(np.stack([g, 255 - g], -1), "LA"), {}),
        "rgb_trns": (rgb, dict(transparency=(1, 2, 3))),
    }


@pytest.mark.parametrize("case", sorted(_pil_cases()))
def test_png_colour_types_match_pil(case, tmp_path):
    img, kw = _pil_cases()[case]
    data = _pil_png(img, **kw)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    np.testing.assert_array_equal(decode_png(data), want)
    p = tmp_path / "x.png"
    p.write_bytes(data)
    np.testing.assert_array_equal(load_image(str(p)), want)


def test_png_16bit_and_interlaced_refused():
    g = (np.arange(12, dtype=np.uint16).reshape(3, 4) * 5000)
    with pytest.raises(ValueError, match="bit depth 16"):
        decode_png(_pil_png(Image.fromarray(g)))
    data = bytearray(_pil_png(Image.fromarray(np.zeros((3, 4, 3),
                                                       np.uint8))))
    data[28] = 1  # IHDR interlace method (its CRC is not checked)
    with pytest.raises(ValueError, match="interlace 1"):
        decode_png(bytes(data))


def test_obj_import_matches_jax(scene_files, numpy_builders):
    jw, tw = vt.World(), pt.World()
    jg = j_obj.import_obj(jw, scene_files["obj"])
    tg = t_obj.import_obj(tw, scene_files["obj"])
    assert tg == jg and len(tg) == 2  # the red base, the green sides
    assert_worlds_equal(jw, tw)
    base, sides = (tw.meshes.mesh_info[m] for m, _ in tg)
    assert base["index_count"] == 6 and sides["index_count"] == 12
    # the .mtl colours baked into 1x1 textures
    np.testing.assert_array_equal(tw.textures.images[-2][0, 0],
                                  [204, 51, 51, 255])
    # flat normals where the faces give none: the sides point up and out
    n = tw.meshes.normals[tg[1][0]]
    assert (np.linalg.norm(n, axis=1) > 0.99).all() and (n[:, 1] > 0).all()


def test_obj_negative_indices(tmp_path):
    p = tmp_path / "tri.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n")
    w = pt.World()
    groups = t_obj.import_obj(w, str(p))
    assert w.meshes.mesh_info[groups[0][0]]["index_count"] == 3


def _snapshot_scene():
    p = t_presets.config5_raytraced_shadows(2.0)
    return p, p.world.device("cpu", with_tlas=True)


def test_snapshot_round_trip(tmp_path):
    p, scene = _snapshot_scene()
    cam = pt.Camera(position=[1, 2, 3], yaw=10.0, pitch=-5.0, aspect=16 / 9)
    path = str(tmp_path / "scene.npz")
    save_scene(path, scene, cam)
    scene2, cam2 = load_scene(path, "cpu")
    leaves, statics = scene_to_numpy(scene)
    leaves2, statics2 = scene_to_numpy(scene2)
    assert leaves.keys() == leaves2.keys() and statics == statics2
    for k, v in leaves.items():
        assert v.dtype == leaves2[k].dtype, k
        np.testing.assert_array_equal(v, leaves2[k], err_msg=k)
    # the World's host leaves under the same names, word for word (the
    # host's u32 words are int32 on the device)
    host = p.world.host_leaves(with_tlas=True)
    for k, v in leaves.items():
        np.testing.assert_array_equal(host[k].view(v.dtype), v, err_msg=k)
    assert scene2.tlas.refit_levels == scene.tlas.refit_levels
    assert scene2.meshes.has_lods == scene.meshes.has_lods
    assert scene2.meshes.bvh_max_leaf == scene.meshes.bvh_max_leaf
    assert scene2.textures.base_size == scene.textures.base_size
    np.testing.assert_array_equal(cam2.position, [1, 2, 3])
    assert (cam2.yaw, cam2.pitch, cam2.aspect) == (10.0, -5.0, 16 / 9)


def test_snapshot_drops_skins(tmp_path):
    p = t_presets.config4_animated_taa(2.0)
    scene = p.world.device("cpu")
    assert len(scene.skins) == 2
    path = str(tmp_path / "scene.npz")
    save_scene(path, scene)
    scene2, cam = load_scene(path, "cpu")
    assert scene2.skins == () and cam is None
    leaves, statics = scene_to_numpy(scene)
    assert statics["skins"] and any(k.startswith("skins.") for k in leaves)
    leaves2, statics2 = scene_to_numpy(scene2)
    assert statics2["skins"] == () and leaves2.keys() == {
        k for k in leaves if not k.startswith("skins.")}


def test_snapshot_version_mismatch(tmp_path):
    _, scene = _snapshot_scene()
    path = str(tmp_path / "scene.npz")
    save_scene(path, scene)
    data = dict(np.load(path, allow_pickle=False))
    data["version"] = np.asarray([SNAPSHOT_VERSION + 1], np.int64)
    np.savez_compressed(path, **data)
    with pytest.raises(ValueError, match=f"format v{SNAPSHOT_VERSION + 1}"):
        load_scene(path, "cpu")
    data.pop("version")
    np.savez_compressed(path, **data)
    with pytest.raises(ValueError, match="no version marker"):
        load_scene(path, "cpu")
    # a snapshot of the JAX package carries no marker of this one
    jw = vt.World()
    jw.instances.add(np.eye(4, dtype=np.float32), 2, 0)
    from voidin_tpu.io.snapshot import save_scene as j_save

    j_save(path, jw.device())
    with pytest.raises(ValueError, match="no version marker"):
        load_scene(path, "cpu")


def test_loaded_snapshot_renders_the_same_frame(tmp_path):
    p = t_presets.config7_sponza_geometry(2.0, n_textures=4, base_size=32,
                                         detail=0.1)
    scene = p.world.device("cpu")
    path = str(tmp_path / "scene.npz")
    save_scene(path, scene, p.camera)
    loaded, cam = load_scene(path, "cpu")
    cfg = RasterConfig(width=96, height=48, tri_capacity=1 << 15,
                       pair_capacity=1 << 15)
    a = Renderer(scene, cfg).render(p.camera).numpy()
    b = Renderer(loaded, cfg).render(cam).numpy()
    assert a.std() > 0.02
    np.testing.assert_array_equal(a, b)


def test_load_scene_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    _, scene = _snapshot_scene()
    path = str(tmp_path / "scene.npz")
    save_scene(path, scene)
    with pytest.raises((RuntimeError, AssertionError)):
        load_scene(path)
    assert os.path.exists(path)

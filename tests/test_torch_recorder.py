"""Port parity: the recorder (framework/recorder.py), the MJPEG-AVI writer
(io/avi.py) and the port's JPEG codec (io/jpeg.py) against the JAX
package's recorder and against PIL (present here, not on the card's host).

- Recorder: the PNG-sequence fallback; without ffmpeg a video path becomes
  an MJPEG-AVI (renamed .avi, with the warning), read back by an
  independent RIFF parse as tests/test_framework.py:174-216 does; the AVI
  header chunks byte-equal to the JAX writer's for the same size and fps;
  tensors pushed are copied to the host and the queue holds arrays.
- Encoder (stated tolerance): PIL decodes the port's JPEG to within mean
  0.5 and max 10 levels of its decode of PIL's own JPEG of the same image
  and quality (4:2:0, PIL's default), and the error to the input is PIL's
  within 2% + 0.05 levels.
- Decoder: PIL-written baseline JPEGs at quality 50 / 75 / 92 / 100 and
  4:4:4 / 4:2:2 / 4:2:0, greyscale (a single-component scan), restart
  intervals and odd sizes decode to within 1 level of PIL's pixels (they
  have all been equal); corrupt data raises ValueError.
- A glTF with an embedded JPEG texture gives the same texture through both
  importers.
"""

import base64
import io
import json
import os
import struct

import numpy as np
import pytest
import torch
from PIL import Image

import voidin_tpu as vt
from voidin_tpu.io import gltf as j_gltf
from voidin_tpu.io.avi import MjpegAviWriter as JaxAviWriter

import voidin_tpu_torch as pt
from voidin_tpu_torch.framework import recorder as rec_mod
from voidin_tpu_torch.framework.recorder import Recorder
from voidin_tpu_torch.io import gltf as t_gltf
from voidin_tpu_torch.io import jpeg
from voidin_tpu_torch.io.avi import MjpegAviWriter
from voidin_tpu_torch.io.image import decode_image

import chip_smoke

torch.set_num_threads(2)


def sample_image(h, w, seed=3):
    """A smooth colour field with a hard-edged patch and a little noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w] / np.float32(max(h, w))
    img = np.stack([0.5 + 0.4 * np.sin(6 * x + 3 * y),
                    0.5 + 0.4 * np.cos(5 * y - 2 * x), x * y], -1)
    img[h // 3:h // 2, w // 4:w // 2] = [0.9, 0.2, 0.1]
    img += rng.normal(0, 0.01, img.shape)
    return (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)


def _pil_jpeg(img, **kw):
    b = io.BytesIO()
    Image.fromarray(img).save(b, format="JPEG", **kw)
    return b.getvalue()


def _pil_decode(data):
    return np.asarray(Image.open(io.BytesIO(data))).astype(np.int64)


def test_recorder_png_fallback(tmp_path):
    rec = Recorder(32, 16, fps=30)
    out = tmp_path / "seq"
    assert rec.start(str(out)) == str(out)
    for i in range(3):
        rec.push(np.full((16, 32, 3), i / 3, np.float32))
    rec.finish()
    files = sorted(os.listdir(out))
    assert files == [f"frame_{i:05d}.png" for i in range(3)]
    got = Image.open(out / files[2])
    assert np.asarray(got).shape == (16, 32, 3)
    assert int(np.asarray(got)[0, 0, 0]) == int(2 / 3 * 255 + 0.5)


def test_recorder_mjpeg_avi_without_ffmpeg(tmp_path, monkeypatch, caplog):
    """A .mp4 path without ffmpeg records an MJPEG-AVI next to it, with the
    warning; an independent RIFF parse finds the header counts, the idx1
    entries and the JPEG frames that were pushed."""
    monkeypatch.setattr(rec_mod.shutil, "which", lambda name: None)
    rec = Recorder(32, 16, fps=30)
    with caplog.at_level("WARNING"):
        out = rec.start(str(tmp_path / "clip.mp4"))
    assert out == str(tmp_path / "clip.avi") and "no ffmpeg" in caplog.text
    colors = [(1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0),
              (1.0, 1.0, 0.0)]
    for c in colors:
        rec.push(np.broadcast_to(np.asarray(c, np.float32), (16, 32, 3)))
    rec.finish()
    data = (tmp_path / "clip.avi").read_bytes()

    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    assert struct.unpack("<I", data[4:8])[0] == len(data) - 8
    assert struct.unpack("<I", data[48:52])[0] == 4  # avih dwTotalFrames
    movi = data.index(b"movi")
    idx1 = data.index(b"idx1")
    assert struct.unpack("<I", data[idx1 + 4:idx1 + 8])[0] // 16 == 4
    jpegs = []
    for i, c in enumerate(colors):
        e = idx1 + 8 + i * 16
        fourcc, flags, off, size = struct.unpack("<4sIII", data[e:e + 16])
        assert fourcc == b"00dc" and flags & 0x10
        assert data[movi + off:movi + off + 4] == b"00dc"
        jpegs.append(data[movi + off + 8:movi + off + 8 + size])
        img = _pil_decode(jpegs[-1])
        assert img.shape == (16, 32, 3)
        assert np.abs(img.reshape(-1, 3).mean(0)
                      - np.asarray(c) * 255).max() < 12  # JPEG loss
    # chip_smoke's reader finds the same frames, in order
    assert chip_smoke.avi_frames(data) == jpegs
    with pytest.raises(ValueError):
        chip_smoke.avi_frames(data[:-4])


def test_avi_headers_equal_jax_writer(tmp_path):
    """Same size and fps: the files of no frames are byte-equal; with
    frames, every byte before the first frame is equal but the five sizes
    patched from the JPEGs' (which differ between the encoders): RIFF,
    avih dwMaxBytesPerSec and dwSuggestedBufferSize, strh
    dwSuggestedBufferSize, LIST movi."""
    for frames in (0, 3):
        files = {}
        for name, cls in (("jax", JaxAviWriter), ("port", MjpegAviWriter)):
            path = str(tmp_path / f"{name}{frames}.avi")
            w = cls(path, 48, 32, fps=24)
            for i in range(frames):
                w.write(sample_image(32, 48, seed=i))
            w.close()
            files[name] = open(path, "rb").read()
        a, b = files["jax"], files["port"]
        if frames == 0:
            assert a == b
            continue
        head = a.index(b"movi")
        assert head == b.index(b"movi")
        patched = {4, 32 + 4, 32 + 28, 108 + 8 + 28, head - 4}
        differ = {i for i in range(head) if a[i] != b[i]}
        assert {i - i % 4 for i in differ} <= patched
        # the frame counts: avih dwTotalFrames, strh dwLength
        assert a[48:52] == b[48:52] == struct.pack("<I", frames)
        assert a[140:144] == b[140:144] == struct.pack("<I", frames)


def test_recorder_push_copies_tensors_to_the_host():
    rec = Recorder(8, 4)
    t = torch.rand(4, 8, 3)
    rec.push(t)
    got = rec._queue.get_nowait()
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, t.numpy())
    t.zero_()
    assert got.any()  # a copy, not a view


@pytest.mark.parametrize("quality", [50, 75, 92, 100])
def test_jpeg_encoder_decodes_in_pil(quality):
    img = sample_image(45, 67)
    ours = _pil_decode(jpeg.encode_jpeg(img, quality))
    pil = _pil_decode(_pil_jpeg(img, quality=quality))
    d = np.abs(ours - pil)
    err, pil_err = (np.abs(ours - img).mean(), np.abs(pil - img).mean())
    print(f"q{quality}: vs PIL's JPEG mean {d.mean():.3f} max "
          f"{d.max()}; error to the input {err:.3f} (PIL's {pil_err:.3f})")
    assert ours.shape == img.shape
    assert d.mean() <= 0.5 and d.max() <= 10
    assert err <= pil_err * 1.02 + 0.05


@pytest.mark.parametrize("size", [(1, 1), (7, 13), (17, 9), (64, 64)])
def test_jpeg_encoder_sizes(size):
    """Sizes that are no multiple of the MCU: the error to the input is
    PIL's encoder's within 5% + 0.5 levels."""
    img = sample_image(*size)
    ours = _pil_decode(jpeg.encode_jpeg(img, 92))
    pil = _pil_decode(_pil_jpeg(img, quality=92))
    assert ours.shape == img.shape
    assert (np.abs(ours - img).mean()
            <= np.abs(pil - img).mean() * 1.05 + 0.5)


def test_jpeg_encoder_refuses_other_images():
    for bad in (np.zeros((4, 4, 3), np.float32), np.zeros((4, 4), np.uint8),
                np.zeros((0, 4, 3), np.uint8)):
        with pytest.raises(ValueError):
            jpeg.encode_jpeg(bad)


@pytest.mark.parametrize("sub", [0, 1, 2])
@pytest.mark.parametrize("quality", [50, 75, 92, 100])
def test_jpeg_decoder_matches_pil(quality, sub):
    data = _pil_jpeg(sample_image(45, 67), quality=quality, subsampling=sub)
    got = jpeg.decode_jpeg(data).astype(np.int64)
    want = _pil_decode(data)
    assert got.shape == want.shape == (45, 67, 3)
    print(f"q{quality} subsampling {sub}: {(got != want).sum()} values "
          f"differ, max {np.abs(got - want).max()}")
    assert np.abs(got - want).max() <= 1


@pytest.mark.parametrize("case", ["grey", "restart", "odd_1x1", "odd_9x5",
                                  "odd_33x65", "restart_grey", "wide"])
def test_jpeg_decoder_edge_cases(case):
    img = sample_image(33, 65)
    kw = dict(quality=85)
    if case == "grey":
        img = img[..., 0]
    elif case == "restart":
        kw.update(restart_marker_blocks=3)
    elif case == "restart_grey":
        img = img[..., 2]
        kw.update(restart_marker_rows=1)
    elif case.startswith("odd"):
        h, w = (int(v) for v in case[4:].split("x"))
        img = sample_image(h, w)
    elif case == "wide":
        img = sample_image(9, 300)
        kw.update(subsampling=1)
    data = _pil_jpeg(img, **kw)
    got = jpeg.decode_jpeg(data).astype(np.int64)
    want = _pil_decode(data)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1


def test_jpeg_decoder_refuses():
    data = _pil_jpeg(sample_image(16, 16), quality=80)
    with pytest.raises(NotImplementedError, match="x.jpg.*progressive"):
        jpeg.decode_jpeg(_pil_jpeg(sample_image(16, 16), progressive=True),
                         "x.jpg")
    with pytest.raises(ValueError):
        jpeg.decode_jpeg(b"\x89PNG" + data[4:])
    with pytest.raises(ValueError):
        # the entropy data cut short and a marker after it
        cut = data.index(b"\xff\xda")
        jpeg.decode_jpeg(data[:cut + 40] + b"\xff\xd9", "cut.jpg")


def test_jpeg_decoder_on_damaged_files():
    """Every prefix and a few flipped bytes of a file either decode or
    raise ValueError: malformed input never escapes as another error."""
    data = _pil_jpeg(sample_image(20, 30), quality=80, restart_marker_blocks=2)
    rng = np.random.default_rng(0)
    damaged = [data[:cut] for cut in range(3, len(data), 11)]
    for _ in range(40):
        b = bytearray(data)
        b[int(rng.integers(2, len(b)))] = int(rng.integers(0, 256))
        damaged.append(bytes(b))
    for d in damaged:
        try:
            jpeg.decode_jpeg(d, "damaged.jpg")
        except ValueError as exc:
            assert "damaged.jpg" in str(exc)
        except NotImplementedError:
            pass  # a flipped byte can name another frame type


def test_jpeg_round_trip_through_decode_image():
    img = sample_image(24, 40)
    data = jpeg.encode_jpeg(img, 95)
    rgba = decode_image(data)
    assert rgba.shape == (24, 40, 4) and (rgba[..., 3] == 255).all()
    np.testing.assert_array_equal(rgba[..., :3], _pil_decode(data))


def test_gltf_embedded_jpeg_texture_matches_jax(tmp_path):
    """chip_smoke's import scene as .gltf with its image replaced by an
    embedded (data URI) JPEG: both importers give the same texture (the
    port's decoder against PIL's) and the same materials."""
    paths = chip_smoke.write_import_scene(str(tmp_path))
    with open(paths["gltf"]) as f:
        doc = json.load(f)
    data = _pil_jpeg(sample_image(24, 32), quality=90)
    doc["images"] = [{"uri": "data:image/jpeg;base64,"
                      + base64.b64encode(data).decode()}]
    path = str(tmp_path / "jpeg.gltf")
    with open(path, "w") as f:
        json.dump(doc, f)
    worlds = {}
    for name, mod, pkg in (("jax", j_gltf, vt), ("port", t_gltf, pt)):
        w = worlds[name] = pkg.World()
        mod.GltfDocument.import_file(w, path)
    a, b = worlds["jax"].textures, worlds["port"].textures
    assert len(a.images) == len(b.images)
    for x, y in zip(a.images, b.images):
        assert np.abs(x.astype(int) - y.astype(int)).max() <= 1
    assert list(a.srgb_flags) == list(b.srgb_flags)
    assert (worlds["port"].textures.images[-1].shape == (24, 32, 4))

"""Pure-Python MJPEG-in-AVI video writer.

Counterpart of ``voidin_tpu/io/avi.py``, with the same RIFF layout,
header fields, idx1 offsets and patching on close(). The reference
Recorder pipes raw frames into a spawned ffmpeg
(components/src/recorder.rs:90-138) and degrades to PNG screenshots when
ffmpeg is missing (recorder.rs:33-46); this writer gives an actual video
without ffmpeg: each frame is a baseline JPEG (``io/jpeg.py``'s encoder,
no PIL) wrapped in the classic AVI RIFF container with an idx1 index —
playable by every mainstream player/browser.

Layout (all little-endian):
  RIFF('AVI ', LIST('hdrl', avih, LIST('strl', strh, strf)),
               LIST('movi', '00dc' <jpeg> ...), idx1)
Sizes/counts are patched on close() (frame count is unknown up front), so
the output file must be seekable.
"""

from __future__ import annotations

import struct

import numpy as np

from .jpeg import encode_jpeg

_AVIF_HASINDEX = 0x00000010
_AVIIF_KEYFRAME = 0x00000010


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    pad = b"\x00" if len(payload) % 2 else b""
    return fourcc + struct.pack("<I", len(payload)) + payload + pad


class MjpegAviWriter:
    def __init__(self, path: str, width: int, height: int, fps: int = 60,
                 quality: int = 92):
        self.width = int(width)
        self.height = int(height)
        self.fps = int(fps)
        self.quality = int(quality)
        self.frames = 0
        self._index = []  # (offset_in_movi, size) per frame chunk
        self._max_chunk = 0
        self._f = open(path, "wb")
        self._write_headers()
        # LIST('movi') with a placeholder size, patched on close
        self._movi_size_pos = self._f.tell() + 4
        self._f.write(b"LIST" + struct.pack("<I", 0) + b"movi")
        self._movi_start = self._f.tell()  # first byte after 'movi' fourcc

    def _write_headers(self):
        w, h, fps = self.width, self.height, self.fps
        avih = struct.pack(
            "<14I",
            1_000_000 // max(fps, 1),  # dwMicroSecPerFrame
            0,  # dwMaxBytesPerSec (patched: informational only)
            0,  # dwPaddingGranularity
            _AVIF_HASINDEX,
            0,  # dwTotalFrames (patched on close)
            0,  # dwInitialFrames
            1,  # dwStreams
            0,  # dwSuggestedBufferSize (patched)
            w, h, 0, 0, 0, 0,
        )
        strh = (
            b"vids" + b"MJPG"
            + struct.pack(
                "<10I4h",
                0, 0, 0,  # flags, priority+language, initial frames
                1, fps,  # dwScale / dwRate -> fps
                0,  # dwStart
                0,  # dwLength in frames (patched on close)
                0,  # dwSuggestedBufferSize (patched)
                0xFFFFFFFF,  # dwQuality (default)
                0,  # dwSampleSize (0: variable)
                0, 0, w, h,  # rcFrame
            )
        )
        strf = struct.pack(
            "<IiiHH4sIiiII",
            40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0,
        )
        strl = b"strl" + _chunk(b"strh", strh) + _chunk(b"strf", strf)
        hdrl = (
            b"hdrl"
            + _chunk(b"avih", avih)
            + b"LIST" + struct.pack("<I", len(strl)) + strl
        )
        self._f.write(b"RIFF" + struct.pack("<I", 0) + b"AVI ")  # patched
        self._f.write(b"LIST" + struct.pack("<I", len(hdrl)) + hdrl)
        # remember patch offsets
        # RIFF size at byte 4; avih fields live inside the hdrl LIST:
        # 12 (RIFF hdr) + 8 (LIST hdr) + 4 ('hdrl') + 8 ('avih' hdr) = 32
        self._avih_pos = 32
        # strh data: 32 + 56 (avih) + 8 (LIST hdr) + 4 ('strl')
        # + 8 ('strh' hdr) = 108
        self._strh_pos = 32 + 56 + 8 + 4 + 8

    def write(self, rgb: np.ndarray):
        """Append one (H, W, 3) uint8 frame."""
        assert rgb.shape == (self.height, self.width, 3), rgb.shape
        data = encode_jpeg(np.ascontiguousarray(rgb), quality=self.quality)
        off = self._f.tell() - self._movi_start + 4  # AVI convention:
        # idx1 offsets count from the 'movi' fourcc (first chunk = 4)
        self._f.write(_chunk(b"00dc", data))
        self._index.append((off, len(data)))
        self._max_chunk = max(self._max_chunk, len(data))
        self.frames += 1

    def close(self):
        if self._f is None:
            return
        movi_end = self._f.tell()
        idx = b"".join(
            b"00dc" + struct.pack("<III", _AVIIF_KEYFRAME, off, size)
            for off, size in self._index
        )
        self._f.write(_chunk(b"idx1", idx))
        riff_end = self._f.tell()

        # patch sizes/counts
        def patch_u32(pos, value):
            self._f.seek(pos)
            self._f.write(struct.pack("<I", value))

        patch_u32(4, riff_end - 8)  # RIFF size
        patch_u32(self._movi_size_pos, movi_end - (self._movi_size_pos + 4))
        patch_u32(self._avih_pos + 4 * 1,
                  self._max_chunk * self.fps)  # dwMaxBytesPerSec
        patch_u32(self._avih_pos + 4 * 4, self.frames)  # dwTotalFrames
        patch_u32(self._avih_pos + 4 * 7, self._max_chunk)
        # strh u32 fields after the two fourccs: flags, prio/lang,
        # initialFrames, scale, rate, start, LENGTH, SUGGESTED_BUFFER, ...
        patch_u32(self._strh_pos + 8 + 4 * 6, self.frames)
        patch_u32(self._strh_pos + 8 + 4 * 7, self._max_chunk)
        self._f.close()
        self._f = None

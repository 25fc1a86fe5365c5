""".stream recording replay and capture (mirrors ``rgbd_recon_tpu/io/stream.py``).

Byte-compatible with the reference's recording path: one ``.stream`` file per
sensor containing back-to-back ``[color][depth]`` frames with no header
(NetKinectArray::readFromFiles, NetKinectArray.cpp:709-749; FileBuffer with
looping, io/FileBuffer.cpp:113-131). Frame sizes derive from the calibration
metadata exactly like NetKinectArray::init (:112-140):

  color: DXT1 (w*h/2 bytes), DXT5 (307200 bytes), or raw RGB888
  depth: u8 (compressed) or f32 meters

The host decode takes ``io/native.best_decoder`` (the threaded C++ decoder
when it builds, else the numpy codec of ``io/dxt.py``; bit for bit the
same); on the card the app uploads the raw payloads (``read_raw``) and
decodes them with ``ops/wire.py``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from . import dxt


@dataclass(frozen=True)
class FrameFormat:
    width: int = 512          # depth resolution (Kinect v2)
    height: int = 424
    width_c: int = 1280       # color resolution
    height_c: int = 1080
    compressed_rgb: int = 0   # 0 raw, 1 DXT1, 5 DXT5 (CalibrationFiles flags)
    compressed_depth: bool = False

    @property
    def color_size(self) -> int:
        if self.compressed_rgb == 1:
            return self.width_c * self.height_c // 2  # DXT1: 8B per 4x4
        if self.compressed_rgb == 5:
            return 307200  # NetKinectArray.cpp:123-126
        return self.width_c * self.height_c * 3

    @property
    def depth_size(self) -> int:
        n = self.width * self.height
        return n if self.compressed_depth else n * 4

    @property
    def frame_size(self) -> int:
        return self.color_size + self.depth_size

    def decode_color(self, payload: np.ndarray, as_float: bool = True) -> np.ndarray:
        """-> f32[Hc, Wc, 3] in [0, 1] (or u8 with ``as_float=False``: the
        device normalizes)."""
        from . import native

        if self.compressed_rgb == 1:
            img = native.best_decoder("dxt1")(payload, self.width_c, self.height_c)
        elif self.compressed_rgb == 5:
            # DXT5 at 307200 B covers 640x480 (NetKinectArray.cpp:123)
            img = native.best_decoder("dxt5")(payload, 640, 480)
        else:
            img = payload.reshape(self.height_c, self.width_c, 3)
        if not as_float:
            return img
        return img.astype(np.float32) / 255.0

    def decode_depth(self, payload: np.ndarray, near: float = 0.5, far: float = 4.5) -> np.ndarray:
        """-> f32[H, W] meters. Compressed u8 depth uses the sqrt mapping the
        bilateral shader inverts (pre_depth.fs:51-61)."""
        if self.compressed_depth:
            d_c = payload.reshape(self.height, self.width).astype(np.float32) / 255.0
            scale = far - near
            scaled_near = scale / 255.0
            out = (d_c * d_c + 0.15 * scaled_near) * scale + near
            return np.where(d_c < scaled_near, 0.0, out).astype(np.float32)
        return payload.view(np.float32).reshape(self.height, self.width)


class StreamReader:
    """Replays per-sensor ``.stream`` files (≙ C3 readFromFiles + C25)."""

    def __init__(self, paths: Sequence[str], fmt: FrameFormat, looping: bool = True,
                 color_u8: bool = False):
        self.fmt = fmt
        self.looping = looping
        self.color_u8 = color_u8
        self.paths = list(paths)
        self._files = [open(p, "rb") for p in paths]
        sizes = [os.fstat(f.fileno()).st_size for f in self._files]
        self.num_frames = min(s // fmt.frame_size for s in sizes)
        if self.num_frames == 0:
            self.close()
            raise ValueError("stream files contain no complete frame")
        self._frame = 0

    def __len__(self) -> int:
        return self.num_frames

    def _next_payloads(self):
        """(color, depth) payload bytes of every sensor for the next frame,
        or None at EOF when not looping."""
        if self._frame >= self.num_frames:
            if not self.looping:
                return None
            self.rewind()
        fmt = self.fmt
        out = []
        for f in self._files:
            raw = np.frombuffer(f.read(fmt.frame_size), np.uint8)
            out.append((raw[: fmt.color_size], raw[fmt.color_size:]))
        self._frame += 1
        return out

    def read(self):
        """Next frame: (depth f32[K, H, W] meters, color f32[K, Hc, Wc, 3]).
        Returns None at EOF when not looping."""
        pays = self._next_payloads()
        if pays is None:
            return None
        fmt = self.fmt
        depths = [fmt.decode_depth(d) for _, d in pays]
        colors = [fmt.decode_color(c, as_float=not self.color_u8) for c, _ in pays]
        return np.stack(depths), np.stack(colors)

    def read_raw(self):
        """Next frame as WIRE payloads: (color u8[K, color_size],
        depth u8[K, depth_size]) with no host decode — for device-side
        decoding (ops/wire.py). Returns None at EOF when not looping."""
        pays = self._next_payloads()
        if pays is None:
            return None
        return np.stack([c for c, _ in pays]), np.stack([d for _, d in pays])

    def rewind(self) -> None:
        for f in self._files:
            f.seek(0)
        self._frame = 0

    def close(self) -> None:
        for f in self._files:
            f.close()


class StreamWriter:
    """Writes reference-format ``.stream`` files (fixture/capture tool)."""

    def __init__(self, paths: Sequence[str], fmt: FrameFormat):
        self.fmt = fmt
        self._files = [open(p, "wb") for p in paths]

    def write(self, depth: np.ndarray, color: np.ndarray) -> None:
        """depth f32[K, H, W] meters; color f32[K, Hc, Wc, 3] in [0, 1]."""
        fmt = self.fmt
        for k, f in enumerate(self._files):
            img = np.clip(np.rint(color[k] * 255.0), 0, 255).astype(np.uint8)
            if fmt.compressed_rgb == 1:
                f.write(dxt.encode_dxt1(img).tobytes())
            elif fmt.compressed_rgb == 5:
                f.write(dxt.encode_dxt5(img).tobytes())
            else:
                f.write(img.tobytes())
            if fmt.compressed_depth:
                near, far = 0.5, 4.5
                scale = far - near
                scaled_near = scale / 255.0
                d = depth[k].astype(np.float32)
                d_c = np.sqrt(np.maximum((d - near) / scale - 0.15 * scaled_near, 0.0))
                d_c = np.where(d <= 0.0, 0.0, d_c)
                f.write(np.clip(d_c * 255.0, 0, 255).astype(np.uint8).tobytes())
            else:
                f.write(depth[k].astype(np.float32).tobytes())

    def close(self) -> None:
        for f in self._files:
            f.close()

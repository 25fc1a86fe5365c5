"""Binary calibration-volume file I/O (mirrors ``rgbd_recon_tpu/calibration/volume.py``).

Byte-compatible with the reference's ``CalibrationVolume<T>``
(framework/calibration/calibration_volume.hpp:29-39 write, :63-82 read):
header = 3x u32 resolution (x, y, z) + 2x f32 depth limits, then the raw
``T[]`` payload in z-major order ``volume[z][y][x]``. Existing ``*.cv_xyz`` /
``*.cv_uv`` / ``*_inv`` assets load unchanged.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np


class CalibrationVolume(NamedTuple):
    """One lookup volume. ``volume`` is ``f32[Dz, Dy, Dx, C]``.

    ``res`` keeps the file-header order (x, y, z); the array is stored
    z-major exactly like the file payload (calibration_volume.hpp:57-59).
    """

    res: np.ndarray          # u32[3] as (x, y, z)
    depth_limits: np.ndarray  # f32[2] (near, far) of the normalized depth axis
    volume: np.ndarray       # f32[Dz, Dy, Dx, C]

    @property
    def channels(self) -> int:
        return self.volume.shape[-1]

    @staticmethod
    def read(path: str, channels: int) -> "CalibrationVolume":
        """channels: 3 for cv_xyz (xyz f32x3), 2 for cv_uv, 4 for cv_xyz_inv
        (the inverse bake stores fvec4, calibration_inverter.cpp:87)."""
        with open(path, "rb") as f:
            header = np.fromfile(f, dtype=np.uint32, count=3)
            limits = np.fromfile(f, dtype=np.float32, count=2)
            rx, ry, rz = (int(v) for v in header)
            payload = np.fromfile(f, dtype=np.float32, count=rx * ry * rz * channels)
        if payload.size != rx * ry * rz * channels:
            raise ValueError(
                f"{path}: expected {rx * ry * rz * channels} floats, got {payload.size}"
            )
        vol = payload.reshape(rz, ry, rx, channels)
        return CalibrationVolume(header, limits, vol)

    def write(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            np.asarray(self.res, np.uint32).tofile(f)
            np.asarray(self.depth_limits, np.float32).tofile(f)
            np.ascontiguousarray(self.volume, dtype=np.float32).tofile(f)

    def corner_points(self) -> np.ndarray:
        """The 8 frustum corner samples, same picks & order as the reference
        (CalibVolumes.cpp:98-113): (x, y) corners of the z=0 slab then the
        z=end slab. Only meaningful for cv_xyz volumes."""
        ex, ey, ez = (int(v) - 1 for v in self.res)
        v = self.volume
        return np.stack([
            v[0, 0, 0, :3], v[0, ey, 0, :3], v[0, ey, ex, :3], v[0, 0, ex, :3],
            v[ez, 0, 0, :3], v[ez, ey, 0, :3], v[ez, ey, ex, :3], v[ez, 0, ex, :3],
        ])

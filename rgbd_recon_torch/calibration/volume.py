"""Calibration lookup volume (mirrors ``rgbd_recon_tpu/calibration/volume.py``).

Only what the synthetic rig builder reaches is copied: the NamedTuple and
``corner_points``. File I/O stays in the JAX package for now.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class CalibrationVolume(NamedTuple):
    """One lookup volume. ``volume`` is ``f32[Dz, Dy, Dx, C]``; ``res`` keeps
    the file-header order (x, y, z) (calibration_volume.hpp:57-59)."""

    res: np.ndarray          # u32[3] as (x, y, z)
    depth_limits: np.ndarray  # f32[2] (near, far) of the normalized depth axis
    volume: np.ndarray       # f32[Dz, Dy, Dx, C]

    def corner_points(self) -> np.ndarray:
        """The 8 frustum corner samples in the reference's order
        (CalibVolumes.cpp:98-113). Only meaningful for cv_xyz volumes."""
        ex, ey, ez = (int(v) - 1 for v in self.res)
        v = self.volume
        return np.stack([
            v[0, 0, 0, :3], v[0, ey, 0, :3], v[0, ey, ex, :3], v[0, 0, ex, :3],
            v[ez, 0, 0, :3], v[ez, ey, 0, :3], v[ez, ey, ex, :3], v[ez, 0, ex, :3],
        ])

"""TSDF volume configuration (mirrors ``rgbd_recon_tpu/ops/tsdf.py``; the
dense reference integrators ``integrate``/``integrate_colors`` are not
ported yet)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..utils.math import Bbox


class TsdfConfig(NamedTuple):
    """Volume geometry + fusion params (kinect_client.cpp:86-88 defaults)."""

    res: tuple[int, int, int]  # (vx, vy, vz) voxel counts
    limit: float = 0.01        # tsdf truncation (normalized-depth units)

    @staticmethod
    def from_voxel_size(bbox: Bbox, voxel_size: float, limit: float = 0.01,
                        align: int = 1) -> "TsdfConfig":
        """res = ceil(bbox_size / voxel_size) (recon_integration.cpp:342-345),
        each axis rounded UP to a multiple of ``align`` (the brick-sparse path
        tiles the volume in 16^3 bricks, so the pipeline derives with
        align=16)."""
        res = tuple(
            -(-int(np.ceil(float(s) / voxel_size)) // align) * align
            for s in bbox.size
        )
        return TsdfConfig(res, limit)

"""Calibration debug visualization (mirrors ``rgbd_recon_tpu/models/calibs.py``).

≙ ReconCalibs (framework/reconstruction/recon_calibs.cpp:22-66 + glsl/
calib_vis.*): renders the selected sensor's calibration volume for
inspection. The inspection images are slice mosaics of the lookup volumes
(host numpy) plus a point splat of the valid inverse-calibration voxels
(drawValidVoxels, CalibVolumes.cpp:188-212) at every second voxel.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import splat as splat_ops
from ..ops.preprocess import ProcessedFrames
from ..ops.raymarch import RenderCamera
from .base import ReconContext, Reconstruction

STRIDE = 2


class ReconCalibs(Reconstruction):
    name = "calibs"

    def __init__(self, ctx: ReconContext):
        super().__init__(ctx)
        self.active = 0
        self._inv = {}    # sensor -> its strided cv_xyz_inv on the device

    def set_active_kinect(self, num: int) -> None:
        # ≙ ReconCalibs::setActiveKinect
        self.active = int(num) % self.ctx.rig.num_sensors

    def slice_mosaic(self, volume: str = "cv_xyz_inv", slices: int = 9) -> np.ndarray:
        """[rows*h, cols*w, 3] mosaic of evenly spaced z-slices, channels
        normalized to [0,1] for display."""
        vol = np.asarray(getattr(self.ctx.rig, volume)[self.active])
        d = vol.shape[0]
        cols = int(np.ceil(np.sqrt(slices)))
        rows = int(np.ceil(slices / cols))
        picks = np.linspace(0, d - 1, slices).astype(int)
        imgs = np.asarray(vol[picks, :, :, :3])
        lo = imgs.min()
        hi = imgs.max()
        imgs = (imgs - lo) / max(hi - lo, 1e-9)
        h, w = imgs.shape[1:3]
        grid = np.zeros((rows * h, cols * w, 3), np.float32)
        for i, img in enumerate(imgs):
            r, c = divmod(i, cols)
            grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = img
        return grid

    def draw_with_depth(self, frames: ProcessedFrames, cam: RenderCamera):
        """The active sensor's valid inverse-calibration voxels, colored by
        their sensor coordinates (calib_vis.fs), z-buffered."""
        k, dev = self.active, self.ctx.device
        if k not in self._inv:
            vol = np.asarray(self.ctx.rig.cv_xyz_inv[k])[::STRIDE, ::STRIDE, ::STRIDE]
            self._inv[k] = torch.tensor(np.asarray(vol, np.float32), device=dev)
        inv = self._inv[k]
        valid = inv[..., 0] >= 0.0
        vz, vy, vx = inv.shape[:3]

        def centers(m):
            return (torch.arange(m, dtype=torch.float32, device=dev) + 0.5) / m

        zz, yy, xx = torch.meshgrid(centers(vz), centers(vy), centers(vx), indexing="ij")
        rig = self.ctx.rig
        bmin = torch.tensor(np.asarray(rig.bbox_min, np.float32), device=dev)
        size = torch.tensor(np.asarray(rig.bbox_max, np.float32), device=dev) - bmin
        world = torch.stack([xx, yy, zz], -1) * size + bmin
        color = torch.clamp(inv[..., :3], 0.0, 1.0)
        return splat_ops.zbuffer_points(world.reshape(-1, 3), color.reshape(-1, 3),
                                        valid.reshape(-1), cam)

"""Legacy multi-view texturing reconstruction (mirrors
``rgbd_recon_tpu/models/mvt.py``).

≙ ReconMVT (framework/reconstruction/recon_mvt.cpp:15-156 + glsl/mvt_accum.*):
the same two-pass accumulation as trigrid, but the bilateral filter runs in
the vertex shader on UNPROCESSED depth (recon_mvt.cpp:32 binds the raw depth
array), quality = lateral_quality^30 / depth (mvt_accum.vs:97, .fs:52), and
grid validity uses ``l = min_length * avg_depth + 0.005`` (mvt_accum.gs:36-39).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.preprocess import MAX_DEPTH_M, ProcessedFrames, _pad_edge
from ..ops.sample import pixel_texcoords, sample3d
from .trigrid import ReconTrigrid, avg_depth, edge_valid

KS = 6                                   # mvt_accum.vs kernel size
TAPS = (2 * KS + 1) ** 2


def _spatial_weights(device) -> torch.Tensor:
    """f32[TAPS, 1, 1] tent weights 1 - |(dx, dy)| / KS in the taps' order
    (dy major, dx minor), rounded from double as the JAX loop's scalars."""
    g = [1.0 - math.hypot(dx, dy) / KS for dy in range(-KS, KS + 1)
         for dx in range(-KS, KS + 1)]
    return torch.as_tensor(np.array(g, np.float32), device=device)[:, None, None]


def mvt_bilateral(depth_m: torch.Tensor, cv_min, cv_max):
    """mvt_accum.vs:43-102 on depth_m f32[K, H, W] (meters): (filtered depth
    meters, lateral^30). Differs from pre_depth.fs: the weight-sum guard
    (w > 0), and the w_range < 0.65 n rejection zeroes the depth
    (mvt_accum.vs:90-95). The 169 taps of a sensor are one batch (edge-
    padded windows of ``F.unfold``), summed over the tap axis."""
    kk, h, w = depth_m.shape
    n = float(TAPS)
    outside_c = (depth_m < cv_min) | (depth_m > cv_max)
    drm = 0.35 * depth_m / MAX_DEPTH_M
    taps = F.unfold(_pad_edge(depth_m, KS)[:, None], 2 * KS + 1).reshape(kk, TAPS, h, w)
    d, dr = depth_m[:, None], drm[:, None]
    dist = (taps - d).abs()
    reject = (taps < cv_min) | (taps > cv_max) | (dist > dr)
    gr = 1.0 - torch.minimum(dist, dr) / torch.where(dr > 0, dr, 1.0)
    wsr = _spatial_weights(depth_m.device) * gr
    depth_bf = torch.where(reject, 0.0, wsr * taps).sum(1)
    w_acc = torch.where(reject, 0.0, wsr).sum(1)
    w_range = torch.where(reject, 0.0, gr).sum(1)
    border = reject.sum(1).to(depth_m.dtype)
    lateral = 1.0 - border / n
    filtered = torch.where(w_acc > 0.0, depth_bf / torch.where(w_acc > 0, w_acc, 1.0), 0.0)
    filtered = torch.where(w_range < n * 0.65, 0.0, filtered)  # vs:90-95
    filtered = torch.where(outside_c, 0.0, filtered)
    return filtered, lateral ** 30.0


class ReconMVT(ReconTrigrid):
    name = "mvt"

    def _per_sensor(self, k: int, frames: ProcessedFrames):
        rig = self.ctx.device_rig()
        cv_min, cv_max = rig.depth_limits[k, 0], rig.depth_limits[k, 1]
        filtered, lat_q = mvt_bilateral(frames.depth_raw[k:k + 1], cv_min, cv_max)
        filtered, lat_q = filtered[0], lat_q[0]
        d_idx = (filtered - cv_min) / (cv_max - cv_min)  # mvt_accum.vs:107
        h, w = filtered.shape
        coords = torch.cat([pixel_texcoords(h, w, filtered.device), d_idx[..., None]], -1)
        world = sample3d(rig.cv_xyz[k], coords)
        qual = lat_q / torch.clamp(filtered, min=1e-6)  # mvt_accum.fs:52
        length = self.min_length * avg_depth(filtered) + 0.005  # mvt_accum.gs:36-39
        valid = edge_valid(world, filtered, length, 0.5)
        return world, frames.color_registered[k], qual, valid

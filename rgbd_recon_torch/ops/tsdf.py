"""TSDF volume configuration and the dense reference integrators (mirrors
``rgbd_recon_tpu/ops/tsdf.py``).

``integrate`` and ``integrate_colors`` update every voxel of the
``[Vz, Vy, Vx]`` grid (the reference's per-voxel integration pass,
glsl/tsdf_integration.vs:23-59 + recon_integration.cpp:242-269), with the
JAX module's per-sensor order of float32 updates. Sampling parity
(NetKinectArray.cpp:181-188):

  cv_xyz_inv  trilinear (GL_LINEAR 3D texture)
  silhouette  bilinear
  depth       NEAREST (m_textures_depth_b is GL_NEAREST)
  quality     bilinear

Every update is per voxel, so the volume is fused in z-slabs of about
``SLAB_VOXELS`` voxels: the sampling temporaries stay bounded (a 256^3
volume at once would hold ~3 GB of them) and the result is the same.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..utils.math import Bbox
from .raymarch import blend_colors_exact
from .sample import sample2d, sample3d

SLAB_VOXELS = 1 << 22


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


@functools.lru_cache(maxsize=None)
def _axis_centers(n: int, device: torch.device) -> torch.Tensor:
    """(i + 0.5) / n in float32, each operation rounded as JAX rounds it;
    made once per (n, device) (``utils.math.device_const``'s rule)."""
    c = (np.arange(n, dtype=np.float32) + np.float32(0.5)) / np.float32(n)
    return torch.as_tensor(c, device=device)


def voxel_centers_normalized(res: tuple[int, int, int], device=None,
                             z_range: tuple[int, int] | None = None) -> torch.Tensor:
    """Normalized voxel-center grid f32[Vz, Vy, Vx, 3] in GL (s, t, r)
    order (volume_sampler.cpp:20 feeds voxel centers; ``ivec3(position *
    res)`` recovers the index, tsdf_integration.vs:57). ``z_range``: only
    the slices [z0, z1)."""
    vx, vy, vz = res
    z0, z1 = z_range or (0, vz)
    device = torch.device(device if device is not None else "cpu")
    xs, ys, zs = _axis_centers(vx, device), _axis_centers(vy, device), \
        _axis_centers(vz, device)[z0:z1]
    zz, yy, xx = torch.meshgrid(zs, ys, xs, indexing="ij")
    return torch.stack([xx, yy, zz], dim=-1)


def _slabs(res: tuple[int, int, int], device, z_range: tuple[int, int] | None = None):
    """(z0, z1, voxel centers of slices z0..z1) over the volume, or over
    the slices [za, zb) of ``z_range`` (z0, z1 then count from za)."""
    vx, vy, vz = res
    za, zb = z_range or (0, vz)
    nz = max(1, min(zb - za, SLAB_VOXELS // (vx * vy)))
    for z0 in range(za, zb, nz):
        z1 = min(zb, z0 + nz)
        yield z0 - za, z1 - za, voxel_centers_normalized(res, device, (z0, z1))


def integrate(frames, rig, cfg: TsdfConfig,
              voxel_mask: torch.Tensor | None = None,
              z_range: tuple[int, int] | None = None) -> torch.Tensor:
    """Fuse all sensors into a TSDF volume f32[Vz, Vy, Vx]. ``rig``: a
    DeviceRig carrying ``cv_xyz_inv``. ``voxel_mask`` (bool[Vz, Vy, Vx],
    from ops/bricks.voxel_occupancy) limits the update to occupied bricks;
    unmasked voxels keep the clear value ``-limit``
    (recon_integration.cpp:249-250). ``z_range`` (z0, z1): only that z-slab
    of the volume, f32[z1 - z0, Vy, Vx] (the sharded dense step)."""
    limit = float(np.float32(cfg.limit))
    vx, vy, vz = cfg.res
    za, zb = z_range or (0, vz)
    dev = frames.depth.device
    out = torch.empty((zb - za, vy, vx), dtype=torch.float32, device=dev)
    for z0, z1, pos in _slabs(cfg.res, dev, z_range):
        weighted_tsd = torch.full(pos.shape[:-1], limit, dtype=torch.float32, device=dev)
        total_weight = torch.zeros(pos.shape[:-1], dtype=torch.float32, device=dev)
        for i in range(rig.num_sensors):
            pos_calib = sample3d(rig.cv_xyz_inv[i], pos)  # (u, v, d_norm)
            uv = pos_calib[..., :2]
            sil = sample2d(frames.silhouette[i][..., None], uv)[..., 0]
            depth = sample2d(frames.depth[i][..., :1], uv, method="nearest")[..., 0]
            qual = sample2d(frames.quality[i][..., None], uv)[..., 0]
            sdist = pos_calib[..., 2] - depth  # tsdf_integration.vs:41

            # silhouette gate (:33-39): with sil < 1 and nothing written
            # yet, force -limit and skip this sensor (1 - 1e-4: a float
            # lerp of a constant-1 window may not return exactly 1)
            skip = (sil < 0.9999) & (weighted_tsd >= limit)
            forced = torch.where(skip, -limit, weighted_tsd)
            in_front = sdist <= -limit
            in_band = (sdist > -limit) & (sdist < limit)
            new_tw = total_weight + qual
            pos_tw = new_tw > 0.0
            accum = torch.where(
                pos_tw,
                (weighted_tsd * total_weight + qual * sdist) / torch.where(pos_tw, new_tw, 1.0),
                weighted_tsd)
            wt_next = torch.where(in_front, -limit, torch.where(in_band, accum, weighted_tsd))
            tw_next = torch.where(in_band & pos_tw, new_tw, total_weight)
            weighted_tsd = torch.where(skip, forced, wt_next)
            total_weight = torch.where(skip, total_weight, tw_next)
        out[z0:z1] = weighted_tsd
    if voxel_mask is not None:
        out = torch.where(voxel_mask[za:zb], out, -limit)
    return out


def integrate_colors(frames, rig, cfg: TsdfConfig,
                     voxel_mask: torch.Tensor | None = None,
                     z_range: tuple[int, int] | None = None) -> torch.Tensor:
    """Per-voxel blended color volume f32[Vz, Vy, Vx, 4] (rgb, flag): the
    raymarch shader's per-sample ``blendColors`` (glsl/tsdf_raymarch.fs:
    295-330) evaluated at voxel centers. alpha > 0 marks a quality-weighted
    blend, alpha <= 0 the 1/dist fallback; unmasked voxels are 0.
    ``z_range``: only that z-slab, as in ``integrate``."""
    limit = float(np.float32(cfg.limit))
    vx, vy, vz = cfg.res
    za, zb = z_range or (0, vz)
    dev = frames.depth.device
    out = torch.empty((zb - za, vy, vx, 4), dtype=torch.float32, device=dev)
    for z0, z1, pos in _slabs(cfg.res, dev, z_range):
        out[z0:z1] = blend_colors_exact(frames, rig, pos, limit)
    if voxel_mask is not None:
        out = torch.where(voxel_mask[za:zb, ..., None], out, 0.0)
    return out


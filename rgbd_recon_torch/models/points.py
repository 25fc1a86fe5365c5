"""Point-splatting reconstruction (mirrors ``rgbd_recon_tpu/models/points.py``).

≙ ReconPoints (framework/reconstruction/recon_points.cpp:27-113 + glsl/
points.{vs,gs,fs}): one point per depth pixel, unprojected through cv_xyz,
bbox-culled, sized 10/dist, textured via cv_uv with Phong/debug shade modes.
The GL point-sprite rasterization becomes a winner-takes-all z-buffer splat
(ops/splat.py).
"""
from __future__ import annotations

import torch

from ..ops import splat as splat_ops
from ..ops.preprocess import ProcessedFrames
from ..ops.raymarch import CAMERA_COLORS, RenderCamera, phong_shade
from ..ops.sample import pixel_texcoords, sample2d, sample3d
from ..utils.math import pmat
from .base import ReconContext, Reconstruction


def _unit(v: torch.Tensor) -> torch.Tensor:
    nn = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.where(nn < 1e-20, 1.0, nn)


class ReconPoints(Reconstruction):
    name = "points"

    def __init__(self, ctx: ReconContext, shade_mode: int = 0):
        super().__init__(ctx)
        self.shade_mode = shade_mode

    def draw_with_depth(self, frames: ProcessedFrames, cam: RenderCamera):
        """The points of every sensor, z-buffered."""
        mv = cam.modelview
        rig = self.ctx.device_rig()
        _, h, w = frames.depth.shape[:3]
        uv = pixel_texcoords(h, w, frames.depth.device)
        worlds, colors, valids = [], [], []
        for k in range(rig.num_sensors):
            depth = frames.depth[k, ..., 0]           # processed normalized depth
            coords = torch.cat([uv, depth[..., None]], -1)
            world = sample3d(rig.cv_xyz[k], coords)    # points.vs:28
            texc = sample3d(rig.cv_uv[k], coords)      # points.vs:30
            color = sample2d(frames.color[k], texc)    # points.fs:66
            normal = frames.normals[k]
            in_box = (world >= rig.bbox_min).all(-1) & (world <= rig.bbox_max).all(-1)
            valid = in_box & (depth > 0.0)             # points.gs:37-39
            # rgb-border cull (points.fs:38-42)
            valid &= ((texc[..., 0] > 0.01) & (texc[..., 0] < 0.99)
                      & (texc[..., 1] > 0.01) & (texc[..., 1] < 0.99))
            if self.shade_mode == 3:
                shaded = CAMERA_COLORS[k].to(color.device).expand(color.shape)
            elif self.shade_mode == 1:
                pos_es = pmat(world, mv[:3, :3].T) + mv[:3, 3]
                shaded = phong_shade(pos_es, _unit(pmat(normal, mv[:3, :3].T)))
            elif self.shade_mode == 2:
                shaded = normal
            else:
                shaded = color
            worlds.append(world.reshape(-1, 3))
            colors.append(shaded.reshape(-1, 3))
            valids.append(valid.reshape(-1))
        max_size = 4.0 if self.shade_mode == 3 else 10.0  # points.gs:53-57
        return splat_ops.zbuffer_points(torch.cat(worlds), torch.cat(colors),
                                        torch.cat(valids), cam, max_size)

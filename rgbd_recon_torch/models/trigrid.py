"""Triangle-grid multi-view blending reconstruction (mirrors
``rgbd_recon_tpu/models/trigrid.py``).

≙ ReconTrigrid (framework/reconstruction/recon_trigrid.cpp:15-153 + glsl/
trigrid_accum.*, trigrid_normalize.fs): a regular triangle grid over each
depth image, validity by world-space edge length ``l = min_length *
avg_depth * 4`` (trigrid_accum.gs:34-37), depth prepass + additive
quality-weighted accumulation with an epsilon z-test, then a normalize
resolve. Realized as a two-pass accumulation splat (ops/splat.py). The grid
neighbours are ``torch.roll``'s, wrapping at the image edges as
``jnp.roll`` does in the JAX strategy.
"""
from __future__ import annotations

import torch

from ..ops import splat as splat_ops
from ..ops.preprocess import ProcessedFrames
from ..ops.raymarch import CAMERA_COLORS, RenderCamera, phong_shade
from ..utils.math import pmat
from .base import ReconContext, Reconstruction
from .points import _unit


def _right(x: torch.Tensor) -> torch.Tensor:
    return torch.roll(x, -1, dims=1)


def _down(x: torch.Tensor) -> torch.Tensor:
    return torch.roll(x, -1, dims=0)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1)


def edge_valid(world: torch.Tensor, depth: torch.Tensor, length: torch.Tensor,
               min_depth: float) -> torch.Tensor:
    """Grid-cell validity (trigrid_accum.gs validSurface): all edges of the
    two cell triangles shorter than ``length``; the four corner depths
    above ``min_depth``."""
    w_r, w_d, w_rd = _right(world), _down(world), _down(_right(world))
    d_r, d_d, d_rd = _right(depth), _down(depth), _down(_right(depth))

    def ok(a, b):
        return _norm(a - b) < length

    depths_ok = (depth > min_depth) & (d_r > min_depth) & (d_d > min_depth) & (d_rd > min_depth)
    return (depths_ok & ok(world, w_r) & ok(world, w_d) & ok(w_r, w_d)
            & ok(w_r, w_rd) & ok(w_d, w_rd))


def avg_depth(depth: torch.Tensor) -> torch.Tensor:
    """The mean depth of a cell's first triangle."""
    return (depth + _right(depth) + _down(depth)) / 3.0


class ReconTrigrid(Reconstruction):
    name = "trigrid"

    def __init__(self, ctx: ReconContext, min_length: float = 0.0125,
                 epsilon: float = 0.075, shade_mode: int = 0,
                 adaptive: bool = True, footprint_cap: int = 6):
        super().__init__(ctx)
        self.min_length = min_length
        self.epsilon = epsilon  # recon_trigrid.cpp epsilon uniform
        self.shade_mode = shade_mode
        # adaptive=False: the fixed 2 px square footprint; footprint_cap
        # bounds the per-point adaptive size (cap^2 offsets a splat pass)
        self.adaptive = adaptive
        self.footprint_cap = footprint_cap

    def _per_sensor(self, k: int, frames: ProcessedFrames):
        """(world, color, quality, valid) of sensor k."""
        depth = frames.depth[k, ..., 0]
        world = frames.world[k]
        length = self.min_length * avg_depth(depth) * 4.0     # trigrid_accum.gs:34
        valid = edge_valid(world, depth, length, 0.0)
        return world, frames.color_registered[k], frames.quality[k], valid

    def draw_with_depth(self, frames: ProcessedFrames, cam: RenderCamera):
        """The blended grids of every sensor."""
        mv = cam.modelview
        rig = self.ctx.device_rig()
        worlds, colors, quals, valids, sizes = [], [], [], [], []
        for k in range(rig.num_sensors):
            world, color, qual, valid = self._per_sensor(k, frames)
            in_box = (world >= rig.bbox_min).all(-1) & (world <= rig.bbox_max).all(-1)
            valid = valid & in_box                     # trigrid_accum.fs:41-43

            # backface cull via the eye-space cell normal (gs:56 + fs:52-55)
            pos_es = pmat(world, mv[:3, :3].T) + mv[:3, 3]
            n_es = _unit(torch.linalg.cross(_right(pos_es) - pos_es, _down(pos_es) - pos_es,
                                            dim=-1))
            dirn = pos_es / torch.clamp(torch.linalg.vector_norm(pos_es, dim=-1, keepdim=True),
                                        min=1e-20)
            valid = valid & ((-n_es * dirn).sum(-1) <= 0.0)

            if self.shade_mode == 3:
                shaded = CAMERA_COLORS[k].to(color.device).expand(color.shape)
            elif self.shade_mode == 1:
                shaded = phong_shade(pos_es, -n_es)
            elif self.shade_mode == 2:
                shaded = frames.normals[k]
            else:
                shaded = color

            # adaptive footprint = the projected cell extent in pixels
            # (the reference rasterizes the triangle pair,
            # trigrid_accum.gs:26-57)
            pxy = splat_ops.project(world, cam)[0]
            ext = torch.maximum(_norm(_right(pxy) - pxy), _norm(_down(pxy) - pxy))
            sizes.append((ext + 1.0).reshape(-1))
            worlds.append(world.reshape(-1, 3))
            colors.append(shaded.reshape(-1, 3))
            quals.append(qual.reshape(-1))
            valids.append(valid.reshape(-1))

        if self.adaptive:
            fp, size = self.footprint_cap, torch.cat(sizes)
        else:
            fp, size = 2, None
        buffers = splat_ops.splat(torch.cat(worlds), torch.cat(colors), torch.cat(quals),
                                  torch.cat(valids), cam, epsilon=self.epsilon,
                                  footprint=fp, size=size)
        rgba, _, depth = splat_ops.normalize(buffers)
        return rgba, depth

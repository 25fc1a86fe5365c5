"""TSDF integration + raymarch reconstruction (mirrors
``rgbd_recon_tpu/models/integration.py``).

≙ ReconIntegration (framework/reconstruction/recon_integration.hpp:35-103):
owns the TSDF volume geometry, brick machinery, renderer and hole filling,
with the same knob surface (setTsdfLimit / setVoxelSize / setBrickSize /
setColorFilling / setUseBricks / setSpaceSkip / setDrawBricks /
setMinVoxelsPerBrick, occupiedRatio). As in the JAX strategy it integrates
with the XLA table integrator (``tsdf_fast.integrate_sparse``: kernel 7's
window mode on the card, with its defaults max_bricks 1024 and a 64-px
window), marks bricks with kernel 4, renders voxel-order volumes with the
default sweep (kernel 2's screen warp) and fills holes with the inpaint
pyramid. The sweep axis is picked on the host.
"""
from __future__ import annotations

import torch

from ..ops import bricks as brick_ops
from ..ops import inpaint
from ..ops import raymarch as rm
from ..ops import raymarch_fast as rmf
from ..ops import tsdf as tsdf_ops
from ..ops import tsdf_fast
from ..ops.preprocess import ProcessedFrames
from ..ops.raymarch import RenderCamera
from ..utils.timers import TimerDatabase
from .base import ReconContext, Reconstruction

WINDOW = 64   # tsdf_fast.integrate_sparse's default window


class ReconIntegration(Reconstruction):
    name = "integration"

    def __init__(self, ctx: ReconContext, limit: float = 0.01,
                 voxel_size: float = 0.01, brick_size: float = 0.1):
        super().__init__(ctx)
        self._limit = limit
        self._voxel_size = voxel_size
        self._brick_size = brick_size
        self._min_voxels = 10
        self._fill_holes = True
        self._use_bricks = True
        self._skip_space = True
        self._draw_bricks = False
        self._shade_mode = 0
        self._ratio_occupied = None   # the last frame's ratio, on the device
        self._num_lods = 6
        self._rebuild()
        for t in ("2integrate", "holefill", "brickdraw", "3recon"):
            TimerDatabase.instance().add_timer(t)

    # -- knobs (≙ recon_integration.hpp setters) ---------------------------

    def set_tsdf_limit(self, limit: float):
        self._limit = limit
        self._rebuild()

    def set_voxel_size(self, size: float):
        # recon_integration.cpp:340-353
        self._voxel_size = size
        self._rebuild()

    def set_brick_size(self, size: float):
        # snapped to voxel multiples (recon_integration.cpp:462-464)
        self._brick_size = size
        self._rebuild()

    def set_min_voxels_per_brick(self, n: int):
        self._min_voxels = n

    def set_color_filling(self, v: bool):
        self._fill_holes = v

    def set_use_bricks(self, v: bool):
        self._use_bricks = v

    def set_space_skip(self, v: bool):
        self._skip_space = v

    def set_draw_bricks(self, v: bool):
        self._draw_bricks = v

    def set_shade_mode(self, mode: int):
        self._shade_mode = mode

    def occupied_ratio(self) -> float:
        """The last frame's occupied-brick ratio (one device read)."""
        return 0.0 if self._ratio_occupied is None else float(self._ratio_occupied)

    @property
    def volume_res(self):
        return self.tsdf_cfg.res

    # ---------------------------------------------------------------------

    def _rebuild(self):
        cfg = tsdf_ops.TsdfConfig.from_voxel_size(self.ctx.bbox, self._voxel_size, self._limit)
        # the brick-sparse integrator wants 16-aligned volumes: res rounded up
        res = tuple(-(-r // tsdf_fast.BRICK) * tsdf_fast.BRICK for r in cfg.res)
        self.tsdf_cfg = cfg._replace(res=res)
        self.brick_grid = brick_ops.make_brick_grid(self.ctx.bbox, self._brick_size,
                                                    self._voxel_size)
        self.tables = tsdf_fast.precompute_tables(self.ctx.rig, self.tsdf_cfg, self.ctx.device)
        self._win_off = {}    # (h, w) -> win_offsets: a function of the tables alone

    def draw_with_depth(self, frames: ProcessedFrames, cam: RenderCamera):
        """The raymarched volume, hole-filled unless color filling is off,
        and its window depth."""
        mv = cam.modelview.detach().cpu().numpy()
        axis, flip = rmf.pick_axis(mv, rm.vol_to_world_matrix(self.ctx.bbox))
        counts = brick_ops.mark_bricks(frames.world, frames.world_valid, self.brick_grid)
        mask = brick_ops.occupancy_mask(counts, self._min_voxels)
        self._ratio_occupied = brick_ops.occupied_ratio(mask)
        res = self.tsdf_cfg.res
        mask16 = brick_ops.block_occupancy(mask, self.brick_grid, res, tsdf_fast.BRICK)
        if not self._use_bricks:
            mask16 = torch.ones_like(mask16)
        h, w = frames.depth.shape[1:3]
        if (h, w) not in self._win_off:
            self._win_off[(h, w)] = tsdf_fast.win_offsets(self.tables, h, w, WINDOW)
        vol, cvol = tsdf_fast.integrate_sparse(frames, self.tables, self.tsdf_cfg, mask16,
                                               window=WINDOW, win_off=self._win_off[(h, w)])
        occ = (rmf.slab_occupancy(mask16, axis, res[axis])
               if (self._skip_space and self._use_bricks) else None)
        out = rmf.render_fast(vol, cvol, cam, self.ctx.bbox, float(self.tsdf_cfg.limit), axis,
                              flip, rm.RenderParams(shade_mode=self._shade_mode),
                              slab_occupied=occ, zmajor=False)
        if not self._fill_holes:
            return out.color, out.depth
        pyr_c, pyr_d = inpaint.build_pyramid(out.color, out.depth, self._num_lods)
        return inpaint.colorfill(pyr_c, pyr_d), out.depth

"""The brick-sparse fast path's integrator tier: its choice, its bakes and
its calls (in the JAX package, parts of ``FramePipeline``:
rgbd_recon_tpu/runtime/pipeline.py:202-237,444-449,609-633).

``choose`` picks one of four tiers, or None on the reference path:

  dense emit        the per-brick quadratic warp (``use_affine``, or a bake
                    residual <= ``affine_tol``) at ``Vx % 128 == 0``: kernel
                    1, z-major output, the depth-band cull's classes
  block-major       the quadratic warp at another Vx: kernel 6, voxel
                    order, every sensor FULL, the whole frame as its window
  warp table        ``use_affine=False`` or a residual over ``affine_tol``:
                    kernel 7 on the dense warp table, no depth-band cull
  table integrator  ``use_pallas`` off: ``tsdf_fast.integrate_sparse``, the
                    XLA formulation (kernel 7's window mode), no cull

``use_pallas=None`` is the JAX gate, on with at least 8 bricks on every
axis (its other clause there, "the backend is a TPU", holds wherever the
port's kernels or their plain versions run), so a 48^3 volume integrates
as the JAX pipeline integrates it.
"""
from __future__ import annotations

import copy
from typing import Callable

import torch

from ..ops import tsdf_affine, tsdf_fast
from ..ops.tsdf import TsdfConfig
from ..ops.tsdf_dense import integrate_dense
from ..ops.tsdf_fast import BRICK, IntegrationTables
from ..ops.tsdf_persist import XSTRIDE2, integrate_affine
from ..ops.tsdf_sparse import integrate_sparse, win_offsets_pallas
from ..utils.timers import SPANS

DENSE, BLOCK_MAJOR = "dense emit", "block-major"          # the quadratic warp's tiers
WARP_TABLE, TABLE = "warp table", "table integrator"


class Integrator:
    """One tier's voxel->sensor bake (``affine`` or ``tables``), its windows
    and depth-band cull bake at a sensor size (``session``), and its calls.
    ``key``: what the bake depends on, (res, the ``use_pallas`` gate,
    ``use_affine``, ``affine_tol``)."""

    def __init__(self, rig, tsdf_cfg: TsdfConfig, cfg, device: torch.device,
                 log: Callable[[str], None], table_cache_dir: str | None, key: tuple):
        """Bakes the tier of ``key`` (``choose``): the per-brick affine
        warp, else the dense warp table."""
        res, gate = tsdf_cfg.res, key[1]
        self.tsdf_cfg, self.key, self._log = tsdf_cfg, key, log
        self._sample_window = cfg.sample_window
        self.affine = self.tables = None
        if gate and cfg.use_affine is not False:
            log(f"baking per-brick affine warp at {res} ...")
            aff = tsdf_affine.bake_affine(rig, tsdf_cfg, device)
            err = float(aff.max_err.max())
            if cfg.use_affine or err <= cfg.affine_tol:
                self.affine = aff
                log(f"  affine residual {err:.2e} (tol {cfg.affine_tol})")
            else:
                log(f"  affine residual {err:.2e} > tol {cfg.affine_tol};"
                    " falling back to the dense warp table")
        if self.affine is None:
            log(f"baking voxel->sensor warp tables at {res} ...")
            self.tables = tsdf_fast.tables_cached(rig, tsdf_cfg, device, table_cache_dir, log)
            self.tier = WARP_TABLE if gate else TABLE
        else:
            self.tier = BLOCK_MAJOR if res[0] % 128 else DENSE
        self.zmajor = self.tier == DENSE      # the color layout the sweep reads
        self._hw = self._cull_key = None
        self._layers = slice(None)      # the z-layers of mask16 it integrates
        self.win_off = self.wy = self.wx = self.xstride = self.cull_bake = None

    def session(self, h: int, w: int, brick_cull: bool) -> bool:
        """The windows of the sensor size (h, w), made at its first frame,
        and the depth-band cull bake, made on a new sensor size or TSDF
        limit, with ``brick_cull`` on the quadratic tiers only. True when
        either was (re)made."""
        made = self._hw != (h, w)
        if made:
            self._hw = (h, w)
            self._windows(h, w)
        limit = float(self.tsdf_cfg.limit)
        key = (h, w, limit) if brick_cull and self.affine is not None else None
        if key != self._cull_key:
            self._cull_key = key
            self.cull_bake = (None if key is None
                              else tsdf_affine.bake_cull(self.affine, h, w, limit))
            made = True
        return made

    def _windows(self, h: int, w: int) -> None:
        if self.tier == TABLE:
            self.win_off = tsdf_fast.win_offsets(self.tables, h, w, self._sample_window)
        elif self.tier == WARP_TABLE:
            self.win_off = win_offsets_pallas(self.tables, h, w)
        else:
            if self.zmajor:
                self.wy, clip_y = tsdf_affine.auto_window_rows(self.affine, h)
                self.wx, self.xstride, clip_x = tsdf_affine.auto_window_cols(self.affine, w)
                self._log(f"integration window: {self.wy} rows ({clip_y:.2%} clip), "
                          f"{self.wx} cols at stride {self.xstride} ({clip_x:.2%} clip)")
            else:
                # kernel 6 reads its taps from the frame in device memory, so
                # its window is the whole frame and clamps no footprint; the
                # TPU kernel's 48 rows and 64 columns clamped a fifth of the
                # occupied (sensor, block) pairs of five sensors at 208x224x208
                self.wy, self.wx, self.xstride = h, w, XSTRIDE2
                self._log(f"integration window: the whole {h}x{w} frame (block-major)")
            self.win_off = tsdf_affine.win_offsets_affine(self.affine, h, w, self.wy, self.wx,
                                                          self.xstride)

    def cull(self, mask16: torch.Tensor, frames):
        """1preprocess's depth-band cull of the 16^3 block mask: (mask16,
        the per-(sensor, block) classes); without a cull bake (mask16, None)."""
        if self.cull_bake is None:
            return mask16, None
        mask16, _, cls = tsdf_affine.block_depth_cull_baked(
            mask16, self.cull_bake, frames.depth[..., 0], frames.quality, frames.silhouette,
            float(self.tsdf_cfg.limit))
        return mask16, cls

    def integrate(self, frames, mask16: torch.Tensor, max_bricks: int, cls=None):
        """2integrate: the fused TSDF and color volumes of the first
        ``max_bricks`` occupied blocks of ``mask16`` (the whole volume's)."""
        cfg, mask16 = self.tsdf_cfg, mask16[self._layers]
        if self.tier == TABLE:
            return tsdf_fast.integrate_sparse(frames, self.tables, cfg, mask16, max_bricks,
                                              self._sample_window, self.win_off)
        if self.tier == WARP_TABLE:
            return integrate_sparse(frames, self.tables, cfg, mask16, max_bricks, self.win_off)
        self._count_pairs(frames, mask16, max_bricks, cls)
        if self.tier == BLOCK_MAJOR:
            return integrate_affine(frames, self.affine, cfg, mask16, max_bricks, self.win_off,
                                    self.wy, wx=self.wx, xstride=self.xstride)
        return integrate_dense(frames, self.affine, cfg, mask16, max_bricks, self.win_off,
                               self.wy, self.wx, self.xstride, cls)

    @staticmethod
    def _count_pairs(frames, mask16, max_bricks, cls) -> None:
        """With the recorder on, kernels 1 and 6's counters:
        ``integrate.pairs``, the (sensor, block) pairs handed over (every
        sensor with each of the first ``max_bricks`` blocks of the culled
        ``mask16``), and ``integrate.pairs_culled``, those the depth-band
        cull classes NONE (1, kernel 1 skips them) or FRONT (2, kernel 1
        sets the front value unsampled); kernel 6 fuses them all."""
        if not SPANS.on:
            return
        m = mask16.reshape(-1)
        fused = m & (torch.cumsum(m, 0) <= max_bricks)
        SPANS.count("integrate.pairs", fused.expand(frames.depth.shape[0], -1))
        if cls is not None:
            SPANS.count("integrate.pairs_culled", ((cls == 1) | (cls == 2)) & fused)

    def slab(self, lo: int, hi: int) -> "Integrator":
        """Bricks [lo, hi), whole z-layers, as the integrator of their z-slab:
        contiguous copies of the bakes and windows, no cull (after
        ``session``)."""
        vx, vy, _ = self.tsdf_cfg.res
        layer = (vx // BRICK) * (vy // BRICK)
        s = copy.copy(self)
        s.tsdf_cfg = TsdfConfig((vx, vy, (hi - lo) // layer * BRICK), self.tsdf_cfg.limit)
        s._layers = slice(lo // layer, hi // layer)
        if self.affine is not None:
            s.affine = self.affine._replace(coeffs=self.affine.coeffs[:, lo:hi].contiguous())
        if self.tables is not None:
            s.tables = IntegrationTables(self.tables.pos_blocked[:, lo:hi].contiguous())
        s.win_off = self.win_off[:, lo:hi].contiguous()
        s.cull_bake = s._cull_key = None
        return s


def choose(rig, tsdf_cfg: TsdfConfig, cfg, device: torch.device,
           log: Callable[[str], None], table_cache_dir: str | None = None,
           prev: Integrator | None = None) -> Integrator | None:
    """The integrator of ``cfg`` (a ``PipelineConfig``) at ``tsdf_cfg``, or
    None on the reference path (``fast_path`` or ``use_bricks`` off, or a
    res that is not 16-aligned). ``prev``, the integrator held, is kept,
    with this ``tsdf_cfg``, while its key is unchanged; else the bake is
    made anew. Logs the tier."""
    res = tsdf_cfg.res
    if not (cfg.fast_path and cfg.use_bricks) or any(r % BRICK for r in res):
        return None
    gate = cfg.use_pallas if cfg.use_pallas is not None else min(res) // BRICK >= 8
    key = (res, gate, cfg.use_affine, cfg.affine_tol)
    integ = (prev if prev is not None and prev.key == key
             else Integrator(rig, tsdf_cfg, cfg, device, log, table_cache_dir, key))
    integ.tsdf_cfg = tsdf_cfg       # a kept integrator takes a new TSDF limit
    log(f"integrator at {res}: " + {
        DENSE: "dense emit (kernel 1)",
        BLOCK_MAJOR: f"block-major (kernel 6; Vx % 128 = {res[0] % 128})",
        WARP_TABLE: "warp table (kernel 7)",
        TABLE: "table integrator (tsdf_fast)"}[integ.tier])
    return integ

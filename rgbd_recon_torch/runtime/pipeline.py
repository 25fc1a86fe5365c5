"""Whole-frame pipeline (mirrors ``rgbd_recon_tpu/runtime/pipeline.py``).

The reference's per-frame hot path (kinect_client.cpp:580-614 ``draw3d``)
in four stages, named like the reference's TimerDatabase entries:

  1preprocess  sensor filtering (bilateral + registration kernels),
               brick occupancy (mark_bricks kernel), depth-band cull
  2integrate   brick-sparse TSDF + color fusion (integrate_dense kernel)
  3recon       sweep raymarch renderer (screen-warp kernel)
  holefill     inpaint pyramid + colorfill

The staged fast path of the JAX pipeline takes these gates:

  pixel warp  affine (residual <= ``warp_tol``) -> piecewise (``warp_knots``
              knots, residual <= ``pw_warp_tol``; kernel 5) -> the exact
              gather of the cv volumes (also ``use_warp=False``)
  integrator  ``use_pallas`` on: the per-brick quadratic warp
              (``affine_tol``): dense emit into the sweep's z-major layout
              when ``Vx % 128 == 0`` (kernel 1), else block-major (kernel
              6); the dense warp table for ``use_affine=False`` or a
              residual over ``affine_tol`` (kernel 7, no depth-band cull).
              ``use_pallas`` off: the XLA table integrator
              ``tsdf_fast.integrate_sparse`` (kernel 7's window mode, no
              affine bake, no depth-band cull)

``use_pallas=None`` is the JAX gate (rgbd_recon_tpu/runtime/pipeline.py:
444-449): on when the volume has at least 8 bricks on every axis
(``min(res) // 16 >= 8``). Its other clause there, "the backend is a TPU",
holds here wherever the port's kernels exist: on the card, and through
their plain versions on the CPU. So a 48^3 volume (``voxel_size`` 0.05)
integrates as the JAX pipeline integrates it, with the XLA formulation;
``use_pallas=True`` keeps the kernel tiers at any size. Brick marking
is kernel 4 at every volume size.

The reference path (JAX ``use_fast`` false: ``fast_path`` or
``use_bricks`` off, or a volume that is not 16-aligned; the res is derived
at align 16 only with both on) runs the JAX pipeline's dense oracle
stages: 1preprocess marks bricks only with ``use_bricks`` and expands the
mask to voxels (``bricks.voxel_occupancy``; no 16^3 mask, no cull,
``occupied_bricks`` 0), 2integrate is ``tsdf.integrate`` +
``integrate_colors`` over every voxel, 3recon the per-ray marcher
``raymarch.render`` (the coarse brick skip with ``skip_space`` and
``use_bricks``), all plain PyTorch beside kernels 2 and 3 (and 4 with
``use_bricks``).

Fused mode (``cfg.fused``, read at every step: a caller may assign
``pipe.cfg``) runs the same frame function, ``_frame``, as one program: on
a CUDA device one replay of a CUDA graph captured for the frame's sweep
variant ``(axis, flip)`` (one graph on the reference path, as the JAX
pipeline runs ``_step`` there), captured at first use with a log line
(``runtime/frame_graph.py``); on the CPU the frame function eagerly. Its
sweep keeps the slab flags on the device (``slab_occupancy_device``),
bit for bit the staged frame's host skip. The graphs hold the addresses
of the session bakes, so whatever replaces a bake (``_configure``,
``retune``, ``reload``, a new sensor size) drops them first.
Session bakes run lazily at the first frame's sensor size, in torch, on
the pipeline's ``device``; ``preprocess`` runs them and the preprocessing
alone (the reconstruction strategies of ``models/`` draw from its
frames).

Session API (the app's control channel): ``retune`` re-derives only what
a change invalidates, ``reload`` rebuilds the stages keeping every bake,
``warmup`` runs each stage once, synchronised, with a log line each (the
first call on the card builds the CUDA kernels), or in fused mode captures
the frame's graph; ``warm_variants_async`` captures the other five sweep
variants on a daemon thread in fused mode. Stage timers live on the
process-wide ``TimerDatabase.instance()``, as in the JAX package; a new
pipeline starts its four stage timers empty. With the span recorder on
(``utils.timers.SPANS``, off by default) each step is a ``frame`` span:
fused on the card, host spans of the key, the load, the launch and the
outputs, and device spans of the stages (3recon as its sweep and its
shade) timed inside the graph; a fused CPU frame has the same stage
spans on the host clock, a staged frame only ``frame``.
"""
from __future__ import annotations

import contextlib
import threading
import time
import weakref
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..calibration.rig import RigCalibration, device_rig
from ..ops import bricks as brick_ops
from ..ops import inpaint
from ..ops import preprocess as pp
from ..ops import raymarch as rm
from ..ops import raymarch_fast as rmf
from ..ops import tsdf_affine
from ..ops import tsdf as tsdf_ops
from ..ops import tsdf_fast
from ..ops.tsdf_dense import integrate_dense
from ..ops.tsdf_fast import BRICK
from ..ops.tsdf_persist import WX2, XSTRIDE2, integrate_affine
from ..ops.tsdf_sparse import integrate_sparse, win_offsets_pallas
from ..ops.warp import bake_piecewise_warp, bake_pixel_warp
from ..utils.math import look_at, perspective
from ..utils.timers import SPANS, TimerDatabase
from .frame_graph import FrameGraphs


class PipelineConfig(NamedTuple):
    """Static configuration: the JAX pipeline's fields and defaults
    (kinect_client.cpp:86-92)."""

    voxel_size: float = 0.01
    brick_size: float = 0.1
    tsdf_limit: float = 0.01
    min_voxels_per_brick: int = 10
    render_width: int = 1280
    render_height: int = 720
    shade_mode: int = 0
    use_bricks: bool = True
    skip_space: bool = True
    fill_holes: bool = True
    num_lods: int = 6
    filter_textures: bool = True
    use_processed_depth: bool = True
    refine_boundary: bool = True
    tsdf_res: tuple[int, int, int] | None = None
    fast_path: bool = True
    max_bricks: int | None = None
    sample_window: int = 64
    sweep_res: tuple[int, int] | None = None
    use_warp: bool = True
    warp_tol: float = 1e-4
    warp_knots: int = 48
    pw_warp_tol: float = 1e-3
    use_pallas: bool | None = None
    use_affine: bool | None = None
    affine_tol: float = 0.02
    brick_cull: bool = True
    fused: bool = False


class FrameOutput(NamedTuple):
    color: torch.Tensor           # f32[H, W, 4] final image (hole-filled)
    depth: torch.Tensor           # f32[H, W] window depth
    hit: torch.Tensor             # bool[H, W]
    tsdf: torch.Tensor            # [Vz, Vy, Vx]: bf16 (dense emit) or f32
    occupied_ratio: torch.Tensor  # f32[]
    num_samples: torch.Tensor     # i32[H, W]
    occupied_bricks: torch.Tensor  # i32[] occupied 16^3 blocks this frame
                                   # (0 on the reference path)


class PreOut(NamedTuple):
    """What 1preprocess hands the later stages."""

    frames: pp.ProcessedFrames
    mask: torch.Tensor | None      # bool[bz, by, bx] brick occupancy (use_bricks)
    vox_mask: torch.Tensor | None  # bool[Vz, Vy, Vx] (reference path with bricks)
    mask16: torch.Tensor | None    # bool[Vz/16, Vy/16, Vx/16] (fast path), culled
    occupied: torch.Tensor         # f32[] occupied brick ratio
    n_occ: torch.Tensor            # i32[] occupied 16^3 blocks (0 off the fast path)
    cls: torch.Tensor | None       # per-(sensor, block) classes of the depth-band cull


STAGE_TIMERS = ("1preprocess", "2integrate", "3recon", "holefill")
VARIANTS = tuple((a, f) for a in (2, 0, 1) for f in (False, True))   # sweep (axis, flip)


class FramePipeline:
    """Rig + static config + session bakes; ``step`` runs one frame.

    ``device``: where every per-frame tensor lives, the card unless the
    caller asks for another. On a CUDA device the four stages launch the
    hand-written kernels; with ``device="cpu"`` the kernels' plain PyTorch
    versions run (tests). ``log``: optional callable(str).
    ``table_cache_dir``: on-disk cache of the dense warp table
    (``tsdf_fast.tables_cached``; the table tier only)."""

    def __init__(self, rig: RigCalibration, cfg: PipelineConfig = PipelineConfig(),
                 log: Callable[[str], None] | None = None,
                 device: torch.device | str = "cuda",
                 table_cache_dir: str | None = None):
        self.rig = rig
        self.bbox = rig.bbox
        self.device = torch.device(device)
        self._log = log or (lambda s: None)
        self._table_cache_dir = table_cache_dir
        self._variants_logged = False
        self._variants_thread = None
        self.timers = TimerDatabase.instance()
        for t in STAGE_TIMERS:
            self.timers.timers.pop(t, None)
            self.timers.add_timer(t)
        me = weakref.ref(self)      # no cycle: a dropped pipeline frees its graphs at once
        self._graphs = FrameGraphs(
            lambda inputs, key: me()._frame(*inputs, *key, scope=SPANS.span), self.device)
        self._graph_cfg = None
        self._configure(cfg)

    def _configure(self, cfg: PipelineConfig, keep_warp_bake: bool = False) -> None:
        """(Re)build everything derived from the static config. With
        ``keep_warp_bake`` the voxel->sensor bake (affine coefficients or
        warp table) and the session bakes of the sensor size (pixel warp,
        device rig, windows) survive as long as they fit the new config:
        the integrator bake is redone when the volume res changed (a
        bricking toggle moves the res between align 16 and 1) or when the
        fast path turns on with no bake held. The depth-band cull bake,
        which reads the TSDF limit, is re-derived at the next frame. Drops
        every fused-frame graph."""
        self._graphs.drop()
        if cfg.tsdf_res is not None:
            tsdf_cfg = tsdf_ops.TsdfConfig(cfg.tsdf_res, cfg.tsdf_limit)
        else:
            # align 16 keeps voxel-size-driven configs on the brick-sparse
            # path (padded up to whole 16^3 bricks, never truncated)
            tsdf_cfg = tsdf_ops.TsdfConfig.from_voxel_size(
                self.bbox, cfg.voxel_size, cfg.tsdf_limit,
                align=BRICK if (cfg.fast_path and cfg.use_bricks) else 1)
        vx, vy, vz = tsdf_cfg.res
        self.cfg = cfg
        self.tsdf_cfg = tsdf_cfg
        self.use_fast = bool(cfg.fast_path and cfg.use_bricks
                             and not (vx % BRICK or vy % BRICK or vz % BRICK))
        self.brick_grid = brick_ops.make_brick_grid(
            self.bbox, cfg.brick_size, cfg.voxel_size)
        self.pre_cfg = pp.PreprocessConfig(
            filter_textures=cfg.filter_textures,
            use_processed_depth=cfg.use_processed_depth,
            refine_boundary=cfg.refine_boundary,
        )
        nb_total = (vx // BRICK) * (vy // BRICK) * (vz // BRICK) if self.use_fast else 0
        if cfg.max_bricks is not None:
            self.max_bricks = min(cfg.max_bricks, nb_total) if nb_total else cfg.max_bricks
        else:
            self.max_bricks = min(nb_total, max(1024, nb_total // 4)) if nb_total else 0
        self._cull_bake = None
        if not keep_warp_bake:
            self.affine = self.tables = None
            self._bake_key = None
            self._sensor_hw = None      # the session bakes redo at the next frame
        key = (tsdf_cfg.res, self._use_pallas(), cfg.use_affine, cfg.affine_tol)
        if self.use_fast and self._bake_key != key:
            self._bake_integrator()
            self._bake_key = key
        # dense emit: whole 128-voxel x-rows and the quadratic warp
        self._dense_emit = self.use_fast and self.affine is not None and vx % 128 == 0

    def _bake_integrator(self) -> None:
        """The voxel->sensor bake of the fast path's integrator tier: the
        per-brick affine warp, else the dense warp table."""
        cfg = self.cfg
        self.affine = self.tables = None
        self._win_off = None            # the windows follow the bake
        if self._use_pallas() and cfg.use_affine is not False:
            self._log(f"baking per-brick affine warp at {self.tsdf_cfg.res} ...")
            aff = tsdf_affine.bake_affine(self.rig, self.tsdf_cfg, self.device)
            err = float(aff.max_err.max())
            if cfg.use_affine or err <= cfg.affine_tol:
                self.affine = aff
                self._log(f"  affine residual {err:.2e} (tol {cfg.affine_tol})")
            else:
                self._log(f"  affine residual {err:.2e} > tol {cfg.affine_tol};"
                          " falling back to the dense warp table")
        if self.affine is None:
            self._log(f"baking voxel->sensor warp tables at {self.tsdf_cfg.res} ...")
            self.tables = tsdf_fast.tables_cached(self.rig, self.tsdf_cfg, self.device,
                                                  self._table_cache_dir, self._log)

    def _use_pallas(self) -> bool:
        """The integrator tier gate (module docstring): the kernel tiers,
        or with False the XLA table integrator."""
        if self.cfg.use_pallas is not None:
            return self.cfg.use_pallas
        return min(self.tsdf_cfg.res) // BRICK >= 8

    def retune(self, voxel_size: float | None = None,
               brick_size: float | None = None,
               tsdf_limit: float | None = None,
               min_voxels_per_brick: int | None = None) -> None:
        """Mid-run parameter change (≙ ReconIntegration::setVoxelSize /
        setBrickSize / setTsdfLimit + divideBox, recon_integration.cpp:
        340-406,462-472). Rebuilds only what the change invalidates:
        tsdf_limit / min_voxels_per_brick keep the warp bakes and re-derive
        the cull bake; brick_size rebuilds the brick grid; voxel_size
        re-derives the volume res from the bbox as ``_configure`` derives
        it (align 16 on the brick-sparse path, 1 on the reference path; any
        ``tsdf_res`` override is dropped) and re-bakes the warp."""
        cfg = self.cfg
        updates = {}
        if voxel_size is not None:
            updates["voxel_size"] = float(voxel_size)
            updates["tsdf_res"] = None
        if brick_size is not None:
            updates["brick_size"] = float(brick_size)
        if tsdf_limit is not None:
            updates["tsdf_limit"] = float(tsdf_limit)
        if min_voxels_per_brick is not None:
            updates["min_voxels_per_brick"] = int(min_voxels_per_brick)
        if not updates:
            return
        new_cfg = cfg._replace(**updates)
        res_changed = "voxel_size" in updates and (
            new_cfg.tsdf_res != cfg.tsdf_res or new_cfg.voxel_size != cfg.voxel_size)
        self._log(f"retune: {updates} (warp rebake: {res_changed})")
        self._configure(new_cfg, keep_warp_bake=not res_changed)

    def reload(self) -> None:
        """≙ the 'S' key shader reload (kinect_client.cpp:776-783): rebuild
        the config-derived state, keeping every bake."""
        self._configure(self.cfg, keep_warp_bake=True)

    # -- session bakes (at the first frame's sensor size) -----------------

    def _bake_warp(self, h: int, w: int):
        """The pixel-warp tiers (the JAX pipeline's ``_get_warp``, with its
        log lines): affine, else piecewise, else None (the gather tier)."""
        cfg = self.cfg
        if not cfg.use_warp:
            return None
        self._log(f"baking pixel warp at {h}x{w} ...")
        warp = bake_pixel_warp(self.rig, h, w, self.device)
        if max(warp.max_err_xyz, warp.max_err_uv) <= cfg.warp_tol:
            return warp
        self._log(f"  cv volumes not affine in depth (residual "
                  f"xyz={warp.max_err_xyz:.2e} uv={warp.max_err_uv:.2e} > "
                  f"{cfg.warp_tol}); trying piecewise warp")
        warp = bake_piecewise_warp(self.rig, h, w, cfg.warp_knots, self.device)
        res = (f"  piecewise warp ({cfg.warp_knots} knots) residual "
               f"xyz={warp.max_err_xyz:.2e} uv={warp.max_err_uv:.2e}")
        if max(warp.max_err_xyz, warp.max_err_uv) > cfg.pw_warp_tol:
            self._log(f"{res} > {cfg.pw_warp_tol}; using exact gather path")
            return None
        self._log(res)
        return warp

    def _session(self, h: int, w: int) -> None:
        """The session bakes of the sensor size (h, w); drops the fused-frame
        graphs when one is (re)made."""
        def bakes():
            return [getattr(self, a, None) for a in ("_warp", "_drig", "_win_off", "_cull_bake")]

        before = bakes()
        self._session_bakes(h, w)
        if any(a is not b for a, b in zip(before, bakes())):
            self._graphs.drop()

    def _session_bakes(self, h: int, w: int) -> None:
        if self._sensor_hw != (h, w):
            self._warp = self._bake_warp(h, w)
            self._sensor_hw = (h, w)
            self._drig = self._win_off = None
            self._cull_bake = None
        # the gather tier and the reference path sample the cv volumes
        # every frame
        volumes = self._warp is None or not self.use_fast
        if self._drig is None or (self._drig.cv_xyz is not None) != volumes:
            self._drig = device_rig(self.rig, self.device, volumes=volumes)
        if self.use_fast and self._win_off is None:
            if not self._use_pallas():
                self._win_off = tsdf_fast.win_offsets(self.tables, h, w,
                                                      self.cfg.sample_window)
            elif self.affine is None:
                self._win_off = win_offsets_pallas(self.tables, h, w)
            else:
                self._wy, clip_y = tsdf_affine.auto_window_rows(self.affine, h)
                if self._dense_emit:
                    self._wx, self._xstride, clip_x = tsdf_affine.auto_window_cols(
                        self.affine, w)
                else:
                    self._wx, self._xstride, clip_x = WX2, XSTRIDE2, 0.0
                self._log(f"integration window: {self._wy} rows ({clip_y:.2%} clip), "
                          f"{self._wx} cols at stride {self._xstride} ({clip_x:.2%} clip)")
                self._win_off = tsdf_affine.win_offsets_affine(
                    self.affine, h, w, self._wy, self._wx, self._xstride)
        if (self._cull_bake is None and self.use_fast and self.affine is not None
                and self.cfg.brick_cull):
            self._cull_bake = tsdf_affine.bake_cull(self.affine, h, w,
                                                    float(self.tsdf_cfg.limit))

    def _sweep_res(self) -> tuple[int, int]:
        if self.cfg.sweep_res is not None:
            return self.cfg.sweep_res

        def rnd(n):
            return max(128, min(512, -(-n // 128) * 128))

        return (rnd(self.cfg.render_height), rnd(self.cfg.render_width))

    # -- stages ------------------------------------------------------------

    def _pre(self, depth_m, color) -> PreOut:
        """1preprocess: filtering, brick occupancy; on the fast path the
        16^3 block mask and the depth-band cull, on the reference path the
        voxel mask."""
        cfg = self.cfg
        frames = pp.preprocess(depth_m, color, self._drig, self.pre_cfg, self._warp)
        mask = vox_mask = mask16 = cls = None
        occupied = torch.ones((), dtype=torch.float32, device=self.device)
        n_occ = torch.zeros((), dtype=torch.int32, device=self.device)
        if cfg.use_bricks:
            counts = brick_ops.mark_bricks(frames.world, frames.world_valid,
                                           self.brick_grid)
            mask = brick_ops.occupancy_mask(counts, cfg.min_voxels_per_brick)
            occupied = brick_ops.occupied_ratio(mask)
            if not self.use_fast:
                vox_mask = brick_ops.voxel_occupancy(mask, self.brick_grid, self.tsdf_cfg.res)
            else:
                mask16 = brick_ops.block_occupancy(mask, self.brick_grid,
                                                   self.tsdf_cfg.res, BRICK)
                if self._cull_bake is not None:
                    mask16, _, cls = tsdf_affine.block_depth_cull_baked(
                        mask16, self._cull_bake, frames.depth[..., 0], frames.quality,
                        frames.silhouette, float(self.tsdf_cfg.limit))
                n_occ = mask16.sum().to(torch.int32)
        return PreOut(frames, mask, vox_mask, mask16, occupied, n_occ, cls)

    def _integrate(self, pre: PreOut):
        """2integrate: fused TSDF + color volumes, by the integrator tier;
        on the reference path every voxel, f32 channels-last."""
        frames, mask16 = pre.frames, pre.mask16
        if not self.use_fast:
            return (tsdf_ops.integrate(frames, self._drig, self.tsdf_cfg, pre.vox_mask),
                    tsdf_ops.integrate_colors(frames, self._drig, self.tsdf_cfg, pre.vox_mask))
        if not self._use_pallas():
            return tsdf_fast.integrate_sparse(frames, self.tables, self.tsdf_cfg, mask16,
                                              self.max_bricks, self.cfg.sample_window,
                                              self._win_off)
        if self.affine is None:
            return integrate_sparse(frames, self.tables, self.tsdf_cfg, mask16,
                                    self.max_bricks, self._win_off)
        if not self._dense_emit:
            return integrate_affine(frames, self.affine, self.tsdf_cfg, mask16,
                                    self.max_bricks, self._win_off, self._wy)
        return integrate_dense(
            frames, self.affine, self.tsdf_cfg, mask16, self.max_bricks,
            self._win_off, self._wy, self._wx, self._xstride, pre.cls)

    def _render(self, pre: PreOut, vol, cvol, mv, proj, axis, flip):
        """3recon: the sweep-composited raymarch, or on the reference path
        the per-ray marcher."""
        cfg = self.cfg
        cam = rm.RenderCamera(mv, proj, cfg.render_width, cfg.render_height)
        params = rm.RenderParams(shade_mode=cfg.shade_mode)
        limit = float(self.tsdf_cfg.limit)
        if not self.use_fast:
            grid = self.brick_grid
            extent = (np.asarray(grid.res, np.float32) * grid.brick_size
                      / self.bbox.size.astype(np.float32))
            return rm.render(
                vol, cvol, pre.frames, self._drig, cam, self.bbox, limit, params,
                brick_mask=pre.mask if (cfg.skip_space and cfg.use_bricks) else None,
                brick_size_vol=grid.brick_size / float(np.max(self.bbox.size)),
                brick_extent=extent)
        occ = None
        if cfg.skip_space:      # fused: the flags stay on the device
            occ = (rmf.slab_occupancy_device if cfg.fused else rmf.slab_occupancy)(
                pre.mask16, axis, self.tsdf_cfg.res[axis])
            SPANS.count("render.slices_occupied", occ)
            SPANS.count("render.slices_swept", len(occ))
        # render_fast's two halves, each a span of the fused frame
        span = SPANS.span if cfg.fused else (lambda name: contextlib.nullcontext())
        scfg = rmf.SweepConfig(res=self._sweep_res())
        with span("3recon.sweep"):
            res = rmf.sweep(vol, cvol, cam, self.bbox, limit, axis, flip, scfg, occ,
                            self._dense_emit)
        with span("3recon.shade"):
            return rmf.shade_sweep(res, cam, self.bbox, axis, flip, vol.shape[2 - axis],
                                   params, scfg)

    def _fill(self, color, depth):
        """holefill: inpaint pyramid + colorfill resolve."""
        pyr_c, pyr_d = inpaint.build_pyramid(color, depth, self.cfg.num_lods)
        return inpaint.colorfill(pyr_c, pyr_d)

    # -- public API --------------------------------------------------------

    def _t(self, a, dtype=None) -> torch.Tensor:
        a = torch.as_tensor(a) if not isinstance(a, torch.Tensor) else a
        return a.to(self.device, dtype) if dtype else a.to(self.device)

    def _sensor_inputs(self, depth_m, color):
        """The frame's depth f32 and color (u8 or f32) on the device, after
        the session bakes for its sensor size."""
        depth = self._t(depth_m, torch.float32).contiguous()
        self._session(depth.shape[1], depth.shape[2])
        col = self._t(color)
        if col.dtype != torch.uint8:
            col = col.to(torch.float32)
        return depth, col.contiguous()

    def _axis(self, modelview) -> tuple[np.ndarray, tuple[int, bool]]:
        """The modelview on the host and the frame's sweep (axis, flip);
        (2, False) on the reference path, which has no sweep."""
        mv_np = np.asarray(modelview.cpu() if isinstance(modelview, torch.Tensor)
                           else modelview, np.float32)
        if not self.use_fast:
            return mv_np, (2, False)
        return mv_np, rmf.pick_axis(mv_np, rm.vol_to_world_matrix(self.bbox))

    def _inputs(self, depth_m, color, modelview, proj):
        mv_np, (axis, flip) = self._axis(modelview)
        depth, col = self._sensor_inputs(depth_m, color)
        return (depth, col, self._t(mv_np), self._t(proj, torch.float32), axis, flip)

    def preprocess(self, depth_m, color) -> pp.ProcessedFrames:
        """The session bakes and 1preprocess's sensor filtering alone (no
        brick marking, integration or render): the frames the
        reconstruction strategies of ``models/`` draw from, and the app's
        texture dumps. depth_m f32[K,H,W] meters; color f32[K,Hc,Wc,3] (or
        u8)."""
        depth, col = self._sensor_inputs(depth_m, color)
        return pp.preprocess(depth, col, self._drig, self.pre_cfg, self._warp)

    def step(self, depth_m, color, modelview, proj) -> FrameOutput:
        """One frame. depth_m f32[K,H,W] meters; color f32[K,Hc,Wc,3] (or
        u8); modelview/proj f32[4,4] row-major GL matrices (numpy or
        tensors; the sweep axis is chosen on the host). In fused mode one
        graph replay on a CUDA device (module docstring)."""
        return self._step(depth_m, color, modelview, proj, timed=False)

    def step_timed(self, depth_m, color, modelview, proj) -> FrameOutput:
        """``step`` with per-stage times recorded into ``self.timers`` (the
        process-wide ``TimerDatabase``) under the reference's stage names
        (CUDA events on a CUDA device; read with
        ``self.timers.duration(name)``). Staged, the four stages are timed,
        on the reference path too, where the JAX pipeline runs one program
        and records it under ``3recon`` alone: the timer CSVs of the two
        packages differ there. Fused, as in the JAX pipeline, the whole
        frame (the graph replay and the copies of its outputs) is timed
        under ``3recon`` and the other three timers stay empty."""
        return self._step(depth_m, color, modelview, proj, timed=True)

    def _fused_key(self, depth_m, modelview) -> tuple[int, bool]:
        """Fused mode's set-up of one frame: the session bakes, the graphs
        dropped if ``cfg`` was reassigned since they were captured; returns
        the frame's graph key, its sweep (axis, flip)."""
        if self._graph_cfg != self.cfg:
            self._graphs.drop()
            self._graph_cfg = self.cfg
        self._session(depth_m.shape[1], depth_m.shape[2])
        return self._axis(modelview)[1]

    def _fused_ready(self, depth_m, color, modelview, proj) -> tuple[int, bool]:
        """Fused mode on the card: the frame copied into the graphs' inputs
        and its graph captured at first use, with a log line and the
        seconds of the eager warm-up (it builds the kernels with nvcc on
        first use) and of the capture; returns the graph key."""
        with SPANS.span("frame.key"):
            key = self._fused_key(depth_m, modelview)
        with SPANS.span("frame.load"):
            self._graphs.load(depth_m, color, modelview, proj)
        if key not in self._graphs:
            what = f"axis={key[0]} flip={key[1]}" if self.use_fast else "per-ray marcher"
            self._log(f"capturing fused frame step ({what}) ...")
            secs = self._graphs.capture(key)
            if secs is not None:
                self._log(f"  fused step ({what}): warm-up {secs[0]:.1f}s, "
                          f"capture {secs[1]:.1f}s")
        return key

    def warmup(self, depth_m, color, modelview, proj) -> None:
        """Run the session bakes, then each stage once on these inputs,
        synchronised, with a log line each (the JAX pipeline's per-stage
        compile warm-up). On the card the first kernel launch builds the
        CUDA library with nvcc (``native.build``), inside 1preprocess. In
        fused mode on the card: capture the frame's graph, logged with the
        seconds of its eager warm-up and of the capture (JAX: "compiling
        fused frame step")."""
        def run(name, fn):
            t0 = time.perf_counter()
            self._log(f"warming {name} ...")
            out = fn()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._log(f"  {name}: {time.perf_counter() - t0:.1f}s")
            return out

        if self.cfg.fused and self.device.type == "cuda":
            self._fused_ready(depth_m, color, modelview, proj)
            return
        depth, col, mv, pr, axis, flip = run(
            "session bakes", lambda: self._inputs(depth_m, color, modelview, proj))
        if self.cfg.fused:      # the CPU: the fused frame runs eagerly
            run("fused frame step (eager on the CPU)",
                lambda: self._frame(depth, col, mv, pr, axis, flip))
            return
        pre = run("1preprocess", lambda: self._pre(depth, col))
        vol, cvol = run("2integrate", lambda: self._integrate(pre))
        what = f"axis={axis} flip={flip}" if self.use_fast else "per-ray marcher"
        out = run(f"3recon ({what})",
                  lambda: self._render(pre, vol, cvol, mv, pr, axis, flip))
        if self.cfg.fill_holes:
            run("holefill", lambda: self._fill(out.color, out.depth))

    def warm_variants_async(self, depth_m, color, modelview, proj) -> None:
        """Fused mode on the card: capture the graphs of the other five
        sweep variants on a daemon thread (``self._variants_thread``), one
        log line each, on the thread's own stream; a frame meanwhile
        replays a finished graph or captures its own. The JAX pipeline
        compiles them in the background the same way. A capture error is
        logged and ends the thread: the variant is captured at its first
        frame. Once per pipeline, as in JAX. Staged, on the CPU or on the
        reference path (one graph) there is nothing to capture: logged
        once."""
        if not (self.cfg.fused and self.device.type == "cuda" and self.use_fast):
            if not self._variants_logged:
                self._variants_logged = True
                self._log("render variants: nothing to warm (eager PyTorch has no "
                          "per-axis programs)" if not self.cfg.fused else
                          "render variants: nothing to capture (the CPU runs the fused "
                          "frame eagerly; the reference path has one graph)")
            return
        if self._variants_thread is not None:
            return
        cur = self._fused_key(depth_m, modelview)
        self._graphs.load(depth_m, color, modelview, proj)
        variants = [v for v in VARIANTS if v != cur]

        def work():
            try:
                for axis, flip in variants:
                    if self._graphs.capture((axis, flip)) is not None:
                        self._log(f"captured fused variant (axis={axis} flip={flip})")
            except Exception as e:  # a retune mid-capture may orphan a bake
                self._log(f"variant capture aborted: {type(e).__name__}: {e}")

        t = threading.Thread(target=work, name="variant-capture", daemon=True)
        self._variants_thread = t
        t.start()

    def _frame(self, depth, col, mv, pr, axis, flip, scope=None) -> FrameOutput:
        """The whole frame as one function of device tensors: 1preprocess,
        2integrate, 3recon and holefill, each in ``scope(stage name)``
        (staged mode's timers). Fused mode's graph body."""
        scope = scope or (lambda name: contextlib.nullcontext())
        with scope("1preprocess"):
            pre = self._pre(depth, col)
        with scope("2integrate"):
            vol, cvol = self._integrate(pre)
        with scope("3recon"):
            out = self._render(pre, vol, cvol, mv, pr, axis, flip)
        color_out = out.color
        if self.cfg.fill_holes:
            with scope("holefill"):
                color_out = self._fill(out.color, out.depth)
        return FrameOutput(
            color=color_out, depth=out.depth, hit=out.hit, tsdf=vol,
            occupied_ratio=pre.occupied, num_samples=out.num_samples,
            occupied_bricks=pre.n_occ,
        )

    def _step(self, depth_m, color, modelview, proj, timed: bool) -> FrameOutput:
        def scope(name):
            return (self.timers.scope(name, self.device) if timed
                    else contextlib.nullcontext())

        with SPANS.frame():
            if self.cfg.fused and self.device.type == "cuda":
                key = self._fused_ready(depth_m, color, modelview, proj)
                with scope("3recon"):
                    out = self._graphs.replay(key)
            else:
                depth, col, mv, pr, axis, flip = self._inputs(depth_m, color, modelview, proj)
                if self.cfg.fused:      # the CPU: the fused frame eagerly, timed as one
                    with scope("3recon"):
                        out = self._frame(depth, col, mv, pr, axis, flip, SPANS.span)
                else:
                    out = self._frame(depth, col, mv, pr, axis, flip, scope)
        if timed:
            self.timers.flush()
        return out

    def check_capacity(self, out: FrameOutput) -> int:
        """Raise if the frame's occupied-brick count exceeded the capacity
        (geometry would have been dropped). Returns the count (one host
        sync, like the reference's per-frame count readback,
        recon_integration.cpp:430-445)."""
        n = int(out.occupied_bricks)
        if self.use_fast and n > self.max_bricks:
            raise RuntimeError(
                f"occupied bricks {n} exceed max_bricks={self.max_bricks}: "
                f"geometry dropped — raise PipelineConfig.max_bricks "
                f"(or leave it None to auto-size)")
        return n

    def default_camera(self, eye=None) -> tuple[np.ndarray, np.ndarray]:
        """View/projection aimed at the volume center."""
        center = (self.bbox.min + self.bbox.max) * 0.5
        if eye is None:
            eye = center + np.array([1.5, 0.8, 2.2], np.float32)
        mv = look_at(eye, center, [0, 1, 0])
        proj = perspective(
            50.0, self.cfg.render_width / self.cfg.render_height, 0.1, 200.0)
        return mv, proj

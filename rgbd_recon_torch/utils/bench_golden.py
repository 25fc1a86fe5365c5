"""The bench-size JAX reference of the port's frame: the file format of
``tests/data/torch_bench_golden.npz``, the digests of its inputs, the
port's stage outputs on the same inputs and the comparisons with their
bounds.

The file holds what the JAX package computes on the CPU (the writer is
``tests/test_torch_bench_golden.py``; rewrite it with
``JAX_PLATFORMS=cpu python tests/test_torch_bench_golden.py --write``) on
frame 0 of the bench inputs (``calibration.synthetic.bench_inputs``: 4
Kinect-v2 sensors at 512x424, fwd_res (128, 256, 128), inv_res 128^3, seed
7), with the sha256 of every rig array and of the frame. Three references:

  A  JAX's TPU formulation at 256^3, its stage chain with the Pallas
     kernels in interpret mode (brick marking, the dense-emit quadratic
     integrator, the screen warp): the preprocessed fields the integrator
     reads at a seeded draw of pixels, the brick counts and the culled
     16^3 mask, the TSDF whole and the color volume at a seeded draw of
     non-clear voxels, and for each of ``VIEWS`` the sweep planes on the
     512x512 grid and the screen planes before and after hole filling;
  B  ``FramePipeline.step`` of the JAX package on the CPU at 256^3 (the
     XLA table integrator, the blocked screen warp): TSDF and screen;
  C  the chain of A at 240^3 through the block-major quadratic
     integrator (kernel 6's formulation): TSDF and screen.

Screen colors are stored as u8 (quantization adds at most 2e-3). The
ladder file (``LADDER_PATH``; ``--write-ladder``) holds reference A of each
configuration of ``LADDER`` (bench.py's other knobs: the complex scene, 5
and 2 sensors, the 128^3 rung) at the default view, and the 512^3 rung's
16^3 masks, each under its name with its inputs' digests; ``config`` reads
one. This module reads the files with numpy alone: ``chip_smoke.py`` holds
the card's frames to them, the tests hold the CPU frames.
"""
from __future__ import annotations

import hashlib
import os
from typing import NamedTuple

import numpy as np
import torch

from ..calibration.rig import RigCalibration
from ..calibration.synthetic import bench_inputs
from ..ops import bricks as brick_ops
from ..ops import raymarch as rm
from ..ops import raymarch_fast as rmf
from .math import look_at, perspective
from .metrics import render_parity, render_parity_passes

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__)))), "tests", "data")
PATH = os.path.join(DATA, "torch_bench_golden.npz")
LADDER_PATH = os.path.join(DATA, "torch_bench_golden_ladder.npz")
SEED = 7                       # chip_smoke.SEED: the frames' noise
SIZE = (512, 424, (128, 256, 128), (128, 128, 128))   # sensor w, h, fwd_res, inv_res


class Config(NamedTuple):
    """One configuration of bench.py's knobs on the bench rig (SIZE)."""

    sensors: int      # BENCH_SENSORS
    scene: str        # BENCH_SCENE
    n: int            # BENCH_TSDF: the volume res, a cube
    stages: bool      # reference A stage by stage; False: the 16^3 masks alone


BENCH = Config(4, "sphere", 256, True)      # the configuration of PATH
# the configurations of LADDER_PATH: the complex scene, 5 and 2 sensors,
# the ladder's 128^3 and 512^3 rungs (512^3: the masks alone; its stage 1
# and brick counts are L1's, which do not depend on the volume res)
LADDER = {
    "C": Config(4, "complex", 256, True),
    "S5": Config(5, "sphere", 256, True),
    "S2": Config(2, "sphere", 256, True),
    "L1": Config(4, "sphere", 128, True),
    "L2": Config(4, "sphere", 512, False),
}
RENDER = (1280, 720)
LIMIT = 0.01                   # the TSDF limit (PipelineConfig.tsdf_limit)
DRAW_SEED = 11                 # the pixel and voxel draws
PIX_DRAW = 65536
VOX_DRAW = 262144
LADDER_VOX_DRAW = 65536        # the ladder's color draw, a configuration
# eye offsets from the bbox center: the pipeline's default camera and the
# four views of scripts/golden_parity.py (sweep axes 2, 2, 2, 0, 1)
VIEWS = {
    "default": (1.5, 0.8, 2.2),
    "front_z": (0.15, 0.25, 2.6),
    "oblique": (1.4, 0.9, 2.0),
    "side_x": (2.5, 0.4, 0.3),
    "top_y": (0.3, 2.6, 0.4),
}
PRE_FIELDS = ("depth", "quality", "silhouette")
# the sweep planes of the port's frame against reference A, from the
# port's own bakes (the TSDF differs on ~50 voxels: quadratic-fit gate
# flips). Measured on the five views (the CPU's plain path and an H100's
# kernels alike): hit differs on <= 2 rays, hit_s off >5e-5 on <= 0.57% of
# the rays both hit, color and gradient off >1e-2 on <= 8.6e-4 of the
# values; the bounds: twice the rays, 1%, and the color share the
# integrator's bound allows (tests/test_tsdf_affine.py:115-116)
SWEEP_BOUNDS = {"hit": 4, "s": 1e-2, "cg": 1e-3}
# brick counts between two float formulations of stage 1: a world point
# within an ulp of a brick face or of the tie between two neighbour votes
# (``bricks.mark_bricks``) is counted in another bin. The JAX package's own
# two formulations (its TPU kernels in interpret mode and its XLA CPU path)
# differ on 2 (complex scene) and 4 (5 sensors) bins, by one point each; the
# bound is twice the larger. The 16^3 masks the integrator reads stay exact.
COUNT_VOTES = 8


def bench_frame(cfg: Config = BENCH):
    """(rig, bbox, depth, color): frame 0 of a configuration's bench inputs."""
    rig, bbox, frames = bench_inputs(cfg.sensors, *SIZE, SEED, frames=1, scene=cfg.scene)
    return rig, bbox, *frames[0]


def bench_config(bbox, n, **over):
    """The bench pipeline config at volume res ``n`` (an int for a cube):
    1280x720, 6 LODs, brick_size 0.1, the voxel size of the bbox's long
    side."""
    from ..runtime.pipeline import PipelineConfig

    res = n if isinstance(n, tuple) else (n, n, n)
    return PipelineConfig(render_width=RENDER[0], render_height=RENDER[1], tsdf_res=res,
                          voxel_size=float(np.max(bbox.size) / res[0]), brick_size=0.1,
                          num_lods=6, **over)


def camera(view: str, bbox) -> tuple[np.ndarray, np.ndarray]:
    """(modelview, projection) of one of ``VIEWS``: 50 degrees, 0.1-200."""
    center = (bbox.min + bbox.max) * 0.5
    mv = look_at(center + np.asarray(VIEWS[view], np.float32), center, [0, 1, 0])
    return mv, perspective(50.0, RENDER[0] / RENDER[1], 0.1, 200.0)


def _digest(a) -> str:
    a = np.ascontiguousarray(a)
    return hashlib.sha256(f"{a.dtype.str}{a.shape}".encode() + a.tobytes()).hexdigest()


def digests(rig: RigCalibration, depth, color) -> dict[str, str]:
    """sha256 of every rig array (dtype and shape included) and of the frame."""
    out = {f: _digest(np.asarray(getattr(rig, f))) for f in RigCalibration._fields}
    out.update(depth=_digest(depth), color=_digest(color))
    return out


# -- storage -----------------------------------------------------------------

def pack_mask(m) -> np.ndarray:
    return np.packbits(np.asarray(m, bool).ravel())


def unpack_mask(b: np.ndarray, shape) -> np.ndarray:
    return np.unpackbits(b, count=int(np.prod(shape))).astype(bool).reshape(shape)


def bf16_bits(x) -> np.ndarray:
    """The bf16 bit patterns of float32 values that are bf16 numbers."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    if np.any(u & 0xFFFF):
        raise ValueError("bf16_bits: values are not bf16 numbers")
    return (u >> 16).astype(np.uint16)


def from_bf16_bits(u: np.ndarray) -> np.ndarray:
    return (u.astype(np.uint32) << 16).view(np.float32)


def to_u8(c) -> np.ndarray:
    return np.round(np.clip(np.asarray(c, np.float32), 0.0, 1.0) * 255.0).astype(np.uint8)


def draws(shape_pix, tsdf: np.ndarray, n_vox: int = VOX_DRAW) -> tuple[np.ndarray, np.ndarray]:
    """The seeded draws: PIX_DRAW sensor pixels of ``shape_pix`` (K, H, W)
    and ``n_vox`` of the non-clear voxels of ``tsdf``, as masks."""
    rng = np.random.default_rng(DRAW_SEED)
    n_pix = int(np.prod(shape_pix))
    pix = np.zeros(n_pix, bool)
    pix[rng.choice(n_pix, PIX_DRAW, replace=False)] = True
    nonclear = nonclear_voxels(tsdf)
    vox = np.zeros(nonclear.size, bool)
    vox[rng.choice(nonclear.size, min(n_vox, nonclear.size), replace=False)] = True
    return pix.reshape(shape_pix), vox


def screen_record(prefix: str, color, depth, hit, filled) -> dict:
    """The screen planes: hit as bits, depth (f32) and color (u8) on the
    hit pixels (misses are the cleared background; ``color`` None leaves
    it out), the hole-filled color (u8) whole."""
    hit = np.asarray(hit, bool)
    rec = {f"{prefix}hit": pack_mask(hit), f"{prefix}depth": np.asarray(depth, np.float32)[hit],
           f"{prefix}filled": to_u8(filled)}
    if color is not None:
        rec[f"{prefix}color"] = to_u8(np.asarray(color)[hit])
    return rec


def sweep_record(prefix: str, hit, hit_s, hit_color, hit_grad) -> dict:
    """The sweep planes: hit as bits, hit_s (f32) and the bf16 color and
    gradient carries (their bits) on the hit rays."""
    h = np.asarray(hit) > 0.5
    return {f"{prefix}sweep_hit": pack_mask(h),
            f"{prefix}sweep_s": np.asarray(hit_s, np.float32)[h],
            f"{prefix}sweep_color": bf16_bits(np.asarray(hit_color)[h]),
            f"{prefix}sweep_grad": bf16_bits(np.asarray(hit_grad)[h])}


class Screen(NamedTuple):
    color: np.ndarray | None  # f32[H, W, 4], u8 steps, on the hit pixels
    depth: np.ndarray      # f32[H, W], 1 on misses
    hit: np.ndarray        # bool[H, W]
    filled: np.ndarray | None  # f32[H, W, 4] after hole filling


def load(path: str = PATH) -> dict:
    """The file as a dict of arrays. Raises if it is missing."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"the bench golden {path} is missing")
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def config(gold: dict, name: str) -> dict:
    """One configuration's records of the ladder file, under the first
    file's keys (``A/...``, ``digest/...``): its ``name/`` prefix dropped
    and its bf16 TSDF (``A/tsdf_bf16``) as ``A/tsdf``, f32[n, n, n]."""
    pre = f"{name}/"
    out = {k[len(pre):]: v for k, v in gold.items() if k.startswith(pre)}
    if "A/tsdf_bf16" in out:
        n = LADDER[name].n
        out["A/tsdf"] = from_bf16_bits(out.pop("A/tsdf_bf16")).reshape(n, n, n)
    return out


def check_digests(gold: dict, rig, depth, color) -> None:
    """Raise unless the inputs hash to the stored digests."""
    bad = [k for k, v in digests(rig, depth, color).items() if str(gold[f"digest/{k}"]) != v]
    if bad:
        raise ValueError(f"the bench inputs differ from the golden's in {bad}")


def nonclear_voxels(tsdf: np.ndarray) -> np.ndarray:
    """Flat indices of the voxels above the clear value."""
    return np.flatnonzero(tsdf.ravel() > -LIMIT + 1e-9)


def screen(gold: dict, prefix: str) -> Screen:
    """Screen planes from their record (misses: color 0, depth 1)."""
    w, h = RENDER
    hit = unpack_mask(gold[f"{prefix}hit"], (h, w))
    color = None
    if f"{prefix}color" in gold:
        color = np.zeros((h, w, 4), np.float32)
        color[hit] = gold[f"{prefix}color"] / np.float32(255.0)
    depth = np.ones((h, w), np.float32)
    depth[hit] = gold[f"{prefix}depth"]
    return Screen(color, depth, hit, gold[f"{prefix}filled"] / np.float32(255.0))


# -- the port's frame, stage by stage --------------------------------------

def _np(t) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


def port_stages(pipe, depth, color, gold: dict, views=tuple(VIEWS),
                on_ref_tsdf: bool = False) -> dict:
    """The port's frame on (depth, color) through ``pipe``'s stages, as
    reference A stores it: the preprocessed fields at the golden's pixel
    draw, the brick counts (one more brick-marking call on the same
    points), the 16^3 masks, the TSDF, the color volume at the golden's
    voxel draw, and for each view the sweep result, the screen planes and
    the hole-filled color. The stages are ``FramePipeline``'s own
    (``_pre``, ``_integrate``, ``_fill``) around ``render_fast``'s two
    halves. With ``on_ref_tsdf`` also ``views_ref``: the same views swept
    on reference A's TSDF (bf16, as its integrator stored it) with the
    port's color volume, the render stage held apart from the TSDF's
    deviation."""
    pre, out = port_masks(pipe, depth, color)
    fr = pre.frames
    pix = torch.from_numpy(unpack_mask(gold["A/pix"], fr.quality.shape)).to(pipe.device)
    out.update({"depth": _np(fr.depth[pix]), "quality": _np(fr.quality[pix]),
                "silhouette": _np(fr.silhouette[pix]),
                "world_valid": fr.world_valid[pix].cpu().numpy()})
    vol, cvol = pipe._integrate(pre)
    out["tsdf"] = _np(vol)
    out["cvol"] = _color_at(cvol, gold, pipe.integrator.zmajor)
    out["views"] = _render_views(pipe, pre, vol, cvol, views)
    if on_ref_tsdf:
        ref = torch.from_numpy(gold["A/tsdf"]).to(pipe.device, torch.bfloat16)
        out["views_ref"] = _render_views(pipe, pre, ref, cvol, views)
    return out


def port_masks(pipe, depth, color) -> tuple:
    """``pipe``'s 1preprocess on (depth, color) and what it decides about
    the bricks: (its PreOut, {"counts": the brick counts of one more
    brick-marking call on the same points, "mask16_pre": the 16^3
    occupancy before the depth-band cull, "mask16": after it})."""
    d, c = pipe._sensor_inputs(depth, color)
    pre = pipe._pre(d, c)
    fr = pre.frames
    counts = brick_ops.mark_bricks(fr.world, fr.world_valid, pipe.brick_grid)
    m0 = brick_ops.block_occupancy(
        brick_ops.occupancy_mask(counts, pipe.cfg.min_voxels_per_brick), pipe.brick_grid,
        pipe.tsdf_cfg.res, 16)
    return pre, {"counts": counts.to(torch.int64).cpu().numpy(),
                 "mask16_pre": m0.cpu().numpy(), "mask16": pre.mask16.cpu().numpy()}


def _color_at(cvol, gold: dict, zmajor: bool) -> np.ndarray:
    """The color volume (z-major or channels-last) at the golden's voxel
    draw: [n, 4]."""
    tsdf = gold["A/tsdf"]
    nonclear = nonclear_voxels(tsdf)
    sel = nonclear[unpack_mask(gold["A/vox"], nonclear.shape)]
    vy, vx = tsdf.shape[1:]
    idx = torch.from_numpy(sel).to(cvol.device)
    z, y, x = idx // (vy * vx), (idx // vx) % vy, idx % vx
    return _np(cvol[z, :, y, x] if zmajor else cvol[z, y, x])


def _render_views(pipe, pre, vol, cvol, views) -> dict:
    """Each view: render_fast's sweep and shade halves as
    ``FramePipeline._render`` calls them, then ``_fill``."""
    cfg = pipe.cfg
    params = rm.RenderParams(shade_mode=cfg.shade_mode)
    sweep_cfg = rmf.SweepConfig(res=pipe._sweep_res())
    limit = float(pipe.tsdf_cfg.limit)
    out = {}
    for view in views:
        mv, proj = camera(view, pipe.bbox)
        axis, flip = rmf.pick_axis(mv, rm.vol_to_world_matrix(pipe.bbox))
        cam = rm.RenderCamera(pipe._t(mv), pipe._t(proj), cfg.render_width, cfg.render_height)
        occ = rmf.slab_occupancy(pre.mask16, axis, pipe.tsdf_cfg.res[axis])
        res = rmf.sweep(vol, cvol, cam, pipe.bbox, limit, axis, flip, sweep_cfg, occ,
                        zmajor=pipe.integrator.zmajor)
        shaded = rmf.shade_sweep(res, cam, pipe.bbox, axis, flip, vol.shape[2 - axis], params,
                                 sweep_cfg)
        filled = pipe._fill(shaded.color, shaded.depth)
        out[view] = dict(
            axis=axis, flip=flip, sweep_hit=res.hit.cpu().numpy() > 0.5,
            sweep_s=_np(res.hit_s), sweep_color=_np(res.hit_color), sweep_grad=_np(res.hit_grad),
            screen=Screen(_np(shaded.color), _np(shaded.depth), shaded.hit.cpu().numpy(),
                          _np(filled)))
    return out


# -- comparisons ---------------------------------------------------------------

class Row(NamedTuple):
    """One comparison: what, the measured deviation, its bound, the verdict."""

    stage: str
    measured: str
    bound: str
    ok: bool

    def line(self, label: str) -> str:
        return (f"{label}: {self.stage}: {self.measured} (bound: {self.bound}) -> "
                f"{'ok' if self.ok else 'FAIL'}")


def _plane(bits: np.ndarray, vals: np.ndarray, shape) -> tuple[np.ndarray, np.ndarray]:
    """(mask, values scattered onto the plane) from a hit record."""
    m = unpack_mask(bits, shape)
    full = np.zeros(shape + vals.shape[1:], vals.dtype)
    full[m] = vals
    return m, full


def compare_pre(gold: dict, got: dict) -> list[Row]:
    """Stage 1 at the pixel draw: the fields the integrator reads within
    atol 2e-4 / rtol 2e-5 everywhere (tests/test_preprocess_pallas.py:41),
    ``world_valid`` equal."""
    rows = []
    for f in PRE_FIELDS:
        ref, mine = gold[f"A/{f}"], got[f]
        d = np.abs(mine.astype(np.float64) - ref)
        n_off = int((d > 2e-4 + 2e-5 * np.abs(ref)).sum())
        rows.append(Row(f"stage 1 {f} ({ref.size} values)",
                        f"{n_off} outside atol 2e-4 rtol 2e-5, max {d.max():.2e}",
                        "every value within", n_off == 0))
    wv = unpack_mask(gold["A/world_valid"], (PIX_DRAW,))
    n_off = int((wv != got["world_valid"]).sum())
    rows.append(Row("stage 1 world_valid", f"{n_off} of {PIX_DRAW} pixels differ", "equal",
                    n_off == 0))
    return rows


def compare_bricks(gold: dict, got: dict, votes: int = 0) -> list[Row]:
    """Brick counts (where stored), the 16^3 mask before the cull (where
    stored) and the culled mask, exact. ``votes``: the counts may differ on
    that many bins by one point each (``COUNT_VOTES``)."""
    rows = []
    if "A/counts" in gold:
        ref_c = gold["A/counts"].astype(np.int64)
        d = got["counts"] - ref_c
        n_c = int((d != 0).sum())
        got_txt = (f"{n_c} of {ref_c.size} bins differ (by {int(np.abs(d).max())} at most), "
                   f"total {int(got['counts'].sum())} vs {int(ref_c.sum())}")
        if votes:
            rows.append(Row("brick counts", got_txt, f"<= {votes} bins differ, by 1 each",
                            n_c <= votes and int(np.abs(d).max()) <= 1))
        else:
            rows.append(Row("brick counts", got_txt, "exact", n_c == 0))
    for key, what in (("mask16_pre", "16^3 mask before the cull"), ("mask16", "culled 16^3 mask")):
        if f"A/{key}" not in gold:
            continue
        ref_m = unpack_mask(gold[f"A/{key}"], got[key].shape)
        n_m = int((ref_m != got[key]).sum())
        rows.append(Row(what, f"{n_m} bricks differ; {int(got[key].sum())} vs "
                        f"{int(ref_m.sum())} occupied", "exact", n_m == 0))
    return rows


def compare_tsdf(ref: np.ndarray, mine: np.ndarray, exact_to: float | None = None) -> Row:
    """The TSDF at the bound between integrator formulations
    (tests/test_tsdf_affine.py:109-116, tests/test_tsdf_pallas.py:40-47:
    < 1e-4 of voxels off by more than 1e-4, the occupied count within
    max(100, 0.2%)); with ``exact_to`` (one formulation on both sides)
    every voxel within it and the occupied count equal."""
    d = np.abs(mine.astype(np.float64) - ref)
    frac = float((d > 1e-4).mean())
    occ, rocc = nonclear_voxels(mine).size, nonclear_voxels(ref).size
    got = (f"max {d.max():.2e}, {int((d > 1e-4).sum())} voxels ({frac:.2e}) off >1e-4, "
           f"occupied {occ} vs {rocc}")
    if exact_to is not None:
        return Row("TSDF", got, f"every voxel within {exact_to:g}, occupied equal",
                   float(d.max()) <= exact_to and occ == rocc)
    return Row("TSDF", got, "<1e-4 of voxels off >1e-4, occupied within "
               "max(100, 0.2%)", frac < 1e-4 and abs(occ - rocc) <= max(100, 0.002 * rocc))


def compare_color(gold: dict, got: dict) -> Row:
    """The color volume at the voxel draw: < 1e-3 of the voxels off by
    more than 1e-2 in a channel (tests/test_tsdf_affine.py:115-116)."""
    d = np.abs(got["cvol"].astype(np.float64) - from_bf16_bits(gold["A/cvol"])).max(axis=1)
    frac = float((d > 1e-2).mean())
    return Row(f"color volume ({d.size} drawn voxels)",
               f"max {d.max():.2e}, {frac:.2e} off >1e-2", "<1e-3 off >1e-2", frac < 1e-3)


def compare_sweep(gold: dict, view: str, got: dict) -> Row:
    """The sweep planes of one view against ``SWEEP_BOUNDS``: the hit rays
    equal but for a few; on the rays both hit, hit_s within 5e-5 but on a
    share of them, color and gradient within 1e-2 but for a share of the
    values."""
    p = f"A/{view}/"
    shape = got["sweep_hit"].shape
    rh, rs = _plane(gold[f"{p}sweep_hit"], gold[f"{p}sweep_s"], shape)
    _, rc = _plane(gold[f"{p}sweep_hit"], from_bf16_bits(gold[f"{p}sweep_color"]), shape)
    _, rg = _plane(gold[f"{p}sweep_hit"], from_bf16_bits(gold[f"{p}sweep_grad"]), shape)
    mh = got["sweep_hit"]
    both = rh & mh
    n_hit = int((rh != mh).sum())
    ds = np.abs(got["sweep_s"][both].astype(np.float64) - rs[both])
    s_share = float((ds > 5e-5).mean())
    dc = np.abs(got["sweep_color"][both].astype(np.float64) - rc[both])
    dg = np.abs(got["sweep_grad"][both].astype(np.float64) - rg[both])
    cg_share = float(((dc > 1e-2).sum() + (dg > 1e-2).sum()) / (dc.size + dg.size))
    b = SWEEP_BOUNDS
    return Row(f"{view} sweep (axis {got['axis']}, {int(rh.sum())} hit rays)",
               f"hit differs on {n_hit} rays; hit_s max {ds.max():.2e}, {s_share:.2e} of the "
               f"rays >5e-5; color max {dc.max():.2e}, gradient max {dg.max():.2e}, "
               f"{cg_share:.2e} of them >1e-2",
               f"hit <= {b['hit']} rays, hit_s >5e-5 on <= {b['s']:.0e}, color and gradient "
               f">1e-2 <= {b['cg']:.0e}",
               n_hit <= b["hit"] and s_share <= b["s"] and cg_share <= b["cg"])


def compare_screen(what: str, ref, mine) -> Row:
    """Screen planes (anything with color, depth, hit) at the render-parity
    bounds of tests/test_golden.py:65-69, coverage > 0.02; the hit pixels
    that differ counted."""
    s = render_parity(ref, mine)
    rh, mh = np.asarray(ref.hit, bool), np.asarray(mine.hit, bool)
    ok = render_parity_passes(s) and s["hit_frac"] > 0.02
    return Row(what, f"hit pixels differ: {int((mh & ~rh).sum())} port only, "
               f"{int((rh & ~mh).sum())} JAX only, of {int(rh.sum())}; agreement "
               f"{s['hit_agreement']:.6f}, {s['psnr_rgb']:.2f} dB, SSIM {s['ssim_rgb']:.5f}, "
               f"depth median {s['depth_err_med']:.2e} p99 {s['depth_err_p99']:.2e}",
               "render parity (hit >0.995, >30 dB, SSIM >0.95, depth med <2e-3, p99 <2e-2)",
               ok)


def filled(sc: Screen):
    """The hole-filled image of screen planes, for ``compare_screen``."""
    return Screen(sc.filled, sc.depth, sc.hit, None)


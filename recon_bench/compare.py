"""The numbers that decide ``correct``: one judged frame of the program
against the plain reference's frame of the same inputs.

Each is a gap, larger is worse. A cell's limits file
(``limits/<cell>.json``) gives every number a limit of its own, or names
it under ``not_held`` with the readings that leave it without one; a file
that does neither, or names a number not computed here, is refused. Over
several judged frames a number takes its largest reading.

- ``tsdf_off``: of the voxels inside the truncation band on either side
  (``|v| < limit``), the share whose values differ by more than a quarter
  of the limit (2integrate, and 1preprocess's filtering under it);
- ``bricks_out``: how far the program's occupied 16^3 blocks lie outside
  what the reference's frame needs, over that need: below the blocks
  holding a band voxel of the reference, or above the blocks of its
  occupied bricks (brick marking and the depth-band cull);
- ``hit_off``: of the pixels hit on either side, the share hit on one side
  only, away from both silhouettes (``EDGE_PX``): surface lost or added;
- ``hit_lost``: of the same pixels, the share hit by the reference alone:
  surface lost (a lower precision adds surface and loses none);
- ``depth_med_mm``: the median eye-space depth gap, in millimetres, over
  the pixels at least ``EDGE_PX`` inside both silhouettes and as far from
  a depth jump on either side (where one surface passes behind another);
- ``color_med``: the median over the same pixels of the largest gap of the
  hole-filled r, g, b;
- ``color_off``: the share of the same pixels whose largest r, g, b gap
  passes ``COLOR_OFF``: colors wrong over part of the surface.

Medians and shares, not tails, and nothing within ``EDGE_PX`` of a
silhouette or a depth jump: where an edge falls between two pixels the sweep and the
per-ray marcher differ by design, by more than a lower precision moves the
tails (PERF.md, the limits' readings). The color volume is no output of
the timed path; its colors are judged where the image samples it.
"""
from __future__ import annotations

import numpy as np
import torch

NAMES = ("tsdf_off", "bricks_out", "hit_off", "hit_lost", "depth_med_mm", "color_med",
         "color_off")
NOT_HELD = "not_held"    # limits-file key: {number: its readings, why no limit}
EDGE_PX = 2              # pixels this near a silhouette or a depth jump are not judged
JUMP_SLOPE = 4.0         # a depth jump: eye depth changing this many times faster
                         # than across the pixels (a surface steeper than 76 degrees)
COLOR_OFF = 0.05         # a color gap past this counts as off


def eye_depth(window_depth: torch.Tensor, proj) -> torch.Tensor:
    """Eye-space distance (m) from GL window depth."""
    p = torch.as_tensor(np.asarray(proj, np.float64), device=window_depth.device)
    z_ndc = window_depth.double() * 2.0 - 1.0
    return -p[2, 3] / (z_ndc + p[2, 2])


def interior(hit: torch.Tensor, r: int = EDGE_PX) -> torch.Tensor:
    """Pixels whose (2r+1)^2 neighbourhood all hit."""
    miss = (~hit).float()[None, None]
    return torch.nn.functional.max_pool2d(miss, 2 * r + 1, 1, r)[0, 0] == 0


def smooth(eye: torch.Tensor, proj, r: int = EDGE_PX) -> torch.Tensor:
    """Pixels with no depth jump within ``r``: not where one surface passes
    behind another. A jump is a range of eye depth over the (2r+1)^2
    neighbourhood past ``JUMP_SLOPE`` times the neighbourhood's width at
    that depth."""
    d = eye.float()[None, None]
    pool = torch.nn.functional.max_pool2d
    spread = (pool(d, 2 * r + 1, 1, r) + pool(-d, 2 * r + 1, 1, r))[0, 0]
    pixel = eye.abs().float() * 2.0 / (float(np.asarray(proj)[1, 1]) * eye.shape[0])
    return spread < JUMP_SLOPE * (2 * r + 1) * pixel


def away(hit: torch.Tensor, r: int = EDGE_PX) -> torch.Tensor:
    """Pixels more than ``r`` from the silhouette: all hit or all miss
    around them."""
    return interior(hit, r) | interior(~hit, r)


def _median(x: torch.Tensor) -> float:
    return float(torch.quantile(x.float(), 0.5)) if x.numel() else 0.0


def numbers(prog: dict, ref, proj, limit: float) -> dict:
    """``prog``: the program's judged outputs (tensors: color, depth, hit,
    tsdf; occupied_bricks an int); ``ref``: ``frozen.reference.Result``."""
    dev = ref.tsdf.device
    tp = torch.as_tensor(prog["tsdf"], device=dev).float()
    band = (tp.abs() < limit * (1 - 1e-3)) | (ref.tsdf.abs() < limit * (1 - 1e-3))
    off = ((tp - ref.tsdf).abs() > 0.25 * limit) & band
    n = int(prog["occupied_bricks"])
    hp = torch.as_tensor(prog["hit"], device=dev).bool()
    zp = eye_depth(torch.as_tensor(prog["depth"], device=dev), proj)
    zr = eye_depth(ref.depth, proj)
    inner = interior(hp) & interior(ref.hit) & smooth(zp, proj) & smooth(zr, proj)
    dz = (zp - zr).abs()
    cp = torch.as_tensor(prog["color"], device=dev).float()[..., :3]
    dc = (cp - ref.color[..., :3]).abs().amax(dim=-1)
    either = hp | ref.hit
    both_away = away(hp) & away(ref.hit)
    return {
        "tsdf_off": int(off.sum()) / max(int(band.sum()), 1),
        "bricks_out": (max(0, ref.n_band - n) + max(0, n - ref.n_blocks)) / max(ref.n_band, 1),
        "hit_off": int(((hp != ref.hit) & both_away).sum()) / max(int(either.sum()), 1),
        "hit_lost": int((ref.hit & ~hp & both_away).sum()) / max(int(either.sum()), 1),
        "depth_med_mm": _median(dz[inner]) * 1e3,
        "color_med": _median(dc[inner]),
        "color_off": float((dc[inner] > COLOR_OFF).float().mean()) if inner.any() else 0.0,
    }


def worst(readings: list[dict]) -> dict:
    return {k: max(r[k] for r in readings) for k in NAMES} if readings else {}


def check_limits(limits: dict) -> None:
    """Refuses a limits file that names a number not computed here, or
    leaves one of ``NAMES`` with neither a limit nor a ``not_held`` entry."""
    not_held = limits.get(NOT_HELD, {})
    unknown = (set(limits) - {NOT_HELD} - set(NAMES)) | (set(not_held) - set(NAMES))
    if unknown:
        raise ValueError(f"limits name numbers not compared: {sorted(unknown)}")
    both = set(not_held) & set(limits)
    missing = [k for k in NAMES if k not in limits and k not in not_held]
    if both or missing:
        raise ValueError(f"every number needs a limit or a not_held entry: "
                         f"missing {missing}, both {sorted(both)}")
    if any(not isinstance(v, str) or not v for v in not_held.values()):
        raise ValueError("a not_held entry gives its readings and why, as text")


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """(all within their limits, {name: {"value", "limit"}}); False when
    no frame was judged."""
    check_limits(limits)
    held = [k for k in NAMES if k in limits]
    if not values:
        return False, {}
    checks = {k: {"value": values[k], "limit": limits[k]} for k in held}
    return all(values[k] <= limits[k] for k in held), checks

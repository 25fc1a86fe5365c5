"""Golden-image render parity at 720p (mirrors ``scripts/golden_parity.py``).

Integrates the bench scene's frame once through the production path and
renders that volume through both renderers of the port: the per-ray oracle
marcher (``ops/raymarch.render``: limit/2 ray steps, 3D-tap gradients) and
the sweep compositor (``ops/raymarch_fast.render_fast``) at four camera
angles, and prints the parity table (hit agreement, PSNR, SSIM,
window-depth error percentiles), each renderer's time (host clock to a
synchronised result) and the card's name and power limit:

    python -m rgbd_recon_torch.scripts.golden_parity [--tsdf 256] [--render 1280x720]
        [--sensors 4] [--markdown] [--ab-only] [--integrate-ab] [--distort AMP]
        [--scene sphere|complex] [--device cuda|cpu]

It runs on the card unless ``--device cpu``. The rig and frames are built
with the port's ``calibration.synthetic`` and cached under
``.bench_cache/`` beside the package (the port's own file names). The
bounds a view must meet are those of tests/test_golden.py:65-69.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import torch

from ..calibration import synthetic
from ..calibration.rig import RigCalibration
from ..ops import raymarch as rm
from ..ops import raymarch_fast as rmf
from ..ops import tsdf_fast
from ..runtime.pipeline import FramePipeline, PipelineConfig
from ..utils.math import Bbox, look_at
from ..utils.metrics import render_parity, render_parity_passes

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".bench_cache")
# camera offsets from the bbox center (scripts/golden_parity.py:131-137)
VIEWS = {
    "front_z": (0.15, 0.25, 2.6),
    "oblique": (1.4, 0.9, 2.0),
    "side_x": (2.5, 0.4, 0.3),
    "top_y": (0.3, 2.6, 0.4),
}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host(out) -> types.SimpleNamespace:
    return types.SimpleNamespace(color=out.color.float().cpu().numpy(),
                                 depth=out.depth.float().cpu().numpy(),
                                 hit=out.hit.cpu().numpy())


def bench_inputs(sensors: int, distort: float | None, scene: str, log=print):
    """The bench rig (4 Kinect-v2 sensors at 512x424, fwd_res (128, 256,
    128), inv_res 128^3) and its rendered frame, from the port's cache
    file or built and cached."""
    cache = os.path.join(CACHE_DIR, f"torch_rig_k{sensors}_d{distort or '0'}_{scene}.npz")
    if os.path.exists(cache):
        log(f"cached rig: {cache}")
        z = np.load(cache)
        return (RigCalibration(*(z[f] for f in RigCalibration._fields)), z["depth"],
                z["color"])
    rig, _, depth, color = synthetic.bench_scene(sensors, 512, 424, (128, 256, 128),
                                                 (128, 128, 128), scene, distort)
    try:
        os.makedirs(CACHE_DIR, exist_ok=True)
        np.savez(cache, depth=depth, color=color, **rig._asdict())
    except OSError as e:
        log(f"rig cache write failed: {e}")
    return rig, depth, color


def views(bbox: Bbox, proj, width: int, height: int, device):
    """(name, render camera, sweep axis, flip) of each of ``VIEWS``."""
    center = (bbox.min + bbox.max) * 0.5
    proj_t = torch.as_tensor(np.asarray(proj, np.float32), device=device)
    for name, off in VIEWS.items():
        mv = look_at(center + np.asarray(off, np.float32), center, [0.0, 1.0, 0.0])
        cam = rm.RenderCamera(torch.as_tensor(mv, device=device), proj_t, width, height)
        yield (name, cam, *rmf.pick_axis(mv, rm.vol_to_world_matrix(bbox)))


def renderer_parity(vol, cvol, bbox: Bbox, limit: float, proj, width: int, height: int,
                    sweep_res, zmajor: bool, log=print) -> list[dict]:
    """One production volume through the oracle marcher and the sweep at
    each of ``VIEWS``: a row of ``render_parity`` stats a view, with the
    sweep axis and each renderer's seconds (host clock, synchronised)."""
    dev = vol.device
    rows = []
    for name, cam, axis, flip in views(bbox, proj, width, height, dev):
        _sync(dev)
        t0 = time.perf_counter()
        fast = rmf.render_fast(vol, cvol, cam, bbox, limit, axis, flip,
                               cfg=rmf.SweepConfig(res=sweep_res), zmajor=zmajor)
        _sync(dev)
        t_fast = time.perf_counter() - t0
        slow = rm.render(vol, cvol, None, None, cam, bbox, limit)
        _sync(dev)
        t_slow = time.perf_counter() - t0 - t_fast
        stats = render_parity(_host(slow), _host(fast))
        stats.update(view=name, axis=axis, t_slow=t_slow, t_fast=t_fast)
        rows.append(stats)
        log(f"{name}: {stats}")
    return rows


def table(rows: list[dict], times: bool = True) -> str:
    """The GOLDEN.md table, each renderer's seconds beside it."""
    head = "| view | axis | hit agree | PSNR (dB) | SSIM | depth med | depth p99 | depth max |"
    lines = [head + (" oracle s | sweep s |" if times else ""),
             "|---" * (10 if times else 8) + "|"]
    for r in rows:
        lines.append(
            f"| {r['view']} | {r['axis']} | {r['hit_agreement']:.4f} | {r['psnr_rgb']:.1f} "
            f"| {r['ssim_rgb']:.4f} | {r['depth_err_med']:.2e} | {r['depth_err_p99']:.2e} "
            f"| {r['depth_err_max']:.2e} |"
            + (f" {r['t_slow']:.3f} | {r['t_fast']:.4f} |" if times else ""))
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m rgbd_recon_torch.scripts.golden_parity")
    ap.add_argument("--tsdf", type=int, default=256)
    ap.add_argument("--render", default="1280x720")
    ap.add_argument("--sensors", type=int, default=4)
    ap.add_argument("--markdown", action="store_true", help="emit GOLDEN.md-ready tables")
    ap.add_argument("--ab-only", action="store_true",
                    help="skip the renderer-parity loop")
    ap.add_argument("--integrate-ab", action="store_true",
                    help="also A/B the integration paths in image space: the production "
                         "volume vs the exact-table volume, both through the sweep")
    ap.add_argument("--distort", type=float, default=None,
                    help="Kinect-magnitude lens distortion + NNI-like warp amplitude (m)")
    ap.add_argument("--scene", default="sphere", choices=["sphere", "complex"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rw, rh = (int(v) for v in args.render.split("x"))
    dev = torch.device(args.device)

    def log(s):
        print(f"# {s}", file=sys.stderr)

    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    else:
        card = "cpu"
    log(f"device {dev} ({card}), {args.tsdf}^3, {rw}x{rh}")
    rig, depth, color = bench_inputs(args.sensors, args.distort, args.scene, log)
    bbox = rig.bbox
    n = args.tsdf
    pipe = FramePipeline(
        rig, PipelineConfig(render_width=rw, render_height=rh, tsdf_res=(n, n, n),
                            voxel_size=float(np.max(bbox.size) / n), brick_size=0.1,
                            num_lods=6),
        log=log, device=dev)
    _, proj = pipe.default_camera()
    # integrate once through the production path
    pre = pipe._pre(*pipe._sensor_inputs(depth, color))
    vol, cvol = pipe._integrate(pre)
    limit = float(pipe.tsdf_cfg.limit)

    rows, ab_rows = [], []
    if not args.ab_only:
        rows = renderer_parity(vol, cvol, bbox, limit, proj, rw, rh, pipe._sweep_res(),
                               pipe._dense_emit, log)
    if args.integrate_ab:
        # the exact-table integration of the same frames (the warp the
        # affine coefficients approximate), its capacity sized to the
        # occupancy: the table path's sampling tensors scale with it
        log("baking exact tables for the A/B ...")
        tables = tsdf_fast.precompute_tables(rig, pipe.tsdf_cfg, dev)
        n_occ = int(pre.mask16.sum())
        mb = min(pipe.max_bricks, -(-(n_occ * 5 // 4) // 128) * 128)
        log(f"table-path capacity {mb} (occupied {n_occ})")
        vol_tab, cvol_tab = tsdf_fast.integrate_sparse(pre.frames, tables, pipe.tsdf_cfg,
                                                       pre.mask16, mb, 64)
        del tables
        sweep = rmf.SweepConfig(res=pipe._sweep_res())
        for name, cam, axis, flip in views(bbox, proj, rw, rh, dev):
            fast = rmf.render_fast(vol, cvol, cam, bbox, limit, axis, flip, cfg=sweep,
                                   zmajor=pipe._dense_emit)
            fast_tab = rmf.render_fast(vol_tab, cvol_tab, cam, bbox, limit, axis, flip,
                                       cfg=sweep, zmajor=False)
            ab = render_parity(_host(fast_tab), _host(fast))
            ab.update(view=name, axis=axis)
            ab_rows.append(ab)
            log(f"integrate-A/B {name}: {ab}")

    if args.markdown:
        if rows:
            print("## Renderer parity (oracle marcher vs sweep, same volume; "
                  f"seconds on {card})")
            print(table(rows))
        if ab_rows:
            print()
            print("## Integration parity (table path vs production path, same renderer)")
            print(table(ab_rows, times=False))
    else:
        for r in rows + ab_rows:
            print(json.dumps(r))
    print(card)
    return 0 if all(render_parity_passes(r) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())

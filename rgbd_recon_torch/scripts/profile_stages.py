"""Per-op timings of the frame pipeline on the card (mirrors
``scripts/profile_stages.py``).

Times each sub-stage alone over varied pre-staged inputs (distinct noisy
frames on the card), with CUDA events: ``PROF_ITERS`` calls cycling over
the inputs are captured in one CUDA graph and replayed (the device's time
alone, ms a call) where the call is capture-safe, and run eagerly where it
syncs with the host (the staged frame's host slab flags and the staged
step itself). Then the whole frame, staged and fused. Color is a Kinect
v2 stream's 1280x1080 8-bit RGB, as the wire delivers it (the scene's
color resampled by nearest pixel).

    python -m rgbd_recon_torch.scripts.profile_stages
    PROF_TSDF=256 PROF_SENSORS=4 PROF_RENDER=1280x720 PROF_ITERS=10   # the defaults
"""
from __future__ import annotations

import os
import subprocess

import numpy as np
import torch

from ..calibration import synthetic
from ..ops import bricks as brick_ops
from ..ops import colors
from ..ops import inpaint
from ..ops import preprocess as pp
from ..ops import raymarch as rm
from ..ops import raymarch_fast as rmf
from ..ops.tsdf_fast import BRICK
from ..runtime.pipeline import FramePipeline, PipelineConfig
from ..utils.math import Bbox


COLOR_SIZE = (1280, 1080)   # a Kinect v2 color stream (width, height)


def timeit(name: str, fn, args_list, iters: int, graph: bool = True):
    """ms of one call of ``fn`` over ``args_list`` (cycled), printed; the
    output of the first call is returned. ``graph``: the ``iters`` calls
    are captured in one CUDA graph and replayed (a call that syncs with
    the host cannot be captured and raises); else they run eagerly."""
    out = fn(*args_list[0])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(iters):
                fn(*args_list[i % len(args_list)])
        g.replay()
        start.record()
        g.replay()
        end.record()
    else:
        start.record()
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
        end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    print(f"{name:30s} {ms:9.3f} ms  ({'graph replay' if graph else 'eager'})", flush=True)
    return out


def main() -> int:
    tsdf_n = int(os.environ.get("PROF_TSDF", "256"))
    k = int(os.environ.get("PROF_SENSORS", "4"))
    rw, rh = (int(v) for v in os.environ.get("PROF_RENDER", "1280x720").split("x"))
    iters = int(os.environ.get("PROF_ITERS", "10"))
    if not torch.cuda.is_available():
        raise SystemExit("profile_stages times the card: no CUDA device")
    dev = torch.device("cuda")

    bbox = Bbox.default()
    rig, cams = synthetic.synthetic_rig(num_sensors=k, bbox=bbox, fwd_res=(128, 256, 128),
                                        inv_res=(128, 128, 128), width=512, height=424)
    depth, color = synthetic.render_frames(cams, synthetic.SphereScene.default(bbox))
    cw, ch = COLOR_SIZE
    iy = np.arange(ch) * color.shape[1] // ch
    ix = np.arange(cw) * color.shape[2] // cw
    color = color[:, iy][:, :, ix]
    pipe = FramePipeline(rig, PipelineConfig(
        render_width=rw, render_height=rh, tsdf_res=(tsdf_n,) * 3,
        voxel_size=float(np.max(bbox.size) / tsdf_n), brick_size=0.1), device=dev)
    mv, proj = pipe.default_camera()
    rng = np.random.default_rng(0)
    host = [(depth + rng.uniform(0, 2e-3, depth.shape).astype(np.float32),
             np.round(np.clip(color + rng.uniform(0, 1e-2, color.shape), 0, 1) * 255)
             .astype(np.uint8)) for _ in range(4)]
    staged = [pipe._sensor_inputs(d, c) for d, c in host]     # the session bakes too
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(f"== config: {pipe.tsdf_cfg.res}, {k} sensors, color {cw}x{ch} u8, {rw}x{rh}, "
          f"integrator {pipe.integrator.tier}; {card.stdout.strip()}")

    # --- preprocess pieces
    rig_d, cfg_p, warp = pipe._drig, pipe.pre_cfg, pipe._warp
    timeit("morph_dilate", pp.morph_dilate, [(d,) for d, _ in staged], iters)
    cols = [c.to(torch.float32) / 255.0 if c.dtype == torch.uint8 else c for _, c in staged]
    depth2, lab, reg = timeit("bilateral_lab", lambda d, c: pp.bilateral_lab(
        d, c, rig_d, cfg_p, warp), list(zip([d for d, _ in staged], cols)), iters)
    timeit("bilateral_lab, no filter", lambda d, c: pp.bilateral_lab(
        d, c, rig_d, cfg_p._replace(filter_textures=False), warp),
        list(zip([d for d, _ in staged], cols)), iters)
    timeit("rgb_to_lab", colors.rgb_to_lab, [(reg,)], iters)
    depth_b, _ = timeit("boundary", lambda d2, lb: pp.boundary(d2, lb, cfg_p),
                        [(depth2, lab)], iters)
    nrm, world, world_valid = timeit("normals", lambda db: pp.normals(db, rig_d, warp),
                                     [(depth_b,)], iters)
    timeit("quality", lambda db, n: pp.quality(db, n, rig_d, warp), [(depth_b, nrm)], iters)
    timeit("preprocess(all)", lambda d, c: pp.preprocess(d, c, rig_d, cfg_p, warp),
           staged, iters)

    # --- bricks, cull, integrate
    pres = [pipe._pre(d, c) for d, c in staged]
    counts = timeit("mark_bricks (kernel 4)", lambda w, v: brick_ops.mark_bricks(
        w, v, pipe.brick_grid), [(world, world_valid)], iters)
    mask = timeit("occupancy_mask", lambda c: brick_ops.occupancy_mask(
        c, pipe.cfg.min_voxels_per_brick), [(counts,)], iters)
    mask16 = timeit("block_occupancy", lambda m: brick_ops.block_occupancy(
        m, pipe.brick_grid, pipe.tsdf_cfg.res, BRICK), [(mask,)], iters)
    if pipe.integrator.cull_bake is not None:
        timeit("block_depth_cull_baked", pipe.integrator.cull,
               [(mask16, p.frames) for p in pres], iters)
    timeit("1preprocess (_pre)", pipe._pre, staged, iters)
    vols = [pipe._integrate(p) for p in pres]
    timeit("2integrate (_integrate)", pipe._integrate, [(p,) for p in pres], iters)

    # --- render
    axis, flip = rmf.pick_axis(mv, rm.vol_to_world_matrix(bbox))
    n_slices = pipe.tsdf_cfg.res[axis]
    timeit("slab_occupancy (host sync)", lambda m: rmf.slab_occupancy(m, axis, n_slices),
           [(p.mask16,) for p in pres], iters, graph=False)
    timeit("slab_occupancy_device", lambda m: rmf.slab_occupancy_device(m, axis, n_slices),
           [(p.mask16,) for p in pres], iters)
    cam = rm.RenderCamera(torch.as_tensor(mv, device=dev), torch.as_tensor(proj, device=dev),
                          rw, rh)
    lim = float(pipe.tsdf_cfg.limit)
    scfg = rmf.SweepConfig(res=pipe._sweep_res())
    for label, flags in (("host skip", [rmf.slab_occupancy(p.mask16, axis, n_slices)
                                        for p in pres]),
                         ("device flags", [rmf.slab_occupancy_device(p.mask16, axis, n_slices)
                                           for p in pres])):
        args = [(v, c, o) for (v, c), o in zip(vols, flags)]
        graph = label == "device flags"     # the kernel copies host flags to the card
        timeit(f"sweep ({label})", lambda v, c, o: rmf.sweep(
            v, c, cam, bbox, lim, axis, flip, scfg, o, pipe.integrator.zmajor), args, iters,
            graph)
        out = timeit(f"render_fast ({label})", lambda v, c, o: rmf.render_fast(
            v, c, cam, bbox, lim, axis, flip, rm.RenderParams(), scfg, o,
            pipe.integrator.zmajor),
            args, iters, graph)

    # --- holefill: kernel 11's levels and resolve beside the plain twins,
    # on the same rendered frame
    lods = pipe.cfg.num_lods
    pyr = timeit("build_pyramid (kernel 11)", lambda c, d: inpaint.build_pyramid(c, d, lods),
                 [(out.color, out.depth)], iters)
    timeit("colorfill (kernel 11)", inpaint.colorfill, [pyr], iters)
    pyr_plain = timeit("build_pyramid_plain", lambda c, d: inpaint.build_pyramid_plain(
        c, d, lods), [(out.color, out.depth)], iters)
    timeit("colorfill_plain", inpaint.colorfill_plain, [pyr_plain], iters)

    # --- the whole frame
    frames = [(d, c, mv, proj) for d, c in host]
    timeit("frame, staged (step)", pipe.step, frames, iters, graph=False)
    pipe.cfg = pipe.cfg._replace(fused=True)
    pipe.warmup(*frames[0])
    timeit("frame, fused (step: replay)", pipe.step, frames, iters, graph=False)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # the checks below
    python3 chip_smoke.py --profile  # + a torch.profiler breakdown of one frame

Phases (any failure raises and the script exits non-zero without printing
a result line):

1. build   compile the four CUDA kernels from rgbd_recon_torch/csrc with
           nvcc into rgbd_recon_torch/_build/ (seconds printed);
2. card    the card's name and power limit from nvidia-smi;
3. frames  build the bench configuration with the port's own calibration
           code — 4 Kinect-v2 sensors at 512x424 (pinhole rig), a 256^3
           TSDF with brick_size 0.1, a 1280x720 render with 6 LODs — and
           run one warm-up FramePipeline.step (session bakes), recording
           the arguments each kernel wrapper receives;
4. kernels every kernel against its plain PyTorch version on those
           main-path arguments (deviation beside its tolerance; brick
           marking must match exactly) and both timed with CUDA events;
5. slice   launch counters set to 0, FramePipeline.step_timed on a few
           distinct frames, counters read: every kernel must have been
           launched; outputs finite, coverage > 0, check_capacity passes;
           per-stage milliseconds printed;
6. parity  a small frame (3 sensors at 256x212, 128^3, 320x240) through
           the CUDA path and through the plain path on the CPU: hit masks,
           colors and depths must agree at the render-parity bounds the
           repo's tests use.

The last two lines are a JSON object with one entry per kernel and the
card's name and power limit; the very last line is the result object.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 7
NUM_FRAMES = 4


def _fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 2


class Recorder:
    """Wraps a module-level kernel wrapper to keep the arguments of its
    first call in the warm-up frame (the main path's real inputs)."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls = []
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))
        return self.fn(*args, **kwargs)

    def restore(self):
        setattr(self.module, self.name, self.fn)


def _time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _profile_frame(pipe, frame, mv, proj, card: str) -> None:
    """Device time by kernel over one frame and the device's busy share
    (sum of kernel times over the frame's wall time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.step(*frame, mv, proj)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side rows only (kernels, memcpy, memset): the CPU-side aten
    # rows carry the same device time again
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in rows)
    print(f"profile: frame {wall_us / 1e3:.3f} ms wall under the profiler, "
          f"device busy {busy_us / 1e3:.3f} ms ({busy_us / wall_us:.1%}), "
          f"{sum(e.count for e in rows)} device ops ({card})")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}")


def _bench_inputs(num_sensors, width, height, fwd_res, inv_res, seed):
    import numpy as np
    from rgbd_recon_torch.calibration import synthetic
    from rgbd_recon_torch.utils.math import Bbox

    bbox = Bbox.default()
    rig, cams = synthetic.synthetic_rig(num_sensors=num_sensors, bbox=bbox,
                                        fwd_res=fwd_res, inv_res=inv_res,
                                        width=width, height=height)
    depth, color = synthetic.render_frames(cams, synthetic.SphereScene.default(bbox))
    rng = np.random.default_rng(seed)
    frames = [(depth + rng.uniform(0, 2e-3, depth.shape).astype(np.float32),
               np.clip(color + rng.uniform(0, 1e-2, color.shape).astype(np.float32), 0, 1))
              for _ in range(NUM_FRAMES)]
    return rig, bbox, frames


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return _fail("torch.cuda.is_available() is false: this run needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(HERE, "rgbd_recon_torch", "csrc")):
        return _fail("rgbd_recon_torch/ not found beside chip_smoke.py")
    sys.path.insert(0, HERE)
    import numpy as np
    from rgbd_recon_torch import native
    from rgbd_recon_torch.ops import bricks, preprocess as pp, raymarch_fast as rmf
    from rgbd_recon_torch.ops import tsdf_dense, warp as warp_ops
    from rgbd_recon_torch.ops.tsdf_fast import occupied_list, pack_frames
    from rgbd_recon_torch.runtime import pipeline as pl

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. build -----------------------------------------------------------
    _, build_s = native.build()
    native.library()
    print(f"build: {build_s:.1f} s ({len(native.KERNELS)} kernels, nvcc sm_90a)")

    # -- 2. card ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 3. bench frames + warm-up -----------------------------------------
    t0 = time.perf_counter()
    rig, bbox, frames = _bench_inputs(4, 512, 424, (128, 256, 128), (128, 128, 128), SEED)
    n = 256
    cfg = pl.PipelineConfig(render_width=1280, render_height=720,
                            tsdf_res=(n, n, n),
                            voxel_size=float(np.max(bbox.size) / n),
                            brick_size=0.1, num_lods=6)
    print(f"rig + frames: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pipe = pl.FramePipeline(rig, cfg, device=dev, log=lambda s: print(f"  {s}"))
    mv, proj = pipe.default_camera()
    recs = {
        "bilateral_accum": Recorder(pp, "bilateral_accum"),
        "mark_bricks": Recorder(bricks, "mark_bricks"),
        "warp_screen_registration": Recorder(pp, "warp_screen"),
        "warp_screen_screen": Recorder(rmf, "warp_screen"),
        "integrate_dense": Recorder(pl, "integrate_dense"),
    }
    try:
        out = pipe.step(*frames[0], mv, proj)
        torch.cuda.synchronize()
    finally:
        for r in recs.values():
            r.restore()
    print(f"session bakes + warm-up frame: {time.perf_counter() - t0:.1f} s")
    for name, r in recs.items():
        if not r.calls:
            raise RuntimeError(f"the warm-up frame never reached {name}")

    # -- 4. kernels vs plain versions ---------------------------------------
    results = {}

    def report(name, route_src, replaces, err, tol_txt, ok, kern, plain, reps):
        ms, plain_ms = _time_ms(kern, reps), _time_ms(plain, reps)
        print(f"kernel {name}: max_abs_err {err['max']:.3e} p99.5 {err['p995']:.3e} "
              f"({tol_txt}) -> {'ok' if ok else 'FAIL'}; {ms:.4f} ms vs plain "
              f"{plain_ms:.4f} ms")
        if not ok:
            raise RuntimeError(f"kernel {name} disagrees with its plain version")
        results[name] = dict(source=route_src, replaces=replaces,
                             max_abs_err=err["max"], ms=ms, plain_ms=plain_ms)

    def errs(a, b):
        d = (a.to(torch.float64) - b.to(torch.float64)).abs().flatten()
        k = max(1, int(0.005 * d.numel()))
        return {"max": float(d.max()), "p995": float(torch.topk(d, k).values.min())}

    # bilateral_accum: the 13x13 accumulators of the 4 x 424 x 512 frame
    (d_in, lim_in), _ = recs["bilateral_accum"].calls[0]
    got = pp.bilateral_accum(d_in, lim_in)
    want = pp.bilateral_accum_plain(d_in, lim_in)
    e = errs(torch.stack(got), torch.stack(want))
    ok = all(torch.allclose(g, w, atol=2e-4, rtol=2e-5) for g, w in zip(got, want))
    report("bilateral_accum", "rgbd_recon_torch/csrc/bilateral_accum.cu",
           "rgbd_recon_tpu/ops/preprocess_pallas.py:75", e, "atol 2e-4 rtol 2e-5",
           ok, lambda: pp.bilateral_accum(d_in, lim_in),
           lambda: pp.bilateral_accum_plain(d_in, lim_in), 20)

    # mark_bricks: the world points of all 4 sensors, integer-exact
    (w_in, v_in, grid), _ = recs["mark_bricks"].calls[0]
    got = bricks.mark_bricks(w_in, v_in, grid).to(torch.int64)
    want = bricks.mark_bricks_plain(w_in, v_in, grid).to(torch.int64)
    e = errs(got, want)
    report("mark_bricks", "rgbd_recon_torch/csrc/mark_bricks.cu",
           "rgbd_recon_tpu/ops/bricks_pallas.py:100", e, "exact",
           bool(torch.equal(got, want)) and int(got.sum()) > 0,
           lambda: bricks.mark_bricks(w_in, v_in, grid),
           lambda: bricks.mark_bricks_plain(w_in, v_in, grid), 20)

    # warp_screen: registration (sensor 0 color) and the sweep->screen warp
    for key, label in (("warp_screen_registration", "registration"),
                       ("warp_screen_screen", "screen")):
        (img, fy, fx, tile), _ = recs[key].calls[0]
        wh, y0, x0 = warp_ops.warp_windows(img.shape[0], img.shape[1], fy, fx, tile)
        got = warp_ops.warp_screen_cuda(img, fy, fx, tile, wh, y0, x0)
        want = warp_ops.warp_screen_plain(img, fy, fx, tile, wh, y0, x0)
        e = errs(got, want)
        ok = bool(torch.allclose(got, want, atol=1e-5, rtol=1e-5))
        report(f"warp_screen[{label} {tuple(img.shape)}->{tuple(fy.shape)}]",
               "rgbd_recon_torch/csrc/warp_screen.cu",
               "rgbd_recon_tpu/ops/warp_pallas.py:116", e, "atol 1e-5 rtol 1e-5",
               ok, lambda: warp_ops.warp_screen_cuda(img, fy, fx, tile, wh, y0, x0),
               lambda: warp_ops.warp_screen_plain(img, fy, fx, tile, wh, y0, x0), 20)

    # integrate_dense: the warm-up frame's occupied bricks at 256^3
    args, kw = recs["integrate_dense"].calls[0]
    fr, aff, tcfg, m16, maxb, woff, wy, wx, xs, cls = args
    packed = pack_frames(fr)
    idx, _, count = occupied_list(m16, maxb)
    iargs = (packed, aff.coeffs, idx, count, woff, cls, tcfg.res, wy, wx, xs,
             float(tcfg.limit))
    vol, cvol = tsdf_dense.integrate_dense_cuda(*iargs)

    def plain_integrate():
        return tsdf_dense.integrate_dense_plain(*iargs)

    pvol, pcvol = plain_integrate()
    v, pv = vol.float(), pvol.float()
    e = errs(v, pv)
    off = float(((v - pv).abs() > 1e-4).float().mean())
    cd = float(((cvol.float() - pcvol.float()).abs().amax(dim=1) > 1e-2).float().mean())
    occ, pocc = int((v > -tcfg.limit + 1e-9).sum()), int((pv > -tcfg.limit + 1e-9).sum())
    ok = off < 1e-4 and cd < 1e-3 and abs(occ - pocc) <= max(100, 0.002 * pocc) and occ > 0
    print(f"  integrate_dense: {int(count)} occupied bricks, voxels off >1e-4: {off:.2e}, "
          f"color off >1e-2: {cd:.2e}, occupied voxels {occ} vs {pocc}")
    report("integrate_dense", "rgbd_recon_torch/csrc/integrate_dense.cu",
           "rgbd_recon_tpu/ops/tsdf_dense.py:452", e,
           "<1e-4 of voxels off >1e-4, <1e-3 color off >1e-2, occupancy within 0.2%",
           ok, lambda: tsdf_dense.integrate_dense_cuda(*iargs), plain_integrate, 5)

    # -- 5. the slice on the card -------------------------------------------
    for k in native.KERNELS.values():
        k.launches = 0
    pipe.timers.reset()
    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(NUM_FRAMES):
        outs.append(pipe.step_timed(*frames[i % len(frames)], mv, proj))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / NUM_FRAMES
    launches = {name: k.launches for name, k in native.KERNELS.items()}
    print(f"launches during {NUM_FRAMES} frames: {launches}")
    missing = [name for name, c in launches.items() if c == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the main path: {missing}")
    for name in pl.STAGE_TIMERS:
        t = pipe.timers.timers[name]
        print(f"stage {name}: mean {t.mean * 1e3:.3f} ms, min {t.vmin * 1e3:.3f} ms "
              f"over {t.count} frames (CUDA events; {card})")
    print(f"frame wall time (host clock, step_timed incl. its syncs): {wall * 1e3:.1f} ms")
    for o in outs:
        n_occ = pipe.check_capacity(o)
        assert o.color.shape == (720, 1280, 4) and o.tsdf.shape == (n, n, n)
        assert bool(torch.isfinite(o.color).all()) and bool(torch.isfinite(o.depth).all())
        assert bool(torch.isfinite(o.tsdf.float()).all())
        cov = float(o.hit.float().mean())
        assert cov > 0.0, "render coverage is 0"
    print(f"outputs: occupied bricks {n_occ} / {pipe.max_bricks}, coverage "
          f"{cov:.4f}, occupied ratio {float(outs[-1].occupied_ratio):.4f}")
    if "--profile" in sys.argv[1:]:
        _profile_frame(pipe, frames[1], mv, proj, card)

    # -- 6. small-frame parity: CUDA path vs plain path on the CPU ----------
    srig, sbbox, sframes = _bench_inputs(3, 256, 212, (48, 64, 48), (48, 48, 48), SEED)
    scfg = pl.PipelineConfig(render_width=320, render_height=240,
                             tsdf_res=(128, 128, 128),
                             voxel_size=float(np.max(sbbox.size) / 128),
                             sweep_res=(256, 256))
    res = {}
    for d in (dev, torch.device("cpu")):
        p = pl.FramePipeline(srig, scfg, device=d)
        smv, sproj = p.default_camera()
        o = p.step(*sframes[0], smv, sproj)
        res[d.type] = [x.detach().float().cpu().numpy() for x in (o.color, o.depth, o.hit)]
    (gc, gd, gh), (cc, cdp, ch) = res["cuda"], res["cpu"]
    gh, ch = gh > 0.5, ch > 0.5
    both = gh & ch
    hit_agree = float((gh == ch).mean())
    mse = float(((gc[..., :3] - cc[..., :3]) ** 2).mean())
    psnr = float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)
    dmed = float(np.median(np.abs(gd[both] - cdp[both]))) if both.any() else 1.0
    print(f"small-frame parity cuda vs cpu-plain: hit agreement {hit_agree:.5f} "
          f"(>0.995), psnr {psnr:.2f} dB (>30), depth err median {dmed:.2e} (<2e-3), "
          f"coverage {float(gh.mean()):.4f}")
    if not (hit_agree > 0.995 and psnr > 30.0 and dmed < 2e-3 and gh.mean() > 0.02):
        raise RuntimeError("the CUDA path disagrees with the plain path on the small frame")

    kernels = [
        {"name": name, "route": "cuda", "source": r["source"], "replaces": r["replaces"],
         "launches": launches[name.split("[")[0]], "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"]}
        for name, r in results.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

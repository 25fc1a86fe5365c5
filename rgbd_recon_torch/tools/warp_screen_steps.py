#!/usr/bin/env python3
"""Time the first warp_screen kernel and each change that led to the
current one, one change at a time, on the main path's own inputs (one
NVIDIA GPU):

    python3 rgbd_recon_torch/tools/warp_screen_steps.py

It builds ``warp_screen_steps.cu`` (steps 0-3; step 4 is
``csrc/warp_screen.cu``) with nvcc, printing each kernel's registers,
runs one pinhole bench frame (chip_smoke.py's configuration at 256^3) to
record the two warp_screen calls of the path (color registration, 3
channels; the sweep-to-screen warp, 9 of 12 channels), holds every step
to the current kernel's output on those inputs (atol 1e-5: the same
operations) and times each step by CUDA-graph replay of back-to-back
calls, three rounds in the order 0..4, 4..0, 0..4. Step 3 applies to the
padded 9-channel source only.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
STEPS = {
    0: "the first kernel: three integer divisions, runtime C, scalar taps and stores",
    1: "+ tile row from the block grid, x >> log2(tw): no division",
    2: "+ channel count at compile time",
    3: "+ source padded to 12 channels, each tap three float4",
    4: "+ warp output staged in shared memory, float4 stores (csrc/warp_screen.cu)",
}
REPS = 50


def _build(native):
    """Compile the steps library; print ptxas's register counts of the
    steps and of the current kernel."""
    nvcc = native._nvcc()
    os.makedirs(native.BUILD_DIR, exist_ok=True)
    so = os.path.join(native.BUILD_DIR, "warp_screen_steps.so")
    cmds = [
        [nvcc, *native.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", so,
         os.path.join(HERE, "warp_screen_steps.cu")],
        [nvcc, *native.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
         os.path.join(native.BUILD_DIR, "warp_screen_current.o"),
         os.path.join(native.CSRC, "warp_screen.cu")],
    ]
    for cmd in cmds:
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{r.stdout}{r.stderr}")
        for line in (r.stdout + r.stderr).splitlines():
            if "Compiling entry" in line or "Used" in line:
                print(f"ptxas: {line.strip()}")
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rr_warp_step.argtypes = [I] + [P] * 6 + [I] * 9 + [P]
    lib.rr_warp_step.restype = I
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("warp_screen_steps: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from rgbd_recon_torch import native
    from rgbd_recon_torch.calibration.synthetic import bench_inputs
    from rgbd_recon_torch.ops import preprocess as pp, raymarch_fast as rmf, warp as warp_ops
    from rgbd_recon_torch.runtime import pipeline as pl
    from rgbd_recon_torch.utils.bench_golden import bench_config

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    lib = _build(native)

    rig, bbox, frames = bench_inputs(4, 512, 424, (128, 256, 128), (128, 128, 128),
                                     cs.SEED, frames=1)
    pipe = pl.FramePipeline(rig, bench_config(bbox, 256), device="cuda")
    mv, proj = pipe.default_camera()
    recs = {"registration": cs.Recorder(pp, "warp_screen"),
            "screen": cs.Recorder(rmf, "warp_screen")}
    try:
        pipe.step(*frames[0], mv, proj)
        torch.cuda.synchronize()
    finally:
        for r in recs.values():
            r.restore()

    for label, rec in recs.items():
        (img, fy, fx, tile), kw = rec.calls[0]
        ch = kw.get("channels")
        ti, si, cp = img.shape
        c = ch or cp
        h, w = fy.shape
        wh, y0, x0 = warp_ops.warp_windows(ti, si, fy, fx, tile)
        want = warp_ops.warp_screen_cuda(img, fy, fx, tile, wh, y0, x0, ch)
        flat = img[..., :c].contiguous()      # the unpadded source of steps 0-2
        out = torch.empty_like(want)

        def step(k, src):
            def run():
                rc = lib.rr_warp_step(k, src.data_ptr(), fy.data_ptr(), fx.data_ptr(),
                                      y0.data_ptr(), x0.data_ptr(), out.data_ptr(), ti, si,
                                      c, h, w, tile[0], tile[1], wh, warp_ops.WXW,
                                      torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"step {k} failed to launch ({rc})")
                return out
            return run

        fns = {k: step(k, flat) for k in (0, 1, 2)}
        if cp == 12:
            fns[3] = step(3, img)
        fns[4] = lambda: warp_ops.warp_screen_cuda(img, fy, fx, tile, wh, y0, x0, ch)
        for k, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not torch.allclose(got, want, atol=1e-5, rtol=1e-5):
                raise RuntimeError(f"{label} step {k} disagrees with the kernel: {err:.3e}")
        order = list(fns) + list(fns)[::-1] + list(fns)
        times = {k: [] for k in fns}
        for k in order:
            times[k].append(cs._time_ms(fns[k], REPS, graph=True))
        print(f"{label}: {(ti, si, cp)} -> {(h, w, c)}, tile {tile}; ms per call, "
              f"CUDA-graph replay of {REPS} calls, 3 rounds ({card})")
        for k, ts in times.items():
            print(f"  step {k} {STEPS[k]}: " + ", ".join(f"{t:.4f}" for t in ts)
                  + f"; mean {sum(ts) / len(ts):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

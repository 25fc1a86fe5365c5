#!/usr/bin/env python3
"""Time the first quadratic integrator (kernels 1 and 6) and each change
that led to the current one, one change at a time, on the main path's own
inputs (one NVIDIA GPU):

    python3 rgbd_recon_torch/tools/integrate_steps.py

It builds ``integrate_steps.cu`` (steps 0-14, the side steps tried on the
way included) with nvcc, printing each kernel's registers and those of
``csrc/integrate_dense.cu``, runs one
pinhole bench frame at 256^3 and one at 240^3 (chip_smoke.py's
configuration) to record the integrator calls (kernel 1; kernel 6 in voxel
order, and in raw mode on the same arguments), holds every step to the
plain version at the integrator bound (tests/test_tsdf_affine.py:109-116;
in raw mode on the visited blocks, with the same visited flags) and times
each step by CUDA-graph replay of back-to-back calls, three rounds in the
order first..current, current..first, first..current.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
STEPS = {
    (0, 0): "the first kernel: fill + memset, one 256-thread block per slot looping 16 z",
    (1, 0): "+ one launch over every brick: 16-byte clear in the idle bricks, slot map",
    (2, 1): "+ one thread per voxel, slabs of 1 slice",
    (2, 2): "+ one thread per voxel, slabs of 2 slices",
    (2, 4): "+ one thread per voxel, slabs of 4 slices",
    (3, 0): "+ __fdividef quotients, one reciprocal for the color (2 slices)",
    (4, 0): "+ 8-byte pixel loads, NEAREST depth from the LINEAR taps (2 slices)",
    (5, 1): "+ z-folded (y, x) warp, 1 slice",
    (5, 2): "+ z-folded (y, x) warp, 2 slices",
    (5, 4): "+ z-folded (y, x) warp, 4 slices",
    (6, 1): "+ bricks in a spread order (item * 1031 mod NB), 1 slice",
    (6, 2): "+ bricks in a spread order (item * 1031 mod NB), 2 slices",
    (7, 1): "+ 32-byte pixels, two 16-byte loads a tap, 1 slice",
    (7, 2): "+ 32-byte pixels, two 16-byte loads a tap, 2 slices",
    (8, 1): "step 5 with two roles a block: clear in ascending order, fuse in spread order, 1",
    (8, 2): "step 5 with two roles a block: clear in ascending order, fuse in spread order, 2",
    (9, 1): "+ frame in two planes (depth, qual, sil, r) (g, b), 1 slice",
    (9, 2): "+ frame in two planes (depth, qual, sil, r) (g, b), 2 slices",
    (10, 0): "step 9 at 32 registers, 2 slices",
    (11, 1): "step 5, one block a brick: 256 threads x 16 slices",
    (11, 2): "step 5, one block a brick: 512 threads x 8 slices",
    (11, 4): "step 5, one block a brick: 1024 threads x 4 slices",
    (12, 2): "step 11 + the two planes, 512 threads x 8 slices",
    (12, 4): "step 11 + the two planes, 1024 threads x 4 slices",
    (12, 3): "step 11 + the two planes, 512 threads x 8 slices at 40 registers",
    (13, 3): "step 12 + taps weighted first, 512 threads x 8 slices at 40 registers",
    (13, 4): "step 12 + taps weighted first, 1024 threads x 4 slices",
    (14, 0): "step 12 (1024 threads), fused bricks first, each block clearing 4 bricks",
    (14, 1): "step 12, fused first, the clear on fused blocks, a quarter a quarter-slab",
    (14, 2): "step 12, odd blocks fuse, all blocks clear equal ranges at their start",
    (14, 3): "step 12, fused first, the clear on fused blocks, at their start",
    (14, 5): "step 14 (0) at 512 threads",
    "current": "csrc/integrate_dense.cu",
}
MODES = {"integrate_dense (z-major)": 0, "integrate_affine (voxel order)": 1,
         "integrate_affine (raw)": 2}
REPS = 20


def _build(native):
    """Compile the steps library; print ptxas's register counts of the
    steps and of the current kernel."""
    nvcc = native._nvcc()
    os.makedirs(native.BUILD_DIR, exist_ok=True)
    so = os.path.join(native.BUILD_DIR, "integrate_steps.so")
    cmds = [
        [nvcc, *native.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", so,
         os.path.join(HERE, "integrate_steps.cu")],
        [nvcc, *native.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
         os.path.join(native.BUILD_DIR, "integrate_dense_current.o"),
         os.path.join(native.CSRC, "integrate_dense.cu")],
    ]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    for cmd, p in zip(cmds, procs):
        out = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{out}")
        name = ""
        for line in out.splitlines():
            if "Compiling entry" in line:   # the kernel and its template arguments
                name = line.split("'")[1]
                name = name[name.find("kernel"):][:60]
            elif "Used" in line:
                print(f"ptxas: {name}: {line.split(':', 1)[1].strip()}")
    lib = ctypes.CDLL(so)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rr_integrate_step.argtypes = [I] * 3 + [P] * 11 + [I] * 11 + [F, P]
    lib.rr_integrate_step.restype = I
    return lib


def _within_bound(got, want, limit, raw):
    """The integrator bound; raw: identical visited flags, the bound on the
    visited blocks."""
    import torch

    v, c = got[0].float(), got[1].float()
    pv, pc = want[0].float(), want[1].float()
    cdim = -1 if c.shape[-1] == 4 else 1
    if raw:
        if not torch.equal(got[2], want[2]):
            return False, "visited differs"
        vis = got[2]
        v, c, pv, pc = v[vis], c[vis], pv[vis], pc[vis]
    off = float(((v - pv).abs() > 1e-4).float().mean())
    cd = float(((c - pc).abs().amax(dim=cdim) > 1e-2).float().mean())
    occ, pocc = int((v > -limit + 1e-9).sum()), int((pv > -limit + 1e-9).sum())
    ok = off < 1e-4 and cd < 1e-3 and abs(occ - pocc) <= max(100, 0.002 * pocc) and pocc > 0
    return ok, f"voxels off >1e-4 {off:.2e}, color off >1e-2 {cd:.2e}, occupied {occ} vs {pocc}"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("integrate_steps: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from rgbd_recon_torch import native
    from rgbd_recon_torch.calibration.synthetic import bench_inputs
    from rgbd_recon_torch.ops import tsdf_dense, tsdf_persist
    from rgbd_recon_torch.ops.tsdf_fast import BRICK, occupied_bricks, pack_frames
    from rgbd_recon_torch.runtime import pipeline as pl
    from rgbd_recon_torch.utils.bench_golden import bench_config

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    lib = _build(native)

    rig, bbox, frames = bench_inputs(4, 512, 424, (128, 256, 128), (128, 128, 128),
                                     cs.SEED, frames=1)
    calls = {}
    for n, name in ((256, "integrate_dense"), (240, "integrate_affine")):
        pipe = pl.FramePipeline(rig, bench_config(bbox, n), device="cuda")
        mv, proj = pipe.default_camera()
        rec = cs.Recorder(pl, name)
        try:
            pipe.step(*frames[0], mv, proj)
            torch.cuda.synchronize()
        finally:
            rec.restore()
        calls[name] = rec.calls[0][0]
        del pipe

    for label, mode in MODES.items():
        if mode == 0:
            fr, aff, tcfg, m16, maxb, woff, wy, wx, xs, cls = calls["integrate_dense"]
        else:
            fr, aff, tcfg, m16, maxb, woff, wy = calls["integrate_affine"]
            wx, xs, cls = tsdf_persist.WX2, tsdf_persist.XSTRIDE2, None
        raw = mode == 2
        limit = float(tcfg.limit)
        vx, vy, vz = tcfg.res
        nbx, nby, nbz = vx // BRICK, vy // BRICK, vz // BRICK
        nb = nbx * nby * nbz
        packed = pack_frames(fr)
        packed8 = torch.nn.functional.pad(packed, (0, 2)).contiguous()   # step 7's frame
        plane_a, plane_b = packed[..., :4].contiguous(), packed[..., 4:].contiguous()
        idx, count, slots = occupied_bricks(m16, maxb)
        if mode == 0:
            want = tsdf_dense.integrate_dense_plain(packed, aff.coeffs, idx, count, woff, cls,
                                                    tcfg.res, wy, wx, xs, limit)
            current = lambda: tsdf_dense.integrate_dense_cuda(  # noqa: E731
                (plane_a, plane_b), aff.coeffs, idx, count, slots, woff, cls, tcfg.res, wy,
                wx, xs, limit)
            out = (torch.empty((vz, vy, vx), dtype=torch.bfloat16, device="cuda"),
                   torch.empty((vz, 4, vy, vx), dtype=torch.bfloat16, device="cuda"), None)
        else:
            want = tsdf_persist.integrate_affine_plain(packed, aff.coeffs, idx, count, woff,
                                                       tcfg.res, wy, limit, raw)
            current = lambda: tsdf_persist.integrate_affine_cuda(  # noqa: E731
                (plane_a, plane_b), aff.coeffs, idx, count, slots, woff, tcfg.res, wy, limit,
                raw)
            shapes = (((nb, 32, 128), (nb, 4, 32, 128)) if raw
                      else ((vz, vy, vx), (vz, vy, vx, 4)))
            out = (torch.empty(shapes[0], device="cuda"),
                   torch.empty(shapes[1], dtype=torch.bfloat16, device="cuda"),
                   torch.empty(nb, dtype=torch.bool, device="cuda") if raw else None)

        def step(s, zs):
            def run():
                src = packed8 if s == 7 else (plane_a if s in (9, 10, 12, 13, 14) else packed)
                rc = lib.rr_integrate_step(
                    s, zs, mode, src.data_ptr(), plane_b.data_ptr(), aff.coeffs.data_ptr(),
                    idx.data_ptr(),
                    count.data_ptr(), slots.data_ptr(), woff.data_ptr(),
                    cls.data_ptr() if cls is not None else None, out[0].data_ptr(),
                    out[1].data_ptr(), out[2].data_ptr() if raw else None, packed.shape[0],
                    packed.shape[1], packed.shape[2], nb, nbx, nby, nbz, idx.shape[0], wy, wx,
                    xs, limit, torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"step {s} failed to launch ({rc})")
                return out if raw else out[:2]
            return run

        fns = {key: (step(*key) if key != "current" else current) for key in STEPS}
        for key, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            ok, msg = _within_bound(got, want, limit, raw)
            print(f"  {label} step {key}: {msg}")
            if not ok:
                raise RuntimeError(f"{label} step {key} is outside the integrator bound")
        order = list(fns) + list(fns)[::-1] + list(fns)
        times = {key: [] for key in fns}
        for key in order:
            times[key].append(cs._time_ms(fns[key], REPS, graph=True))
        print(f"{label}: {tcfg.res}, {int(count)} fused bricks of {nb}; ms per call, "
              f"CUDA-graph replay of {REPS} calls, 3 rounds ({card})")
        for key, ts in times.items():
            print(f"  step {key} {STEPS[key]}: " + ", ".join(f"{t:.4f}" for t in ts)
                  + f"; mean {sum(ts) / len(ts):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

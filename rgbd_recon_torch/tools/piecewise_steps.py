#!/usr/bin/env python3
"""Time the first kernels 5 (piecewise_eval) and 4 (mark_bricks) and each
change that led to the current ones, one change at a time, on the main
path's own inputs (one NVIDIA GPU):

    python3 rgbd_recon_torch/tools/piecewise_steps.py [--kernel 4|5]

It builds ``piecewise_steps.cu`` with nvcc, printing the registers of each
step and of ``csrc/piecewise_eval.cu`` and ``csrc/mark_bricks.cu``, runs
one pinhole and one distorted bench frame (chip_smoke.py's configurations
at 256^3) to record the path's mark_bricks call and its piecewise_eval
calls (xyz, uv and the normal stencil), holds every step to the current
kernel bit for bit (kernel 5; kernel 4 integer-exact) and times each step
by CUDA-graph replay of back-to-back calls, three rounds in the order
first..current, current..first, first..current, each round also with the
L2 cold (every call after a 128 MB read, whose own time is subtracted:
back-to-back replays keep a small call's inputs in the 50 MB L2, which a
frame's other work evicts). Each kernel 5 step is
timed as the function from the depth maps in one call: steps 0-2 include
the two elementwise passes that compute the knot coordinates (their
divisor a 0-d tensor on the card, so that they divide as the kernel
does), and steps 0-3, which take no offsets, evaluate the stencil's
shifted taps as the first port did (each depth map counter-shifted, the
result shifted back and its border line evaluated again). Last, an empty
kernel at mark_bricks' grid, alone and after the memset of its counts:
the floor under a small kernel's graph-replayed time. Kernel 4 is also
timed on its worst case for adds to global bins (every point valid and in
one brick).
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
STEPS5 = {
    (0, 0): "the first kernel: dc, cc outside; thread per (k, c, pixel), 64-bit / and %",
    (1, 0): "+ 32-bit indices",
    (2, 0): "+ one pixel a thread, the C channels inside, stride-C stores",
    (2, 1): "+ each warp's run staged in shared memory, coalesced stores",
    (3, 0): "+ the clamp and the knot coordinate inside (D in)",
    (4, 0): "+ a (dy, dx) offset a map: the stencil in one launch",
    (4, 1): "step 4 with streaming (evict-first) stores",
    (4, 2): "step 4 with the maps across the grid, not a loop a thread",
    "current": "csrc/piecewise_eval.cu",
}
STEPS4 = {   # (step, a, b): rr_mark_step's arguments (piecewise_steps.cu)
    (0, 0, 2): "the first kernel: all bins a block, 2 blocks an SM, an atomicAdd a point",
    (1, 0, 2): "+ warp aggregation (__match_any_sync in every warp), 2 blocks an SM",
    (1, 1, 2): "+ aggregation only in warps with a valid point (__any_sync first)",
    (2, 2, 2): "+ the bins over a cluster of 2, 2 blocks an SM",
    (2, 4, 2): "+ the bins over a cluster of 4, 2 blocks an SM",
    (2, 8, 2): "+ the bins over a cluster of 8, 2 blocks an SM",
    (2, 4, 4): "cluster of 4, 4 blocks an SM",
    (2, 8, 4): "cluster of 8, 4 blocks an SM",
    (3, 4, 1): "+ one pass over the points (<= 8 blocks an SM), cluster of 4, 1 point a thread",
    (3, 4, 2): "+ one pass, cluster of 4, 2 points a thread, loads first",
    (3, 4, 4): "+ one pass, cluster of 4, 4 points a thread, loads first",
    (3, 8, 1): "+ one pass, cluster of 8, 1 point a thread",
    (3, 8, 2): "+ one pass, cluster of 8, 2 points a thread, loads first",
    (3, 8, 4): "+ one pass, cluster of 8, 4 points a thread, loads first",
    (4, 8, 0): "step 3 (8, 2) at <= 32 registers, cut: the loads and the bins only",
    (4, 8, 1): "step 3 (8, 2) at <= 32 registers, cut: + the histogram, no flush",
    (4, 8, 2): "step 3 (8, 2) at <= 32 registers: the whole kernel",
    (4, 4, 2): "step 3 (4, 2) at <= 32 registers: the whole kernel",
    (4, 8, 3): "step 3 (8, 2) at <= 32 registers, cut: the loads, bins, zeroing and syncs",
    (6, 8, 0): "step 4 (8, 2) whole, the first cluster barrier split around the loads",
    (5, 1, 2): "no cluster: one pass, 2 points a thread, a global add a point",
    (5, 0, 1): "no cluster: one pass, 1 point a thread, a global add a warp and bin",
    (5, 0, 2): "no cluster: one pass, 2 points a thread, a global add a warp and bin",
    (5, 0, 4): "no cluster: one pass, 4 points a thread, a global add a warp and bin",
    (7, 16, 2): "step 5 (2 points) + a cache of 16 bins a block before the global adds",
    (7, 64, 2): "step 5 (2 points) + a cache of 64 bins a block before the global adds",
    (7, 256, 2): "step 5 (2 points) + a cache of 256 bins a block before the global adds",
    (7, 64, 4): "step 5 (4 points) + a cache of 64 bins a block before the global adds",
    "current": "csrc/mark_bricks.cu",
}
REPS = 20


def _ptxas(cmd: list[str]) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _build(native):
    """Compile the steps library; print ptxas's register counts of the
    steps and of the two current kernels."""
    nvcc = native._nvcc()
    os.makedirs(native.BUILD_DIR, exist_ok=True)
    so = os.path.join(native.BUILD_DIR, "piecewise_steps.so")
    cmds = [[nvcc, *native.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", so,
             os.path.join(HERE, "piecewise_steps.cu")]]
    for src in ("piecewise_eval.cu", "mark_bricks.cu"):
        cmds.append([nvcc, *native.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                     os.path.join(native.BUILD_DIR, src + ".current.o"),
                     os.path.join(native.CSRC, src)])
    filt = shutil.which("cu++filt") or os.path.join(os.path.dirname(nvcc), "cu++filt")
    for cmd, p in [(c, _ptxas(c)) for c in cmds]:
        out = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{out}")
        name = ""
        for line in out.splitlines():
            if "Compiling entry" in line:
                name = line.split("'")[1]
                if os.path.exists(filt):
                    name = subprocess.run([filt, name], capture_output=True,
                                          text=True).stdout.strip() or name
            elif "Used" in line:
                print(f"ptxas: {name[:100]}: {line.split(':', 1)[1].strip()}")
    lib = ctypes.CDLL(so)
    P, I, F, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.rr_piecewise_step.argtypes = [I, I] + [P] * 7 + [I] * 6 + [F] * 3 + [P]
    lib.rr_piecewise_step.restype = I
    lib.rr_mark_step.argtypes = [I, I, I, P, P, P, I64] + [F] * 4 + [I] * 3 + [P]
    lib.rr_mark_step.restype = I
    return lib


def _shift2d(x, dy, dx):
    """Edge-clamped shift of [K, H, W, ...]: out[y, x] = x[clamp(y+dy), clamp(x+dx)]."""
    import torch

    h, w = x.shape[1], x.shape[2]
    iy = torch.clamp(torch.arange(h, device=x.device) + dy, 0, h - 1)
    ix = torch.clamp(torch.arange(w, device=x.device) + dx, 0, w - 1)
    return x[:, iy][:, :, ix]


def _shifted_chain(evalf, D5, a, b, r):
    """The normal stencil as the first port evaluated it without offsets:
    the four tap maps counter-shifted, one M = 5 evaluation on the
    unshifted table, each tap shifted back and its clamp-collapsed border
    line evaluated again as a one-row image. ``evalf(D, a, b, r)`` ->
    [M, K, H, W, C]."""
    import torch

    h, w = D5.shape[2], D5.shape[3]

    def line(a_l, b_l, r_l, d_l):
        return evalf(d_l[None, :, None].contiguous(), a_l[:, None].contiguous(),
                     b_l[:, None].contiguous(), r_l[:, :, :, None].contiguous())[0, :, 0]

    def fix(q, dy, dx, d):
        out = _shift2d(q, dy, dx)
        if dy != 0:
            row = h - 1 if dy > 0 else 0
            out[:, row] = line(a[:, row], b[:, row], r[:, :, :, row], d[:, row])
        if dx != 0:
            col = w - 1 if dx > 0 else 0
            out[:, :, col] = line(a[:, :, col], b[:, :, col], r[:, :, :, :, col], d[:, :, col])
        return out

    taps = ((1, 0), (-1, 0), (0, -1), (0, 1))
    D = torch.stack([D5[0]] + [_shift2d(D5[i + 1][..., None], -dy, -dx)[..., 0]
                               for i, (dy, dx) in enumerate(taps)])
    q = evalf(D, a, b, r)
    return (q[0],) + tuple(fix(q[i + 1], dy, dx, D5[i + 1]) for i, (dy, dx) in enumerate(taps))


def _time_rounds(cs, fns, card, label, cold=True):
    """{key: [ms of 3 rounds]} by graph replay of back-to-back calls and,
    with ``cold``, {key: [ms]} with the L2 cold (chip_smoke._time_cold_ms),
    one cold reading a round."""
    order = list(fns) + list(fns)[::-1] + list(fns)
    times = {key: [] for key in fns}
    colds = {key: [] for key in fns}
    for key in order:
        times[key].append(cs._time_ms(fns[key], REPS, graph=True))
        if cold:
            colds[key].append(cs._time_cold_ms(fns[key], REPS, rounds=1))
    print(f"{label}; ms per call, CUDA-graph replay of {REPS} calls, 3 rounds"
          f"{', then L2 cold (each call after a 128 MB read)' if cold else ''} ({card})")
    return times, colds


def _print_step(key, desc, ts, cs_, bound=None):
    mean = sum(ts) / len(ts)
    line = f"  step {key} {desc}: " + ", ".join(f"{t:.4f}" for t in ts) + f"; mean {mean:.4f}"
    if cs_:
        cold = sum(cs_) / len(cs_)
        line += "; cold " + ", ".join(f"{t:.4f}" for t in cs_) + f"; mean {cold:.4f}"
    if bound is not None:
        line += f" ({bound / mean:.0%} of the bound warm"
        line += f", {bound / max(cold, 1e-9):.0%} cold)" if cs_ else ")"
    print(line)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("piecewise_steps: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from rgbd_recon_torch import native
    from rgbd_recon_torch.calibration.synthetic import bench_inputs
    from rgbd_recon_torch.ops import bricks, warp as warp_ops
    from rgbd_recon_torch.runtime import pipeline as pl
    from rgbd_recon_torch.utils.bench_golden import bench_config

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    lib = _build(native)
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    # the path's inputs: mark_bricks from a pinhole frame, kernel 5 from a
    # distorted one (both 4 x 512x424 sensors, 256^3)
    only = sys.argv[sys.argv.index("--kernel") + 1] if "--kernel" in sys.argv else None
    recorded = {}
    for label, distortion in (("pinhole", None), ("distorted", cs.DISTORT)):
        if only == {"pinhole": "5", "distorted": "4"}[label]:
            continue
        rig, bbox, frames = bench_inputs(4, 512, 424, (128, 256, 128), (128, 128, 128),
                                         cs.SEED, frames=1, distortion=distortion,
                                         device=dev if distortion else "cpu")
        pipe = pl.FramePipeline(rig, bench_config(bbox, 256), device=dev)
        mv, proj = pipe.default_camera()
        recs = {"mark_bricks": cs.Recorder(bricks, "mark_bricks"),
                "piecewise_eval": cs.Recorder(warp_ops, "piecewise_eval")}
        try:
            pipe.step(*frames[0], mv, proj)
            torch.cuda.synchronize()
        finally:
            for r in recs.values():
                r.restore()
        if label == "pinhole":
            recorded["mark_bricks"] = recs["mark_bricks"].calls[0][0]
        else:
            recorded["piecewise_eval"] = recs["piecewise_eval"].calls
        del pipe, rig, frames

    # -- kernel 5 ---------------------------------------------------------
    calls = {}
    for args, kw in recorded.get("piecewise_eval", ()):
        D, a = args[0], args[1]
        offs = kw.get("offsets")
        name = ("stencil" if offs is not None else "xyz" if a.shape[-1] == 3 else "uv")
        calls.setdefault(name, (args, offs))
    if calls:
        print(f"kernel 5 calls of the distorted frame: {len(recorded['piecewise_eval'])} "
              f"({', '.join(calls)})")
    for name, ((D, a, b, r, d_min, d_max), offs) in calls.items():
        m, k, h, w = D.shape
        c, s = r.shape[1], r.shape[2]
        span_t = torch.full((), d_max - d_min, dtype=torch.float32, device=dev)
        off_arr = (ctypes.c_int * 16)()
        if offs is not None:
            for i, (dy, dx) in enumerate(offs):
                off_arr[2 * i], off_arr[2 * i + 1] = dy, dx

        def knot_coords(Dm):
            dc = torch.clamp(Dm, d_min, d_max).contiguous()
            return dc, ((dc - d_min) / span_t * (s - 1)).contiguous()

        def run_step(step, variant, Dm, am, bm, rm, cc=None, with_offs=False):
            mm, kk, hh, ww = Dm.shape
            out = torch.empty((mm, kk, hh, ww, am.shape[-1]), device=dev)
            zero = (ctypes.c_int * 16)()
            rc = lib.rr_piecewise_step(
                step, variant, Dm.data_ptr(), cc.data_ptr() if cc is not None else None,
                am.data_ptr(), bm.data_ptr(), rm.data_ptr(), off_arr if with_offs else zero,
                out.data_ptr(), mm, kk, am.shape[-1], rm.shape[2], hh, ww, d_min, d_max,
                d_max - d_min, stream())
            if rc:
                raise RuntimeError(f"kernel 5 step {step}.{variant} failed to launch ({rc})")
            return out

        def step_fn(key):
            step, variant = key
            if step <= 2:
                def evalf(Dm, am, bm, rm):
                    dc, cc = knot_coords(Dm)
                    return run_step(step, variant, dc, am, bm, rm, cc)
            else:
                def evalf(Dm, am, bm, rm):
                    return run_step(step, variant, Dm, am, bm, rm, with_offs=step >= 4)
            if offs is not None and step <= 3:
                return lambda: _shifted_chain(evalf, D, a, b, r)
            return lambda: evalf(D, a, b, r)

        fns = {key: (step_fn(key) if key != "current" else
                     (lambda: warp_ops.piecewise_eval_cuda(D, a, b, r, d_min, d_max, offs)))
               for key in STEPS5}
        want = warp_ops.piecewise_eval_plain(D, a, b, r, d_min, d_max, offs)
        for key, fn in fns.items():
            got = fn()
            got = torch.stack(got) if isinstance(got, tuple) else got
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                dev_max = float((got - want).abs().max())
                raise RuntimeError(f"kernel 5 {name} step {key} differs from the plain "
                                   f"version (max {dev_max:.3e})")
        nbytes = m * k * h * w * (4 + 2 * c * 2 + 4 * c) + k * h * w * 8 * c
        bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
        times, colds = _time_rounds(cs, fns, card, f"kernel 5 {name}: M={m} K={k} {h}x{w} "
                                    f"C={c} S={s} offsets={offs}, bit for bit the plain "
                                    f"version; bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB)")
        for key, ts in times.items():
            _print_step(key, STEPS5[key], ts, colds[key], bound)

    # -- kernel 4 ---------------------------------------------------------
    if only == "5":
        return 0
    world, valid, grid = recorded["mark_bricks"]
    n = valid.numel()
    w2, v2 = world.reshape(n, 3).contiguous(), valid.reshape(n).contiguous()
    bx, by, bz = grid.res
    bmin = np.asarray(grid.bbox_min, np.float32)
    bsize = float(np.float32(grid.brick_size))
    want = bricks.mark_bricks_plain(world, valid, grid).to(torch.int64)

    def mark_step(step, sa, sb):
        def run():
            out = torch.empty((bz, by, bx), dtype=torch.int32, device=dev)
            rc = lib.rr_mark_step(step, sa, sb, w2.data_ptr(), v2.data_ptr(), out.data_ptr(),
                                  n, float(bmin[0]), float(bmin[1]), float(bmin[2]), bsize,
                                  bx, by, bz, stream())
            if rc:
                raise RuntimeError(f"kernel 4 step {step} failed to launch ({rc})")
            return out
        return run

    fns = {key: (mark_step(*key) if key != "current" else
                 (lambda: bricks.mark_bricks(world, valid, grid))) for key in STEPS4}
    for key, fn in fns.items():
        got = fn().to(torch.int64)
        torch.cuda.synchronize()
        if key != "current" and key[0] == 4 and key[2] != 2:
            continue    # cut down: computes part of the function
        if not torch.equal(got, want):
            raise RuntimeError(f"kernel 4 step {key} differs from the plain version")
    # the bytes the function needs: every valid flag, the 12 bytes of each
    # valid point (no other point is read), the counts written
    n_valid = int(valid.sum())
    nbytes = n + 12 * n_valid + bx * by * bz * 4
    bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
    times, colds = _time_rounds(cs, fns, card, f"kernel 4: {n} points ({n_valid} valid), "
                                f"{bx * by * bz} bins, exact; bound {bound:.5f} ms "
                                f"({nbytes / 1e6:.3f} MB)")
    for key, ts in times.items():
        _print_step(key, STEPS4[key], ts, colds[key], bound)

    # the worst case for adds to global bins: as many points, all valid, all
    # within 0.04 of one brick's center (its bin and up to 6 neighbours)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    center = torch.as_tensor(bmin + (np.array(grid.res) // 2 + 0.5) * bsize, device=dev)
    w2 = (center + (torch.rand((n, 3), generator=gen, device=dev) - 0.5) * 0.08).float()
    v2 = torch.ones(n, dtype=torch.bool, device=dev)
    world, valid = w2, v2
    want = bricks.mark_bricks_plain(world, valid, grid).to(torch.int64)
    worst = {key: fns[key] if key == "current" else mark_step(*key)
             for key in ((0, 0, 2), (2, 8, 4), (4, 8, 2), (5, 0, 2), (7, 16, 2), (7, 64, 2),
                         (7, 256, 2), (7, 64, 4), "current")}
    for key, fn in worst.items():
        if not torch.equal(fn().to(torch.int64), want):
            raise RuntimeError(f"kernel 4 step {key} differs from the plain version (one brick)")
    nbytes = n * 13 + bx * by * bz * 4
    bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
    times, colds = _time_rounds(cs, worst, card, f"kernel 4, every point in one brick: {n} "
                                f"points, {int((want > 0).sum())} bins hit, exact; bound "
                                f"{bound:.5f} ms ({nbytes / 1e6:.3f} MB)")
    for key, ts in times.items():
        _print_step(key, STEPS4[key], ts, colds[key], bound)

    # -- the launch floor ---------------------------------------------------
    floor = native.library().rr_launch_floor
    floor.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p]
    floor.restype = ctypes.c_int
    buf = torch.empty(bx * by * bz, dtype=torch.int32, device=dev)
    blocks = 2 * torch.cuda.get_device_properties(0).multi_processor_count
    fns = {f"empty {blk}x{thr}{' after a memset' if mem else ''}":
           (lambda blk=blk, thr=thr, mem=mem:
            floor(buf.data_ptr(), buf.numel() * 4 if mem else 0, blk, thr, stream()))
           for blk, thr in ((1, 32), (blocks, 256)) for mem in (False, True)}
    times, _ = _time_rounds(cs, fns, card, f"launch floor (memset of {buf.numel() * 4} bytes)",
                            cold=False)
    for key, ts in times.items():
        print(f"  {key}: " + ", ".join(f"{t:.4f}" for t in ts)
              + f"; mean {sum(ts) / len(ts):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

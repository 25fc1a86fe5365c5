#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # the checks below
    python3 chip_smoke.py --ladder   # phases 1, 2 and 15 alone
    python3 chip_smoke.py --sweep    # phases 1, 2 and 16 alone

Phases (any failure raises and the script exits non-zero without printing
a result line):

1. build      compile the CUDA kernels from rgbd_recon_torch/csrc with nvcc
              into rgbd_recon_torch/_build/ (seconds printed);
2. card       the card's name and power limit from nvidia-smi;
3. pinhole    the bench configuration built with the port's own calibration
              code — 4 Kinect-v2 sensors at 512x424 (pinhole rig), a 256^3
              TSDF with brick_size 0.1, a 1280x720 render with 6 LODs. A
              warm-up FramePipeline.step (session bakes) records the
              arguments each kernel wrapper receives; kernels 1-4, 10 and 11
              are held against their plain PyTorch versions on those arguments
              (deviation beside its tolerance; brick marking exactly) and
              both timed with CUDA events; then the path: launch counters
              set to 0, FramePipeline.step_timed on distinct frames,
              counters read — every kernel of the path must have launched;
              outputs finite, coverage > 0, check_capacity passes; stage
              means printed;
4. distorted  the same at the BENCH_DISTORT=0.004 rig (Kinect-magnitude lens
              distortion, NNI-like bake warp, offset rgb cameras; fwd_res
              (128, 256, 128), inv_res 128^3), rig and frames built on the
              card: the pixel-warp gate's tier log (piecewise, 48 knots),
              the bake seconds, kernel 5 (piecewise_eval) bit for bit
              against its plain version at each distinct call of the
              warm-up frame (xyz M=1 C=3, uv M=1 C=2, the normal stencil
              M=5 C=3 with its five offsets), and the path with kernels
              1-5, its kernel 5 launches counted by call (xyz 2, uv 1,
              stencil 1 a frame);
5. block      the pinhole rig at 240^3 (Vx % 128 = 112: the block-major
              integrator): kernel 6 (integrate_affine) and its path; on the
              path's recorded kernel-6 arguments, kernel 6 in raw mode
              (block-major blocks; held against its plain version on the
              visited blocks, with its own bound) then kernel 8
              (scatter_dense) must equal kernel 6's voxel-order output bit
              for bit, and kernel 8 its plain version exactly; then the
              assembly path (counters to 0,
              integrate_affine(raw=True) + scatter_dense, counters read);
6. table      the pinhole rig at 256^3 with use_affine=False (the dense warp
              table): kernel 7 (integrate_sparse) and its path;
7. gather     one small distorted frame with pw_warp_tol below the piecewise
              residual: the gate must log the exact gather tier;
8. parity     a small frame (3 sensors at 256x212, 128^3, 320x240) through
              the CUDA path and through the plain path on the CPU: hit
              masks, colors and depths must agree at the render-parity
              bounds the repo's tests use;
9. app        the kinect_client app path: the port writes a compressed
              reference-format scene into a temporary directory (4 Kinect-v2
              sensors at 512x424, the two-sphere scene, fwd_res (128, 256,
              128), inv_res 128^3, DXT1 color + u8 depth, 8 distinct noisy
              frames recorded) and a .conf (recon mode 1, 1280x720,
              voxel_size 0.01, brick_size 0.1, tsdf_limit 0.01); the wire
              decode on the card must equal the host decode bit for bit on
              every recorded frame; then ``rgbd_recon_torch.app.main`` replays
              16 frames on the card (on-device wire decode, a frame and
              texture dump on the last): the res it derives (208x224x208,
              the block-major integrator), kernels 2, 3, 4 and 6 launched,
              the app's wall and steady fps, the stage means of its
              ``mean_*.csv``, its PNGs read back, and its first frame within
              atol 1e-5 of a FramePipeline built from the in-memory rig and
              fed the host-decoded frame;
10. models    the reconstruction strategies (``models/``) on phase 9's scene:
              counters to 0, then ``rgbd_recon_torch.app.main`` replays 12
              frames with ``-serve`` on 127.0.0.1, 4 each in recon modes 0
              (points), 2 (trigrid, ``-draw-bricks`` on) and 3 (mvt), the
              switches posted to its control channel (each must be logged as
              applied, none refused); one ReconIntegration frame at
              voxel_size 0.01 / brick_size 0.1 and one ReconCalibs draw for
              sensor 1 at 1280x720; counters read: kernels 2, 3, 4 and kernel
              7's window mode (``integrate_sparse_window``, the XLA table
              integrator) must have launched; every frame finite with
              coverage > 0; the draw_<name> times and trigrid's scattered
              entries printed; kernel 7's window mode held against its plain
              form on the integration's call at the integrator bound and
              timed as its own kernel entry; then on phase 8's small frame
              (3 sensors at 256x212, 320x240) every strategy (points in shade
              modes 0-3, trigrid, mvt, calibs, integration) on the card
              against itself on the CPU at the render-parity bounds, with the
              pixels that differ counted;
11. reference the reference path (``fast_path`` or bricking off, unaligned
              volumes: voxel mask, dense integrators, per-ray marcher):
              (a) ``rgbd_recon_torch.app.main`` replays phase 9's scene with
              ``bricking: false`` (res 200x221x200 at align 1) for 4 frames,
              then POSTs to its control channel turn bricking on (208x224x208,
              the block-major integrator) and off again, 2 frames after each:
              each toggle logged with its res, every frame finite with
              coverage > 0, kernels 2 and 3 (and no brick marking or
              integrator kernel) launched with bricking off, kernels 2, 3, 4
              and 6 with it on; the stage means of its ``mean_ref,*.csv``;
              (b) ``fast_path=False`` at 256^3 on phase 3's rig and frames, 2
              frames through ``step_timed`` (kernels 2, 3 and 4 launched, stage
              means, hit fraction), and the brick skip's mean samples a ray
              against the same frame with ``skip_space=False``; (c) phase 8's
              small frame through the reference path on the card and on the
              CPU: the render-parity bounds and the TSDF at the integrator
              bound; (d) golden parity: phase 3's production volume (kernel
              1's bf16 z-major output) rendered by the oracle marcher and by
              the sweep at the four views of ``scripts/golden_parity.py`` at
              1280x720, every view at the render-parity bounds of
              tests/test_golden.py:65-69, each renderer's time printed;
12. fused     fused mode (``PipelineConfig.fused``: one CUDA graph replay a
              frame) on each of phases 3-6's pipelines after its staged run:
              one staged frame with the counters at 0, ``fused`` flipped on by
              assignment, ``warmup`` (the capture, its seconds logged), 2
              fused frames with the counters at 0 on the staged run's inputs:
              each bit for bit the staged frame (else the differing fields
              named with their largest deviation, and the render-parity and
              integrator bounds required), each kernel of the path launched
              by every replay as often as by a staged frame. At pinhole 256^3
              also: the frame medians over 20 step_timed frames staged, fused,
              staged (host clock, synced; the stage means, fused the whole
              replay under 3recon), kernels 1-4, 10 and 11 in the launch tally
              that the capture recorded (``FrameGraphs``' ``_Graph.launches``),
              the memory reserved staged, with 1 variant and with 6, the orbit
              (``warm_variants_async`` captures the other 5 variants on its
              thread; each variant's frame bit for bit the staged frame at its
              camera). Last, phase 11 (c)'s 128^3 frame on the reference path
              (one graph), fused against staged;
13. sharded   the sharded paths and the offline tools (``parallel/``,
              ``calibration.inverter``, ``io/native.py``): (a) a world of one
              under NCCL (TCP rendezvous on 127.0.0.1) at phase 3's
              configuration with the cull off (the default capacity):
              ``fast_sharded_step`` bit for bit ``FramePipeline.step``
              (kernels 1-4 launched, counted a frame); the default step (cull
              on) at the render-parity bounds, its TSDF at the integrator
              bound over the bricks its cull kept and clear in the others;
              the frame medians of the three over 5 frames; the world-of-one
              frames of (b); ``ReplayDriver`` with B = 2
              distinct frames bit for bit two steps; ``sharded_step`` at
              phase 11 (c)'s 128^3 bit for bit the reference path; the group
              destroyed. (b) 4 z-slabs of 64 on one card
              (``fast_sharded.sweep_slabs``: the per-rank functions rank by
              rank, pieces, halos and planes handed over) at each of the six
              sweep variants of the orbit cameras against the world-of-one
              frames of (a), bit for bit or, only where the slab flags show a
              window starting after an empty brick layer, the TSDF exact and
              the folded planes at the windowed-start bounds against the
              whole sweep (hit and samples exact, hit_s 5e-5, colors and
              gradients 1e-2); 240^3 refused over 4 ranks and run
              as 3 slabs of 80 (kernel 6) against its world of one. (c)
              ``python -m
              rgbd_recon_torch.scripts.calib_inverter`` on phase 9's scene at
              0.007 m (286x315x286, 4 sensors): seconds a sensor, device
              memory peak, each volume read back and held against the
              analytic inverse (median and p99 within 0.5 and 2 forward
              cells), the frustum share; the card against the CPU on a small
              scene (masks equal, atol 1e-5). (d) the native DXT decoder bit
              for bit ``io/dxt.py`` on phase 9's recorded planes, both timed;
14. jax       the card's frame against the JAX package's own outputs at the
              bench size, stored in tests/data/torch_bench_golden.npz
              (``rgbd_recon_torch/utils/bench_golden.py``): the file loaded
              and the sha256 of phase 3's rig and frame 0 checked against its
              digests (a missing file or a differing digest fails the run);
              then on frame 0, each with the counters at 0 and its kernels
              required: (a) the default 256^3 pipeline (kernels 1-4) against
              reference A, JAX's TPU formulation, stage by stage: the
              preprocessed fields at 65,536 drawn pixels, brick counts and
              the culled mask, the TSDF and the color volume at 262,144
              drawn voxels, and at five views (sweep axes 2, 2, 2, 0, 1) the
              sweep planes and the screen before and after hole filling;
              its ``step`` at the default camera the stages' frame bit for
              bit; (b) ``use_pallas=False`` (kernel 7's window mode) against
              reference B, JAX's own CPU frame: TSDF within 1e-5, screen at
              render parity; (c) ``use_affine=False`` (kernel 7's table
              mode) against B at the integrator bound; (d) 240^3 (kernel 6)
              against reference C. One line a comparison (its deviation
              beside its bound), then the phase's seconds;
15. ladder    the bench's other configurations (bench.py's knobs) against
              the JAX package's outputs stored in
              tests/data/torch_bench_golden_ladder.npz
              (``bench_golden.LADDER``): C, the complex scene at 256^3; S5
              and S2, rigs of 5 and 2 sensors at 256^3 (built on the host,
              seconds printed); L1 and L2, the 128^3 and 512^3 rungs on
              phase 3's rig. For each, the sha256 of its rig and frame 0
              checked, then ``FramePipeline`` on the card: ``warmup``, one
              staged frame whose launches must include kernels 1-4 with K
              registration warps and one screen warp, ``check_capacity``
              (occupied / capacity printed); with the counters at 0,
              LADDER_RUN staged frames over LADDER_FRAMES distinct frames
              (median, min, max, host clock synced; stage means), every
              kernel of the path launched; then fused: capture seconds,
              LADDER_RUN frames, memory reserved. The holds on frame 0: C,
              S5, S2 and L1 stage by stage against reference A at the
              default view (phase 14's bounds; the brick counts to
              ``bench_golden.COUNT_VOTES``, the bound between the JAX
              package's own two stage-1 formulations; the sweep planes on
              reference A's TSDF with the port's color volume, the render
              stage apart from the TSDF's flips, which the integrator bound
              holds: the planes on the port's own TSDF are printed beside
              the bound, the screens held at render parity); L2's 16^3
              masks before and after the depth-band cull exact, its counts
              as the others'; kernel 1 against its plain
              twin on the path's call at L2 and S5 (the integrator bound,
              timed as kernel entries); the sweep against the per-ray
              oracle on the production volume at golden_parity's four
              views at L2 and C (render parity, and at C also the complex
              scene's bounds of tests/test_complex_scene.py:139-142). One
              line a comparison, a summary, then the phase's seconds;
16. sweep     (run right after phase 3) the sweep kernel
              (``csrc/sweep_march.cu``) on phase 3's rig and frame 0 at
              256^3 and 512^3: the staged frame's sweep arguments recorded;
              at each (axis, flip), the default camera for its own and
              ``_orbit_camera`` for the others, the kernel against
              ``sweep_plain`` bit for bit on the frame's volumes and device
              flags and its graph-replayed ms (the time by axis); the
              default view as a kernel entry (L2-cold and plain ms, the
              bound of ``recon_bench/roofline.sweep_work`` on the frame's
              occupied blocks); one launch a fused frame.

Every kernel entry carries its time and, where one PyTorch call computes
the same function, that call's time (both from a CUDA graph of back-to-back
calls, the device's time alone; the kernel's eager time is printed too),
its time with the L2 cold (``cold_ms``: each call after a 128 MB read, that
read's own time subtracted), its plain version's time (eager: some plain
versions sync with the host), its launches on its path's run (per call
site for warp_screen and kernel 5), and the bound: the larger of its bytes
over 3.35 TB/s and its fp32 operations over 67 TFLOP/s (H100 SXM data
sheet), from this run's shapes, occupied counts and valid points.
Phase 3 also prints the launch floor once: an empty kernel at
mark_bricks' grid by CUDA-graph replay, alone and after a memset of its
counts. The kernels JSON line holds the launches of phases 3-6 and, for
kernel 7's window mode, of phase 10's path, and for kernel 1 at 512^3 and
at K = 5, of phase 15's staged frames; phase 9 prints its own. The
last three lines are a JSON object with one entry per kernel (one per
timed call of kernel 5), the card's name and power limit, and the result
object.
"""
from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 7
NUM_FRAMES = 4
PINHOLE_FRAMES = 2
APP_FRAMES = 8             # recorded frames of the app's scene, all distinct
APP_RUN = 16               # frames the app replays (two passes)
APP_TIMED_EVERY = 4        # the app's step_timed cadence (RGBD_TIMED_EVERY)
APP_CONF = ("recon_mode: 1\nscreenWidth: 1280\nscreenHeight: 720\nplay: true\n"
            "voxel_size: 0.01\nbrick_size: 0.1\ntsdf_limit: 0.01\n"
            # the navigator's 2.5 starts 15 m out; 0.35 puts the spheres on screen
            "zoom: 0.35\n")
DISTORT = 0.004            # bench.py BENCH_DISTORT: ~4 mm bake deformation
HOLEFILL = ("holefill_level", "holefill_resolve")   # kernel 11: the levels, the resolve
PATH_KERNELS = ("bilateral_accum", "quality", "mark_bricks", "warp_screen") + HOLEFILL
HBM_BYTES_PER_S = 3.35e12  # H100 SXM: device memory rate
FP32_OPS_PER_S = 67e12     # H100 SXM: float32 outside the tensor cores
FLUSH_BYTES = 128 << 20    # read between cold calls: 2.5x the H100's 50 MB L2
_FLUSH = []
# fp32 operations of one bilateral tap, an FMA counted as two: s - dc, the
# FMA 1 - dist * inv, gs * gr, wr += gr, wa += ws, the FMA bf += ws * s (the
# clamp at 0 is a max, not counted)
TAP_OPS = 1 + 2 + 1 + 1 + 1 + 2
# fp32 operations of one quality tap of a pixel inside (0, 1): s - d (the abs
# is an operand modifier), the window compare, min(dist, drm), the quotient,
# 1 - q, the border count and the range-weight sum
QUALITY_TAP_OPS = 7
# fp32 operations of one tap of a holefill pyramid level: the hole test, the
# depth-average sum, the keep test and the r, g, b and depth sums
HOLEFILL_TAP_OPS = 7
# fp32 operations of one pixel the holefill resolve blends: two upsampled
# values of 4 channels, each two row outputs and one column output of two
# products and two sums (2 * 4 * 3 * 4 = 96); s, t, the norm and the two
# weights (9); per channel two products, a sum and a quotient (16)
HOLEFILL_BLEND_OPS = 96 + 9 + 16
# fp32 operations of one (voxel, sensor) of the quadratic integrator, an FMA
# counted as two and a __fdividef as two (reciprocal, product); clamps,
# floors and compares not counted:
# - warp: 3 channels x 5 FMA of the slab-folded (y, x) quadratic = 30;
# - sampling: cu - iu, cv - iv, pu + 0.5, pv + 0.5 = 4;
# - LINEAR taps: 1 - sil at 4 taps, 1 - gu, 1 - gv, then per channel (5)
#   two row lerps (product + FMA: 3 each) and one column lerp (3) = 51;
# - fusion: sdist, new_tw, wt*tw + qual*sdist (3), its quotient (2),
#   dist, dist + 0.01, w_c (2), tc += r w_c (3 FMA: 6), tcw +=, w2 (2),
#   td += r w2 (6), tdw += = 27.
WARP_OPS = 3 * 5 * 2
FUSE_OPS = WARP_OPS + 4 + (4 + 2 + 5 * 9) + (1 + 1 + 3 + 2 + 1 + 1 + 2 + 6 + 1 + 2 + 6 + 1)
# per voxel once: fuse_color's reciprocal (2) and three products
COLOR_OPS = 2 + 3


def _fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 2


class Recorder:
    """Wraps a module-level function to keep the arguments of its calls in
    the warm-up frame (the main path's real inputs) and their host-clock
    seconds (synchronized)."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls = []
        self.seconds = []
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        import torch

        self.calls.append((args, kwargs))
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t0)
        return out

    def restore(self):
        setattr(self.module, self.name, self.fn)


class CallCounter:
    """Wraps a module-level function to count its calls by ``key(args,
    kwargs)``, keeping no arguments and adding no sync (for the path's own
    run)."""

    def __init__(self, module, name: str, key):
        self.module, self.name, self.key = module, name, key
        self.fn = getattr(module, name)
        self.counts = {}
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        k = self.key(args, kwargs)
        self.counts[k] = self.counts.get(k, 0) + 1
        return self.fn(*args, **kwargs)

    def restore(self):
        setattr(self.module, self.name, self.fn)


def _piecewise_call(args, kwargs) -> str:
    """Which of the frame's kernel 5 calls this is: the normal stencil (with
    offsets), xyz (C = 3) or uv (C = 2)."""
    if kwargs.get("offsets") is not None:
        return "stencil"
    return "xyz" if args[1].shape[-1] == 3 else "uv"


def _time_cold_ms(fn, reps: int, rounds: int = 3) -> float:
    """Mean ms of one call with the L2 cold: a CUDA graph of ``reps`` times
    (a read of FLUSH_BYTES, the call) against one of the ``reps`` reads
    alone, replayed in turn ``rounds`` times. The read evicts the call's
    inputs and writes back its output, as a frame's other work between two
    calls does; the difference of the two graphs is the call's time."""
    import torch

    if not _FLUSH:
        _FLUSH.append(torch.zeros(FLUSH_BYTES // 4, device="cuda"))
    buf = _FLUSH[0]
    fn()
    torch.cuda.synchronize()
    graphs = []
    for with_call in (True, False):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                buf.sum()
                if with_call:
                    fn()
        g.replay()
        graphs.append(g)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = [0.0, 0.0]
    for _ in range(rounds):
        for i, g in enumerate(graphs):
            start.record()
            g.replay()
            end.record()
            end.synchronize()
            total[i] += start.elapsed_time(end)
    return (total[0] - total[1]) / (rounds * reps)


def _time_ms(fn, reps: int, graph: bool = False) -> float:
    """Mean ms of one of ``reps`` back-to-back calls (CUDA events, after a
    warm-up call). ``graph``: the calls are captured once in a CUDA graph
    and replayed, so the time is the device's alone; eagerly, a call that
    takes the device less time than the host needs to enqueue it (the
    wrapper's checks and allocations) is timed at the host's pace."""
    import torch

    fn()
    torch.cuda.synchronize()
    run = fn
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        run, reps_run = g.replay, 1
    else:
        reps_run = reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps_run):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _bound(nbytes: float, ops: float):
    """(least ms for the work, what bounds it) on an H100 SXM."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _errs(a, b):
    import torch

    d = (a.to(torch.float64) - b.to(torch.float64)).abs().flatten()
    k = max(1, int(0.005 * d.numel()))
    return {"max": float(d.max()), "p995": float(torch.topk(d, k).values.min())}


class _Tee(io.TextIOBase):
    """stdout that also keeps what was written (the app's log lines)."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.out.write(s)
        self.text.append(s)
        return len(s)

    def flush(self):
        self.out.flush()


def _write_app_scene(work: str, frames):
    """Phase 9's scene in ``work``: the reference-format files of the
    4-sensor pinhole rig and APP_FRAMES compressed recorded frames. Returns
    (.ks path, stream paths, FrameFormat)."""
    from rgbd_recon_torch.calibration import synthetic
    from rgbd_recon_torch.io.stream import FrameFormat, StreamWriter
    from rgbd_recon_torch.utils.math import Bbox

    ks = synthetic.write_reference_scene(
        work, num_sensors=4, bbox=Bbox.default(), fwd_res=(128, 256, 128),
        inv_res=(128, 128, 128), width=512, height=424, compressed_rgb=1,
        compressed_depth=True)
    fmt = FrameFormat(512, 424, 512, 424, compressed_rgb=1, compressed_depth=True)
    rec = os.path.join(work, "recordings")
    os.makedirs(rec)
    paths = [os.path.join(rec, f"sensor{k}.stream") for k in range(4)]
    w = StreamWriter(paths, fmt)
    for depth, color in frames[:APP_FRAMES]:
        w.write(depth, color)
    w.close()
    return ks, paths, fmt


def _app_phase(rig, frames, card: str, work: str):
    """Phase 9 (module docstring). ``rig``/``frames``: the pinhole bench rig
    built in memory and its distinct noisy frames; ``work``: the directory
    the scene is written into (phases 10, 11 and 13 read it too). Returns
    ``_write_app_scene``'s (.ks path, stream paths, FrameFormat)."""
    import numpy as np
    import torch
    from rgbd_recon_torch import app as app_mod
    from rgbd_recon_torch import native
    from rgbd_recon_torch.io.stream import StreamReader
    from rgbd_recon_torch.ops.wire import make_wire_decoder
    from rgbd_recon_torch.runtime import integrator as integ_mod, pipeline as pl
    from rgbd_recon_torch.utils.math import perspective
    from rgbd_recon_torch.utils.navigator import CameraNavigator
    from rgbd_recon_torch.utils.png import read_png

    dev = torch.device("cuda")
    need = ("bilateral_accum", "quality", "mark_bricks", "warp_screen", "integrate_affine"
            ) + HOLEFILL
    t0 = time.perf_counter()
    scene = ks, paths, fmt = _write_app_scene(work, frames)
    rec, out_dir = os.path.dirname(paths[0]), os.path.join(work, "frames")
    conf = os.path.join(work, "run.conf")
    with open(conf, "w") as f:
        f.write(APP_CONF)
    size = sum(os.path.getsize(os.path.join(work, n)) for n in os.listdir(work)
               if os.path.isfile(os.path.join(work, n)))
    print(f"app: scene ({size / 1e6:.0f} MB) + {APP_FRAMES} recorded frames written in "
          f"{time.perf_counter() - t0:.1f} s; {4 * fmt.frame_size} B a frame on the wire "
          f"(DXT1 + u8 depth)")

    # the wire decode on the card, bit for bit the host decode
    reader = StreamReader(paths, fmt, looping=False)
    raws = [reader.read_raw() for _ in range(APP_FRAMES)]
    reader.close()
    if len({hashlib.sha1(c.tobytes() + d.tobytes()).digest() for c, d in raws}) \
            != APP_FRAMES:
        raise RuntimeError("the recorded frames are not all distinct")
    decode = make_wire_decoder(fmt)
    host = []
    for cp, dp in raws:
        hd = np.stack([fmt.decode_depth(p) for p in dp])
        hc = np.stack([fmt.decode_color(p) for p in cp])
        gd, gc = decode(torch.from_numpy(cp).to(dev), torch.from_numpy(dp).to(dev))
        if not (torch.equal(gd.cpu(), torch.from_numpy(hd))
                and torch.equal(gc.cpu(), torch.from_numpy(hc))):
            raise RuntimeError("the wire decode on the card differs from the host decode")
        host.append((hd, hc))
    print(f"app: wire decode on the card bitwise equal to the host decode (io/dxt.py, "
          f"FrameFormat.decode_depth) on all {APP_FRAMES} recorded frames")

    # the app: main() as a user runs it; its first frame and instance kept
    first = {}
    frame_step = app_mod.KinectClientApp.frame_step

    def keep_first(self):
        rgba = frame_step(self)
        if rgba is not None and not first:
            first.update(app=self, rgba=rgba.clone())
        return rgba

    for k in native.KERNELS.values():
        k.launches = 0
    tee = _Tee(sys.stdout)
    env = {"RGBD_TIMED_EVERY": str(APP_TIMED_EVERY), "RGBD_WIRE_DECODE": "auto"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    app_mod.KinectClientApp.frame_step = keep_first
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(tee):
            rc = app_mod.main([ks, conf, "-recordings", rec, "-outdir", out_dir,
                               "-dump-every", str(APP_RUN), "-dump-textures",
                               "-frames", str(APP_RUN)])
    finally:
        app_mod.KinectClientApp.frame_step = frame_step
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    wall = time.perf_counter() - t0
    counts = {name: k.launches for name, k in native.KERNELS.items()}
    app = first.pop("app")
    pipe = app.pipeline
    res = pipe.tsdf_cfg.res
    print(f"app: main() exit {rc} after {app._frames_done} frames, {wall:.1f} s (host "
          f"clock, scene load and session bakes included); volume res {res} from "
          f"voxel_size {pipe.cfg.voxel_size} ({pipe.integrator.tier} "
          f"integrator), occupied-brick capacity {pipe.max_bricks}")
    if rc != 0 or app._frames_done != APP_RUN:
        raise RuntimeError(f"the app ran {app._frames_done} frames (exit {rc})")
    if res != (208, 224, 208) or pipe.integrator.tier != integ_mod.BLOCK_MAJOR:
        raise RuntimeError(f"the app did not take the block-major integrator at {res}")
    if app._wire_decode is None:
        raise RuntimeError("the app decoded the compressed streams on the host")
    print(f"app: kernel launches over the run: {counts}")
    missing = [k for k in need if counts[k] == 0]
    if missing:
        raise RuntimeError(f"app: kernels never launched: {missing}")
    print("app: kernels 2, 3, 4 and 6 launched: " + ", ".join(
        f"{k} {counts[k]}" for k in ("warp_screen", "bilateral_accum", "mark_bricks",
                                     "integrate_affine")))
    log = "".join(tee.text).splitlines()
    for key in ("app wall fps", "app steady fps"):
        lines = [ln for ln in log if ln.startswith(key)]
        if not lines:
            raise RuntimeError(f"the app logged no '{key}' line")
        print(f"app: {lines[-1]} ({card})")

    # its CSVs and PNGs, read back
    csv = {}
    for kind in ("mean", "min", "max"):
        found = glob.glob(os.path.join(work, f"{kind}_run,*.csv"))
        if len(found) != 1:
            raise RuntimeError(f"the app wrote {len(found)} {kind}_run,*.csv files")
        with open(found[0]) as f:
            header, values = f.read().splitlines()
        names = [n.strip('"') for n in header.split(",")[1:]]
        csv[kind] = dict(zip(names, (float(v) for v in values.split(",")[1:])))
    print(f"app: {os.path.basename(found[0])[4:]} stage means (min, max) in ms over the "
          f"{-(-APP_RUN // APP_TIMED_EVERY)} timed frames (CUDA events; draw: host "
          f"clock to a synced frame; {card}): " + ", ".join(
              f"{n} {csv['mean'][n]:.3f} ({csv['min'][n]:.3f}, {csv['max'][n]:.3f})"
              for n in sorted(csv["mean"])))
    png = read_png(os.path.join(out_dir, f"frame_{APP_RUN:05d}.png"))
    textures = glob.glob(os.path.join(out_dir, f"frame_{APP_RUN:05d}_k*_*.png"))
    if png.shape != (720, 1280, 4) or len(textures) != 4 * 5:
        raise RuntimeError(f"the app's dump: {png.shape}, {len(textures)} textures")
    print(f"app: dump frame_{APP_RUN:05d}.png {png.shape[1]}x{png.shape[0]}, coverage "
          f"{float((png[..., 3] > 0).mean()):.4f}; {len(textures)} texture PNGs")
    del app, pipe

    # the app's first frame against the in-memory rig fed the host decode
    mcfg = pl.PipelineConfig(render_width=1280, render_height=720, voxel_size=0.01,
                             brick_size=0.1, tsdf_limit=0.01)
    mpipe = pl.FramePipeline(rig, mcfg, device=dev)
    nav = CameraNavigator(zoom=0.35)
    nav.resize(1280, 720)
    out = mpipe.step(*host[0], nav.modelview(), perspective(50.0, 1280 / 720, 0.1, 200.0))
    err = float((out.color - first["rgba"]).abs().max())
    cov = float(out.hit.float().mean())
    print(f"app: first frame vs FramePipeline(in-memory rig, host-decoded frame): max abs "
          f"err {err:.3e} (atol 1e-5, tests/test_app.py:187), coverage {cov:.4f}")
    if not (err <= 1e-5 and cov > 0.0):
        raise RuntimeError("the app's first frame differs from the in-memory pipeline's")
    return scene


MODELS_CONF = APP_CONF.replace("recon_mode: 1", "recon_mode: 0")
MODELS_RUN = ((0, False), (2, True), (3, False))   # (recon mode, draw bricks), 4 frames each
MODELS_FRAMES = 4


def _models_phase(rig, frames, card: str, work: str, check_integrator, integrator_work,
                  launches: dict) -> None:
    """Phase 10 (module docstring). ``work`` holds phase 9's scene;
    ``check_integrator`` / ``integrator_work``: main()'s helpers (kernel
    entry with its bound); ``launches``: main()'s launch record."""
    import json as _json
    import urllib.request

    import numpy as np
    import torch
    from rgbd_recon_torch import app as app_mod
    from rgbd_recon_torch import models, native
    from rgbd_recon_torch.calibration.synthetic import bench_inputs
    from rgbd_recon_torch.ops import tsdf_sparse
    from rgbd_recon_torch.ops.raymarch import RenderCamera
    from rgbd_recon_torch.ops.tsdf_fast import pack_frames
    from rgbd_recon_torch.runtime import pipeline as pl
    from rgbd_recon_torch.utils.math import perspective
    from rgbd_recon_torch.utils.metrics import render_parity, render_parity_passes
    from rgbd_recon_torch.utils.navigator import CameraNavigator
    from rgbd_recon_torch.utils.timers import TimerDatabase

    dev = torch.device("cuda")
    ks, rec = os.path.join(work, "scene.ks"), os.path.join(work, "recordings")
    conf = os.path.join(work, "models.conf")
    with open(conf, "w") as f:
        f.write(MODELS_CONF)

    # the path: counters to 0, the app in modes 0, 2, 3 (switched over the
    # control channel, -draw-bricks in mode 2), then ReconIntegration and
    # ReconCalibs on the app's last frame; counters read
    for k in native.KERNELS.values():
        k.launches = 0
    TimerDatabase.instance().reset()
    shots, kept = {}, {}
    frame_step = app_mod.KinectClientApp.frame_step

    def step(self):
        n = self._frames_done
        if n and n % MODELS_FRAMES == 0 and n // MODELS_FRAMES < len(MODELS_RUN):
            mode, bricks = MODELS_RUN[n // MODELS_FRAMES]
            body = _json.dumps({"recon_mode": mode, "draw_bricks": bricks}).encode()
            req = urllib.request.Request(f"http://127.0.0.1:{self.viewer.port}/control",
                                         data=body, method="POST")
            if not _json.load(urllib.request.urlopen(req, timeout=30))["ok"]:
                raise RuntimeError(f"the control channel refused {body}")
        rgba = frame_step(self)        # applies the command, then draws
        mode = self.cfg.recon_mode
        if rgba is not None:
            kept.update(app=self)
            shots.setdefault(mode, []).append(
                rgba.clone() if isinstance(rgba, torch.Tensor) else torch.from_numpy(rgba))
        return rgba

    tee = _Tee(sys.stdout)
    app_mod.KinectClientApp.frame_step = step
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(tee):
            rc = app_mod.main([ks, conf, "-recordings", rec, "-outdir",
                               os.path.join(work, "frames_models"), "-serve", "0",
                               "-frames", str(MODELS_FRAMES * len(MODELS_RUN))])
    finally:
        app_mod.KinectClientApp.frame_step = frame_step
    app = kept.pop("app")
    print(f"models: main() exit {rc} after {app._frames_done} frames in modes "
          f"{[m for m, _ in MODELS_RUN]} ({MODELS_FRAMES} each), {time.perf_counter() - t0:.1f} s "
          f"(host clock, scene load and session bakes included)")
    log = "".join(tee.text).splitlines()
    switches = [ln for ln in log if "control: recon_mode ->" in ln]
    refused = [ln for ln in log if "refused" in ln]
    print(f"models: control channel: {switches}")
    if rc != 0 or refused or len(switches) != len(MODELS_RUN) - 1:
        raise RuntimeError(f"the mode switches were not applied: {switches} {refused}")
    for mode, bricks in MODELS_RUN:
        imgs = shots.get(mode, [])
        last = imgs[-1] if imgs else torch.zeros(1, 1, 4)
        cov = float((last[..., 3] > 0).float().mean())
        ok = (len(imgs) == MODELS_FRAMES and tuple(last.shape) == (720, 1280, 4)
              and all(bool(torch.isfinite(i).all()) for i in imgs) and cov > 0)
        print(f"models: mode {mode} ({app_mod.MODE_NAMES[mode]}{', -draw-bricks' if bricks else ''}): "
              f"{len(imgs)} frames, coverage {cov:.4f}{'' if ok else ' FAIL'}")
        if not ok:
            raise RuntimeError(f"recon mode {mode}: frames not finite or empty")

    # ReconIntegration at voxel_size 0.01 / brick_size 0.1, ReconCalibs for
    # sensor 1, on the last recorded frame
    ctx = app.models[0].ctx
    nav = CameraNavigator(zoom=0.35)
    nav.resize(1280, 720)
    cam = RenderCamera(torch.from_numpy(nav.modelview()).to(dev),
                       torch.from_numpy(perspective(50.0, 1280 / 720, 0.1, 200.0)).to(dev),
                       1280, 720)
    pframes = app.pipeline.preprocess(*frames[MODELS_FRAMES - 1])
    integ = models.ReconIntegration(ctx, voxel_size=0.01, brick_size=0.1)
    rec7 = Recorder(tsdf_sparse, "integrate_sparse_cuda")
    try:
        icolor = integ.draw_f(pframes, cam)
    finally:
        rec7.restore()
    calibs = models.ReconCalibs(ctx)
    calibs.set_active_kinect(1)
    ccolor = calibs.draw_f(pframes, cam)
    torch.cuda.synchronize()
    counts = {name: k.launches for name, k in native.KERNELS.items()}
    print(f"models: launches over the path (app modes 0/2/3, integration, calibs): {counts}")
    need = ("warp_screen", "bilateral_accum", "quality", "mark_bricks",
            "integrate_sparse_window") + HOLEFILL
    if any(counts[k] == 0 for k in need):
        raise RuntimeError(f"models: kernels never launched: "
                           f"{[k for k in need if counts[k] == 0]}")
    launches["integrate_sparse[xla window]"] = counts["integrate_sparse_window"]
    for name, img in (("integration", icolor), ("calibs", ccolor)):
        cov = float((img[..., 3] > 0).float().mean())
        print(f"models: {name} 1280x720 coverage {cov:.4f}")
        if not (bool(torch.isfinite(img).all()) and cov > 0):
            raise RuntimeError(f"models: {name} frame not finite or empty")
    print(f"models: integration res {integ.volume_res}, occupied ratio "
          f"{integ.occupied_ratio():.4f}")
    db = TimerDatabase.instance()
    print("models: draw times, host clock to the synced image, mean (min) over the frames "
          f"({card}): " + ", ".join(
              f"{n} {db.timers[n].mean * 1e3:.3f} ({db.timers[n].vmin * 1e3:.3f}) ms x"
              f"{db.timers[n].count}" for n in sorted(db.timers) if n.startswith("draw_")
              and db.timers[n].count))
    trig = app.models[2]
    n_pts = pframes.depth.shape[0] * pframes.depth.shape[1] * pframes.depth.shape[2]
    print(f"models: trigrid footprint cap {trig.footprint_cap} px -> "
          f"{trig.footprint_cap ** 2} offsets x {n_pts} points = "
          f"{trig.footprint_cap ** 2 * n_pts / 1e6:.1f} M entries scattered a pass; points "
          f"9 x {n_pts} = {9 * n_pts / 1e6:.1f} M")

    # kernel 7's window mode against its plain form on the integration's call
    (packed, pos, idx, count, woff, res, limit, window), _ = rec7.calls[0]
    n_occ = int(count)
    print(f"  integrate_sparse[xla window]: {n_occ} occupied bricks at {res}, window {window}")
    check_integrator("integrate_sparse[xla window]", "rgbd_recon_torch/csrc/integrate_sparse.cu",
                     "rgbd_recon_tpu/ops/tsdf_fast.py:233",
                     lambda: tsdf_sparse.integrate_sparse_cuda(*rec7.calls[0][0]),
                     lambda: tsdf_sparse.integrate_sparse_plain(*rec7.calls[0][0]), limit, 5,
                     *integrator_work(packed, n_occ, 4 + n_occ * 4, res, 20, 4096 * 12 + 8,
                                      FUSE_OPS - WARP_OPS))
    del app, integ, calibs, rec7, pframes, shots

    # parity: each strategy on the card against itself on the CPU, on
    # phase 8's small frame (3 sensors at 256x212, 320x240)
    srig, sbbox, sframes = bench_inputs(3, 256, 212, (48, 64, 48), (48, 48, 48), SEED,
                                        frames=1)
    voxel = float(np.max(sbbox.size) / 64)
    cfg = pl.PipelineConfig(render_width=320, render_height=240, tsdf_res=(64, 64, 64),
                            voxel_size=voxel, brick_size=0.2)
    out = {}
    for d in (dev, torch.device("cpu")):
        p = pl.FramePipeline(srig, cfg, device=d)
        smv, sproj = p.default_camera()
        fr = p.preprocess(*sframes[0])
        sctx = models.ReconContext(rig=srig, bbox=sbbox, width=320, height=240, device=d)
        scam = RenderCamera(torch.from_numpy(smv).to(d), torch.from_numpy(sproj).to(d), 320, 240)
        strategies = {f"points[{m}]": models.ReconPoints(sctx, m) for m in range(4)}
        strategies.update(trigrid=models.ReconTrigrid(sctx), mvt=models.ReconMVT(sctx),
                          calibs=models.ReconCalibs(sctx),
                          integration=models.ReconIntegration(sctx, voxel_size=voxel,
                                                              brick_size=0.2))
        for name, m in strategies.items():
            out.setdefault(name, []).append(
                [x.float().cpu().numpy() for x in m.draw_with_depth(fr, scam)])
    for name, ((gc, gd), (cc, cd)) in out.items():
        def hit(color, depth):
            return depth < 1.0 if name == "integration" else color[..., 3] > 0

        g = types.SimpleNamespace(color=gc, depth=gd, hit=hit(gc, gd))
        h = types.SimpleNamespace(color=cc, depth=cd, hit=hit(cc, cd))
        st = render_parity(h, g)
        differ = int(((g.hit != h.hit) | (np.abs(gc - cc).max(-1) > 1e-3)).sum())
        ok = render_parity_passes(st) and st["hit_frac"] > 0.02
        print(f"models parity {name} cuda vs cpu: hit agreement {st['hit_agreement']:.5f}, "
              f"psnr {st['psnr_rgb']:.2f} dB, ssim {st['ssim_rgb']:.5f}, depth err median "
              f"{st['depth_err_med']:.2e} p99 {st['depth_err_p99']:.2e}, coverage "
              f"{st['hit_frac']:.4f}, pixels differing {differ} of {gc.shape[0] * gc.shape[1]}"
              f"{'' if ok else ' FAIL'}")
        if not ok:
            raise RuntimeError(f"models: {name} on the card disagrees with the CPU")


REF_CONF = APP_CONF + "bricking: false\n"
REF_TOGGLES = {4: {"bricking": True}, 6: {"bricking": False}}   # before frame n
REF_FRAMES = 8
REF_BENCH_FRAMES = 2


def _launches():
    from rgbd_recon_torch import native

    return {name: k.launches for name, k in native.KERNELS.items()}


def _reference_phase(rig, bbox, frames, golden, mv, proj, card: str, work: str,
                     drive) -> None:
    """Phase 11 (module docstring): the reference path. ``rig``/``frames``:
    phase 3's; ``golden``: phase 3's production volume; ``work``: phase 9's
    scene; ``drive``: main()'s path runner."""
    import json as _json
    import urllib.request

    import numpy as np
    import torch
    from rgbd_recon_torch import app as app_mod
    from rgbd_recon_torch import native
    from rgbd_recon_torch.calibration.synthetic import bench_inputs
    from rgbd_recon_torch.runtime import pipeline as pl
    from rgbd_recon_torch.scripts import golden_parity
    from rgbd_recon_torch.utils.metrics import render_parity, render_parity_passes
    from rgbd_recon_torch.utils.timers import TimerDatabase

    dev = torch.device("cuda")

    # (a) the app with bricking off, then on and off over the control channel
    ks, rec = os.path.join(work, "scene.ks"), os.path.join(work, "recordings")
    conf = os.path.join(work, "ref.conf")
    with open(conf, "w") as f:
        f.write(REF_CONF)
    for k in native.KERNELS.values():
        k.launches = 0
    TimerDatabase.instance().reset()
    snaps, shots = [], []
    frame_step = app_mod.KinectClientApp.frame_step

    def step(self):
        cmd = REF_TOGGLES.get(self._frames_done)
        if cmd is not None:
            req = urllib.request.Request(f"http://127.0.0.1:{self.viewer.port}/control",
                                         data=_json.dumps(cmd).encode(), method="POST")
            if not _json.load(urllib.request.urlopen(req, timeout=30))["ok"]:
                raise RuntimeError(f"the control channel refused {cmd}")
        t = time.perf_counter()
        rgba = frame_step(self)        # applies the command, then draws (synced: timed)
        if rgba is not None:
            shots.append((bool(torch.isfinite(rgba).all()),
                          float((rgba[..., 3] > 0).float().mean()), time.perf_counter() - t))
            snaps.append(_launches())
        return rgba

    tee = _Tee(sys.stdout)
    saved = os.environ.get("RGBD_TIMED_EVERY")
    os.environ["RGBD_TIMED_EVERY"] = "1"
    app_mod.KinectClientApp.frame_step = step
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(tee):
            rc = app_mod.main([ks, conf, "-recordings", rec, "-outdir",
                               os.path.join(work, "frames_ref"), "-serve", "0",
                               "-frames", str(REF_FRAMES)])
    finally:
        app_mod.KinectClientApp.frame_step = frame_step
        if saved is None:
            os.environ.pop("RGBD_TIMED_EVERY")
        else:
            os.environ["RGBD_TIMED_EVERY"] = saved
    print(f"reference (a): app main() exit {rc} after {len(shots)} frames, "
          f"{time.perf_counter() - t0:.1f} s (host clock, scene load and bakes included)")
    log = "".join(tee.text).splitlines()
    start = [ln for ln in log if "volume res (200, 221, 200) at voxel_size 0.01" in ln]
    toggles = [ln.split("] ", 1)[-1] for ln in log if "control: bricking" in ln]
    print(f"reference (a): start-up {start[:1]}; toggles {toggles}")
    want = ["control: bricking on: volume res (208, 224, 208) (brick-sparse path)",
            "control: bricking off: volume res (200, 221, 200) (reference path)"]
    if rc != 0 or len(shots) != REF_FRAMES or not start or \
            [t[-len(w):] for t, w in zip(toggles, want)] != want or len(toggles) != 2:
        raise RuntimeError(f"the app's bricking toggles: exit {rc}, {len(shots)} frames, "
                           f"{toggles}")
    if any("refused" in ln for ln in log):
        raise RuntimeError("the app refused a command")
    print("reference (a): frames (finite, coverage, host ms of frame_step incl. its sync): "
          + ", ".join(f"{'ok' if fin else 'NaN'} {cov:.4f} {sec * 1e3:.1f}"
                      for fin, cov, sec in shots))
    if not all(fin and cov > 0 for fin, cov, _ in shots):
        raise RuntimeError("reference (a): a frame is not finite or empty")
    zero = dict.fromkeys(snaps[0], 0)
    segs = {"off": (0, 4), "on": (4, 6), "off again": (6, 8)}
    for seg, (i, j) in segs.items():
        a, b = (snaps[i - 1] if i else zero), snaps[j - 1]
        d = {k: b[k] - a[k] for k in b if b[k] - a[k]}
        sec = [x[2] for x in shots[i:j]]
        print(f"reference (a): bricking {seg}: launches over its {j - i} frames {d}; frame_step "
              f"host ms {', '.join(f'{x * 1e3:.1f}' for x in sec)} ({card})")
        need = (("warp_screen", "bilateral_accum", "quality", "mark_bricks", "integrate_affine")
                if seg == "on" else ("warp_screen", "bilateral_accum", "quality")) + HOLEFILL
        absent = () if seg == "on" else ("mark_bricks", "integrate_affine")
        if any(k not in d for k in need) or any(k in d for k in absent):
            raise RuntimeError(f"reference (a): bricking {seg} launched {d}")
    found = glob.glob(os.path.join(work, "mean_ref,*.csv"))
    if len(found) != 1:
        raise RuntimeError(f"the app wrote {len(found)} mean_ref,*.csv files")
    with open(found[0]) as f:
        header, values = f.read().splitlines()
    names = [n.strip('"') for n in header.split(",")[1:]]
    print(f"reference (a): {os.path.basename(found[0])} stage means in ms over its "
          f"{REF_FRAMES} timed frames (off, on, off; CUDA events; draw: host clock; {card}): "
          + ", ".join(f"{n} {float(v):.3f}" for n, v in zip(names, values.split(",")[1:])))

    # (b) fast_path=False at the bench config: phase 3's rig and frames
    rcfg = pl.PipelineConfig(render_width=1280, render_height=720, tsdf_res=(256,) * 3,
                             voxel_size=float(np.max(bbox.size) / 256), brick_size=0.1,
                             num_lods=6, fast_path=False)
    pipe = pl.FramePipeline(rig, rcfg, device=dev, log=lambda s: print(f"  {s}"))
    if pipe.use_fast:
        raise RuntimeError("fast_path=False did not take the reference path")
    pipe.step(*frames[0], mv, proj)       # session bakes
    outs = drive("reference 256^3", pipe, frames, mv, proj,
                 ("warp_screen", "bilateral_accum", "quality", "mark_bricks") + HOLEFILL,
                 REF_BENCH_FRAMES,
                 rcfg.tsdf_res)
    skip = float(outs[0].num_samples.float().mean())
    pipe._configure(rcfg._replace(skip_space=False), keep_warp_bake=True)
    noskip = pipe.step(*frames[0], mv, proj)
    full = float(noskip.num_samples.float().mean())
    hit = float(outs[0].hit.float().mean())
    print(f"reference 256^3: hit fraction {hit:.4f}; mean samples a ray {skip:.2f} with the "
          f"brick skip, {full:.2f} without (same frame, {full / max(skip, 1e-9):.1f}x), hit "
          f"fraction without {float(noskip.hit.float().mean()):.4f}")
    if not skip < full:
        raise RuntimeError("the brick skip did not shorten the march")
    del pipe, outs, noskip

    # (c) card against CPU: phase 8's small frame through the reference path
    srig, sbbox, sframes = bench_inputs(3, 256, 212, (48, 64, 48), (48, 48, 48), SEED,
                                        frames=1)
    scfg = pl.PipelineConfig(render_width=320, render_height=240, tsdf_res=(128, 128, 128),
                             voxel_size=float(np.max(sbbox.size) / 128), sweep_res=(256, 256),
                             fast_path=False)
    res = {}
    for d in (dev, torch.device("cpu")):
        p = pl.FramePipeline(srig, scfg, device=d)
        smv, sproj = p.default_camera()
        o = p.step(*sframes[0], smv, sproj)
        res[d.type] = types.SimpleNamespace(color=o.color.cpu().numpy(),
                                            depth=o.depth.cpu().numpy(),
                                            hit=o.hit.cpu().numpy(), tsdf=o.tsdf.cpu())
    g, c = res["cuda"], res["cpu"]
    st = render_parity(c, g)
    dv = (g.tsdf - c.tsdf).abs()
    off = float((dv > 1e-4).float().mean())
    occ, cocc = int((g.tsdf > -0.01 + 1e-9).sum()), int((c.tsdf > -0.01 + 1e-9).sum())
    ok = (render_parity_passes(st) and st["hit_frac"] > 0.02 and off < 1e-4
          and abs(occ - cocc) <= max(100, 0.002 * cocc) and cocc > 1000)
    print(f"reference (c) cuda vs cpu at 128^3, 320x240: hit agreement "
          f"{st['hit_agreement']:.5f}, psnr {st['psnr_rgb']:.2f} dB, ssim {st['ssim_rgb']:.5f}, "
          f"depth err median {st['depth_err_med']:.2e} p99 {st['depth_err_p99']:.2e} max "
          f"{st['depth_err_max']:.2e}, max color dev {np.abs(g.color - c.color).max():.3e}, "
          f"coverage {st['hit_frac']:.4f}; tsdf max dev {float(dv.max()):.3e}, voxels off "
          f">1e-4 {off:.2e}, occupied {occ} vs {cocc} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("reference (c): the card disagrees with the CPU")
    del res, g, c, p, o

    # (d) golden parity: the oracle and the sweep on phase 3's production
    # volume at the four views of scripts/golden_parity.py, 1280x720
    rows = golden_parity.renderer_parity(
        golden["vol"], golden["cvol"], bbox, golden["limit"], proj, 1280, 720,
        golden["sweep_res"], golden["zmajor"], log=lambda s: None)
    print(f"reference (d): golden parity, oracle marcher vs sweep on the 256^3 production "
          f"volume (bf16, z-major), 1280x720; seconds are host clock to a synchronised "
          f"result ({card}):")
    print(golden_parity.table(rows))
    bad = [r["view"] for r in rows if not render_parity_passes(r)]
    if bad:
        raise RuntimeError(f"reference (d): views outside the render-parity bounds: {bad}")


FUSED_FRAMES = 2           # fused frames held against the staged frames, each path
FUSED_BENCH = 20           # fused and staged frames timed at pinhole 256^3
OUT_FIELDS = ("color", "depth", "hit", "tsdf", "occupied_ratio", "num_samples",
              "occupied_bricks")


def _orbit_camera(pipe, axis: int, flip: bool):
    """A view whose sweep is (axis, flip): the eye 3 m off the volume center
    along that axis (a little off-axis, so no tie), looking at the center."""
    import numpy as np
    from rgbd_recon_torch.ops import raymarch as rm, raymarch_fast as rmf
    from rgbd_recon_torch.utils.math import look_at

    center = (pipe.bbox.min + pipe.bbox.max) * 0.5
    d = np.array([0.25, 0.35, 0.3], np.float32)
    d[axis] = 3.0 if flip else -3.0
    mv = look_at(center + d, center, [0, 0, 1] if axis == 1 else [0, 1, 0])
    if rmf.pick_axis(mv, rm.vol_to_world_matrix(pipe.bbox)) != (axis, flip):
        raise RuntimeError(f"the orbit camera of {(axis, flip)} picks another sweep")
    return mv


def _same_frame(label: str, got, want) -> None:
    """Phase 12's comparison: bit for bit on every FrameOutput field. If a
    field differs, it is named with its largest deviation, and the frame
    must meet the render-parity bounds and the TSDF the integrator bound
    (tests/test_golden.py:65-69, tests/test_tsdf_affine.py:109-116)."""
    import numpy as np
    import torch
    from rgbd_recon_torch.utils.metrics import render_parity, render_parity_passes

    diff = {f: float((getattr(got, f).double() - getattr(want, f).double()).abs().max())
            for f in OUT_FIELDS if not torch.equal(getattr(got, f), getattr(want, f))}
    if not diff:
        return
    host = [types.SimpleNamespace(color=o.color.cpu().numpy(), depth=o.depth.cpu().numpy(),
                                  hit=o.hit.cpu().numpy()) for o in (want, got)]
    st = render_parity(*host)
    v, pv = got.tsdf.float(), want.tsdf.float()
    off = float(((v - pv).abs() > 1e-4).float().mean())
    ok = render_parity_passes(st) and off < 1e-4
    print(f"{label}: fused differs from staged in {sorted(diff)} (max deviation "
          f"{diff}); render parity {st}, tsdf voxels off >1e-4 {off:.2e} -> "
          f"{'within the bounds' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{label}: the fused frame is outside the bounds of the staged")


def _fused_phase(label: str, pipe, frames, mv, proj, staged_outs, need, card: str) -> None:
    """Phase 12 on one path (module docstring): one staged frame with the
    counters at 0 (its launches a frame), then ``fused`` flipped on by
    assignment, ``warmup`` (the capture, seconds logged) and FUSED_FRAMES
    fused frames with the counters at 0: each bit for bit the staged frame
    on the same inputs (``staged_outs``), every kernel of ``need`` launched
    by each replay as often as by the staged frame."""
    import torch
    from rgbd_recon_torch import native

    for k in native.KERNELS.values():
        k.launches = 0
    pipe.step(*frames[0], mv, proj)
    torch.cuda.synchronize()
    per_frame = {n: k.launches for n, k in native.KERNELS.items() if k.launches}
    log = pipe._log
    pipe.cfg = pipe.cfg._replace(fused=True)
    pipe.warmup(*frames[0], mv, proj)
    torch.cuda.synchronize()
    for k in native.KERNELS.values():
        k.launches = 0
    outs = [pipe.step(*frames[i], mv, proj) for i in range(FUSED_FRAMES)]
    torch.cuda.synchronize()
    counts = {n: k.launches for n, k in native.KERNELS.items() if k.launches}
    per_replay = {n: c / FUSED_FRAMES for n, c in counts.items()}
    print(f"fused {label}: launches in {FUSED_FRAMES} replays {counts} (the staged frame: "
          f"{per_frame}); captured variants {pipe._graphs.keys()}")
    missing = [n for n in need if counts.get(n, 0) == 0]
    if missing or per_replay != per_frame:
        raise RuntimeError(f"fused {label}: kernels {missing} not launched, or launches a "
                           f"replay {per_replay} != a staged frame's {per_frame}")
    for i, o in enumerate(outs):
        _same_frame(f"fused {label} frame {i}", o, staged_outs[i])
    log(f"fused {label}: {FUSED_FRAMES} frames bit for bit the staged frames ({card})")


def _fused_pinhole(pipe, frames, mv, proj, card: str, reserved_0: int) -> None:
    """Phase 12's pinhole extras on phase 3's pipeline, fused and captured:
    the medians over FUSED_BENCH frames fused and staged, kernels 1-4 and
    10 in the launch tally its capture recorded, the memory reserved with 1
    and 6 variants, and the orbit of the 6 variants through
    warm_variants_async, each bit for bit the staged frame.
    ``reserved_0``: the memory reserved before the first capture."""
    import numpy as np
    import torch
    from rgbd_recon_torch.runtime import pipeline as pl

    def median_ms(fused: bool) -> float:
        """The frame median of FUSED_BENCH step_timed frames (host clock,
        synced), with the stage timers' means (CUDA events; fused: the
        whole replay under 3recon)."""
        pipe.cfg = pipe.cfg._replace(fused=fused)
        pipe.timers.reset()
        times = []
        for i in range(FUSED_BENCH):
            t0 = time.perf_counter()
            pipe.step_timed(*frames[i % len(frames)], mv, proj)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        med = float(np.median(times)) * 1e3
        timers = pipe.timers.timers     # reset() empties it; a fused frame fills 3recon
        stages = ", ".join(f"{n} {timers[n].mean * 1e3:.3f} (min {timers[n].vmin * 1e3:.3f})"
                           for n in pl.STAGE_TIMERS if n in timers)
        print(f"fused pinhole 256^3: {'fused' if fused else 'staged'} frame median "
              f"{med:.3f} ms over {FUSED_BENCH} step_timed frames (host clock, synced); "
              f"stage means {stages} ms (CUDA events) ({card})")
        return med

    reserved_1 = torch.cuda.memory_reserved()
    staged = median_ms(False)
    fused = median_ms(True)
    staged2 = median_ms(False)
    print(f"fused pinhole 256^3: frame median fused {fused:.3f} ms, staged {staged:.3f} / "
          f"{staged2:.3f} ms (before / after): {staged / fused:.2f}x / {staged2 / fused:.2f}x "
          f"({card})")
    pipe.cfg = pipe.cfg._replace(fused=True)
    key = pipe._axis(mv)[1]
    tally = pipe._graphs._graphs[key].launches
    need = ("integrate_dense", "warp_screen", "bilateral_accum", "quality", "mark_bricks")
    missing = [k for k in need if not tally.get(k)]
    if missing:
        raise RuntimeError(f"fused graph {key}: kernels {missing} not in its launches {tally}")
    # kernel 11 at 1280x720 with 6 LODs: 5 levels and one resolve a replay
    if (tally.get("holefill_level"), tally.get("holefill_resolve")) != (5, 1):
        raise RuntimeError(f"fused graph {key}: kernel 11 launches {tally} a replay, not "
                           f"5 levels and 1 resolve")
    print(f"fused pinhole 256^3: the graph of {key} launches {tally} a replay "
          f"(kernels 1-4, 10 and 11 recorded at its capture) ({card})")

    # the orbit: the other five variants captured on warm_variants_async's thread
    logs = []
    pipe._log = lambda s: (logs.append(s), print(f"  {s}"))
    t0 = time.perf_counter()
    pipe.warm_variants_async(*frames[0], mv, proj)
    pipe._variants_thread.join(timeout=600)
    if pipe._variants_thread.is_alive() or sorted(pipe._graphs.keys()) != sorted(pl.VARIANTS):
        raise RuntimeError(f"warm_variants_async: captured {pipe._graphs.keys()}: {logs}")
    torch.cuda.synchronize()
    reserved_6 = torch.cuda.memory_reserved()
    print(f"fused pinhole 256^3: 5 variants captured on the thread in "
          f"{time.perf_counter() - t0:.1f} s; memory reserved {reserved_0 / 2**30:.3f} GiB "
          f"staged, {reserved_1 / 2**30:.3f} GiB with 1 variant, {reserved_6 / 2**30:.3f} GiB "
          f"with 6 ({card})")
    for v in pl.VARIANTS:
        cam = _orbit_camera(pipe, *v)
        pipe.cfg = pipe.cfg._replace(fused=False)
        want = pipe.step(*frames[0], cam, proj)
        pipe.cfg = pipe.cfg._replace(fused=True)
        got = pipe.step(*frames[0], cam, proj)
        torch.cuda.synchronize()
        _same_frame(f"fused orbit {v}", got, want)
        print(f"fused orbit {v}: bit for bit the staged frame; coverage "
              f"{float(got.hit.float().mean()):.4f}")
    if len(pipe._graphs.keys()) != 6:
        raise RuntimeError(f"the orbit captured more than its 6 variants: {pipe._graphs.keys()}")


def _fused_reference(card: str) -> None:
    """Phase 12 on the reference path: phase 11 (c)'s 128^3 frame, fused
    (one graph) against staged on the card."""
    import numpy as np
    import torch
    from rgbd_recon_torch.calibration.synthetic import bench_inputs
    from rgbd_recon_torch.runtime import pipeline as pl

    srig, sbbox, sframes = bench_inputs(3, 256, 212, (48, 64, 48), (48, 48, 48), SEED,
                                        frames=FUSED_FRAMES)
    scfg = pl.PipelineConfig(render_width=320, render_height=240, tsdf_res=(128, 128, 128),
                             voxel_size=float(np.max(sbbox.size) / 128), sweep_res=(256, 256),
                             fast_path=False)
    pipe = pl.FramePipeline(srig, scfg, device="cuda", log=lambda s: print(f"  {s}"))
    smv, sproj = pipe.default_camera()
    staged = [pipe.step(*f, smv, sproj) for f in sframes]
    # 256x212 color takes exact registration taps (no tile fits): no kernel 2
    _fused_phase("reference 128^3", pipe, sframes, smv, sproj, staged,
                 ("bilateral_accum", "quality", "mark_bricks"), card)
    if pipe._graphs.keys() != [(2, False)]:
        raise RuntimeError(f"the reference path captured {pipe._graphs.keys()}, not one graph")


SHARD_FRAMES = 5           # timed frames of phase 13 (a)'s steps
SHARD_SLABS = 4            # phase 13 (b): slabs of the 256^3 volume


def _median_ms(fn, n: int) -> float:
    """Median ms of ``n`` calls of ``fn(i)`` (host clock, synced)."""
    import numpy as np
    import torch

    times = []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def _bitwise(label: str, got, want, fields=OUT_FIELDS) -> None:
    import torch

    bad = [f for f in fields if not (getattr(got, f).dtype == getattr(want, f).dtype
                                     and torch.equal(getattr(got, f), getattr(want, f)))]
    if bad:
        raise RuntimeError(f"{label}: not bit for bit in {bad}")


def _within_default(label: str, got, want, keep16, limit: float) -> str:
    """The sharded frame (no cull) against the default single-card step,
    whose depth-band cull drops bricks by design (a dropped brick holds the
    clear value, ``ops/tsdf_affine.py`` block_depth_cull): the image at the
    render-parity bounds (tests/test_golden.py:65-69), the TSDF at the
    integrator bound (tests/test_tsdf_affine.py:109-116) over the bricks
    the cull kept (``keep16``), the clear value in every brick it dropped."""
    import torch
    from rgbd_recon_torch.utils.metrics import render_parity, render_parity_passes

    host = [types.SimpleNamespace(color=o.color.cpu().numpy(), depth=o.depth.cpu().numpy(),
                                  hit=o.hit.cpu().numpy()) for o in (want, got)]
    st = render_parity(*host)
    keep = keep16.repeat_interleave(16, 0).repeat_interleave(16, 1).repeat_interleave(16, 2)
    v, w = got.tsdf.float()[keep], want.tsdf.float()[keep]
    off = float(((v - w).abs() > 1e-4).float().mean())
    occ, wocc = int((v > -limit + 1e-9).sum()), int((w > -limit + 1e-9).sum())
    clear = torch.tensor(-limit, dtype=want.tsdf.dtype, device=want.tsdf.device)
    dropped_clear = bool((want.tsdf[~keep] == clear).all())
    ok = (render_parity_passes(st) and st["hit_frac"] > 0.02 and off < 1e-4
          and abs(occ - wocc) <= max(100, 0.002 * wocc) and dropped_clear)
    txt = (f"hit agreement {st['hit_agreement']:.5f}, psnr {st['psnr_rgb']:.2f} dB, ssim "
           f"{st['ssim_rgb']:.5f}, depth err median {st['depth_err_med']:.2e} p99 "
           f"{st['depth_err_p99']:.2e}; over the {int(keep16.sum())} bricks the cull kept: "
           f"tsdf voxels off >1e-4 {off:.2e}, occupied {occ} vs {wocc}; the "
           f"{int((~keep16).sum())} others clear in the default step: {dropped_clear}")
    if not ok:
        raise RuntimeError(f"{label}: outside the bounds of the default step: {txt}")
    return txt


def _slabs_vs_world(label: str, pipe, n: int, s, got, want, inputs) -> str:
    """Phase 13 (b): the frame of ``n`` slabs run rank by rank (``got``,
    from ``fast_sharded.sweep_slabs`` ``s``) against the world of one
    (``want``). Bit for bit, except where some window starts right after an
    empty brick layer, as the slab flags show: JAX's windowed start
    rebuilds the carry from the halo there (ROADMAP queue 3). That case
    holds the TSDF exact, the frame of one slab bit for bit ``want``, and
    the folded planes against that slab's (the whole sweep) at the bounds
    measured for the deviation (tests/test_torch_sweep_window.py: hit and
    sample counts exact, hit_s 5e-5, colors and gradients 1e-2). Returns
    the finding for the log."""
    import torch
    from rgbd_recon_torch.parallel import fast_sharded as fs

    diff = [f for f in OUT_FIELDS if not torch.equal(getattr(got, f), getattr(want, f))]
    if not diff:
        return "bit for bit"
    ns = pipe.tsdf_cfg.res[s.axis]
    nl = ns // n
    # window L (logical) starts at slice L*nl; its halo ends at logical
    # L*nl - 1, physical ns - L*nl when flipped
    after_empty = [w for w in range(1, n) if s.flags is not None
                   and not s.flags[(ns - w * nl) if s.flip else w * nl - 1]]
    if not after_empty or "tsdf" in diff:
        raise RuntimeError(f"{label}: not bit for bit in {diff}; windows starting after an "
                           f"empty brick layer: {after_empty}")
    whole = fs.sweep_slabs(pipe, 1, *inputs)
    _bitwise(f"{label}: one slab vs the world of one", fs.finish(pipe, *whole[:-1]), want)
    bounds = {"hit": 0.0, "num_samples": 0.0, "hit_s": 5e-5, "hit_color": 1e-2,
              "hit_grad": 1e-2}
    dev = {f: float((getattr(s.merged, f) - getattr(whole.merged, f)).abs().max())
           for f in bounds}
    txt = (f"differs in {diff}; windows {after_empty} (logical) start after an empty brick "
           f"layer; planes against the whole sweep, max {dev} (bounds {bounds})")
    if any(dev[f] > b for f, b in bounds.items()) or not any(dev.values()):
        raise RuntimeError(f"{label}: {txt}: outside the windowed-start bounds, or the "
                           f"frame differs where the planes do not")
    return txt


def _sharded_phase(rig, bbox, frames, card: str, work: str, ks: str, paths, fmt) -> None:
    """Phase 13 (module docstring): the sharded paths, the inverter and the
    native decoder. ``rig``/``frames``: phase 3's; ``work``/``ks``/``paths``/
    ``fmt``: phase 9's scene."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from rgbd_recon_torch import native
    from rgbd_recon_torch.calibration import inverter as inv_mod
    from rgbd_recon_torch.calibration import synthetic
    from rgbd_recon_torch.calibration.volume import CalibrationVolume
    from rgbd_recon_torch.io import dxt, native as host_native
    from rgbd_recon_torch.io.stream import StreamReader
    from rgbd_recon_torch.parallel import fast_sharded as fs
    from rgbd_recon_torch.parallel.replay import ReplayDriver
    from rgbd_recon_torch.parallel.sharding import make_mesh, sharded_step
    from rgbd_recon_torch.runtime import integrator as integ_mod, pipeline as pl
    from rgbd_recon_torch.scripts import calib_inverter
    from rgbd_recon_torch.utils.bench_golden import bench_config
    from rgbd_recon_torch.utils.math import Bbox

    dev = torch.device("cuda")
    n = 256

    def counts():
        return {name: k.launches for name, k in native.KERNELS.items() if k.launches}

    def zero():
        torch.cuda.synchronize()
        for k in native.KERNELS.values():
            k.launches = 0

    # (a) a world of one under NCCL at phase 3's configuration (no cull)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    mesh = make_mesh(device="cuda")
    print(f"sharded (a): process group {dist.get_backend()} world {mesh.size} on {mesh.device}")
    try:
        pipe = pl.FramePipeline(rig, bench_config(bbox, n, brick_cull=False), device=dev)
        base = pl.FramePipeline(rig, bench_config(bbox, n), device=dev)
        mv, proj = pipe.default_camera()
        step = fs.fast_sharded_step(pipe, mesh)
        want = pipe.step(*frames[0], mv, proj)
        step(*frames[0], mv, proj)
        zero()
        got = step(*frames[0], mv, proj)
        per_frame = counts()
        print(f"sharded (a): fast_sharded_step launches a frame (world of one): {per_frame}")
        missing = [k for k in PATH_KERNELS + ("integrate_dense",) if k not in per_frame]
        if missing:
            raise RuntimeError(f"sharded (a): kernels never launched: {missing}")
        _bitwise("sharded (a) fast_sharded_step vs step(brick_cull=False)", got, want)
        keep16 = base._pre(*base._sensor_inputs(*frames[0])).mask16
        txt = _within_default("sharded (a)", got, base.step(*frames[0], mv, proj), keep16,
                              float(base.tsdf_cfg.limit))
        print(f"sharded (a): fast_sharded_step bit for bit step(brick_cull=False); against "
              f"the default step (cull on): {txt}")
        nf = len(frames)
        t_sh = _median_ms(lambda i: step(*frames[i % nf], mv, proj), SHARD_FRAMES)
        t_1 = _median_ms(lambda i: pipe.step(*frames[i % nf], mv, proj), SHARD_FRAMES)
        t_b = _median_ms(lambda i: base.step(*frames[i % nf], mv, proj), SHARD_FRAMES)
        print(f"sharded (a): frame median over {SHARD_FRAMES} frames (host clock, synced): "
              f"fast_sharded_step {t_sh:.1f} ms, step(brick_cull=False) {t_1:.1f} ms, default "
              f"step {t_b:.1f} ms ({card})")

        # ReplayDriver, B = 2 distinct frames, against two steps
        drv = ReplayDriver(base, mesh)
        db = np.stack([frames[0][0], frames[1][0]])
        cb = np.stack([frames[0][1], frames[1][1]])
        zero()
        out = drv.step(db, cb, mv, proj)
        rc = counts()
        for i in range(2):
            item = types.SimpleNamespace(**{f: getattr(out, f)[i] for f in OUT_FIELDS})
            _bitwise(f"sharded (a) ReplayDriver item {i}", item, base.step(*frames[i], mv, proj))
        t_r = _median_ms(lambda i: drv.step(db, cb, mv, proj), 3)
        print(f"sharded (a): ReplayDriver B=2 bit for bit two steps; launches {rc}; median "
              f"{t_r:.1f} ms a batch step (host clock, synced) ({card})")
        # the world-of-one frames (b) holds the slabs to: the six sweep
        # variants at 256^3, and the z camera at 240^3 (kernel 6)
        world = {v: step(*frames[0], _orbit_camera(pipe, *v), proj) for v in pl.VARIANTS}
        bpipe = pl.FramePipeline(rig, bench_config(bbox, 240, brick_cull=False), device=dev)
        world[240] = fs.fast_sharded_step(bpipe, mesh)(*frames[0], mv, proj)
        del drv, out, base, step, got, want

        # sharded_step at phase 11 (c)'s 128^3 against the reference path
        srig, sbbox, sframes = synthetic.bench_inputs(3, 256, 212, (48, 64, 48), (48, 48, 48),
                                                      SEED, frames=1)
        scfg = pl.PipelineConfig(render_width=320, render_height=240, tsdf_res=(128,) * 3,
                                 voxel_size=float(np.max(sbbox.size) / 128),
                                 sweep_res=(256, 256), fast_path=False)
        rpipe = pl.FramePipeline(srig, scfg, device=dev)
        smv, sproj = rpipe.default_camera()
        dstep = sharded_step(rpipe, mesh)
        want = rpipe.step(*sframes[0], smv, sproj)
        dstep(*sframes[0], smv, sproj)
        zero()
        got = dstep(*sframes[0], smv, sproj)
        dc = counts()
        _bitwise("sharded (a) sharded_step vs the reference path", got, want, OUT_FIELDS[:-1])
        t_d = _median_ms(lambda i: dstep(*sframes[0], smv, sproj), 3)
        t_r1 = _median_ms(lambda i: rpipe.step(*sframes[0], smv, sproj), 3)
        print(f"sharded (a): sharded_step at 128^3 bit for bit the reference path "
              f"(fast_path=False); launches {dc}; occupied bricks {int(got.occupied_bricks)} "
              f"(the brick grid's, as JAX's step counts); median {t_d:.1f} ms vs {t_r1:.1f} ms "
              f"(host clock, synced) ({card})")
        del rpipe, dstep, got, want
    finally:
        dist.destroy_process_group()

    # (b) four slabs on one card: the per-rank functions run rank by rank
    for v in pl.VARIANTS:
        cam = _orbit_camera(pipe, *v)
        zero()
        t0 = time.perf_counter()
        s = fs.sweep_slabs(pipe, SHARD_SLABS, *frames[0], cam, proj)
        got = fs.finish(pipe, *s[:-1])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        sc = counts()
        txt = _slabs_vs_world(f"sharded (b) {v}", pipe, SHARD_SLABS, s, got, world[v],
                              (*frames[0], cam, proj))
        print(f"sharded (b) 256^3, {SHARD_SLABS} slabs of 64, sweep {v}: {txt}; launches "
              f"{sc}; {secs * 1e3:.1f} ms (host clock, synced); coverage "
              f"{float(got.hit.float().mean()):.4f} ({card})")
    try:
        fs.slab_plan(bpipe, 4)
        raise RuntimeError("sharded (b): 240^3 over 4 ranks was not refused")
    except ValueError as e:
        print(f"sharded (b) 240^3: 4 slabs refused: {e}")
    zero()
    s = fs.sweep_slabs(bpipe, 3, *frames[0], mv, proj)
    got = fs.finish(bpipe, *s[:-1])
    bc = counts()
    if bpipe.integrator.tier != integ_mod.BLOCK_MAJOR or "integrate_affine" not in bc:
        raise RuntimeError(f"sharded (b) 240^3: kernel 6 did not run: {bc}")
    txt = _slabs_vs_world("sharded (b) 240^3", bpipe, 3, s, got, world[240],
                          (*frames[0], mv, proj))
    print(f"sharded (b) 240^3, 3 slabs of 80, sweep {pipe._axis(mv)[1]}: {txt}; launches "
          f"{bc} ({card})")
    del pipe, bpipe, got, world
    torch.cuda.empty_cache()

    # (c) the inverter on phase 9's scene at the reference's default 0.007 m
    secs = []
    one = inv_mod.CalibrationInverter._invert_one

    def timed_one(self, *a):
        t0 = time.perf_counter()
        out = one(self, *a)
        secs.append(time.perf_counter() - t0)
        return out

    inv_mod.CalibrationInverter._invert_one = timed_one
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        calib_inverter.main([ks, "-s", "0.007"])
    finally:
        inv_mod.CalibrationInverter._invert_one = one
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"inverter: 4 sensors in {wall:.1f} s, per sensor "
          f"{', '.join(f'{x:.2f}' for x in secs)} s (host clock, synced); device memory peak "
          f"{peak:.2f} GiB ({card})")
    bb = Bbox.default()
    cams = synthetic.make_cameras(4, bb, width=512, height=424)
    for i, cam in enumerate(cams):
        got = CalibrationVolume.read(os.path.join(work, f"sensor{i}.cv_xyz_inv"), 4)
        if tuple(int(r) for r in got.res) != (286, 315, 286) or got.volume.shape != (
                286, 315, 286, 4):
            raise RuntimeError(f"inverter: sensor {i} res {got.res}, {got.volume.shape}")
        ana = synthetic.bake_inverse_volume(cam, bb, (286, 315, 286)).volume
        g = got.volume
        both = (g[..., 0] >= 0) & (ana[..., 0] >= 0)
        dv = np.abs(g[..., :3] - ana[..., :3]).max(-1)[both]
        med, p99 = float(np.median(dv)), float(np.percentile(dv, 99))
        ok = np.isfinite(g).all() and med < 0.5 / 128 and p99 < 2.0 / 128
        print(f"inverter: sensor {i} against the analytic inverse: median {med:.2e}, p99 "
              f"{p99:.2e}, max {float(dv.max()):.2e} (bounds 0.5 and 2 forward cells, "
              f"{0.5 / 128:.2e} and {2 / 128:.2e}); inside the frustum "
              f"{float((g[..., 0] >= 0).mean()):.4f}, masks agree "
              f"{float(((g[..., 0] >= 0) == (ana[..., 0] >= 0)).mean()):.4f} -> "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"inverter: sensor {i} deviates from the analytic inverse")
    # the card against the CPU on a small scene (tests/test_torch_inverter.py)
    with tempfile.TemporaryDirectory(prefix="rgbd_inv_") as small:
        synthetic.write_reference_scene(small, num_sensors=2, bbox=bb, fwd_res=(16, 24, 16))
        files = [os.path.join(small, f"sensor{i}.yml") for i in range(2)]
        res = {}
        for d in ("cuda", "cpu"):
            inv = inv_mod.CalibrationInverter(files, bb, device=d)
            inv.calculate_inverse_volumes((10, 12, 10))
            res[d] = [v.volume for v in inv.inverted]
    for i, (g, c) in enumerate(zip(res["cuda"], res["cpu"])):
        if not np.array_equal(g[..., 0] >= 0, c[..., 0] >= 0):
            raise RuntimeError(f"inverter: card and CPU frustum masks differ (sensor {i})")
        dmax = float(np.abs(g - c).max())
        print(f"inverter: small scene sensor {i}, card vs CPU: masks equal, max deviation "
              f"{dmax:.2e} (atol 1e-5)")
        if dmax > 1e-5:
            raise RuntimeError("inverter: the card disagrees with the CPU on the small scene")

    # (d) the native decoder on phase 9's recorded frames
    reader = StreamReader(paths, fmt, looping=False)
    raws = [reader.read_raw()[0] for _ in range(APP_FRAMES)]
    reader.close()
    pays = [p for c in raws for p in c]
    t0 = time.perf_counter()
    nat = [host_native.decode_dxt1(p, fmt.width_c, fmt.height_c) for p in pays]
    t_nat = (time.perf_counter() - t0) / len(pays)
    t0 = time.perf_counter()
    ref = [dxt.decode_dxt1(p, fmt.width_c, fmt.height_c) for p in pays]
    t_np = (time.perf_counter() - t0) / len(pays)
    if not all(np.array_equal(a, b) for a, b in zip(nat, ref)):
        raise RuntimeError("the native DXT1 decoder differs from io/dxt.py")
    print(f"native decoder: bit for bit io/dxt.py on {len(pays)} recorded DXT1 planes "
          f"(512x424); {t_nat * 1e3:.3f} ms a plane vs numpy {t_np * 1e3:.3f} ms (host clock; "
          f"{os.cpu_count()} host cores) ({card})")


def _jax_phase(rig, frames, card: str) -> None:
    """Phase 14 (module docstring): the card's frame against the JAX
    package's outputs stored in tests/data/torch_bench_golden.npz.
    ``rig``/``frames``: phase 3's."""
    import numpy as np
    import torch
    from rgbd_recon_torch import native
    from rgbd_recon_torch.runtime import pipeline as pl
    from rgbd_recon_torch.utils import bench_golden as bg

    t_phase = time.perf_counter()
    gold = bg.load()
    depth, color = frames[0]
    bg.check_digests(gold, rig, depth, color)
    print(f"jax: {bg.PATH} loaded; the {len(rig) + 2} inputs hash to its sha256 digests")
    bbox = rig.bbox
    rows = []

    def run(label, cfg, need, frame_fn):
        """Build the pipeline, counters to 0, ``frame_fn(pipe)``, counters
        read: every kernel of ``need`` must have launched."""
        pipe = pl.FramePipeline(rig, cfg, device="cuda")
        for k in native.KERNELS.values():
            k.launches = 0
        got = frame_fn(pipe)
        torch.cuda.synchronize()
        counts = {name: k.launches for name, k in native.KERNELS.items() if k.launches}
        missing = [name for name in need if not counts.get(name)]
        print(f"jax {label}: launches {counts}")
        if missing:
            raise RuntimeError(f"jax {label}: kernels never launched: {missing}")
        return pipe, got

    def hold(label, new_rows):
        for r in new_rows:
            print(r.line(f"jax {label}"))
        rows.extend((label, r) for r in new_rows)

    def step_screen(out):
        """A frame's output (its color hole-filled) as screen planes."""
        return bg.Screen(out.color.float().cpu().numpy(), out.depth.float().cpu().numpy(),
                         out.hit.cpu().numpy(), None)

    # (a) the default pipeline (kernels 1-4) against reference A, stage by
    # stage at the five views; its step at the default camera is the
    # stages' frame bit for bit
    label = "A 256^3 kernels 1-4"
    pipe, got = run(label, bg.bench_config(bbox, 256), PATH_KERNELS + ("integrate_dense",),
                    lambda p: bg.port_stages(p, depth, color, gold))
    out = pipe.step(depth, color, *bg.camera("default", bbox))
    filled = got["views"]["default"]["screen"].filled
    same = (np.array_equal(out.color.float().cpu().numpy(), filled)
            and np.array_equal(out.tsdf.float().cpu().numpy(), got["tsdf"]))
    if not same:
        raise RuntimeError("jax: FramePipeline.step differs from its stages' frame")
    hold(label, bg.compare_pre(gold, got) + bg.compare_bricks(gold, got)
         + [bg.compare_tsdf(gold["A/tsdf"], got["tsdf"]), bg.compare_color(gold, got)])
    for view, v in got["views"].items():
        ref = bg.screen(gold, f"A/{view}/")
        hold(label, [bg.compare_sweep(gold, view, v),
                     bg.compare_screen(f"{view} screen", ref, v["screen"]),
                     bg.compare_screen(f"{view} screen hole-filled", bg.filled(ref),
                                       bg.filled(v["screen"]))])
    del pipe, got, out
    mv, proj = bg.camera("default", bbox)
    ref_b = bg.filled(bg.screen(gold, "B/default/"))

    # (b) kernel 7's window mode (use_pallas=False): reference B's formulation
    label = "B 256^3 kernel 7 window mode"
    _, out = run(label, bg.bench_config(bbox, 256, use_pallas=False),
                 PATH_KERNELS + ("integrate_sparse_window",),
                 lambda p: p.step(depth, color, mv, proj))
    hold(label, [bg.compare_tsdf(gold["B/tsdf"], out.tsdf.float().cpu().numpy(), exact_to=1e-5),
                 bg.compare_screen("screen hole-filled", ref_b, step_screen(out))])
    # (c) kernel 7's table mode (use_affine=False) against reference B
    label = "B 256^3 kernel 7 table mode"
    _, out = run(label, bg.bench_config(bbox, 256, use_affine=False),
                 PATH_KERNELS + ("integrate_sparse",), lambda p: p.step(depth, color, mv, proj))
    hold(label, [bg.compare_tsdf(gold["B/tsdf"], out.tsdf.float().cpu().numpy()),
                 bg.compare_screen("screen hole-filled", ref_b, step_screen(out))])
    # (d) the block-major integrator (kernel 6) at 240^3 against reference C
    label = "C 240^3 kernel 6"
    _, out = run(label, bg.bench_config(bbox, 240), PATH_KERNELS + ("integrate_affine",),
                 lambda p: p.step(depth, color, mv, proj))
    n_occ = int(out.occupied_bricks)
    hold(label, [bg.compare_tsdf(gold["C/tsdf"], out.tsdf.float().cpu().numpy()),
                 bg.Row("occupied 16^3 bricks", f"{n_occ} vs {int(gold['C/n_occ'])}", "equal",
                        n_occ == int(gold["C/n_occ"])),
                 bg.compare_screen("screen hole-filled", bg.filled(bg.screen(gold, "C/default/")),
                                   step_screen(out))])
    del out
    torch.cuda.empty_cache()
    bad = [f"{label}: {r.stage}" for label, r in rows if not r.ok]
    print(f"jax: {len(rows) - len(bad)} of {len(rows)} comparisons within their bounds; "
          f"phase 14: {time.perf_counter() - t_phase:.1f} s ({card})")
    if bad:
        raise RuntimeError(f"the card's frame disagrees with the JAX package's outputs: {bad}")


LADDER_FRAMES = 4          # distinct noisy frames a configuration of phase 15
LADDER_RUN = 10            # staged and fused frames timed a configuration
# sweep against the per-ray oracle on the complex scene: the JAX test's own
# bounds (tests/test_complex_scene.py:139-142; a 2 cm panel's silhouette)
COMPLEX_BOUNDS = {"hit_agreement": 0.99, "psnr_rgb": 28.0, "depth_err_med": 2e-3,
                  "depth_err_p99": 3e-2}
# phase 15's configurations whose kernel 1 call is held to its plain twin
# (new shapes: 8,192 slots at 512^3, K = 5) and whose sweep is held to the
# oracle at golden_parity's four views
LADDER_TWIN = {"L2": "512^3", "S5": "K=5"}
LADDER_ORACLE = ("L2", "C")


SWEEP_REPS = 10           # graph-replayed sweeps a timing


def _sweep_phase(rig, bbox, frames, card: str, report, launches) -> None:
    """Phase 16: the sweep kernel (``csrc/sweep_march.cu``) on the pinhole
    rig's frame 0 at 256^3 and 512^3: the staged frame's sweep arguments
    recorded, then at each (axis, flip) (the default camera for its own
    variant, ``_orbit_camera`` for the others) the kernel against
    ``sweep_plain`` bit for bit on the frame's volumes and device flags,
    and timed by graph replay; the default view's entry in the kernels
    table with its L2-cold and plain times and the bound of
    ``recon_bench/roofline.sweep_work`` on the frame's occupied blocks; the
    launches of a fused frame (one a replay)."""
    import torch
    from rgbd_recon_torch import native
    from rgbd_recon_torch.ops import raymarch as rm, raymarch_fast as rmf
    from rgbd_recon_torch.runtime import pipeline as pl
    from rgbd_recon_torch.utils.bench_golden import bench_config

    sys.path.insert(0, HERE)
    from recon_bench import roofline

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    for n in (256, 512):
        pipe = pl.FramePipeline(rig, bench_config(bbox, n), device=dev)
        mv, proj = pipe.default_camera()
        recs = {name: Recorder(rmf, name) for name in ("sweep", "slab_occupancy_device")}
        try:
            pipe.step(*frames[0], mv, proj)
            torch.cuda.synchronize()
        finally:
            for r in recs.values():
                r.restore()
        (vol, cvol, cam, box, limit, axis0, flip0, scfg, _, zmajor), _ = recs["sweep"].calls[0]
        (mask16, _, _), _ = recs["slab_occupancy_device"].calls[0]
        n_occ = int(mask16.sum())
        with open(os.path.join(HERE, "recon_bench", "configs", f"k4-{n}.json")) as f:
            nbytes, ops = roofline.sweep_work(json.load(f), n_occ)
        proj_t = torch.as_tensor(proj, dtype=torch.float32, device=dev)
        by_axis = {}
        for axis, flip in [(axis0, flip0)] + [v for v in pl.VARIANTS if v != (axis0, flip0)]:
            view = mv if (axis, flip) == (axis0, flip0) else _orbit_camera(pipe, axis, flip)
            vcam = rm.RenderCamera(torch.as_tensor(view, dtype=torch.float32, device=dev),
                                   proj_t, cam.width, cam.height)
            occ = rmf.slab_occupancy_device(mask16, axis, n)
            args = (vol, cvol, vcam, box, limit, axis, flip, scfg, occ, zmajor)
            got, want = rmf.sweep_cuda(*args), rmf.sweep_plain(*args)
            fields = ("hit", "hit_s", "hit_color", "hit_grad", "num_samples")
            differ = [f for f in fields if not torch.equal(getattr(got, f), getattr(want, f))]
            ms = _time_ms(lambda a=args: rmf.sweep_cuda(*a), SWEEP_REPS, graph=True)
            by_axis[(axis, flip)] = ms
            print(f"  sweep_march {n}^3 ({axis}, {flip}): {ms:.4f} ms (graph replay), hit "
                  f"{float(got.hit.mean()):.4f}, occupied slices {int(occ.sum())}/{n}, "
                  f"bit for bit sweep_plain: {not differ} {differ or ''} ({card})")
            if differ:
                raise RuntimeError(f"sweep_march {n}^3 {(axis, flip)} differs from "
                                   f"sweep_plain in {differ}")
            if (axis, flip) == (axis0, flip0):
                cat = lambda r: torch.cat([getattr(r, f).reshape(-1) for f in fields])
                report(f"sweep_march[{n}^3]", "rgbd_recon_torch/csrc/sweep_march.cu",
                       "none: the sweep's slice loop (rgbd_recon_torch/ops/raymarch_fast.py "
                       "sweep_plain)", _errs(cat(got), cat(want)), "bit for bit", True,
                       lambda a=args: rmf.sweep_cuda(*a), lambda a=args: rmf.sweep_plain(*a),
                       5, nbytes, ops)
        print(f"  sweep_march {n}^3 by axis (ms): "
              + ", ".join(f"{v}: {ms:.4f}" for v, ms in by_axis.items()))
        pipe.cfg = pipe.cfg._replace(fused=True)
        pipe.warmup(*frames[0], mv, proj)
        kern = native.KERNELS["sweep_march"]
        before = kern.launches
        for i in range(3):
            pipe.step(*frames[i % len(frames)], mv, proj)
        torch.cuda.synchronize()
        per_frame = (kern.launches - before) / 3
        print(f"  sweep_march {n}^3: {per_frame:g} launches a fused frame")
        if per_frame != 1:
            raise RuntimeError(f"sweep_march launched {per_frame} times a fused frame")
        launches[f"sweep_march[{n}^3]"] = 1
        del pipe, recs, vol, cvol, got, want
        torch.cuda.empty_cache()
    print(f"sweep phase: {time.perf_counter() - t_phase:.1f} s")


def _ladder_phase(rig, frames, card: str, check_integrator, integrator_work,
                  launches) -> None:
    """Phase 15 (module docstring): the bench's other configurations through
    ``FramePipeline`` on the card, each held to the JAX package's outputs in
    tests/data/torch_bench_golden_ladder.npz. ``rig``/``frames``: phase 3's
    (the 4-sensor sphere rig of L1 and L2); ``check_integrator`` /
    ``integrator_work``: main's; kernel 1's twin checks add entries to the
    kernels line, their launches to ``launches``."""
    import numpy as np
    import torch
    from rgbd_recon_torch import native
    from rgbd_recon_torch.calibration.synthetic import bench_inputs
    from rgbd_recon_torch.ops import preprocess as pp, raymarch_fast as rmf, tsdf_dense
    from rgbd_recon_torch.ops.tsdf_fast import occupied_bricks, pack_frames, pack_planes
    from rgbd_recon_torch.runtime import integrator as integ_mod, pipeline as pl
    from rgbd_recon_torch.scripts import golden_parity
    from rgbd_recon_torch.utils import bench_golden as bg
    from rgbd_recon_torch.utils.metrics import render_parity_passes

    t_phase = time.perf_counter()
    gold = bg.load(bg.LADDER_PATH)
    inputs = {(4, "sphere"): (rig, rig.bbox, frames[:LADDER_FRAMES])}
    rows, summary = [], []
    need = PATH_KERNELS + ("integrate_dense",)
    for name, cfg in bg.LADDER.items():
        label = f"ladder {name} ({cfg.sensors} sensors, {cfg.scene}, {cfg.n}^3)"
        key = (cfg.sensors, cfg.scene)
        if key not in inputs:
            t0 = time.perf_counter()
            inputs = {(4, "sphere"): inputs[(4, "sphere")],
                      key: bench_inputs(cfg.sensors, *bg.SIZE, SEED, frames=LADDER_FRAMES,
                                        scene=cfg.scene)}
            print(f"{label}: rig + frames (host numpy): {time.perf_counter() - t0:.1f} s")
        krig, bbox, kframes = inputs[key]
        g = bg.config(gold, name)
        bg.check_digests(g, krig, *kframes[0])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pipe = pl.FramePipeline(krig, bg.bench_config(bbox, cfg.n), device="cuda",
                                log=lambda s: print(f"  {s}"))
        mv, proj = pipe.default_camera()
        pipe.warmup(*kframes[0], mv, proj)
        print(f"{label}: pipeline, session bakes and warm-up: {time.perf_counter() - t0:.1f} s")
        # one staged frame: kernels 1-4, K registration warps and one screen
        rec = Recorder(integ_mod, "integrate_dense")
        split = [CallCounter(pp, "warp_screen", lambda a, kw: "registration"),
                 CallCounter(rmf, "warp_screen", lambda a, kw: "screen")]
        for k in native.KERNELS.values():
            k.launches = 0
        try:
            out = pipe.step(*kframes[0], mv, proj)
            torch.cuda.synchronize()
        finally:
            rec.restore()
            for cc in split:
                cc.restore()
        counts = {n: k.launches for n, k in native.KERNELS.items() if k.launches}
        warps = {e: c for cc in split for e, c in cc.counts.items()}
        n_occ = pipe.check_capacity(out)
        print(f"{label}: a staged frame launches {counts}, warp_screen by call {warps}; "
              f"check_capacity: {n_occ} occupied 16^3 bricks of {pipe.max_bricks}")
        missing = [n for n in need if not counts.get(n)]
        if missing or warps != {"registration": cfg.sensors, "screen": 1}:
            raise RuntimeError(f"{label}: kernels {missing} never launched, or warp_screen "
                               f"calls {warps} are not {cfg.sensors} registrations + 1 screen")

        def timed(fused):
            """LADDER_RUN step_timed frames over the distinct frames: host
            clock (synced) per frame, the stage timers' means."""
            pipe.cfg = pipe.cfg._replace(fused=fused)
            pipe.timers.reset()
            times = []
            for i in range(LADDER_RUN):
                t = time.perf_counter()
                pipe.step_timed(*kframes[i % len(kframes)], mv, proj)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            tm = pipe.timers.timers
            stages = ", ".join(f"{n} {tm[n].mean * 1e3:.3f}" for n in pl.STAGE_TIMERS
                               if n in tm and tm[n].count)
            print(f"{label}: {'fused' if fused else 'staged'} frame median "
                  f"{np.median(times):.3f} ms (min {min(times):.3f}, max {max(times):.3f}) "
                  f"over {LADDER_RUN} step_timed frames (host clock, synced); stage means "
                  f"{stages} ms (CUDA events) ({card})")
            return float(np.median(times))

        # the path: counters to 0, the staged frames, counters read
        for k in native.KERNELS.values():
            k.launches = 0
        staged = timed(False)
        torch.cuda.synchronize()
        run_counts = {n: k.launches for n, k in native.KERNELS.items() if k.launches}
        if any(not run_counts.get(n) for n in need):
            raise RuntimeError(f"{label}: a kernel of {need} never launched: {run_counts}")
        reserved_staged = torch.cuda.memory_reserved()
        pipe.cfg = pipe.cfg._replace(fused=True)
        t0 = time.perf_counter()
        pipe.warmup(*kframes[0], mv, proj)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        reserved_fused = torch.cuda.memory_reserved()
        fused = timed(True)
        pipe.cfg = pipe.cfg._replace(fused=False)
        print(f"{label}: occupied {n_occ} / {pipe.max_bricks}; staged {staged:.3f} ms, fused "
              f"{fused:.3f} ms; warm-up + capture {capture_s:.1f} s; memory reserved "
              f"{reserved_staged / 2**30:.3f} GiB staged, {reserved_fused / 2**30:.3f} GiB "
              f"with 1 variant (peak {torch.cuda.max_memory_reserved() / 2**30:.3f}) ({card})")
        summary.append((name, n_occ, pipe.max_bricks, staged, fused, capture_s,
                        reserved_fused / 2**30))

        # the holds against JAX's outputs on frame 0
        if cfg.stages:
            got = bg.port_stages(pipe, *kframes[0], g, views=("default",), on_ref_tsdf=True)
            v = got["views"]["default"]
            ref = bg.screen(g, "A/default/")
            on_ref = bg.compare_sweep(g, "default", got["views_ref"]["default"])
            new = (bg.compare_pre(g, got) + bg.compare_bricks(g, got, bg.COUNT_VOTES)
                   + [bg.compare_tsdf(g["A/tsdf"], got["tsdf"]), bg.compare_color(g, got),
                      on_ref._replace(stage=f"{on_ref.stage} on JAX's TSDF"),
                      bg.compare_screen("default screen", ref, v["screen"]),
                      bg.compare_screen("default screen hole-filled", bg.filled(ref),
                                        bg.filled(v["screen"]))])
            # the sweep on the port's own TSDF: its flips at the integrator
            # bound carry into the planes (ROADMAP queue 3); measured, held
            # through the screens above
            e2e = bg.compare_sweep(g, "default", v)
            print(f"jax {label}: {e2e.stage} on the port's TSDF: {e2e.measured} (measured "
                  f"beside {e2e.bound}: {'within' if e2e.ok else 'outside'})")
            del got, v
        else:
            _, got = bg.port_masks(pipe, *kframes[0])
            new = bg.compare_bricks(g, got, bg.COUNT_VOTES)
        for r in new:
            print(r.line(f"jax {label}"))
        rows.extend((name, r) for r in new)

        # kernel 1 against its plain twin on this path's call (new shapes)
        if name in LADDER_TWIN:
            entry = f"integrate_dense[{LADDER_TWIN[name]}]"
            (fr, aff, tcfg, m16, maxb, woff, wy, wx, xs, cls), _ = rec.calls[0]
            idx, count, slots = occupied_bricks(m16, maxb)
            packed = pack_frames(fr)
            iargs = (packed, aff.coeffs, idx, count, woff, cls, tcfg.res, wy, wx, xs,
                     float(tcfg.limit))
            kargs = (pack_planes(fr), aff.coeffs, idx, count, slots) + iargs[4:]
            print(f"  {entry}: {int(count)} fused bricks of {slots.numel()}, "
                  f"{maxb} slots, K = {packed.shape[0]}")
            check_integrator(entry, "rgbd_recon_torch/csrc/integrate_dense.cu",
                             "rgbd_recon_tpu/ops/tsdf_dense.py:452",
                             lambda: tsdf_dense.integrate_dense_cuda(*kargs),
                             lambda: tsdf_dense.integrate_dense_plain(*iargs), tcfg.limit, 3,
                             *integrator_work(packed, int(count),
                                              (slots.numel() + int(count) + 1) * 4, tcfg.res,
                                              10, 3 * 40 + 8 + 4, FUSE_OPS))
            launches[entry] = run_counts["integrate_dense"]
            del fr, aff, m16, woff, cls, idx, slots, packed, iargs, kargs
        rec.calls.clear()

        # the sweep against the per-ray oracle on this path's production
        # volume of frame 0 at golden_parity's four views, 1280x720
        if name in LADDER_ORACLE:
            pre = pipe._pre(*pipe._sensor_inputs(*kframes[0]))
            vol, cvol = pipe._integrate(pre)
            del pre
            views = golden_parity.renderer_parity(
                vol, cvol, bbox, float(pipe.tsdf_cfg.limit), proj, 1280, 720,
                pipe._sweep_res(), pipe.integrator.zmajor, log=lambda s: None)
            del vol, cvol
            print(f"{label}: golden parity, oracle marcher vs sweep on the production volume "
                  f"(bf16, z-major), 1280x720 ({card}):")
            print(golden_parity.table(views))
            for r in views:
                ok = render_parity_passes(r)
                bound = "render parity"
                if cfg.scene == "complex":
                    ok = ok and (r["hit_agreement"] > COMPLEX_BOUNDS["hit_agreement"]
                                 and r["psnr_rgb"] > COMPLEX_BOUNDS["psnr_rgb"]
                                 and r["depth_err_med"] < COMPLEX_BOUNDS["depth_err_med"]
                                 and r["depth_err_p99"] < COMPLEX_BOUNDS["depth_err_p99"])
                    bound += " and the complex-scene bounds"
                row = bg.Row(f"{r['view']} sweep vs oracle", f"hit {r['hit_agreement']:.5f}, "
                             f"{r['psnr_rgb']:.2f} dB, depth median {r['depth_err_med']:.2e} p99 "
                             f"{r['depth_err_p99']:.2e}", bound, ok)
                print(row.line(label))
                rows.append((name, row))
        del pipe, out
    torch.cuda.empty_cache()
    print(f"ladder summary ({card}): name, occupied / capacity, staged ms, fused ms, "
          f"warm-up + capture s, GiB reserved with 1 variant:")
    for s in summary:
        print(f"  {s[0]}: {s[1]} / {s[2]}, {s[3]:.3f}, {s[4]:.3f}, {s[5]:.1f}, {s[6]:.3f}")
    bad = [f"{name}: {r.stage}" for name, r in rows if not r.ok]
    print(f"ladder: {len(rows) - len(bad)} of {len(rows)} comparisons within their bounds; "
          f"phase 15: {time.perf_counter() - t_phase:.1f} s ({card})")
    if bad:
        raise RuntimeError(f"the ladder's configurations disagree with the JAX package: {bad}")


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        return _fail("torch.cuda.is_available() is false: this run needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(HERE, "rgbd_recon_torch", "csrc")):
        return _fail("rgbd_recon_torch/ not found beside chip_smoke.py")
    sys.path.insert(0, HERE)
    import numpy as np
    from rgbd_recon_torch import native
    from rgbd_recon_torch.calibration.synthetic import bench_inputs
    from rgbd_recon_torch.ops import assemble, bricks, inpaint, preprocess as pp
    from rgbd_recon_torch.ops import raymarch_fast as rmf
    from rgbd_recon_torch.ops import tsdf_dense, tsdf_persist, tsdf_sparse, warp as warp_ops
    from rgbd_recon_torch.ops.tsdf_fast import (occupied_bricks, occupied_list, pack_frames,
                                                pack_planes)
    from rgbd_recon_torch.runtime import integrator as integ_mod, pipeline as pl
    from rgbd_recon_torch.utils.bench_golden import bench_config

    t_start = time.perf_counter()
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

    results = {}      # kernel entry -> measured numbers
    launches = {}     # kernel -> launches in the run of its own path

    def report(name, route_src, replaces, err, tol_txt, ok, kern, plain, reps, nbytes, ops,
               library=None):
        """Time a kernel, its plain version and its library yardstick on the
        same inputs; ``nbytes``/``ops``: the work of this call (each input
        read once, each output written once, as much as this run's data
        needs)."""
        ms, eager_ms = _time_ms(kern, reps, graph=True), _time_ms(kern, reps)
        cold_ms = _time_cold_ms(kern, reps)
        plain_ms = _time_ms(plain, reps)
        lib_ms = _time_ms(library, reps, graph=True) if library is not None else None
        bound_ms, bound_by = _bound(nbytes, ops)
        print(f"kernel {name}: max_abs_err {err['max']:.3e} p99.5 {err['p995']:.3e} "
              f"({tol_txt}) -> {'ok' if ok else 'FAIL'}; {ms:.4f} ms (graph replay; L2 "
              f"cold {cold_ms:.4f}; eager {eager_ms:.4f}) vs plain {plain_ms:.4f} ms "
              f"(eager), library {'none' if lib_ms is None else f'{lib_ms:.4f} ms'}; bound "
              f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.3f} MB, {ops / 1e9:.3f} G fp32 "
              f"ops; cold at {bound_ms / max(cold_ms, 1e-9):.0%} of it)")
        if not ok:
            raise RuntimeError(f"kernel {name} disagrees with its plain version")
        results[name] = dict(source=route_src, replaces=replaces, max_abs_err=err["max"],
                             ms=ms, cold_ms=cold_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=lib_ms)

    def warm_up(label, pipe, frame, mv, proj, wrap):
        """One step with Recorders on the (module, name) pairs of ``wrap``."""
        recs = {key: Recorder(mod, name) for key, (mod, name) in wrap.items()}
        t0 = time.perf_counter()
        try:
            pipe.step(*frame, mv, proj)
            torch.cuda.synchronize()
        finally:
            for r in recs.values():
                r.restore()
        print(f"{label}: session bakes + warm-up frame: {time.perf_counter() - t0:.1f} s")
        for key, r in recs.items():
            if not r.calls:
                raise RuntimeError(f"the {label} warm-up frame never reached {key}")
        return recs

    def drive(label, pipe, frames, mv, proj, need, n_frames, res, split=None):
        """The path's run: counters to 0, step_timed over distinct frames,
        counters read; every kernel of ``need`` must have launched.
        ``split``: kernel -> (module, name, key) of the functions that
        launch it, each call counted under the kernel entry ``key(args,
        kwargs)`` names; the entries' counts must sum to the kernel's."""
        for k in native.KERNELS.values():
            k.launches = 0
        pipe.timers.reset()
        outs = []
        counters = {kern: [CallCounter(*spec) for spec in specs]
                    for kern, specs in (split or {}).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            for i in range(n_frames):
                outs.append(pipe.step_timed(*frames[i % len(frames)], mv, proj))
            torch.cuda.synchronize()
        finally:
            for ccs in counters.values():
                for cc in ccs:
                    cc.restore()
        wall = (time.perf_counter() - t0) / n_frames
        counts = {name: k.launches for name, k in native.KERNELS.items()}
        print(f"{label}: launches during {n_frames} frames: {counts}")
        missing = [name for name in need if counts[name] == 0]
        if missing:
            raise RuntimeError(f"{label}: kernels never launched on the path: {missing}")
        for name in need:
            launches.setdefault(name, counts[name])
        for kern, ccs in counters.items():
            by_entry = {}
            for cc in ccs:
                for entry, c in cc.counts.items():
                    by_entry[entry] = by_entry.get(entry, 0) + c
            print(f"{label}: {kern} launches by call: {by_entry}")
            if sum(by_entry.values()) != counts[kern]:
                raise RuntimeError(f"{label}: {kern}'s calls {by_entry} do not sum to its "
                                   f"{counts[kern]} launches")
            launches.update(by_entry)
        for name in pl.STAGE_TIMERS:
            t = pipe.timers.timers[name]
            print(f"{label}: stage {name}: mean {t.mean * 1e3:.3f} ms, min "
                  f"{t.vmin * 1e3:.3f} ms over {t.count} frames (CUDA events; {card})")
        print(f"{label}: frame wall time (host clock, step_timed incl. its syncs): "
              f"{wall * 1e3:.1f} ms")
        for o in outs:
            n_occ = pipe.check_capacity(o)
            assert o.color.shape == (720, 1280, 4) and tuple(o.tsdf.shape) == res[::-1]
            assert bool(torch.isfinite(o.color).all()) and bool(torch.isfinite(o.depth).all())
            assert bool(torch.isfinite(o.tsdf.float()).all())
            cov = float(o.hit.float().mean())
            assert cov > 0.0, f"{label}: render coverage is 0"
        print(f"{label}: outputs: occupied bricks {n_occ} / {pipe.max_bricks}, coverage "
              f"{cov:.4f}, occupied ratio {float(outs[-1].occupied_ratio):.4f}")
        return outs

    def check_integrator(name, source, replaces, run_kernel, run_plain, limit, reps, nbytes,
                         ops):
        """An integration kernel against its plain version at the repo's
        bound between formulations (tests/test_tsdf_affine.py:109-116)."""
        vol, cvol = run_kernel()
        pvol, pcvol = run_plain()
        v, pv = vol.float(), pvol.float()
        cdim = 1 if cvol.shape[1] == 4 else -1        # z-major or channels-last color
        off = float(((v - pv).abs() > 1e-4).float().mean())
        cd = float(((cvol.float() - pcvol.float()).abs().amax(dim=cdim) > 1e-2).float().mean())
        occ, pocc = int((v > -limit + 1e-9).sum()), int((pv > -limit + 1e-9).sum())
        ok = off < 1e-4 and cd < 1e-3 and abs(occ - pocc) <= max(100, 0.002 * pocc) and occ > 0
        print(f"  {name}: voxels off >1e-4: {off:.2e}, color off >1e-2: {cd:.2e}, "
              f"occupied voxels {occ} vs {pocc}")
        report(name, source, replaces, _errs(v, pv),
               "<1e-4 of voxels off >1e-4, <1e-3 color off >1e-2, occupancy within 0.2%",
               ok, run_kernel, run_plain, reps, nbytes, ops)

    def integrator_work(packed, n_occ, index_bytes, res, out_bytes, in_bytes_per_brick,
                        pair_ops):
        """Bytes and fp32 operations of one integration: the packed frames,
        the brick index (list or per-brick slot map), the fused bricks'
        per-sensor inputs, the dense outputs; ``pair_ops`` per (voxel,
        sensor), COLOR_OPS per voxel."""
        k = packed.shape[0]
        vox = res[0] * res[1] * res[2]
        nbytes = (packed.numel() * 4 + index_bytes + n_occ * k * in_bytes_per_brick
                  + vox * out_bytes)
        return nbytes, n_occ * 4096 * (k * pair_ops + COLOR_OPS)

    if "--sweep" in sys.argv[1:]:
        # phase 16 alone, on phase 3's rig and frames
        rig, bbox, frames = bench_inputs(4, 512, 424, (128, 256, 128), (128, 128, 128), SEED,
                                         frames=NUM_FRAMES)
        _sweep_phase(rig, bbox, frames, card, report, launches)
        return _finish(t_start, results, launches, card)

    if "--ladder" in sys.argv[1:]:
        # phase 15 alone, on phase 3's rig and frames
        rig, _, frames = bench_inputs(4, 512, 424, (128, 256, 128), (128, 128, 128), SEED,
                                      frames=NUM_FRAMES)
        _ladder_phase(rig, frames, card, check_integrator, integrator_work, launches)
        return _finish(t_start, results, launches, card)

    # -- 3. pinhole 256^3 ---------------------------------------------------
    t0 = time.perf_counter()
    # APP_FRAMES distinct frames: phases 3-6 take the first 4, the app phase all
    rig, bbox, frames = bench_inputs(4, 512, 424, (128, 256, 128), (128, 128, 128), SEED,
                                     frames=APP_FRAMES)
    print(f"pinhole rig + frames: {time.perf_counter() - t0:.1f} s")
    n = 256
    cfg = bench_config(bbox, n)
    pipe = pl.FramePipeline(rig, cfg, device=dev, log=lambda s: print(f"  {s}"))
    mv, proj = pipe.default_camera()
    recs = warm_up("pinhole", pipe, frames[0], mv, proj, {
        "bilateral_accum": (pp, "bilateral_accum"),
        "quality": (pp, "quality_cuda"),
        "mark_bricks": (bricks, "mark_bricks"),
        "warp_screen_registration": (pp, "warp_screen"),
        "warp_screen_screen": (rmf, "warp_screen"),
        "integrate_dense": (integ_mod, "integrate_dense"),
        "holefill": (inpaint, "build_pyramid"),
    })

    # bilateral_accum: the 13x13 accumulators of the 4 x 424 x 512 frame
    (d_in, lim_in), _ = recs["bilateral_accum"].calls[0]
    got = pp.bilateral_accum(d_in, lim_in)
    want = pp.bilateral_accum_plain(d_in, lim_in)
    ok = all(torch.allclose(g, w, atol=2e-4, rtol=2e-5) for g, w in zip(got, want))
    report("bilateral_accum", "rgbd_recon_torch/csrc/bilateral_accum.cu",
           "rgbd_recon_tpu/ops/preprocess_pallas.py:75",
           _errs(torch.stack(got), torch.stack(want)), "atol 2e-4 rtol 2e-5",
           ok, lambda: pp.bilateral_accum(d_in, lim_in),
           lambda: pp.bilateral_accum_plain(d_in, lim_in), 20,
           16 * d_in.numel() + lim_in.numel() * 4, d_in.numel() * 169 * TAP_OPS)

    # quality: the 13x13 stencil and its epilogue on the frame's 4 x 424 x 512
    # pixels, bit for bit the twin; its work: the taps of the pixels inside
    # (0, 1) (the others write 0), every depth read and every output written,
    # the normal and world position of each pixel inside
    q_args, _ = recs["quality"].calls[0]
    got = pp.quality_cuda(*q_args)
    want = pp.quality_plain(*q_args)
    dn = q_args[0][..., 0]
    n_in = int(((dn > 0) & (dn < 1)).sum())
    print(f"  quality: {n_in} pixels inside (0, 1) of {dn.numel()}")
    report("quality", "rgbd_recon_torch/csrc/quality.cu",
           "none (rgbd_recon_tpu/ops/preprocess.py::quality, XLA ops)", _errs(got, want),
           "bit for bit", bool(torch.equal(got.view(torch.int32), want.view(torch.int32))),
           lambda: pp.quality_cuda(*q_args), lambda: pp.quality_plain(*q_args), 20,
           8 * dn.numel() + 24 * n_in + q_args[3].numel() * 4,
           n_in * 169 * QUALITY_TAP_OPS)

    # holefill (kernel 11): the pyramid's levels and the resolve on the
    # frame's rendered 1280 x 720 image, every level and the output bit for
    # bit the twins; its work: the image read once, each coarser level
    # written and read again, the output written; the level taps and the
    # pixels the resolve blends (holes at LOD 0 that are no background)
    (h_col, h_dep, h_lods), _ = recs["holefill"].calls[0]
    kc, kd = inpaint.build_pyramid(h_col, h_dep, h_lods)
    pc, pd = inpaint.build_pyramid_plain(h_col, h_dep, h_lods)
    got, want = inpaint.colorfill(kc, kd), inpaint.colorfill_plain(pc, pd)
    same = len(kc) == len(pc) and all(
        torch.equal(a.view(torch.int32), b.view(torch.int32))
        for a, b in zip(kc + kd + [got], pc + pd + [want]))
    hh, hw = h_dep.shape
    n_blend = int(((h_col[..., 3] <= 0) & (h_dep < 1)).sum())
    lvl_px = sum(d.numel() for d in kd[1:])
    print(f"  holefill: {len(kc)} LODs {[tuple(d.shape) for d in kd]}, {n_blend} pixels "
          f"blended of {hh * hw}")
    report("holefill", "rgbd_recon_torch/csrc/holefill.cu",
           "none (rgbd_recon_tpu/ops/inpaint.py, XLA ops)", _errs(got, want), "bit for bit",
           same, lambda: inpaint.colorfill(*inpaint.build_pyramid(h_col, h_dep, h_lods)),
           lambda: inpaint.colorfill_plain(*inpaint.build_pyramid_plain(h_col, h_dep, h_lods)),
           20, hh * hw * (20 + 16) + 2 * lvl_px * 20,
           lvl_px * 16 * HOLEFILL_TAP_OPS + n_blend * HOLEFILL_BLEND_OPS)

    # mark_bricks: the world points of all 4 sensors, integer-exact; its
    # work: every valid flag, the 12 bytes of each valid point (the only
    # points it reads) and the counts written
    (w_in, v_in, grid), _ = recs["mark_bricks"].calls[0]
    got = bricks.mark_bricks(w_in, v_in, grid).to(torch.int64)
    want = bricks.mark_bricks_plain(w_in, v_in, grid).to(torch.int64)
    n_valid = int(v_in.sum())
    print(f"  mark_bricks: {n_valid} valid points of {v_in.numel()}, {got.numel()} bins")
    report("mark_bricks", "rgbd_recon_torch/csrc/mark_bricks.cu",
           "rgbd_recon_tpu/ops/bricks_pallas.py:100", _errs(got, want), "exact",
           bool(torch.equal(got, want)) and int(got.sum()) > 0,
           lambda: bricks.mark_bricks(w_in, v_in, grid),
           lambda: bricks.mark_bricks_plain(w_in, v_in, grid), 20,
           v_in.numel() + 12 * n_valid + got.numel() * 4, n_valid * 20)

    # the floor under a small kernel's graph-replayed time: an empty kernel
    # at mark_bricks' grid, alone and after the memset of its counts
    floor = native.library().rr_launch_floor
    floor.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p]
    floor.restype = ctypes.c_int
    fbuf = torch.empty(got.numel(), dtype=torch.int32, device=dev)
    fblocks = 2 * torch.cuda.get_device_properties(0).multi_processor_count
    t_floor = [_time_ms(lambda nb=nb: floor(fbuf.data_ptr(), nb, fblocks, 256,
                                            torch.cuda.current_stream().cuda_stream), 20,
                        graph=True) for nb in (0, fbuf.numel() * 4)]
    print(f"launch floor: an empty {fblocks}x256 kernel {t_floor[0]:.4f} ms, after a memset "
          f"of {fbuf.numel() * 4} bytes {t_floor[1]:.4f} ms (graph replay; {card})")

    # warp_screen: registration (sensor 0 color) and the sweep->screen warp;
    # yardstick F.grid_sample (bilinear, border, align_corners) on the same
    # image in NCHW, the same function wherever no tile's window clamp bites
    ws_entry = {}
    for key, label in (("warp_screen_registration", "registration"),
                       ("warp_screen_screen", "screen")):
        (img, fy, fx, tile), kw = recs[key].calls[0]
        ch = kw.get("channels")
        ti, si, cp = img.shape
        c = ch or cp
        wh, y0, x0 = warp_ops.warp_windows(ti, si, fy, fx, tile)
        got = warp_ops.warp_screen_cuda(img, fy, fx, tile, wh, y0, x0, ch)
        want = warp_ops.warp_screen_plain(img, fy, fx, tile, wh, y0, x0, ch)
        inp = img[..., :c].permute(2, 0, 1)[None].contiguous()
        grid_n = torch.stack([fx / (si - 1) * 2 - 1, fy / (ti - 1) * 2 - 1], dim=-1)[None]

        def grid_sample(inp=inp, grid_n=grid_n):
            return F.grid_sample(inp, grid_n, mode="bilinear", padding_mode="border",
                                 align_corners=True)

        nty, ntx = fy.shape[0] // tile[0], fy.shape[1] // tile[1]
        oy, ox = (o.reshape(nty, ntx).repeat_interleave(tile[0], 0)
                  .repeat_interleave(tile[1], 1).float() for o in (y0, x0))
        ry, rx = fy - oy, fx - ox
        clamped = (ry < 0) | (ry > wh - 1) | (rx < 0) | (rx > warp_ops.WXW - 1)
        dev_gs = (grid_sample()[0].permute(1, 2, 0) - got).abs().amax(dim=-1)
        print(f"  warp_screen[{label}]: the window clamp moves {int(clamped.sum())} of "
              f"{clamped.numel()} pixels; grid_sample vs kernel elsewhere: max "
              f"{float(dev_gs[~clamped].max()):.3e}")
        h, w = fy.shape
        ws_entry[label] = f"warp_screen[{label} {(ti, si, c)}->{tuple(fy.shape)}]"
        report(ws_entry[label],
               "rgbd_recon_torch/csrc/warp_screen.cu",
               "rgbd_recon_tpu/ops/warp_pallas.py:116", _errs(got, want),
               "atol 1e-5 rtol 1e-5", bool(torch.allclose(got, want, atol=1e-5, rtol=1e-5)),
               lambda: warp_ops.warp_screen_cuda(img, fy, fx, tile, wh, y0, x0, ch),
               lambda: warp_ops.warp_screen_plain(img, fy, fx, tile, wh, y0, x0, ch), 20,
               ti * si * c * 4 + h * w * 8 + y0.numel() * 8 + h * w * c * 4,
               h * w * (10 + 6 * c), library=grid_sample)

    # integrate_dense: the warm-up frame's occupied bricks at 256^3
    (fr, aff, tcfg, m16, maxb, woff, wy, wx, xs, cls), _ = recs["integrate_dense"].calls[0]
    idx, count, slots = occupied_bricks(m16, maxb)
    packed = pack_frames(fr)
    iargs = (packed, aff.coeffs, idx, count, woff, cls, tcfg.res, wy, wx, xs, float(tcfg.limit))
    kargs = (pack_planes(fr), aff.coeffs, idx, count, slots) + iargs[4:]
    print(f"  integrate_dense: {int(count)} fused bricks of {slots.numel()}")
    check_integrator("integrate_dense", "rgbd_recon_torch/csrc/integrate_dense.cu",
                     "rgbd_recon_tpu/ops/tsdf_dense.py:452",
                     lambda: tsdf_dense.integrate_dense_cuda(*kargs),
                     lambda: tsdf_dense.integrate_dense_plain(*iargs), tcfg.limit, 5,
                     # per (brick, sensor): 3 x 10 coefficients, window, class
                     *integrator_work(packed, int(count), (slots.numel() + int(count) + 1) * 4,
                                      tcfg.res, 10, 3 * 40 + 8 + 4, FUSE_OPS))

    outs = drive("pinhole", pipe, frames, mv, proj, PATH_KERNELS + ("integrate_dense",),
                 PINHOLE_FRAMES, cfg.tsdf_res, split={"warp_screen": [
                     (pp, "warp_screen", lambda a, kw: ws_entry["registration"]),
                     (rmf, "warp_screen", lambda a, kw: ws_entry["screen"])]})
    launches["holefill"] = sum(launches[k] for k in HOLEFILL)
    # phase 11 (d) renders this path's production volume of the first frame
    pre = pipe._pre(*pipe._sensor_inputs(*frames[0]))
    golden = dict(zip(("vol", "cvol"), pipe._integrate(pre)), sweep_res=pipe._sweep_res(),
                  zmajor=pipe.integrator.zmajor, limit=float(pipe.tsdf_cfg.limit))
    del pre
    # phase 12 on this path, then its pinhole extras
    reserved_0 = torch.cuda.memory_reserved()
    _fused_phase("pinhole 256^3", pipe, frames, mv, proj, outs,
                 PATH_KERNELS + ("integrate_dense",), card)
    _fused_pinhole(pipe, frames, mv, proj, card, reserved_0)
    del pipe, recs, iargs, kargs, packed, slots, fr, aff, m16, woff, cls, outs

    # -- 16. the sweep kernel at 256^3 and 512^3 (on this phase's rig) -------
    _sweep_phase(rig, bbox, frames, card, report, launches)

    # -- 4. distorted rig, 256^3 (the piecewise warp, kernel 5) --------------
    t0 = time.perf_counter()
    drig, dbbox, dframes = bench_inputs(4, 512, 424, (128, 256, 128), (128, 128, 128),
                                        SEED, frames=NUM_FRAMES, distortion=DISTORT,
                                        device=dev)
    print(f"distorted rig + frames (float64 on the card): {time.perf_counter() - t0:.1f} s")
    logs = []

    def dlog(s):
        logs.append(s)
        print(f"  {s}")

    t0 = time.perf_counter()
    dcfg = bench_config(dbbox, n)
    pipe = pl.FramePipeline(drig, dcfg, device=dev, log=dlog)
    print(f"distorted: affine bake {time.perf_counter() - t0:.1f} s")
    recs = warm_up("distorted", pipe, dframes[0], mv, proj, {
        "bake_piecewise_warp": (pl, "bake_piecewise_warp"),
        "piecewise_eval": (warp_ops, "piecewise_eval"),
    })
    print(f"distorted: piecewise warp bake {recs['bake_piecewise_warp'].seconds[0]:.2f} s "
          f"(host clock, synchronized)")
    if not any("piecewise warp (48 knots) residual" in s and "gather" not in s for s in logs):
        raise RuntimeError(f"the distorted rig did not take the piecewise tier: {logs}")
    if not isinstance(pipe._warp, warp_ops.PiecewiseWarp) or not pipe.integrator.zmajor:
        raise RuntimeError("the distorted rig is not on the piecewise + dense-emit path")

    # piecewise_eval at each distinct call of the frame: xyz (M=1, C=3:
    # bilateral_lab's and quality's), uv (M=1, C=2) and the normal stencil
    # (M=5, C=3, one offset a tap)
    pcalls = {}
    for args, kw in recs["piecewise_eval"].calls:
        pcalls.setdefault(_piecewise_call(args, kw), []).append((args, kw.get("offsets")))
    by_call = {key: len(v) for key, v in pcalls.items()}
    print(f"  piecewise_eval launches in the warm-up frame by call: {by_call}")
    if by_call != {"xyz": 2, "uv": 1, "stencil": 1}:
        raise RuntimeError(f"a distorted frame should launch kernel 5 4 times: {by_call}")
    pe_entry = {}
    for key in ("xyz", "uv", "stencil"):
        (D, a, b, r, d_min, d_max), offs = pcalls[key][0]
        m, k, h, w = D.shape
        c, s = r.shape[1], r.shape[2]
        got = warp_ops.piecewise_eval_cuda(D, a, b, r, d_min, d_max, offs)
        want = warp_ops.piecewise_eval_plain(D, a, b, r, d_min, d_max, offs)
        pe_entry[key] = f"piecewise_eval[{key} M={m} C={c} {(k, h, w)} S={s}]"
        report(pe_entry[key],
               "rgbd_recon_torch/csrc/piecewise_eval.cu",
               "rgbd_recon_tpu/ops/piecewise_pallas.py:45", _errs(got, want),
               "bitwise: the same float32 operations, no FMA contraction",
               bool(torch.equal(got, want)),
               lambda: warp_ops.piecewise_eval_cuda(D, a, b, r, d_min, d_max, offs),
               lambda: warp_ops.piecewise_eval_plain(D, a, b, r, d_min, d_max, offs), 20,
               # per map-pixel D, two knots a channel, the output; per pixel A, B
               m * k * h * w * (4 + 8 * c) + k * h * w * 8 * c,
               # per map-pixel the knot coordinate and weights (8), 6 a channel
               m * k * h * w * (8 + 6 * c))
    outs = drive("distorted", pipe, dframes, mv, proj,
                 PATH_KERNELS + ("integrate_dense", "piecewise_eval"), NUM_FRAMES,
                 dcfg.tsdf_res, split={"piecewise_eval": [
                     (warp_ops, "piecewise_eval",
                      lambda a, kw: pe_entry[_piecewise_call(a, kw)])]})
    per_call = [launches[pe_entry[key]] for key in ("xyz", "uv", "stencil")]
    if per_call != [2 * NUM_FRAMES, NUM_FRAMES, NUM_FRAMES]:
        raise RuntimeError(f"kernel 5 launched {per_call} times (xyz, uv, stencil) in "
                           f"{NUM_FRAMES} distorted frames, not 2, 1, 1 a frame")
    _fused_phase("distorted 256^3", pipe, dframes, mv, proj, outs,
                 PATH_KERNELS + ("integrate_dense", "piecewise_eval"), card)
    del pipe, recs, pcalls, D, a, b, r, got, want, dframes, outs

    # -- 5. block-major integrator: pinhole rig at 240^3 (kernel 6) ----------
    bcfg = bench_config(bbox, 240)
    pipe = pl.FramePipeline(rig, bcfg, device=dev, log=lambda s: print(f"  {s}"))
    recs = warm_up("block-major", pipe, frames[0], mv, proj,
                   {"integrate_affine": (integ_mod, "integrate_affine")})
    if pipe.integrator.tier != integ_mod.BLOCK_MAJOR:
        raise RuntimeError("the 240^3 volume did not take the block-major integrator")
    (fr, aff, tcfg, m16, maxb, woff, wy), kw = recs["integrate_affine"].calls[0]
    win = {"wx": kw["wx"], "xstride": kw["xstride"]}     # the pipeline's: the whole frame
    idx, count, slots = occupied_bricks(m16, maxb)
    packed = pack_frames(fr)
    aargs = (packed, aff.coeffs, idx, count, woff, tcfg.res, wy, float(tcfg.limit))
    kargs = (pack_planes(fr), aff.coeffs, idx, count, slots) + aargs[4:]
    print(f"  integrate_affine: {int(count)} fused bricks of {slots.numel()} at {tcfg.res}")
    check_integrator("integrate_affine", "rgbd_recon_torch/csrc/integrate_dense.cu",
                     "rgbd_recon_tpu/ops/tsdf_persist.py:787",
                     lambda: tsdf_persist.integrate_affine_cuda(*kargs, **win),
                     lambda: tsdf_persist.integrate_affine_plain(*aargs, **win), tcfg.limit, 5,
                     *integrator_work(packed, int(count), (slots.numel() + int(count) + 1) * 4,
                                      tcfg.res, 12, 3 * 40 + 8, FUSE_OPS))

    # kernel 6 in raw mode (block-major, no clear) against its plain
    # version on the visited blocks; its work: the inputs as above, the
    # occupied blocks and the visited flags written
    vbm, cbm, visited = tsdf_persist.integrate_affine_cuda(*kargs, raw=True, **win)
    pvbm, pcbm, pvisited = tsdf_persist.integrate_affine_plain(*aargs, raw=True, **win)
    vis = visited.nonzero().squeeze(1)
    v, pv = vbm[vis], pvbm[vis]
    off = float(((v - pv).abs() > 1e-4).float().mean())
    cd = float(((cbm[vis].float() - pcbm[vis].float()).abs().amax(dim=1) > 1e-2).float().mean())
    n_occ = int(count)
    print(f"  integrate_affine[raw]: {vis.numel()} visited blocks; voxels off >1e-4: "
          f"{off:.2e}, color off >1e-2: {cd:.2e}")
    report("integrate_affine[raw]", "rgbd_recon_torch/csrc/integrate_dense.cu",
           "rgbd_recon_tpu/ops/tsdf_persist.py:787", _errs(v, pv),
           "visited as the plain version's; on them <1e-4 of voxels off >1e-4, <1e-3 color "
           "off >1e-2", torch.equal(visited, pvisited) and vis.numel() == n_occ and off < 1e-4
           and cd < 1e-3,
           lambda: tsdf_persist.integrate_affine_cuda(*kargs, raw=True, **win),
           lambda: tsdf_persist.integrate_affine_plain(*aargs, raw=True, **win), 5,
           packed.numel() * 4 + (slots.numel() + n_occ + 1) * 4
           + n_occ * packed.shape[0] * (3 * 40 + 8)
           + n_occ * 4096 * 12 + visited.numel(),
           n_occ * 4096 * (packed.shape[0] * FUSE_OPS + COLOR_OPS))
    del pvbm, pcbm, pvisited, v, pv

    # kernel 6 in raw mode, then kernel 8: bit for bit the voxel-order
    # output of kernel 6; kernel 8 exactly its plain version
    dense_v, dense_c = assemble.scatter_dense_cuda(vbm, cbm, idx, count, tcfg.res, tcfg.limit)
    want_v, want_c = tsdf_persist.integrate_affine_cuda(*kargs, **win)
    same = (torch.equal(dense_v, want_v) and torch.equal(dense_c.permute(1, 2, 3, 0), want_c)
            and int(visited.sum()) == int(count))
    print(f"  integrate_affine raw + scatter_dense bit for bit the voxel-order output: "
          f"{'ok' if same else 'FAIL'}")
    if not same:
        raise RuntimeError("integrate_affine raw + scatter_dense != integrate_affine")
    pv, pc = assemble.scatter_dense_plain(vbm, cbm, idx, count, tcfg.res, tcfg.limit)
    n8 = int(count)
    nbz, nby, nbx = (r // 16 for r in tcfg.res[::-1])
    sel = idx[:n8].long()
    bz, by, bx = sel // (nby * nbx), (sel // nbx) % nby, sel % nbx

    def index_put():
        """The clear plus one index_select + index_put_ per array (indices
        prepared outside the timing)."""
        v = torch.full((nbz, 16, nby, 16, nbx, 16), -tcfg.limit, device=dev)
        c = torch.zeros((4, nbz, 16, nby, 16, nbx, 16), dtype=torch.bfloat16, device=dev)
        v.permute(0, 2, 4, 1, 3, 5).index_put_(
            (bz, by, bx), vbm.index_select(0, sel).view(n8, 16, 16, 16))
        c.permute(1, 3, 5, 0, 2, 4, 6).index_put_(
            (bz, by, bx), cbm.index_select(0, sel).view(n8, 4, 16, 16, 16))
        return v, c

    lv, lc = index_put()
    if not (torch.equal(lv.view(-1), dense_v.view(-1)) and torch.equal(lc.view(-1),
                                                                       dense_c.view(-1))):
        raise RuntimeError("the index_put_ yardstick of scatter_dense computes another function")
    vox = tcfg.res[0] * tcfg.res[1] * tcfg.res[2]
    report("scatter_dense", "rgbd_recon_torch/csrc/scatter_dense.cu",
           "rgbd_recon_tpu/ops/assemble_pallas.py:116", _errs(dense_v, pv),
           "exact (a copy)",
           bool(torch.equal(dense_v, pv)) and bool(torch.equal(dense_c, pc)),
           lambda: assemble.scatter_dense_cuda(vbm, cbm, idx, count, tcfg.res, tcfg.limit),
           lambda: assemble.scatter_dense_plain(vbm, cbm, idx, count, tcfg.res, tcfg.limit),
           20, n8 * 4096 * 12 + n8 * 4 + vox * 12, 0, library=index_put)
    del vbm, cbm, dense_v, dense_c, want_v, want_c, pv, pc, lv, lc

    outs = drive("block-major", pipe, frames, mv, proj, PATH_KERNELS + ("integrate_affine",),
                 NUM_FRAMES, bcfg.tsdf_res)
    _fused_phase("block-major 240^3", pipe, frames, mv, proj, outs,
                 PATH_KERNELS + ("integrate_affine",), card)
    pipe.cfg = pipe.cfg._replace(fused=False)
    del outs

    # the block-major assembly path through the public entry points:
    # kernel 6 in raw mode, then kernel 8
    for k in native.KERNELS.values():
        k.launches = 0
    vbm, cbm, visited = tsdf_persist.integrate_affine(fr, aff, tcfg, m16, maxb, woff, wy,
                                                      raw=True, **win)
    idx, _, count = occupied_list(m16, maxb)
    dense_v, dense_c = assemble.scatter_dense(vbm, cbm, idx, count, tcfg.res, tcfg.limit)
    torch.cuda.synchronize()
    counts = {name: k.launches for name, k in native.KERNELS.items()}
    print(f"assembly: launches of integrate_affine(raw=True) + scatter_dense: {counts}")
    if counts["integrate_affine"] == 0 or counts["scatter_dense"] == 0:
        raise RuntimeError(f"the assembly path did not launch kernels 6 and 8: {counts}")
    launches["scatter_dense"] = counts["scatter_dense"]
    launches["integrate_affine[raw]"] = counts["integrate_affine"]
    if not (bool(torch.isfinite(dense_v).all()) and int((dense_v > -tcfg.limit).sum()) > 0):
        raise RuntimeError("the assembled volume is not finite or holds no surface")
    del pipe, recs, aargs, kargs, packed, slots, fr, aff, m16, woff, vbm, cbm, dense_v, dense_c

    # -- 6. table integrator: pinhole rig at 256^3, use_affine=False (kernel 7)
    tcfg_p = bench_config(bbox, n, use_affine=False)
    t0 = time.perf_counter()
    pipe = pl.FramePipeline(rig, tcfg_p, device=dev, log=lambda s: print(f"  {s}"))
    torch.cuda.synchronize()
    print(f"table: warp-table bake {time.perf_counter() - t0:.1f} s "
          f"({pipe.integrator.tables.pos_blocked.numel() * 4 / 1e6:.0f} MB)")
    recs = warm_up("table", pipe, frames[0], mv, proj,
                   {"integrate_sparse": (integ_mod, "integrate_sparse")})
    if pipe.integrator.tier != integ_mod.WARP_TABLE:
        raise RuntimeError("use_affine=False did not take the table integrator")
    (fr, tables, tcfg, m16, maxb, woff), _ = recs["integrate_sparse"].calls[0]
    idx, _, count = occupied_list(m16, maxb)
    sargs = (pack_frames(fr), tables.pos_blocked, idx, count, woff, tcfg.res,
             float(tcfg.limit))
    print(f"  integrate_sparse: {int(count)} occupied bricks (no depth-band cull)")
    check_integrator("integrate_sparse", "rgbd_recon_torch/csrc/integrate_sparse.cu",
                     "rgbd_recon_tpu/ops/tsdf_pallas.py:437",
                     lambda: tsdf_sparse.integrate_sparse_cuda(*sargs),
                     lambda: tsdf_sparse.integrate_sparse_plain(*sargs), tcfg.limit, 5,
                     *integrator_work(sargs[0], int(count), 4 + int(count) * 4, tcfg.res, 20,
                                      4096 * 12 + 8, FUSE_OPS - WARP_OPS))
    outs = drive("table", pipe, frames, mv, proj, PATH_KERNELS + ("integrate_sparse",),
                 NUM_FRAMES, tcfg_p.tsdf_res)
    _fused_phase("table 256^3", pipe, frames, mv, proj, outs,
                 PATH_KERNELS + ("integrate_sparse",), card)
    del pipe, recs, sargs, fr, tables, m16, woff, outs
    torch.cuda.empty_cache()

    # -- 7. the gather tier, once: a small distorted frame -------------------
    grig, gbbox, gframes = bench_inputs(2, 128, 104, (32, 48, 32), (32, 32, 32), SEED,
                                        frames=1, distortion=DISTORT, device=dev)
    logs = []
    gcfg = pl.PipelineConfig(render_width=320, render_height=240, tsdf_res=(128, 128, 128),
                             voxel_size=float(np.max(gbbox.size) / 128),
                             sweep_res=(256, 256), pw_warp_tol=1e-9)
    pipe = pl.FramePipeline(grig, gcfg, device=dev, log=logs.append)
    smv, sproj = pipe.default_camera()
    o = pipe.step(*gframes[0], smv, sproj)
    gather_log = [s for s in logs if "using exact gather path" in s]
    if pipe._warp is not None or not gather_log:
        raise RuntimeError(f"pw_warp_tol below the residual did not take the gather tier: {logs}")
    if not (bool(torch.isfinite(o.color).all()) and float(o.hit.float().mean()) > 0.0):
        raise RuntimeError("the gather tier's frame is not finite or has no coverage")
    print(f"gather tier: {gather_log[0].strip()}; coverage {float(o.hit.float().mean()):.4f}")
    del pipe, o

    # -- 8. small-frame parity: CUDA path vs plain path on the CPU ----------
    srig, sbbox, sframes = bench_inputs(3, 256, 212, (48, 64, 48), (48, 48, 48), SEED,
                                        frames=1)
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
    del p, o, res

    # -- 9. the app: compressed scene replay through rgbd_recon_torch.app ---
    # -- 10. the reconstruction strategies (models/) on the same scene -----
    with tempfile.TemporaryDirectory(prefix="rgbd_app_") as work:
        scene = _app_phase(rig, frames, card, work)
        _models_phase(rig, frames, card, work, check_integrator, integrator_work, launches)
        _reference_phase(rig, bbox, frames, golden, mv, proj, card, work, drive)
        # -- 12. fused mode: phases 3-6 above, then the reference path -------
        _fused_reference(card)
        # -- 13. sharded and offline, on phase 3's inputs and phase 9's scene
        _sharded_phase(rig, bbox, frames, card, work, *scene)
    # -- 14. the card's frame against the JAX package's stored outputs -----
    _jax_phase(rig, frames, card)
    # -- 15. the bench's other configurations against the JAX package ------
    _ladder_phase(rig, frames, card, check_integrator, integrator_work, launches)
    return _finish(t_start, results, launches, card)


def _finish(t_start: float, results: dict, launches: dict, card: str) -> int:
    """The last three lines: the kernels JSON, the card, the result."""
    import torch

    print(f"total wall time: {time.perf_counter() - t_start:.1f} s")
    kernels = [
        {"name": name, "route": "cuda", "source": r["source"], "replaces": r["replaces"],
         "launches": launches[name if name in launches else name.split("[")[0]],
         "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "cold_ms": r["cold_ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
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

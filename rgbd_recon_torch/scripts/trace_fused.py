"""Device-time budget of the FUSED frame step (mirrors ``scripts/trace_fused.py``).

Records ``--steps`` fused frames (each one CUDA graph replay) under
``torch.profiler`` with CUDA activities and aggregates the GPU time per
frame by kernel name, taking each event's self time (an event nested in
another, as a graph's memset inside a copy's span, is not counted twice),
then by stage. It prints the device's busy share of the frame: the union
of the GPU events' spans over the frames' wall time (host clock, synced).

A replayed kernel carries no shapes and no Python stack (its launch is
the one ``cudaGraphLaunch``), so the script also profiles the frame
function once eagerly, with each stage in a ``record_function`` range,
and lines the replay's GPU events up with that run's (the graph holds the
same launches in the same order): each replayed event takes the stage
and the input shapes of its eager twin. Buckets: the port's hand-written
kernels by name (``bilateral_accum`` ...), 3recon's ops on the render
size's pixels as ``3recon: screen`` (the screen warp's maps, shading) and
its other ops as ``3recon: sweep``, the rest of each stage by stage name,
and the copies outside the graph (the frame's inputs in, the outputs'
copies out) as ``io``.

    python -m rgbd_recon_torch.scripts.trace_fused [--tsdf 256] [--sensors 4]
        [--render 1280x720] [--steps 3] [--out chiprun_out/trace_fused] [--parse-only]

It needs the card; ``--parse-only`` re-reads the traces of an earlier run
(``trace.json.gz``, ``eager.json.gz``, ``meta.json`` in ``--out``).
"""
from __future__ import annotations

import argparse
import collections
import gzip
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ..calibration import synthetic
from ..runtime.pipeline import STAGE_TIMERS, FramePipeline, PipelineConfig
from ..utils.math import Bbox

# device function name (csrc/*.cu) -> the port's kernel entry
PORT_KERNELS = {
    "bilateral_accum_kernel": "bilateral_accum",
    "quality_kernel": "quality",
    "mark_bricks_kernel": "mark_bricks",
    "warp_screen_kernel": "warp_screen",
    "integrate_quadratic_kernel": "integrate_dense/affine",
    "integrate_sparse_kernel": "integrate_sparse",
    "piecewise_eval_kernel": "piecewise_eval",
    "copy_bricks_kernel": "scatter_dense",
}
GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def build(tsdf: int, sensors: int, render: tuple[int, int], log=print):
    """The bench rig (sensors at 512x424, the two-sphere scene) and a fused
    pipeline on the card at ``tsdf``^3; returns (pipe, (depth, color, mv,
    proj))."""
    bbox = Bbox.default()
    rig, cams = synthetic.synthetic_rig(num_sensors=sensors, bbox=bbox,
                                        fwd_res=(128, 256, 128), inv_res=(128, 128, 128),
                                        width=512, height=424)
    depth, color = synthetic.render_frames(cams, synthetic.SphereScene.default(bbox))
    pipe = FramePipeline(rig, PipelineConfig(
        render_width=render[0], render_height=render[1], tsdf_res=(tsdf,) * 3,
        voxel_size=float(np.max(bbox.size) / tsdf), brick_size=0.1, num_lods=6, fused=True),
        log=log, device="cuda")
    mv, proj = pipe.default_camera()
    return pipe, (depth, color, mv, proj)


def record(pipe: FramePipeline, frame, steps: int, out: str) -> None:
    """Warm up (capture), then write ``eager.json.gz`` (the frame function
    once, eagerly, stages as ``record_function`` ranges, input shapes),
    ``trace.json.gz`` (``steps`` fused frames) and ``meta.json`` (their wall
    time, the card) into ``out``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    os.makedirs(out, exist_ok=True)
    pipe.warmup(*frame)
    pipe.step(*frame)
    torch.cuda.synchronize()
    key = pipe._fused_key(frame[0], frame[2])
    with profile(activities=acts, record_shapes=True) as prof:
        pipe._frame(*pipe._graphs._inputs, *key, scope=record_function)
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(out, "eager.json.gz"))
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            pipe.step(*frame)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(os.path.join(out, "trace.json.gz"))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    with open(os.path.join(out, "meta.json"), "w") as f:
        json.dump({"steps": steps, "wall_ms": wall * 1e3, "card": card.stdout.strip(),
                   "sweep_res": list(pipe._sweep_res()), "tsdf_res": list(pipe.tsdf_cfg.res),
                   "render": [pipe.cfg.render_height, pipe.cfg.render_width],
                   "key": list(key)}, f)


def _events(path: str) -> list[dict]:
    with gzip.open(path, "rt") as f:
        return json.load(f)["traceEvents"]


def _gpu(events) -> list[dict]:
    return sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in GPU_CATS),
                  key=lambda e: (e["ts"], -e["dur"]))


def _corr(e) -> int | None:
    return (e.get("args") or {}).get("correlation")


def _eager_labels(events) -> list[tuple[str, str, str]]:
    """(name, stage, input dims) of each GPU event of the eager run, in
    order: the stage range and the op that enclose its launch."""
    runtime = {_corr(e): e for e in events
               if e.get("cat") in ("cuda_runtime", "cuda_driver") and _corr(e) is not None}
    ops = {(e.get("args") or {}).get("External id"): e for e in events
           if e.get("cat") == "cpu_op"}
    stages = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name") in STAGE_TIMERS]
    out = []
    for e in _gpu(events):
        launch = runtime.get(_corr(e))
        stage, dims = "?", ""
        if launch is not None:
            ts = launch["ts"]
            stage = next((s["name"] for s in stages if s["ts"] <= ts <= s["ts"] + s["dur"]), "?")
            op = ops.get((launch.get("args") or {}).get("External id"))
            if op is not None:
                dims = str((op.get("args") or {}).get("Input Dims", ""))
        out.append((e["name"], stage, dims))
    return out


def _bucket(name: str, stage: str, dims: str, screen: tuple[int, int]) -> str:
    """The port's kernels by name; 3recon split into the screen warp and
    shading (ops on the render size's pixels) and the sweep (the rest:
    the slices' resampling and the hit carry on the sweep grid)."""
    for fn, entry in PORT_KERNELS.items():
        if fn in name:
            return f"kernel {entry}"
    if stage == "3recon":
        return "3recon: screen" if f"{screen[0]}, {screen[1]}" in dims else "3recon: sweep"
    return stage


def _align(names: list[str], eager: list[str], look: int = 32):
    """The eager twin's index of each replayed event (None where none is
    found) and the first place the two runs part, for the log. Walks both
    in step; where the names differ, skips the fewer events (up to
    ``look``) on one side that brings them back together: a run may hold
    events the other does not (a memset traced in one of them)."""
    def same(a, b):     # a memset is named by its API in one run, its node in the other
        return a == b or ("emset" in a and "emset" in b)

    twins, i, j, miss = [], 0, 0, None
    while i < len(names):
        if j < len(eager) and same(names[i], eager[j]):
            twins.append(j)
            i, j = i + 1, j + 1
            continue
        if miss is None:
            miss = (f"replay #{i} {names[i][:60]!r} against eager #{j} "
                    f"{eager[j][:60]!r}" if j < len(eager) else f"replay #{i} past the end")
        skip_e = next((k for k in range(1, look) if j + k < len(eager)
                       and same(eager[j + k], names[i])), None)
        skip_r = next((k for k in range(1, look) if i + k < len(names) and j < len(eager)
                       and same(names[i + k], eager[j])), None)
        if skip_e is not None and (skip_r is None or skip_e <= skip_r):
            j += skip_e
        elif skip_r is not None:
            twins.extend([None] * skip_r)
            i += skip_r
        else:
            twins.append(None)
            i, j = i + 1, j + 1
    return twins, miss


def _self_times(gpu) -> tuple[collections.Counter, float]:
    """Self time (us) of each event (by index; the interval stack of the
    JAX script: an event starting inside another takes the part they
    share from it) and the union of the events' spans (us)."""
    self_t, busy, stack, end = collections.Counter(), 0.0, [], -1.0
    for i, e in enumerate(gpu):
        ts, dur = e["ts"], e["dur"]
        while stack and ts >= stack[-1][0] + stack[-1][1] - 1e-9:
            stack.pop()
        if stack:
            p_ts, p_dur, p = stack[-1]
            self_t[p] -= min(ts + dur, p_ts + p_dur) - ts
        self_t[i] += dur
        stack.append((ts, dur, i))
        busy += max(0.0, ts + dur - max(ts, end))
        end = max(end, ts + dur)
    return self_t, busy


def _main_bucket(times: collections.Counter) -> str:
    """The bucket holding most of a kernel name's time, "+" if others
    hold some too (a GEMM of the sweep and of holefill share a name)."""
    top = times.most_common(1)[0][0]
    return top + ("+" if len(times) > 1 else "")


def parse(out: str, log=print) -> dict:
    """Print the per-kernel table, the stage buckets and the busy share of
    the traces in ``out``; returns them."""
    with open(os.path.join(out, "meta.json")) as f:
        meta = json.load(f)
    steps, screen = meta["steps"], tuple(meta["render"])
    events = _events(os.path.join(out, "trace.json.gz"))
    gpu = _gpu(events)
    graph_corr = {_corr(e) for e in events
                  if e.get("cat") in ("cuda_runtime", "cuda_driver")
                  and "GraphLaunch" in e.get("name", "")}
    eager = _eager_labels(_events(os.path.join(out, "eager.json.gz")))
    replays = collections.defaultdict(list)
    for i, e in enumerate(gpu):
        if _corr(e) in graph_corr:
            replays[_corr(e)].append(i)
    label = {}
    matched = total = 0
    first_miss = None
    eager_names = [n for n, _, _ in eager]
    for idx in replays.values():
        twins, miss = _align([gpu[i]["name"] for i in idx], eager_names)
        first_miss = first_miss or miss
        for i, j in zip(idx, twins):
            label[i] = eager[j][1:] if j is not None else ("unaligned", "")
        matched += sum(j is not None for j in twins)
        total += len(idx)
    self_t, busy = _self_times(gpu)
    by_name, count, buckets = collections.Counter(), collections.Counter(), collections.Counter()
    bucket_of = collections.defaultdict(collections.Counter)   # name -> bucket -> us
    for i, e in enumerate(gpu):
        stage, dims = label.get(i, ("io", ""))
        b = _bucket(e["name"], stage, dims, screen)
        by_name[e["name"]] += self_t[i]
        count[e["name"]] += 1
        bucket_of[e["name"]][b] += self_t[i]
        buckets[b] += self_t[i]
    wall_ms = meta["wall_ms"] / steps
    busy_ms = busy / 1e3 / steps
    log(f"== {meta['card']}; key (axis, flip) {tuple(meta['key'])}, {meta['tsdf_res']} ==")
    log(f"== {len(replays)} replays of {steps} frames, {total} GPU events in the graphs, "
        f"{matched} lined up with the eager run's {len(eager)} ({matched / max(total, 1):.2%}); "
        f"GPU self time {sum(self_t.values()) / 1e3 / steps:.3f} ms/frame ==")
    if first_miss:
        log(f"   first event off the eager run: {first_miss}")
    for name, t in by_name.most_common(30):
        log(f"{t / 1e3 / steps:8.3f} ms/frame x{count[name] // steps:5d}  "
            f"[{_main_bucket(bucket_of[name]):22s}] {name[:90]}")
    log("\n== stage buckets (ms/frame) ==")
    for b, t in buckets.most_common():
        log(f"{t / 1e3 / steps:8.3f}  {b}")
    log(f"\ndevice busy {busy_ms:.3f} ms of a {wall_ms:.3f} ms fused frame "
        f"({busy_ms / wall_ms:.1%}; host clock, synced; {meta['card']})")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "busy_share": busy_ms / wall_ms,
            "replays": len(replays), "aligned": matched / max(total, 1),
            "kernels": {n: t / 1e3 / steps for n, t in by_name.items()},
            "buckets": {b: t / 1e3 / steps for b, t in buckets.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tsdf", type=int, default=256)
    ap.add_argument("--sensors", type=int, default=4)
    ap.add_argument("--render", default="1280x720")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "trace_fused"))
    ap.add_argument("--parse-only", action="store_true")
    args = ap.parse_args(argv)
    if not args.parse_only:
        if not torch.cuda.is_available():
            raise SystemExit("trace_fused needs a CUDA device")
        rw, rh = (int(v) for v in args.render.split("x"))
        pipe, frame = build(args.tsdf, args.sensors, (rw, rh),
                            log=lambda m: print(f"# {m}", file=sys.stderr))
        record(pipe, frame, args.steps, args.out)
    parse(args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

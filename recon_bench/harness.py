"""One run of one cell: set-up, the measured window, the traced window's
reading, the comparison with the plain reference, the result line.

The window drives the program's ``FramePipeline.step`` in fused mode (one
CUDA-graph replay a frame) in a closed loop with one frame in flight: the
host hands ``step`` the frame's host arrays and waits on
``torch.cuda.synchronize()`` before the next. A frame's latency runs from
the call of ``step`` to the end of that synchronise. The outputs of the
judged frames are copied to the host after their latency is taken.

Set-up (``setup_s``, from the process's start to the first timed frame):
imports and CUDA, the rig and the traffic's frames made on the device,
the pipeline with its bakes, and for every sweep variant the traffic uses
a ``warmup`` (the eager frame, which builds the kernels in a new checkout,
and the graph's capture) and one untimed replay.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

from . import compare, discover, guard, schedule, trace
from .frozen import inputs as gen
from .frozen import reference

GIB = float(1 << 30)
TRACE_CHUNKS = 3           # traced chunks spread over the window
TRACE_FRAMES = 3           # frames in a chunk: the first is traced, not read


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def voxel_size(cfg: dict) -> float:
    return float(np.max(gen.bbox_of(cfg).size) / cfg["tsdf_res"][0])


def pipeline(cfg: dict, rig: gen.Rig, device):
    """The program under test: ``FramePipeline`` in fused mode on the
    configuration's sizes."""
    from rgbd_recon_torch.calibration.rig import RigCalibration
    from rgbd_recon_torch.runtime.pipeline import FramePipeline, PipelineConfig

    pcfg = PipelineConfig(
        voxel_size=voxel_size(cfg), brick_size=cfg["brick_size"], tsdf_limit=cfg["tsdf_limit"],
        min_voxels_per_brick=cfg["min_voxels_per_brick"], tsdf_res=tuple(cfg["tsdf_res"]),
        render_width=cfg["render"]["width"], render_height=cfg["render"]["height"],
        num_lods=cfg["num_lods"], max_bricks=cfg["capacity"], fused=True)
    return FramePipeline(RigCalibration(*rig), pcfg, log=log, device=device)


def host_outputs(out) -> dict:
    return {"color": out.color.cpu(), "depth": out.depth.cpu(), "hit": out.hit.cpu(),
            "tsdf": out.tsdf.cpu(), "occupied_bricks": int(out.occupied_bricks)}


def half_sensors(depth: np.ndarray) -> np.ndarray:
    """The frame's depth with the second half of the sensors left out."""
    depth = depth.copy()
    depth[depth.shape[0] // 2:] = 0.0
    return depth


def rotate_colors(color: torch.Tensor) -> torch.Tensor:
    """An image's r, g, b rotated, alpha kept."""
    return torch.cat([color[..., [1, 2, 0]], color[..., 3:]], dim=-1)


class Faulty:
    """The timed path broken underneath, for the checks that a broken
    program comes out not correct: ``stale`` returns the previous frame's
    outputs (the state unchanged), ``half`` leaves out the second half of
    the sensors, ``alter`` rotates the color channels of each image."""

    def __init__(self, step, fault: str):
        self.step, self.fault, self.last = step, fault, None

    def __call__(self, depth, color, mv, proj):
        if self.fault == "half":
            depth = half_sensors(depth)
        out = self.step(depth, color, mv, proj)
        if self.fault == "stale":
            out, self.last = (self.last if self.last is not None else out), out
        elif self.fault == "alter":
            out = out._replace(color=rotate_colors(out.color))
        return out


def make_inputs(cfg: dict, traffic: dict, seed: int, device):
    rig, cams = gen.make_rig(cfg, device)
    depth, color = gen.make_frames(cfg, traffic, seed, cams, device)
    return rig, depth, color


def warm(pipe, sched: schedule.Schedule, depth, color, device) -> None:
    """Capture every variant the traffic uses and replay each once, in a
    fixed order whatever the seed's order of views (the graphs' memory
    pool is laid out in capture order)."""
    seen = {}
    for i, v in enumerate(sched.variants):
        seen.setdefault(v, i)
    for v in (v for v in schedule.VARIANTS if v in seen):
        mv, proj = sched.cameras[seen[v]]
        pipe.warmup(depth[0], color[0], mv, proj)
        pipe.step(depth[0], color[0], mv, proj)
        sync(device)
    log(f"warmed {len(seen)} sweep variant(s): {sorted(seen)}")


def window(step, sched, depth, color, seconds: float, device, keep: set,
           traced_at: list | None = None):
    """The measured window. Returns (latencies s, the host's share of each
    (``step``'s call to its return, before the synchronise) s, elapsed s,
    kept outputs {frame: host outputs}, traced chunks [(trace events,
    keys, n_occ)], frames of each variant)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    lat, host, kept, chunks, per_variant = [], [], {}, [], {}
    last_judged = max(keep, default=-1)    # chunks start once every judged frame is kept
    n, t_start, t_end = 0, time.perf_counter(), None
    prof, chunk_keys, chunk_occ, next_chunk = None, [], [], 0
    while True:
        t0 = time.perf_counter()
        if t0 - t_start >= seconds:
            break
        if (traced_at is not None and prof is None and next_chunk < len(traced_at)
                and t0 - t_start >= traced_at[next_chunk] * seconds and n > last_judged):
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
            chunk_keys, chunk_occ = [], []
            t0 = time.perf_counter()
        i, c = sched.at(n)
        mv, proj = sched.cameras[c]
        if prof is not None:
            with record_function(trace.FRAME_RANGE):
                out = step(depth[i], color[i], mv, proj)
                t_ret = time.perf_counter()
                sync(device)
            chunk_keys.append(sched.variants[c])
            chunk_occ.append(out.occupied_bricks)
        else:
            out = step(depth[i], color[i], mv, proj)
            t_ret = time.perf_counter()
            sync(device)
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        host.append(t_ret - t0)
        t_end = t1
        per_variant.setdefault(sched.variants[c], []).append(t1 - t0)
        if n in keep:
            kept[n] = host_outputs(out)
        del out
        n += 1
        if prof is not None and len(chunk_keys) == TRACE_FRAMES:
            # read out at once: on an H100 a profile exported after a later
            # one had run read a third of its device time
            prof.__exit__(None, None, None)
            chunks.append((_events(prof), chunk_keys, [int(o) for o in chunk_occ]))
            prof, next_chunk = None, next_chunk + 1
    if prof is not None:
        prof.__exit__(None, None, None)
    return lat, host, (t_end or t_start) - t_start, kept, chunks, per_variant


def _events(prof) -> list[dict]:
    """A profile's trace events, through a file in the temporary directory
    that is deleted once read."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="recon_bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return trace.load(path)
    finally:
        os.remove(path)


def eager_labels(pipe, keys, device) -> dict:
    """Each graph key's eager frame under ``record_function`` stage ranges,
    profiled: key -> ``trace.eager_labels``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    out = {}
    for key in sorted(set(keys)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            pipe._frame(*pipe._graphs._inputs, *key, scope=record_function)
            sync(device)
        out[key] = trace.eager_labels(_events(prof))
    return out


def read_trace(cell: discover.Cell, chunks, eager: dict) -> tuple[dict, dict, dict]:
    """(per-layer metrics, device busy/window seconds, breakdown)."""
    cfg = cell.config
    screen = (cfg["render"]["height"], cfg["render"]["width"])
    buckets, names, gaps = {}, {}, {}
    busy = win = launch_idle = 0.0
    matched = total = frames = 0
    occ = []
    for events, keys, n_occ in chunks:
        r = trace.parse_chunk(events, keys, eager, screen)
        for b, us in r["buckets"].items():
            buckets[b] = buckets.get(b, 0.0) + us
        for k, us in r["names"].items():
            names[k] = names.get(k, 0.0) + us
        for k, us in r["gaps"]:
            gaps[k] = gaps.get(k, 0.0) + us
        busy += r["busy_us"]
        win += r["window_us"]
        launch_idle += r["launch_idle_us"]
        matched += r["matched"]
        total += r["events"]
        frames += r["frames"]
        occ.extend(n_occ[-r["frames"]:])
    log(f"trace: {len(chunks)} chunks, {frames} frames, {total} replayed GPU events, "
        f"{matched} lined up with the eager runs ({matched / max(total, 1):.2%})")
    record = {"config": cfg, "frames": frames, "n_occ": occ,
              "buckets_ms": {b: us / 1e3 / max(frames, 1) for b, us in buckets.items()},
              "busy_s": busy / 1e6, "window_s": win / 1e6, "launch_idle_s": launch_idle / 1e6}
    for b, ms in sorted(record["buckets_ms"].items(), key=lambda kv: -kv[1]):
        log(f"  {ms:10.4f} ms/frame  {b}")
    metrics = {}
    for m in cell.per_layer:
        v = discover.reader(m["name"])(record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    breakdown = {
        "device_ops": [[k, us / 1e6] for k, us in
                       sorted(names.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[k, us / 1e6] for k, us in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
    }
    return metrics, {"busy_s": busy / 1e6, "window_s": win / 1e6}, breakdown


def judge(cell: discover.Cell, rig, sched, depth, color, kept: dict,
          device) -> tuple[dict, int]:
    """The comparison numbers of every kept judged frame, worst of each,
    and how many judged frames fail a limit."""
    readings = []
    for n, prog in sorted(kept.items()):
        i, c = sched.at(n)
        mv, proj = sched.cameras[c]
        t0 = time.perf_counter()
        with torch.no_grad():
            ref = reference.frame(rig, cell.config, depth[i], color[i], mv, proj, device)
        r = compare.numbers(prog, ref, proj, float(cell.config["tsdf_limit"]))
        log(f"judged frame {n} (input {i}, sweep {sched.variants[c]}): "
            + ", ".join(f"{k} {v:.6g}" for k, v in r.items())
            + f"; reference {time.perf_counter() - t0:.1f}s")
        readings.append(r)
        del ref
    failed = sum(not compare.verdict(r, cell.limits)[0] for r in readings)
    return compare.worst(readings), failed


def run_cell(cell: discover.Cell, seed: int, seconds: float, traced: bool, device,
             t_process: float, fault: str | None = None) -> dict:
    """One run; returns the result object. ``fault``: a ``Faulty`` fault
    planted under the timed path (the checks of the comparison)."""
    device = torch.device(device)
    cfg, tr = cell.config, cell.traffic
    t0 = time.perf_counter()
    log(f"imports and the benchmark's files ({t0 - t_process:.2f}s)")
    if device.type == "cuda":
        torch.empty(1, device=device)      # the context
        torch.cuda.synchronize(device)
        log(f"CUDA ({time.perf_counter() - t0:.2f}s)")
        t0 = time.perf_counter()
    rig, depth, color = make_inputs(cfg, tr, seed, device)
    if device.type == "cuda":     # the generator's memory is not the program's
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    sched = schedule.make(cfg, tr, seed)
    log(f"inputs: {depth.shape[0]} frames of {depth.shape[1]} sensors, "
        f"{len(sched.cameras)} camera steps, judged frames {sched.judged} "
        f"({time.perf_counter() - t0:.2f}s)")
    t0 = time.perf_counter()
    pipe = pipeline(cfg, rig, device)
    log(f"pipeline ({time.perf_counter() - t0:.2f}s)")
    t0 = time.perf_counter()
    warm(pipe, sched, depth, color, device)
    log(f"warm-up ({time.perf_counter() - t0:.2f}s)")
    step = Faulty(pipe.step, fault) if fault else pipe.step
    setup_s = time.perf_counter() - t_process
    lat, host, elapsed, kept, chunks, per_variant = window(
        step, sched, depth, color, seconds, device, set(sched.judged),
        [(i + 0.5) / TRACE_CHUNKS for i in range(TRACE_CHUNKS)] if traced else None)
    peak = torch.cuda.max_memory_reserved(device) if device.type == "cuda" else 0
    q = statistics.quantiles(lat, n=20) if len(lat) >= 2 else lat * 19   # 5% steps
    qh = statistics.quantiles(host, n=20) if len(host) >= 2 else host * 19
    log(f"window: {len(lat)} frames in {elapsed:.3f}s; latency ms p5 {q[0] * 1e3:.2f} "
        f"median {statistics.median(lat) * 1e3:.2f} p95 {q[18] * 1e3:.2f}; of it in step's "
        f"call, ms p5 {qh[0] * 1e3:.2f} median {statistics.median(host) * 1e3:.2f} "
        f"p95 {qh[18] * 1e3:.2f}; frames of each sweep variant "
        f"{ {v: len(t) for v, t in sorted(per_variant.items())} }, their median ms "
        f"{ {v: round(statistics.median(t) * 1e3, 2) for v, t in sorted(per_variant.items())} }")
    result = {"attempted": len(lat)}
    metrics, dev_extra, breakdown = {}, {}, None
    if traced:
        eager = eager_labels(pipe, [k for _, keys, _ in chunks for k in keys], device)
        metrics, dev_extra, breakdown = read_trace(cell, chunks, eager)
    else:
        e2e = {"fps": len(lat) / elapsed, "frame_p95_ms": q[18] * 1e3,
               "peak_gib": peak / GIB, "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    del pipe, step
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    values, failed = judge(cell, rig, sched, depth, color, kept, device)
    ok, checks = compare.verdict(values, cell.limits)
    result.update(correct=ok, failed=failed if values else 1, metrics=metrics)
    result["device"] = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": cell.chips, "memory_peak_bytes": int(peak), **dev_extra}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv, t_process: float) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = discover.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"needs {cell.chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        import rgbd_recon_torch  # noqa: F401  (the program under test)
    except ImportError as e:
        log(f"the program is missing from this checkout: {e}")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_process)
    bad = guard.loaded()
    if bad:
        log(f"the run loaded {', '.join(bad)}: no result")
        return 3
    log(f"run: {time.perf_counter() - t_process:.1f}s in all")
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']:.6g} (limit {v['limit']:.6g})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


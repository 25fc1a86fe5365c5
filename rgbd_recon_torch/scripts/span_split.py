"""The span recorder's split of the fused frame in the benchmark's cells.

For each cell of ``BENCHMARK.json`` named in ``--plan``, builds the inputs,
the schedule and the pipeline as ``recon_bench``'s harness does, warms
every variant, and runs the harness's measured window
(``recon_bench.harness.window``) in one of three modes:

- ``off``: the recorder off, as the benchmark's untraced run;
- ``on``: the recorder on (``SPANS.enable`` before the pipeline is built,
  so that its captures carry the stage events and the slice count);
- ``traced``: the recorder on, with the harness's three profiled chunks,
  whose trace metrics are read as a ``--trace 1`` run reads them;
- ``ab``: the recorder's cost. Two pipelines, one captured with the
  recorder off and one with it on, step the cell's frames in blocks taken
  in turn, so that a slow stretch of the card or the host falls on every
  side: ``off``, ``graph`` (the second pipeline with the recorder off: its
  graph's event nodes and sum alone) and ``on``; ``run_ab``.

Each run prints one JSON line, appended to ``--out`` too if given: ``fps``,
``frame_p95_ms``, the host's median share of ``step`` and, with the
recorder on, ``summarise``'s medians over the frames outside the profiled
chunks. A traced run also gives them over the frames before its first
chunk (``before_chunks``): once ``torch.profiler`` has run in a process,
every later graph launch costs the host more.

    python -m rgbd_recon_torch.scripts.span_split --plan k4-256.static:off,on,ab \\
        [--seconds 40] [--seed 3141592653] [--out split.jsonl]

Run it from the repository's root, on the card.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import time

import torch

TOP = ("1preprocess", "2integrate", "3recon", "holefill", "frame.io.load", "frame.io.outputs")


def _median(values):
    return statistics.median(values) if values else None


def summarise(rec: dict, chunks: set, before: bool = False) -> dict:
    """Medians of a ``SPANS.collect()`` record over its frames ``f`` with
    neither ``f`` nor ``f + 1`` in ``chunks`` (the profiled frames), or with
    ``before``, over those before the first chunk: ``host.<span>`` and
    ``dev.<span>`` in ms (a frame's spans of one name added up),
    ``dev.device.idle``, ``device.span_idle_pct`` (100 x (1 - the frame's
    top-level device spans over the device time from its start to the next
    frame's start)), ``render.slices_occupied_pct``, ``integrate.pairs`` and
    ``integrate.pairs_culled`` (the quadratic-warp integrators' counters),
    ``graph.nodes`` (the mean over the captures), the frames read and
    ``dropped``. A median with no frame to read is None."""
    spans = rec["spans"]
    first = min(chunks, default=None)
    if before:
        ok = lambda f: first is None or f + 1 < first      # noqa: E731
    else:
        ok = lambda f: f not in chunks and f + 1 not in chunks      # noqa: E731
    host, dev, idle, top = {}, {}, {}, {}
    for s in spans:
        f = s["frame"]
        if f < 0:
            continue
        ms = (s["end"] - s["start"]) / 1e6
        if s["clock"] == "host":
            per = host.setdefault(s["name"], {})
        elif s["name"] == "device.idle":
            idle[f] = ms
            continue
        else:
            per = dev.setdefault(s["name"], {})
            if s["parent"] >= 0 and spans[s["parent"]]["name"] == "frame" and s["name"] in TOP:
                top[f] = top.get(f, 0.0) + ms
        per[f] = per.get(f, 0.0) + ms
    out = {}
    for prefix, group in (("host.", host), ("dev.", dev)):
        for name, per in sorted(group.items()):
            out[prefix + name] = _median([v for f, v in per.items() if ok(f)])
    out["dev.device.idle"] = _median([v for f, v in idle.items() if ok(f) and ok(f - 1)])
    frame = dev.get("frame", {})
    read = [f for f in frame if ok(f)]
    out["device.span_idle_pct"] = _median(
        [100.0 * (1.0 - top[f] / (frame[f] + idle[f + 1]))
         for f in read if f + 1 in idle and f in top])
    counts = {}
    for c in rec["counts"]:
        counts.setdefault(c["name"], {})[c["frame"]] = c["value"]
    occ = counts.get("render.slices_occupied", {})
    swept = counts.get("render.slices_swept", {})
    out["render.slices_occupied_pct"] = _median(
        [100.0 * v / swept[f] for f, v in occ.items() if f in swept and ok(f)])
    for name in ("integrate.pairs", "integrate.pairs_culled"):
        out[name] = _median([v for f, v in counts.get(name, {}).items() if ok(f)])
    nodes = [c["value"] for c in rec["counts"] if c["name"] == "graph.nodes"]
    out["graph.nodes"] = statistics.mean(nodes) if nodes else None
    out["frames_read"] = len(read)
    out["dropped"] = rec["dropped"]
    return out


def run(name: str, mode: str, seed: int, seconds: float) -> dict:
    """One run of cell ``name`` in ``mode`` (module docstring)."""
    from recon_bench import discover, schedule
    from recon_bench import harness as H
    from rgbd_recon_torch.utils.timers import SPANS

    device = torch.device("cuda")
    cell = discover.cell(name)
    rig, depth, color = H.make_inputs(cell.config, cell.traffic, seed, device)
    sched = schedule.make(cell.config, cell.traffic, seed)
    if mode != "off":
        SPANS.enable(1 << 18)
    pipe = H.pipeline(cell.config, rig, device)
    H.warm(pipe, sched, depth, color, device)
    chunks = set()

    def step(*args):
        profiled = torch.autograd.profiler._is_profiler_enabled
        out = pipe.step(*args)
        if profiled:
            chunks.add(SPANS.frame_id)
        return out

    traced_at = ([(i + 0.5) / H.TRACE_CHUNKS for i in range(H.TRACE_CHUNKS)]
                 if mode == "traced" else None)
    lat, host, elapsed, _, traces, _ = H.window(step, sched, depth, color, seconds, device,
                                                set(), traced_at)
    res = {"cell": name, "mode": mode, "seed": seed, "frames": len(lat),
           "fps": len(lat) / elapsed,
           "frame_p95_ms": statistics.quantiles(lat, n=20)[18] * 1e3,
           "host_med_ms": statistics.median(host) * 1e3}
    if SPANS.on:
        with SPANS.frame():     # reads the window's last frame
            pass
        rec = SPANS.collect()
        SPANS.disable()
        res.update(summarise(rec, chunks))
        if chunks:
            res["before_chunks"] = summarise(rec, chunks, before=True)
    if traces:
        eager = H.eager_labels(pipe, [k for _, keys, _ in traces for k in keys], device)
        metrics, extra, _ = H.read_trace(cell, traces, eager)
        res["trace"] = {k: v["value"] for k, v in metrics.items()}
        res["busy_s"], res["window_s"] = extra["busy_s"], extra["window_s"]
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return res


def run_ab(name: str, seed: int, seconds: float, block: int = 20) -> dict:
    """Mode ``ab`` (module docstring) for ``seconds`` in all: the frames
    per second of each side over its blocks, each block's, ``cost_pct``,
    100 x (1 - on / off), and ``graph_cost_pct``, 100 x (1 - graph / off)."""
    from recon_bench import discover, schedule
    from recon_bench import harness as H
    from rgbd_recon_torch.utils.timers import SPANS

    device = torch.device("cuda")
    cell = discover.cell(name)
    rig, depth, color = H.make_inputs(cell.config, cell.traffic, seed, device)
    sched = schedule.make(cell.config, cell.traffic, seed)
    pipes = {}
    for side in ("off", "on"):
        if side == "on":
            SPANS.enable(1 << 14)
        pipes[side] = H.pipeline(cell.config, rig, device)
        H.warm(pipes[side], sched, depth, color, device)
    SPANS.disable()
    spent = {"off": [], "graph": [], "on": []}
    sides = list(spent)
    n, t_end = 0, time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        r = len(spent["on"]) % len(sides)
        for side in sides[r:] + sides[:r]:
            pipe = pipes["off" if side == "off" else "on"]
            if side == "on":
                SPANS.enable(1 << 14)
            t0 = time.perf_counter()
            for _ in range(block):
                i, c = sched.at(n)
                pipe.step(depth[i], color[i], *sched.cameras[c])
                H.sync(device)
                n += 1
            spent[side].append(time.perf_counter() - t0)
            SPANS.disable()
    fps = {side: block * len(t) / sum(t) for side, t in spent.items()}
    res = {"cell": name, "mode": "ab", "seed": seed, "block": block,
           **{f"fps_{side}": v for side, v in fps.items()},
           "cost_pct": 100.0 * (1.0 - fps["on"] / fps["off"]),
           "graph_cost_pct": 100.0 * (1.0 - fps["graph"] / fps["off"]),
           "blocks_on_slower": sum(a > b for a, b in zip(spent["on"], spent["off"])),
           **{f"block_fps_{side}": [block / t for t in ts] for side, ts in spent.items()}}
    del pipes
    gc.collect()
    torch.cuda.empty_cache()
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--plan", nargs="+", required=True, help="cell:mode,mode,...")
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=3_141_592_653, help="the first run's; +1 a run")
    ap.add_argument("--out", help="a JSON-lines file to append each run's line to")
    args = ap.parse_args()
    plan = [(name, mode) for name, modes in (item.split(":") for item in args.plan)
            for mode in modes.split(",")]
    for _, mode in plan:
        if mode not in ("off", "on", "traced", "ab"):
            raise SystemExit(f"unknown mode {mode!r} (off, on, traced, ab)")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    print(torch.cuda.get_device_name(0), flush=True)
    for k, (name, mode) in enumerate(plan):
        t0 = time.perf_counter()
        if mode == "ab":
            res = run_ab(name, args.seed + k, args.seconds)
        else:
            res = run(name, mode, args.seed + k, args.seconds)
        res["wall_s"] = time.perf_counter() - t0
        line = json.dumps(res)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        print(line, flush=True)


if __name__ == "__main__":
    main()

"""The readings that the comparison's limits are set from, on the card at a
cell's own size:

- the program: each seed's judged frames through the timed path, as a run
  drives it (the traffic's frames in order, one in flight);
- the control: the reference in the next precision down (computing in
  bfloat16, the volumes stored as float8 e4m3), put in the program's place;
- the faults, planted in the program: ``stale`` (a frame returns the one
  before it), ``half`` (the second half of the sensors left out),
  ``alter`` (the color channels rotated where the image is produced).

Each reading is a line of JSON: cell, seed, frame, kind, and the numbers
of ``compare.NAMES``. One process builds the pipeline once and reads every
seed:

    python3 recon_bench/readings.py --workload <cell> --seeds 11 12 13 \\
        [--kinds program control stale half alter] [--out readings.jsonl]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from recon_bench import compare, discover, harness, schedule  # noqa: E402
from recon_bench.frozen import reference  # noqa: E402

KINDS = ("program", "control", "stale", "half", "alter")


def read_seed(cell, pipe, rig, seed: int, kinds, device, emit) -> None:
    cfg, tr = cell.config, cell.traffic
    depth, color = harness.gen.make_frames(cfg, tr, seed, harness.gen.cameras(cfg), device)
    sched = schedule.make(cfg, tr, seed)
    want = set(sched.judged) | {n - 1 for n in sched.judged}
    kept = {}
    for n in range(max(sched.judged) + 1):
        i, c = sched.at(n)
        mv, proj = sched.cameras[c]
        out = pipe.step(depth[i], color[i], mv, proj)
        harness.sync(device)
        if n in want:
            kept[n] = harness.host_outputs(out)
    half = {}
    if "half" in kinds:
        for n in sched.judged:
            i, c = sched.at(n)
            half[n] = harness.host_outputs(pipe.step(harness.half_sensors(depth[i]), color[i],
                                                     *sched.cameras[c]))
    limit = float(cfg["tsdf_limit"])
    for n in sched.judged:
        i, c = sched.at(n)
        mv, proj = sched.cameras[c]
        t0 = time.perf_counter()
        with torch.no_grad():
            ref = reference.frame(rig, cfg, depth[i], color[i], mv, proj, device)
        t_ref = time.perf_counter() - t0
        progs = {"program": kept[n], "stale": kept[n - 1], "half": half.get(n)}
        if "alter" in kinds:
            progs["alter"] = dict(kept[n], color=harness.rotate_colors(kept[n]["color"]))
        for kind in kinds:
            if kind == "control":
                t0 = time.perf_counter()
                with torch.no_grad(), reference.computing(torch.bfloat16, torch.float8_e4m3fn):
                    low = reference.frame(rig, cfg, depth[i], color[i], mv, proj, device)
                prog = {"color": low.color, "depth": low.depth, "hit": low.hit,
                        "tsdf": low.tsdf, "occupied_bricks": low.n_blocks}
                extra = {"control_s": time.perf_counter() - t0}
            else:
                prog, extra = progs[kind], {}
            r = compare.numbers(prog, ref, proj, limit)
            emit({"cell": cell.name, "seed": seed, "frame": n, "sweep": sched.variants[c],
                  "kind": kind, **r, "reference_s": t_ref, "n_occ": int(prog["occupied_bricks"]),
                  "ref_blocks": ref.n_blocks, "ref_band_blocks": ref.n_band, **extra})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--kinds", nargs="+", default=list(KINDS), choices=KINDS)
    ap.add_argument("--out", default="readings.jsonl")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=ROOT, help="the checkout holding BENCHMARK.json")
    args = ap.parse_args(argv)
    cell = discover.cell(args.workload, root=args.root)
    device = torch.device(args.device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    rig, depth, color = harness.make_inputs(cell.config, cell.traffic, args.seeds[0], device)
    pipe = harness.pipeline(cell.config, rig, device)
    harness.warm(pipe, schedule.make(cell.config, cell.traffic, args.seeds[0]), depth, color,
                 device)
    with open(args.out, "a") as f:
        def emit(rec):
            line = json.dumps(rec)
            print(line, flush=True)
            f.write(line + "\n")
            f.flush()

        for seed in args.seeds:
            read_seed(cell, pipe, rig, seed, args.kinds, device, emit)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Device-trace arithmetic of the traced run.

The parse is a copy of the port's ``rgbd_recon_torch/scripts/trace_fused.py``
at commit c43690d (``_gpu``, ``_corr``, ``_eager_labels``, ``_align``,
``_self_times``): each GPU event's self time (an event nested in another is
not counted twice), the busy union of the GPU events' spans, and the stage
of each replayed event, found by lining the graph replay's events up with an
eager run of the frame function under ``record_function`` stage ranges. The
alignment goes by stage range and not by kernel name, so a bucket stays
filled when a later change replaces the ops inside a stage.

Buckets (``bucket``): the stage of each replayed event (``1preprocess``,
``2integrate``, ``holefill``), 3recon split into ``3recon: screen`` (the
screen warp kernel and ops on the render size's pixels) and ``3recon:
sweep`` (the rest: the slices' resampling and the hit carry), ``unaligned``
where no eager twin was found, and ``io`` for GPU events outside any graph
replay (the frame's inputs copied in, the outputs' copies out).
"""
from __future__ import annotations

import collections
import gzip
import json

GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STAGES = ("1preprocess", "2integrate", "3recon", "holefill")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
FRAME_RANGE = "bench.frame"   # the harness's range around each traced frame
SHORT_GAP_US = 20.0     # gaps under this between two device ops are the launch gaps


def load(path: str) -> list[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


def gpu_events(events) -> list[dict]:
    return sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in GPU_CATS),
                  key=lambda e: (e["ts"], -e["dur"]))


def corr(e) -> int | None:
    return (e.get("args") or {}).get("correlation")


def eager_labels(events) -> list[tuple[str, str, str]]:
    """(name, stage, input dims) of each GPU event of the eager run, in
    order: the stage range and the op that enclose its launch."""
    runtime = {corr(e): e for e in events
               if e.get("cat") in ("cuda_runtime", "cuda_driver") and corr(e) is not None}
    ops = {(e.get("args") or {}).get("External id"): e for e in events
           if e.get("cat") == "cpu_op"}
    stages = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name") in STAGES]
    out = []
    for e in gpu_events(events):
        launch = runtime.get(corr(e))
        stage, dims = "?", ""
        if launch is not None:
            ts = launch["ts"]
            stage = next((s["name"] for s in stages if s["ts"] <= ts <= s["ts"] + s["dur"]), "?")
            op = ops.get((launch.get("args") or {}).get("External id"))
            if op is not None:
                dims = str((op.get("args") or {}).get("Input Dims", ""))
        out.append((e["name"], stage, dims))
    return out


def align(names: list[str], eager: list[str], look: int = 32):
    """The eager twin's index of each replayed event (None where none is
    found). Walks both in step; where the names differ, skips the fewer
    events (up to ``look``) on one side that brings them back together."""
    def same(a, b):     # a memset is named by its API in one run, its node in the other
        return a == b or ("emset" in a and "emset" in b)

    twins, i, j = [], 0, 0
    while i < len(names):
        if j < len(eager) and same(names[i], eager[j]):
            twins.append(j)
            i, j = i + 1, j + 1
            continue
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
    return twins


def self_times(gpu) -> tuple[collections.Counter, float, list[tuple[float, float]]]:
    """Self time (us) of each event by index, the union of the events'
    spans (us), and the busy intervals of that union in time order."""
    self_t, busy, stack, end = collections.Counter(), 0.0, [], -1.0
    spans: list[list[float]] = []
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
        if spans and ts <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], ts + dur)
        else:
            spans.append([ts, ts + dur])
        end = max(end, ts + dur)
    return self_t, busy, [tuple(s) for s in spans]


def bucket(name: str, stage: str, dims: str, screen: tuple[int, int]) -> str:
    if stage == "3recon":
        on_screen = "warp_screen" in name or f"{screen[0]}, {screen[1]}" in dims
        return "3recon: screen" if on_screen else "3recon: sweep"
    return stage


def host_at(host: list[dict], t: float) -> str:
    """The innermost host event spanning time ``t`` (us), by name."""
    best = None
    for e in host:
        if e["ts"] <= t <= e["ts"] + e["dur"] and (best is None or e["dur"] < best["dur"]):
            best = e
    return best["name"] if best is not None else "host: outside any traced range"


def parse_chunk(events, keys: list, eager: dict, screen: tuple[int, int]) -> dict:
    """One traced chunk of frames: ``keys`` the graph key of each frame in
    order, ``eager`` key -> ``eager_labels`` of that key's eager run.
    Its window runs from the second ``bench.frame`` range's start to the
    last one's end: the first frame, whose launch pays the tracer's
    start-up, is traced but not read. Returns, inside the window, GPU self
    time (us) by bucket and by event name, the busy union (us), the idle
    gaps [(host activity, us)], the idle time while the host is inside a
    graph launch (us) and the frames read; the window (us); and how many
    replayed events lined up."""
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    frames = sorted((e for e in host if e.get("name") == FRAME_RANGE), key=lambda e: e["ts"])
    # the chunk's first frame pays the tracer's start-up: it is run, not read
    w0 = frames[min(1, len(frames) - 1)]["ts"]
    w1 = max(e["ts"] + e["dur"] for e in frames)
    gpu = gpu_events(events)
    graph_corr = {corr(e) for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                  and "GraphLaunch" in e.get("name", "")}
    replays = collections.defaultdict(list)
    for i, e in enumerate(gpu):
        if corr(e) in graph_corr:
            replays[corr(e)].append(i)
    order = sorted(replays, key=lambda c: gpu[replays[c][0]]["ts"])
    label, matched, total = {}, 0, 0
    for c, key in zip(order, keys):
        idx = replays[c]
        lab = eager[key]
        twins = align([gpu[i]["name"] for i in idx], [n for n, _, _ in lab])
        for i, j in zip(idx, twins):
            label[i] = lab[j][1:] if j is not None else ("unaligned", "")
        matched += sum(j is not None for j in twins)
        total += len(idx)
    self_t, _, spans = self_times(gpu)
    buckets, names = collections.Counter(), collections.Counter()
    for i, e in enumerate(gpu):
        if not w0 <= e["ts"] <= w1:
            continue
        stage, dims = label.get(i, ("io", ""))
        buckets[bucket(e["name"], stage, dims, screen)] += self_t[i]
        names[e["name"]] += self_t[i]
    edges = [(w0, w0)] + [s for s in spans if s[1] > w0 and s[0] < w1] + [(w1, w1)]
    busy = sum(min(b, w1) - max(a, w0) for a, b in edges)
    launches = sorted((e["ts"], e["ts"] + e["dur"]) for e in host
                      if e.get("cat") in ("cuda_runtime", "cuda_driver")
                      and "GraphLaunch" in e.get("name", ""))
    gaps, launch_idle = [], 0.0
    for j, (a, b) in enumerate(zip(edges, edges[1:])):
        if b[0] <= a[1]:
            continue
        launch_idle += sum(max(0.0, min(b[0], l1) - max(a[1], l0)) for l0, l1 in launches)
        between_ops = 0 < j < len(edges) - 2 and b[0] - a[1] < SHORT_GAP_US
        gaps.append(("device: between ops (< 20 us)" if between_ops
                     else host_at(host, (a[1] + b[0]) / 2), b[0] - a[1]))
    return {"buckets": buckets, "names": names, "busy_us": busy, "window_us": w1 - w0,
            "launch_idle_us": launch_idle, "gaps": gaps, "replays": len(order), "matched": matched, "events": total,
            "frames": max(len(frames) - 1, 1)}

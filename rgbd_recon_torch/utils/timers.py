"""Named per-stage timers (mirrors ``rgbd_recon_tpu/utils/timers.py``).

≙ the reference's TimerDatabase + TimerGPU (timer_database.hpp:10-37,
timer_gpu.cpp:13-31). On a CUDA device a span is a pair of CUDA events
recorded on the current stream, read back when the caller asks for the
duration (the GL timestamp-query model); on the CPU it is the host clock.
Unlike the JAX version this is not a process-wide singleton: the pipeline
owns one, so two pipelines never share timers.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch


@dataclass
class _Timer:
    total: float = 0.0
    count: int = 0
    vmin: float = float("inf")
    vmax: float = 0.0
    last: float = 0.0
    _pending: list = field(default_factory=list)

    def add(self, dt: float) -> None:
        self.last = dt
        self.total += dt
        self.count += 1
        self.vmin = min(self.vmin, dt)
        self.vmax = max(self.vmax, dt)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class TimerDatabase:
    """Per-stage timers in seconds. ``scope(name, device)`` times a block
    with CUDA events on a CUDA device (no host sync inside the block) and
    with ``time.perf_counter`` otherwise; ``flush()`` synchronises and folds
    pending event pairs into the statistics."""

    def __init__(self):
        self.timers: dict[str, _Timer] = {}

    def add_timer(self, name: str) -> None:
        self.timers.setdefault(name, _Timer())

    @contextlib.contextmanager
    def scope(self, name: str, device: torch.device | str = "cpu"):
        t = self.timers.setdefault(name, _Timer())
        if torch.device(device).type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield
            finally:
                end.record()
                t._pending.append((start, end))
        else:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                t.add(time.perf_counter() - t0)

    def flush(self) -> None:
        """Wait for recorded CUDA events and account their spans."""
        for t in self.timers.values():
            for start, end in t._pending:
                end.synchronize()
                t.add(start.elapsed_time(end) * 1e-3)
            t._pending.clear()

    def duration(self, name: str) -> float:
        self.flush()
        return self.timers[name].last

    def reset(self) -> None:
        self.timers.clear()

"""Named per-stage timers (mirrors ``rgbd_recon_tpu/utils/timers.py``).

≙ the reference's TimerDatabase + TimerGPU (timer_database.hpp:10-37,
timer_gpu.cpp:13-31): a process-wide singleton of named timers
accumulating mean/min/max, with the reference's CSV writers
(timer_database.cpp:59-121). Two ways to time a span:

- ``begin(name)`` / ``end(name, sync=t)``: host clock; ``end``
  synchronises the device of tensor ``t`` first (the JAX version's
  ``block_until_ready``), so the span covers the device work queued in it;
- ``scope(name, device)``: on a CUDA device a pair of CUDA events recorded
  on the current stream, read back by ``flush()`` (the GL timestamp-query
  model, no host sync inside the span); the host clock otherwise.
"""
from __future__ import annotations

import contextlib
import os
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
    _start: float = 0.0
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
    """Per-stage timers in seconds; ``instance()`` is the process-wide one
    (timer_database.hpp:13) that the pipeline and the app share."""

    _instance: "TimerDatabase | None" = None

    def __init__(self):
        self.timers: dict[str, _Timer] = {}

    @classmethod
    def instance(cls) -> "TimerDatabase":
        if cls._instance is None:
            cls._instance = TimerDatabase()
        return cls._instance

    def add_timer(self, name: str) -> None:
        self.timers.setdefault(name, _Timer())

    def begin(self, name: str) -> None:
        self.timers.setdefault(name, _Timer())._start = time.perf_counter()

    def end(self, name: str, sync: torch.Tensor | None = None) -> float:
        """Close a ``begin`` span; with ``sync`` wait for its device first."""
        if sync is not None and sync.device.type == "cuda":
            torch.cuda.synchronize(sync.device)
        t = self.timers[name]
        t.add(time.perf_counter() - t._start)
        return t.last

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

    def mean(self, name: str) -> float:
        self.flush()
        return self.timers[name].mean

    # CSV contract (timer_database.cpp:59-121): given "<dir>/<name>,<date>,
    # <time>.csv", each writer emits "<dir>/{mean|min|max}_<file>" holding a
    # header row `timer,"n1","n2",...` and a value row `<name>,v1,v2,...`
    # with times in milliseconds
    def _write(self, file_name: str, getter, prefix: str) -> None:
        self.flush()
        directory, filename = os.path.split(file_name)
        name = filename.split(",")[0]
        names = sorted(self.timers)
        with open(os.path.join(directory, prefix + filename), "w") as f:
            f.write("timer" + "".join(f',"{n}"' for n in names) + "\n")
            f.write(name + "".join(f",{getter(self.timers[n]) * 1e3:.6f}" for n in names)
                    + "\n")

    def write_mean(self, path: str) -> None:
        self._write(path, lambda t: t.mean, "mean_")

    def write_min(self, path: str) -> None:
        self._write(path, lambda t: (t.vmin if t.count else 0.0), "min_")

    def write_max(self, path: str) -> None:
        self._write(path, lambda t: t.vmax, "max_")

    def reset(self) -> None:
        self.timers.clear()

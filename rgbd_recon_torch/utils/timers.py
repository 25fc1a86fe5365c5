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

``SPANS`` is the port's span-and-counter recorder (no reference
counterpart): off by default, turned on by ``SPANS.enable(capacity)``.
When off a span site costs one attribute check and returns a shared
null context. When on, each span is one record (name, parent span,
frame id, start, end, clock) in a buffer of fixed capacity, and counts
are (name, frame id, value) records beside them; ``collect()`` hands
both over. Spans of one ``frame()`` share its frame id. Host spans read
``time.perf_counter_ns()`` and, under an active ``torch.profiler``, are
``record_function`` ranges too. Inside a CUDA-graph capture made with
the recorder on (``probe``), a span becomes a pair of timing events
captured as event-record nodes, and one device count is summed into a
device scalar; plain events around a fused frame (``mark_start``,
``copies``, ``mark_end``; two sets, made once and recorded again every
other frame) bound its device span and time its copies.
Both are read at the next ``frame()``, before it replays anything, and
only if complete: the recorder never synchronises.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass, field

import numpy as np
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


HOST, DEVICE = 0, 1                # a record's clock
_NULL = contextlib.nullcontext()   # every span site's context while the recorder is off
_OPEN = np.iinfo(np.int64).min     # the end of a span not closed yet
_SPAN = np.dtype([("name", np.int32), ("parent", np.int64), ("frame", np.int64),
                  ("start", np.int64), ("end", np.int64), ("clock", np.int8)])
_COUNT = np.dtype([("name", np.int32), ("frame", np.int64), ("value", np.int64)])
_MUTED = object()                  # a thread's capture context that records nothing


def _ns(a: torch.cuda.Event, b: torch.cuda.Event) -> int:
    return round(a.elapsed_time(b) * 1e6)


def _event() -> torch.cuda.Event:
    return torch.cuda.Event(enable_timing=True)


class _HostSpan:
    __slots__ = ("rec", "name", "slot", "prof", "frame")

    def __init__(self, rec: "Spans", name: str, frame: int | None = None):
        self.rec, self.name, self.frame, self.prof = rec, name, frame, None

    def __enter__(self):
        rec, local = self.rec, self.rec._local
        if torch.autograd.profiler._is_profiler_enabled:
            self.prof = torch.autograd.profiler.record_function(self.name)
            self.prof.__enter__()
        stack = local.__dict__.setdefault("stack", [])
        if self.frame is not None:
            local.frame = self.frame
        self.slot = rec._take(0)
        if self.slot >= 0:
            rec._spans[self.slot] = (rec._name(self.name), stack[-1] if stack else -1,
                                     getattr(local, "frame", -1), time.perf_counter_ns(),
                                     _OPEN, HOST)
        stack.append(self.slot)
        return self

    def __exit__(self, *exc):
        t = time.perf_counter_ns()
        rec, local = self.rec, self.rec._local
        if self.slot >= 0:
            rec._spans["end"][self.slot] = t
        local.stack.pop()
        if self.frame is not None:
            local.frame = -1
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False


class _Probe:
    """One CUDA graph's device spans and counts, made while it is captured:
    spans as pairs of timing events (event-record nodes of the graph), one
    device count summed into ``total`` by the graph, constants kept here.
    Read after each replay through ``Spans.mark_end``."""

    def __init__(self, device: torch.device):
        self.pairs: list = []      # [name id, parent pair or -1, start event, end event]
        self.counts: list = []     # (name id, constant, or None for ``total``)
        self.total = torch.zeros((), dtype=torch.int64, device=device)
        self.host = torch.zeros((), dtype=torch.int64, pin_memory=True)
        self.summed = False
        self._stack: list[int] = []

    @contextlib.contextmanager
    def span(self, nid: int):
        i = len(self.pairs)
        start = torch.cuda.Event(enable_timing=True, external=True)
        end = torch.cuda.Event(enable_timing=True, external=True)
        self.pairs.append([nid, self._stack[-1] if self._stack else -1, start, end])
        self._stack.append(i)
        start.record()
        try:
            yield
        finally:
            end.record()
            self._stack.pop()

    def count(self, nid: int, value) -> None:
        if not isinstance(value, torch.Tensor):
            self.counts.append((nid, int(value)))
            return
        if self.summed:
            raise RuntimeError("a graph carries one device count")
        torch.sum(value.reshape(-1), dim=0, dtype=torch.int64, out=self.total)
        self.summed = True
        self.counts.append((nid, None))


class _Marks:
    """The plain events of one fused frame, made once and recorded again
    every other frame: its start and end, and a pair for each copy in or
    out (``pairs[:used]`` this frame, each [name id, start, end])."""

    def __init__(self):
        self.start, self.end = _event(), _event()
        self.pairs: list = []
        self.used = 0


class Spans:
    """The span-and-counter recorder (module docstring); ``SPANS`` is the
    process-wide one."""

    def __init__(self):
        self.on = False
        self.dropped = 0
        self.frame_id = -1            # the last frame id handed out
        self._local = threading.local()
        self._lock = threading.Lock()
        self._names: dict[str, int] = {}
        self._spans = self._counts = None
        self._n = [0, 0]              # spans, counts handed a slot (past the capacity too)
        self._open = self._pending = self._last_end = self._marks = None

    def enable(self, capacity: int = 1 << 16) -> None:
        """Start recording into empty buffers of ``capacity`` spans and as
        many counts."""
        self._spans = np.zeros(capacity, _SPAN)
        self._counts = np.zeros(capacity, _COUNT)
        self._n = [0, 0]
        self.dropped = 0
        self._open = self._pending = self._last_end = self._marks = None
        self.on = True

    def disable(self) -> None:
        """Stop recording; what was recorded stays for ``collect``."""
        self.on = False
        self._open = self._pending = None

    # -- span sites -----------------------------------------------------------

    def span(self, name: str):
        """A span named ``name`` under the innermost open span of this
        thread: on the host clock, or inside a ``probe`` as device events."""
        if not self.on:
            return _NULL
        probe = getattr(self._local, "probe", None)
        if probe is None:
            return _HostSpan(self, name)
        return _NULL if probe is _MUTED else probe.span(self._name(name))

    def frame(self):
        """The parent span of one frame: reads the previous frame's device
        events, then hands out a new frame id, which every span and count of
        this thread shares until the span ends."""
        if not self.on:
            return _NULL
        self._poll()
        self.frame_id += 1
        return _HostSpan(self, "frame", self.frame_id)

    def count(self, name: str, value) -> None:
        """Count ``value`` (a number, or an array or tensor whose sum is
        counted) in the current frame. A CUDA tensor is counted only inside
        a ``probe``, by the graph: reading it here would synchronise."""
        if not self.on:
            return
        probe = getattr(self._local, "probe", None)
        if probe is _MUTED:
            return
        if isinstance(value, torch.Tensor) and value.device.type == "cuda":
            if probe is not None:
                probe.count(self._name(name), value)
            return
        value = int(value.sum()) if hasattr(value, "sum") else int(value)
        if probe is not None:
            probe.count(self._name(name), value)
        else:
            self._count(self._name(name), getattr(self._local, "frame", -1), value)

    def probe(self, device: torch.device):
        """Around a CUDA-graph capture on this thread: spans and device
        counts inside become the graph's own (yields the ``_Probe``)."""
        return self._capture_context(_Probe(device))

    def muted(self):
        """Around the eager run before a capture, which is no frame: spans
        and counts inside record nothing."""
        return self._capture_context(_MUTED)

    @contextlib.contextmanager
    def _capture_context(self, probe):
        self._local.probe = probe
        try:
            yield probe
        finally:
            self._local.probe = None

    def mark_start(self) -> None:
        """The device start of this thread's frame: an event on the current
        stream before the frame's first copy in."""
        if not self.on:
            return
        frame = getattr(self._local, "frame", -1)
        if frame < 0:
            self._open = None
            return
        if self._marks is None:
            self._marks = (_Marks(), _Marks())
        marks = self._marks[frame % 2]     # the frame before's are not read yet
        marks.used = 0
        marks.start.record()
        self._open = (frame, marks)

    def copies(self, name: str):
        """Around copies of the frame on the current stream: a device span
        ``name`` between two events (several of one name add up)."""
        if not self.on or self._open is None:
            return _NULL
        return self._copy_span(self._name(name))

    @contextlib.contextmanager
    def _copy_span(self, nid: int):
        marks = self._open[1]
        if marks.used == len(marks.pairs):
            marks.pairs.append([nid, _event(), _event()])
        pair = marks.pairs[marks.used]
        marks.used += 1
        pair[0] = nid
        pair[1].record()
        try:
            yield
        finally:
            pair[2].record()

    def mark_end(self, probe: _Probe | None = None) -> None:
        """The device end of the frame, after its last copy out: ``probe``
        is the replayed graph's, whose device counts are copied to the
        host first. The frame's events wait for the next ``frame()``."""
        if not self.on or self._open is None:
            return
        if probe is not None and probe.summed:
            probe.host.copy_(probe.total, non_blocking=True)
        frame, marks = self._open
        marks.end.record()
        self._pending = (frame, marks.start, marks.end, marks.pairs[:marks.used], probe)
        self._open = None

    # -- the buffers ----------------------------------------------------------

    def _name(self, name: str) -> int:
        nid = self._names.get(name)
        if nid is None:
            with self._lock:
                nid = self._names.setdefault(name, len(self._names))
        return nid

    def _take(self, which: int) -> int:
        """A free slot of the spans (0) or counts (1) buffer, or -1 (then
        counted in ``dropped``)."""
        with self._lock:
            i = self._n[which]
            self._n[which] += 1
            if i < len(self._spans):
                return i
            self.dropped += 1
            return -1

    def _device_span(self, nid: int, parent: int, frame: int, start: int, end: int) -> int:
        i = self._take(0)
        if i >= 0:
            self._spans[i] = (nid, parent, frame, start, end, DEVICE)
        return i

    def _count(self, nid: int, frame: int, value: int) -> None:
        i = self._take(1)
        if i >= 0:
            self._counts[i] = (nid, frame, value)

    def _poll(self) -> None:
        """Read the last fused frame's device events, if complete: device
        spans in ns from its start event. ``frame`` (start to end), the
        copies (``frame.io.load``, ``frame.io.outputs``), the graph's spans,
        and ``device.idle`` from the frame before's end to this start."""
        pending, self._pending = self._pending, None
        if pending is None:
            return
        frame, start, end, pairs, probe = pending
        if not end.query():
            self.dropped += 1
            self._last_end = None
            return
        top = self._device_span(self._name("frame"), -1, frame, 0, _ns(start, end))
        last, self._last_end = self._last_end, (frame, end)
        if last is not None and last[0] == frame - 1:
            self._device_span(self._name("device.idle"), top, frame, -_ns(last[1], start), 0)
        for nid, a, b in pairs:
            self._device_span(nid, top, frame, _ns(start, a), _ns(start, b))
        if probe is None:
            return
        slots = []
        for nid, parent, a, b in probe.pairs:
            slots.append(self._device_span(nid, slots[parent] if parent >= 0 else top, frame,
                                           _ns(start, a), _ns(start, b)))
        for nid, value in probe.counts:
            self._count(nid, frame, int(probe.host) if value is None else value)

    def collect(self) -> dict:
        """What was recorded since ``enable``: ``spans`` and ``counts`` as
        lists of dicts (a span's ``parent`` is the index of its parent span
        in ``spans``, or -1; device spans in ns from their frame's start event,
        host spans on ``perf_counter_ns``; spans still open are left out),
        ``dropped`` (records past the capacity, and device frames not
        complete when read) and ``capacity``."""
        if self._spans is None:
            return {"spans": [], "counts": [], "dropped": 0, "capacity": 0}
        names = {i: n for n, i in self._names.items()}
        spans = self._spans[:min(self._n[0], len(self._spans))]
        keep = np.flatnonzero(spans["end"] != _OPEN)
        index = {int(k): j for j, k in enumerate(keep)}
        counts = self._counts[:min(self._n[1], len(self._counts))]
        return {
            "spans": [{"name": names[int(s["name"])], "parent": index.get(int(s["parent"]), -1),
                       "frame": int(s["frame"]), "start": int(s["start"]), "end": int(s["end"]),
                       "clock": "device" if s["clock"] == DEVICE else "host"}
                      for s in spans[keep]],
            "counts": [{"name": names[int(c["name"])], "frame": int(c["frame"]),
                        "value": int(c["value"])} for c in counts],
            "dropped": self.dropped, "capacity": len(self._spans)}

SPANS = Spans()

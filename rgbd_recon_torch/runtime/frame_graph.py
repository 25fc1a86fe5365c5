"""CUDA graphs of whole frames: the port's stand-in for ``jax.jit``.

The JAX pipeline's fused mode (``PipelineConfig.fused``) compiles the whole
frame into one XLA program per sweep variant ``(axis, flip)``, so the host
dispatches a frame once. JAX has no counterpart of this module: PyTorch
runs eagerly, one launch per op, and the port's frame is bound by the host
that issues them. A CUDA graph is PyTorch's form of the single program:
the frame's launches are recorded once per key and replayed by one call.

``FrameGraphs`` owns

- the static inputs: depth f32[K, H, W], color u8 or f32[K, Hc, Wc, 3],
  modelview and proj f32[4, 4]. ``load`` copies each frame into them
  outside any graph (from pinned staging where the input comes from the
  host), allocating them at the first frame and anew, dropping every
  graph, when a shape or dtype changes;
- one ``torch.cuda.CUDAGraph`` per key, captured by torch's protocol: an
  eager warm-up on the capturing thread's own side stream, then the
  capture on that stream (``capture_error_mode="thread_local"``, so a
  variant can be captured on another thread while frames replay). The
  frame function must not sync with the host or copy from pageable host
  memory; a capture that fails raises, and nothing runs the frame eagerly
  on the card in its place. No garbage collection runs inside a capture
  (collected first, then held off): a collection there could free another
  pipeline's graphs, and the ``cudaFree`` of their memory invalidates the
  capture;
- the kernel launches each capture recorded (``native.recording``), added
  to the kernel counters at every replay, so the counters count what ran.

A replay returns copies of the graph's outputs: the next replay never
overwrites a frame the caller still holds. The graphs share one memory
pool, since every replay goes on the caller's stream and none runs beside
another; the allocator reuses a block only on the stream that freed it,
so each thread captures on one stream of its own, kept for its captures:
the graphs one thread captured share their temporaries. A graph holds the
addresses of every tensor its frame read (session bakes, cached
constants): the owner calls ``drop()`` whenever one of them is replaced. A lock guards the graph table, so a frame on the
calling thread replays a finished graph or captures its own while another
thread captures other keys; a capture that a ``drop()`` overtook is
discarded.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Callable, Hashable, NamedTuple

import numpy as np
import torch

from .. import native


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    out: tuple                    # the graph's own output tensors (a NamedTuple)
    launches: dict[str, int]      # kernel launches of one replay


_GC_LOCK = threading.Lock()
_GC_HELD = {"depth": 0, "enabled": True}


@contextlib.contextmanager
def _no_gc():
    """Collect, then hold the cyclic collector off until the last thread
    inside leaves (it is process-wide)."""
    gc.collect()
    with _GC_LOCK:
        if _GC_HELD["depth"] == 0:
            _GC_HELD["enabled"] = gc.isenabled()
            gc.disable()
        _GC_HELD["depth"] += 1
    try:
        yield
    finally:
        with _GC_LOCK:
            _GC_HELD["depth"] -= 1
            if _GC_HELD["depth"] == 0 and _GC_HELD["enabled"]:
                gc.enable()


def _host_tensor(a, dtype: torch.dtype) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    return t.to(dtype) if t.dtype != dtype else t


class FrameGraphs:
    """One CUDA graph of ``fn(inputs, key)`` per key (module docstring).
    ``fn`` returns a NamedTuple of tensors; ``inputs`` are the static
    input buffers (depth, color, modelview, proj)."""

    def __init__(self, fn: Callable[[tuple, Hashable], tuple], device: torch.device):
        self._fn = fn
        self.device = torch.device(device)
        self._lock = threading.Lock()
        self._graphs: dict[Hashable, _Graph] = {}
        self._gen = 0                 # drop() count: a capture it overtook is discarded
        self._pool = None
        self._spec = None             # (shape, dtype) of each static input
        self._inputs = None
        self._staging = None          # pinned host copies of the static inputs
        self._staged = None           # event: the last copy out of the staging buffers
        self._streams = threading.local()    # each thread's capture stream

    def keys(self) -> list:
        with self._lock:
            return list(self._graphs)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._graphs

    def drop(self) -> None:
        """Free every graph (their outputs and pool go with them)."""
        with self._lock:
            self._graphs.clear()
            self._gen += 1
            self._pool = None

    def load(self, depth, color, modelview, proj) -> None:
        """Copy one frame into the static inputs: numpy arrays or tensors,
        on the host or on the card. Depth, modelview and proj become f32,
        color stays u8 or becomes f32."""
        col_dtype = torch.uint8 if (color.dtype in (np.uint8, torch.uint8)) else torch.float32
        dtypes = (torch.float32, col_dtype, torch.float32, torch.float32)
        srcs = [s if isinstance(s, torch.Tensor) and s.device.type == "cuda"
                else _host_tensor(s, dt) for s, dt in zip((depth, color, modelview, proj), dtypes)]
        spec = tuple((tuple(s.shape), dt) for s, dt in zip(srcs, dtypes))
        if spec != self._spec:
            self.drop()
            self._inputs = tuple(torch.empty(sh, dtype=dt, device=self.device)
                                 for sh, dt in spec)
            self._staging = tuple(torch.empty(sh, dtype=dt, pin_memory=True) for sh, dt in spec)
            self._staged = None
            self._spec = spec
        if self._staged is not None:
            self._staged.synchronize()      # the last frame's copies have left the staging
        for buf, stage, src in zip(self._inputs, self._staging, srcs):
            if src.device.type == "cuda":
                buf.copy_(src)
            else:
                stage.copy_(src)
                buf.copy_(stage, non_blocking=True)
        self._staged = torch.cuda.Event()
        self._staged.record()

    def capture(self, key: Hashable) -> tuple[float, float] | None:
        """Capture the graph of ``key`` on this thread's capture stream:
        (warm-up seconds, capture seconds), or None if the key was
        already captured or a ``drop()`` overtook the capture (the graph
        is then discarded)."""
        with self._lock:
            if key in self._graphs:
                return None
            if self._inputs is None:
                raise RuntimeError("FrameGraphs.capture before the first load()")
            gen, inputs = self._gen, self._inputs
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            pool = self._pool
        stream = getattr(self._streams, "stream", None)
        if stream is None:
            stream = self._streams.stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        t0 = time.perf_counter()
        with torch.cuda.stream(stream):
            self._fn(inputs, key)           # the eager warm-up; its output is not kept
        stream.synchronize()
        t1 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with _no_gc(), torch.cuda.stream(stream), native.recording() as tally:
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out = self._fn(inputs, key)
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                raise
            graph.capture_end()
        t2 = time.perf_counter()
        with self._lock:
            if self._gen != gen:
                return None
            self._graphs.setdefault(key, _Graph(graph, out, dict(tally)))
        return t1 - t0, t2 - t1

    def replay(self, key: Hashable) -> tuple:
        """Run the graph of ``key`` on the current stream (captured by the
        caller with ``capture`` first) and return copies of its outputs."""
        with self._lock:
            g = self._graphs[key]
        g.graph.replay()
        native.add_launches(g.launches)
        return type(g.out)(*(t.clone() for t in g.out))

"""Sharded offline replay: a batch of recorded sequences reconstructed
side by side (mirrors ``rgbd_recon_tpu/parallel/replay.py``).

Sequence-level data parallelism: the batch axis is split over the ranks
of the mesh, each rank runs the pipeline's whole frame on its share, and
the outputs are all-gathered with a leading batch axis. The novel-view
camera is shared by the batch, so the sweep variant ``(axis, flip)`` is one
host decision a step. JAX vmaps the frame over the rank's items; the port
runs them one after another (``torch.vmap`` cannot batch the hand-written
kernels), each through the pipeline's staged frame function. Across
processes each one feeds only its own share (``step(local=True)``,
``partition_sequences``).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from .sharding import Mesh, all_gather, check_mesh, make_mesh, split_range


class ReplayDriver:
    """Batched data-parallel frame stepping over ``mesh`` (a world of one
    on the card when None). The batch size must be a multiple of the mesh
    size."""

    def __init__(self, pipe, mesh: Mesh | None = None):
        self.pipe = pipe
        self.mesh = mesh or make_mesh(device=pipe.device)
        check_mesh(pipe, self.mesh)

    def step(self, depth_b, color_b, modelview, proj, local: bool = False):
        """depth_b f32[B, K, H, W]; color_b f32[B, K, Hc, Wc, 3] (or u8); a
        shared camera. ``local``: the arrays hold only this rank's B/n
        items (each process feeds its own share). Returns a FrameOutput
        with a leading B axis on every rank."""
        pipe, mesh = self.pipe, self.mesh
        n = mesh.size
        if local:
            mine = range(len(depth_b))
        else:
            if len(depth_b) % n:
                raise ValueError(f"batch {len(depth_b)} is not a multiple of the mesh size {n}")
            mine = range(*split_range(len(depth_b), mesh.rank, n))
        outs = [pipe._frame(*pipe._inputs(depth_b[i], color_b[i], modelview, proj))
                for i in mine]
        fields = [torch.stack(f) for f in zip(*outs)]
        return type(outs[0])(*[torch.cat(all_gather(mesh, f)) for f in fields])

    def run(self, readers: Sequence, modelview, proj, num_frames: int | None = None):
        """Replay a batch of StreamReaders in lockstep, each rank reading only
        its share; yields the batched FrameOutput of each frame.
        ``num_frames`` defaults to the shortest sequence."""
        n = self.mesh.size
        if len(readers) % n:
            raise ValueError(f"batch {len(readers)} is not a multiple of the mesh size {n}")
        count = num_frames if num_frames is not None else min(len(r) for r in readers)
        mine = readers[slice(*split_range(len(readers), self.mesh.rank, n))]
        for _ in range(count):
            frames = [r.read() for r in mine]
            yield self.step(np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames]),
                            modelview, proj, local=True)


def partition_sequences(paths: Sequence[str], process_index: int | None = None,
                        num_processes: int | None = None) -> list[str]:
    """Range-partition sequence paths across processes (each feeds only its
    share); the rank and world size default to the process group's (0 and
    1 without one)."""
    on = dist.is_available() and dist.is_initialized()
    pi = process_index if process_index is not None else (dist.get_rank() if on else 0)
    n = num_processes if num_processes is not None else (dist.get_world_size() if on else 1)
    return [p for i, p in enumerate(paths) if i % n == pi]

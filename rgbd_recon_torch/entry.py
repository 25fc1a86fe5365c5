"""Entry points of the port (the counterpart of ``__graft_entry__.py``).

``entry()``      -> (frame_fn, example_args): the port's whole-frame
                    function (``FramePipeline._frame``, what fused mode
                    captures as one CUDA graph) and its arguments on a small
                    rig, on the card unless the caller asks for the CPU.
``dryrun_multichip(n)`` -> spawns n ``gloo`` ranks on the CPU and runs one
                    frame of ``sharded_step`` (32^3) and of
                    ``fast_sharded_step`` (32 x 32 x 16n) under the default
                    camera and an x-dominant one, asserting finite outputs.
"""
from __future__ import annotations

import numpy as np
import torch


def _build_small(num_sensors=2, width=128, height=104, tsdf=(32, 32, 32), render=(96, 64),
                 fwd=(32, 48, 32), inv=(32, 32, 32), device="cuda", **over):
    """The small synthetic rig, its sphere-scene frames and a pipeline."""
    from .calibration import synthetic
    from .runtime.pipeline import FramePipeline, PipelineConfig
    from .utils.math import Bbox

    bbox = Bbox.default()
    rig, cams = synthetic.synthetic_rig(num_sensors=num_sensors, bbox=bbox, fwd_res=fwd,
                                        inv_res=inv, width=width, height=height)
    depth, color = synthetic.render_frames(cams, synthetic.SphereScene.default(bbox))
    cfg = PipelineConfig(render_width=render[0], render_height=render[1], tsdf_res=tsdf,
                         voxel_size=float(np.max(bbox.size) / tsdf[0]), brick_size=0.2,
                         num_lods=4, **over)
    pipe = FramePipeline(rig, cfg, device=device)
    mv, proj = pipe.default_camera()
    return pipe, depth, color, mv, proj


def x_camera(pipe) -> np.ndarray:
    """A modelview on the +x side of the volume (an x-dominant sweep)."""
    from .utils.math import look_at

    center = (pipe.bbox.min + pipe.bbox.max) * 0.5
    eye = center + np.array([2.5, 0.3, 0.1], np.float32)
    return look_at(eye, center, [0.0, 1.0, 0.0]).astype(np.float32)


def entry(device: torch.device | str = "cuda"):
    """The frame function and example arguments (depth, color, modelview,
    proj as device tensors, then the sweep axis and flip)."""
    pipe, depth, color, mv, proj = _build_small(device=device)
    return pipe._frame, pipe._inputs(depth, color, mv, proj)


def _dryrun_rank(rank: int, n: int, rendezvous: str) -> None:
    import torch.distributed as dist

    from .parallel.fast_sharded import fast_sharded_step
    from .parallel.sharding import make_mesh, sharded_step

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", world_size=n,
                            rank=rank)
    try:
        mesh = make_mesh(n, device="cpu")
        pipe, depth, color, mv, proj = _build_small(device="cpu")
        out = sharded_step(pipe, mesh)(depth, color, mv, proj)
        assert bool(torch.isfinite(out.color).all())
        # the production path: whole brick layers per rank, then an
        # x-dominant camera (the all-to-all reshard onto the x axis)
        pipe, depth, color, mv, proj = _build_small(tsdf=(32, 32, 16 * n), device="cpu")
        assert pipe.use_fast
        step = fast_sharded_step(pipe, mesh)
        mv_x = x_camera(pipe)
        assert pipe._axis(mv_x)[1][0] == 0
        for m in (mv, mv_x):
            out = step(depth, color, m, proj)
            assert bool(torch.isfinite(out.color).all())
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int) -> None:
    """Run the sharded steps over ``n_devices`` spawned gloo CPU ranks (a
    file rendezvous in a temporary directory); raises if any rank fails."""
    import os
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="rgbd_dryrun_") as tmp:
        mp.start_processes(_dryrun_rank, args=(n_devices, os.path.join(tmp, "rendezvous")),
                           nprocs=n_devices, join=True, start_method="spawn")

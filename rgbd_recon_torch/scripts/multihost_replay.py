"""Multi-process loopback replay check (mirrors ``scripts/multihost_replay.py``).

Each process owns a range partition of the recorded sequences
(``partition_sequences``), joins one ``torch.distributed`` process group
over loopback TCP, and runs one batched replay step (``ReplayDriver``)
feeding only its own share; a global coverage mean is reduced across the
processes with ``all_reduce``.

    python -m rgbd_recon_torch.scripts.multihost_replay <port> 0 2 --device cpu
    python -m rgbd_recon_torch.scripts.multihost_replay <port> 1 2 --device cpu

``--device cpu`` runs ``gloo`` on the CPU; the default, the card, runs
``nccl`` with one card a process (rank modulo the card count). Prints
``MULTIHOST OK pid=... world=... mine=... coverage=...`` on success, the
same coverage in every process.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.distributed as dist


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("port", type=int)
    ap.add_argument("pid", type=int)
    ap.add_argument("nproc", type=int)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    device = torch.device(args.device)
    if device.type == "cpu":
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{args.port}",
                            world_size=args.nproc, rank=args.pid)
    try:
        from ..entry import _build_small
        from ..parallel.replay import ReplayDriver, partition_sequences
        from ..parallel.sharding import make_mesh

        mesh = make_mesh(args.nproc, device=device)
        seqs = [f"seq{i}.stream" for i in range(2 * args.nproc)]
        mine = partition_sequences(seqs)
        assert len(mine) == len(seqs) // args.nproc
        # the same deterministic scene in every process (shared recordings)
        pipe, depth, color, mv, proj = _build_small(device=mesh.device)
        drv = ReplayDriver(pipe, mesh)
        local_depth = np.stack([depth] * len(mine)) + np.float32(args.pid * 1e-6)
        local_color = np.stack([color] * len(mine))
        out = drv.step(local_depth, local_color, mv, proj, local=True)
        assert out.color.shape[0] == len(seqs)
        # the cross-process reduction: global mean coverage of this share's items
        lo = args.pid * len(mine)
        mine_cov = (out.color[lo:lo + len(mine), ..., 3] > 0).to(torch.float64)
        acc = torch.stack([mine_cov.sum(), torch.tensor(float(mine_cov.numel()),
                                                        dtype=torch.float64,
                                                        device=mine_cov.device)])
        dist.all_reduce(acc)
        cov = float(acc[0] / acc[1])
        assert np.isfinite(cov)
        print(f"MULTIHOST OK pid={args.pid} world={args.nproc} mine={mine} "
              f"coverage={cov:.4f}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

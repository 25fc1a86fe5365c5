"""Brick-sparse integration helpers (mirrors the parts of
``rgbd_recon_tpu/ops/tsdf_fast.py`` the dense-emit path uses)."""
from __future__ import annotations

import torch

BRICK = 16          # voxels per brick edge


def pack_frames(frames) -> torch.Tensor:
    """f32[K, H, W, 6]: depth | quality | silhouette | registered rgb."""
    return torch.cat(
        [
            frames.depth[..., :1],
            frames.quality[..., None],
            frames.silhouette[..., None],
            frames.color_registered,
        ],
        dim=-1,
    ).contiguous()


def occupied_list(mask16: torch.Tensor, max_bricks: int):
    """Fixed-capacity list of occupied brick ids in ascending order,
    device-resident (replaces the reference's GPU->CPU readback,
    recon_integration.cpp:430-445). Returns (idx i32[max_bricks], valid
    bool[max_bricks], count i32[1] = min(#occupied, max_bricks)); bricks
    past the capacity are dropped (``FrameOutput.occupied_bricks`` makes
    that detectable)."""
    flat = mask16.reshape(-1)
    c = torch.cumsum(flat.to(torch.int32), dim=0)
    slot = torch.where(flat, c - 1, max_bricks).clamp(max=max_bricks).to(torch.int64)
    idx = torch.zeros(max_bricks + 1, dtype=torch.int32, device=mask16.device)
    idx.scatter_(0, slot, torch.arange(flat.shape[0], dtype=torch.int32,
                                       device=mask16.device))
    total = c[-1:]
    valid = torch.arange(max_bricks, device=mask16.device) < total
    count = torch.clamp(total, max=max_bricks).to(torch.int32)
    return idx[:max_bricks].contiguous(), valid, count

"""Brick grid: occupancy marking and sparsity bookkeeping (mirrors
``rgbd_recon_tpu/ops/bricks.py``).

``mark_bricks`` is the port of the TPU kernel
``bricks_pallas.mark_bricks_pallas``: the reference's per-pixel
``atomicAdd`` (inc_bricks.glsl:40-58) as a shared-memory histogram in
``csrc/mark_bricks.cu``; ``mark_bricks_plain`` is the same function as a
PyTorch ``index_add_``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import native
from ..utils.math import Bbox


class BrickGrid(NamedTuple):
    """Static brick-grid geometry (host side)."""

    res: tuple[int, int, int]   # (bx, by, bz) brick counts per axis
    brick_size: float           # snapped to a voxel multiple
    bbox_min: np.ndarray
    bbox_max: np.ndarray

    @property
    def num_bricks(self) -> int:
        bx, by, bz = self.res
        return bx * by * bz


def make_brick_grid(bbox: Bbox, brick_size: float, voxel_size: float) -> BrickGrid:
    """Brick size snaps to a voxel multiple (recon_integration.cpp:462-464)
    and the grid covers the bbox with ceil division (divideBox loop)."""
    snapped = voxel_size * max(1.0, round(brick_size / voxel_size))
    res = tuple(int(np.ceil(float(s) / snapped)) for s in bbox.size)
    return BrickGrid(res, float(snapped), bbox.min, bbox.max)


def mark_bricks_plain(world: torch.Tensor, valid: torch.Tensor,
                      grid: BrickGrid) -> torch.Tensor:
    """PyTorch form of kernel 4 (see mark_bricks)."""
    bx, by, bz = grid.res
    dev = world.device
    hi = torch.tensor([bx - 1, by - 1, bz - 1], dtype=torch.float32, device=dev)
    bmin = torch.as_tensor(np.asarray(grid.bbox_min, np.float32), device=dev)
    bsize = torch.tensor(grid.brick_size, dtype=torch.float32, device=dev)
    pos = world.reshape(-1, 3)
    v = valid.reshape(-1)
    # saturating float -> int conversion then clip, NaN -> 0 (XLA semantics)
    f = torch.nan_to_num(torch.floor((pos - bmin) / bsize), nan=0.0)
    index = torch.minimum(torch.clamp(f, min=0.0), hi).to(torch.int64)
    center = bmin + (index.to(torch.float32) + 0.5) * bsize
    diff = pos - center
    d_abs = diff.abs()
    min_v = d_abs.amax(dim=-1, keepdim=True)
    offset = torch.where(d_abs >= min_v, torch.sign(diff), 0.0).to(torch.int64)
    hi_i = hi.to(torch.int64)
    neighbor = torch.minimum(torch.clamp(index + offset, min=0), hi_i)
    neighbor_inc = (d_abs[:, 0] > bsize * 0.1) & v

    def flat_id(idx):
        return (idx[:, 2] * by + idx[:, 1]) * bx + idx[:, 0]

    counts = torch.zeros(bx * by * bz, dtype=torch.int64, device=dev)
    counts.index_add_(0, flat_id(index), v.to(torch.int64))
    counts.index_add_(0, flat_id(neighbor), neighbor_inc.to(torch.int64))
    return counts.to(torch.uint32).reshape(bz, by, bx)


_MARK_BRICKS = native.Kernel(
    "mark_bricks",
    [native.P, native.P, native.P, native.I64] + [native.F] * 4 + [native.I] * 3,
)


def mark_bricks(world: torch.Tensor, valid: torch.Tensor, grid: BrickGrid) -> torch.Tensor:
    """``mark_brick`` (inc_bricks.glsl:40-58) over all valid depth pixels:
    per point its brick plus the closest-neighbor co-mark. world f32[..., 3],
    valid bool[...] -> counts u32[bz, by, bx] (integer-exact)."""
    if not native.is_cuda(world):
        return mark_bricks_plain(world, valid, grid)
    bx, by, bz = grid.res
    n = valid.numel()
    dev = world.device
    world = world.reshape(n, 3)
    valid = valid.reshape(n)
    native.check(world, "world", torch.float32, (n, 3), dev)
    native.check(valid, "valid", torch.bool, (n,), dev)
    counts = torch.empty((bz, by, bx), dtype=torch.uint32, device=dev)
    bmin = np.asarray(grid.bbox_min, np.float32)
    _MARK_BRICKS(world.data_ptr(), valid.data_ptr(), counts.data_ptr(), n,
                 float(bmin[0]), float(bmin[1]), float(bmin[2]),
                 float(np.float32(grid.brick_size)), bx, by, bz)
    return counts


def occupancy_mask(counts: torch.Tensor, min_voxels: int = 10) -> torch.Tensor:
    """bool[bz, by, bx] — ``>= m_min_voxels_per_brick``
    (recon_integration.cpp:434-439)."""
    return counts.to(torch.int64) >= int(min_voxels)


def occupied_ratio(mask: torch.Tensor) -> torch.Tensor:
    """≙ ReconIntegration::occupiedRatio (recon_integration.cpp:441)."""
    return mask.to(torch.float32).mean()


def _axis_key(grid: BrickGrid, axis: int) -> tuple[float, float, int]:
    """What the brick index of an axis reads of the grid, hashable: (the
    bbox's extent, the brick size, the brick count)."""
    return float(grid.bbox_max[axis] - grid.bbox_min[axis]), grid.brick_size, grid.res[axis]


def _axis_brick_index(key: tuple[float, float, int], n_vox: int) -> np.ndarray:
    """Host-side: brick index of each voxel center along one axis
    (``_axis_key``)."""
    size, brick_size, nb = key
    centers = (np.arange(n_vox) + 0.5) / n_vox * size
    return np.clip((centers / brick_size).astype(np.int32), 0, nb - 1)


# the index and cover tables below are made once per (axis, device), so a
# frame copies nothing from the host (``utils.math.device_const``'s rule)

@functools.lru_cache(maxsize=None)
def _axis_index_t(key: tuple[float, float, int], n_vox: int,
                  device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_axis_brick_index(key, n_vox), dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=None)
def _axis_cover_t(key: tuple[float, float, int], n_vox: int, block: int,
                  device: torch.device) -> torch.Tensor:
    """bool[n_vox / block, nb]: block i of the axis covers brick j."""
    idx = _axis_brick_index(key, n_vox).reshape(n_vox // block, block)
    m = np.zeros((n_vox // block, key[2]), bool)
    np.put_along_axis(m, idx, True, axis=1)
    return torch.as_tensor(m, device=device)


def voxel_occupancy(mask: torch.Tensor, grid: BrickGrid,
                    vol_res: tuple[int, int, int]) -> torch.Tensor:
    """Expand the brick mask to per-voxel bool[Vz, Vy, Vx]: voxel centers
    that fall in an occupied brick (the reference's per-occupied-brick
    VolumeSampler draws, recon_integration.cpp:254-259). vol_res is (vx,
    vy, vz). An index gather of each axis's brick index; the JAX package
    writes the same nearest upsample as three one-hot matmuls, a TPU
    layout."""
    vx, vy, vz = vol_res

    def index(n_vox, axis):
        return _axis_index_t(_axis_key(grid, axis), n_vox, mask.device)

    return mask[index(vz, 2)][:, index(vy, 1)][:, :, index(vx, 0)]


def block_occupancy(mask: torch.Tensor, grid: BrickGrid,
                    vol_res: tuple[int, int, int], block: int = 16) -> torch.Tensor:
    """Brick-grid -> voxel-block mask: block (i, j, k) of ``block``^3 voxels
    is occupied iff ANY of its voxel centers lies in an occupied brick.
    Returns bool[Vz/16, Vy/16, Vx/16]."""
    vx, vy, vz = vol_res

    def cover(n_vox, axis):
        return _axis_cover_t(_axis_key(grid, axis), n_vox, block, mask.device)

    cz, cy, cx = cover(vz, 2), cover(vy, 1), cover(vx, 0)
    # any over the covered bricks of each axis, axis by axis
    m = (cz[:, :, None, None] & mask[None]).any(dim=1)            # [Z, by, bx]
    m = (cy[None, :, :, None] & m[:, None]).any(dim=2)            # [Z, Y, bx]
    m = (cx[None, None] & m[:, :, None]).any(dim=3)               # [Z, Y, X]
    return m

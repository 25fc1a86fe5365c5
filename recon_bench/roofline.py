"""Peaks of the chip and the work the inputs need: the rooflines' counts.

Counted from the configuration's sizes and the frame's occupied 16^3
bricks alone, never from the program's tensors, so that the count reads
the same work whatever implements it. Each input byte is counted read
once and each output byte written once.

- integrate: the sensor frames read once (``SENSOR_BYTES_PER_PIXEL``), the
  occupied bricks' voxels written once (``cfg["voxel_bytes"]``), and fp32
  operations ``FUSE_OPS`` a (voxel, sensor) and ``COLOR_OPS`` a voxel over
  the occupied voxels (copied from the port's ``chip_smoke.py`` at commit
  c43690d, where they are counted and explained).
- sweep: the occupied bricks' voxels of both volumes read once and the
  sweep planes written once (``SWEEP_BYTES_PER_RAY``), no operations.

The bound is the larger of bytes over the memory rate and operations over
the fp32 rate: ``bound`` says which.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

BRICK_VOXELS = 16 ** 3
# the frame as 1preprocess hands it to integration: f32 depth, quality,
# silhouette and three color channels a sensor pixel
SENSOR_BYTES_PER_PIXEL = 6 * 4
# a ray's hit state on the sweep grid: hit, its sweep coordinate, rgba and
# the gradient, f32 each
SWEEP_BYTES_PER_RAY = 9 * 4
# fp32 operations of one (voxel, sensor) and one voxel of fusion
WARP_OPS = 3 * 5 * 2
FUSE_OPS = WARP_OPS + 4 + (4 + 2 + 5 * 9) + (1 + 1 + 3 + 2 + 1 + 1 + 2 + 6 + 1 + 2 + 6 + 1)
COLOR_OPS = 2 + 3


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least seconds for the work, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def integrate_work(cfg: dict, n_occ: int) -> tuple[float, float]:
    """(bytes, fp32 operations) of one frame's integration."""
    k = cfg["sensors"]
    pixels = cfg["sensor"]["width"] * cfg["sensor"]["height"]
    vox = n_occ * BRICK_VOXELS
    return (k * pixels * SENSOR_BYTES_PER_PIXEL + vox * cfg["voxel_bytes"],
            vox * (k * FUSE_OPS + COLOR_OPS))


def sweep_work(cfg: dict, n_occ: int) -> tuple[float, float]:
    """(bytes, fp32 operations) of one frame's sweep."""
    rows, cols = cfg["sweep_res"]
    return n_occ * BRICK_VOXELS * cfg["voxel_bytes"] + rows * cols * SWEEP_BYTES_PER_RAY, 0.0

"""Offline inverse-calibration bake, the ``calib_inverter`` tool's core
(mirrors ``rgbd_recon_tpu/calibration/inverter.py``).

≙ CalibrationInverter (framework/calibration/calibration_inverter.cpp:12-143
+ source/calib_inverter.cpp:12-73): for every voxel of a bbox grid, find the
8 nearest samples of the forward cv_xyz volume (a CGAL kd-tree in the
reference) and inverse-distance-weight their (x, y, z) grid indices
(:55-67); +half-voxel offset, normalized by the forward volume dims (:101);
voxels outside the sensor frustum get fvec4(-1) (:95-98).

The search is the JAX module's two-level blocked brute force, in torch on
the card: forward samples grouped into 8^3-sample cells (edge-padded);
per 4^3-voxel target block the 12 nearest cells by centroid distance;
then the exact 8-NN against those cells' 6,144 samples, the distances
from the matmul cross-term |p|^2 + |q|^2 - 2 p.q (float32, TF32 off) and
``torch.topk``. The blocks run in chunks of ``CHUNK`` so the distance
tensors stay at a few GB (``CHUNK`` x 64 x 6144 floats each). The voxel
grid and the frustum cull are host numpy, as in JAX.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..utils.math import Bbox, full_f32
from .frustum import Frustum
from .volume import CalibrationVolume

CELL = 8          # forward samples per cell edge
TBLOCK = 4        # target voxels per block edge
NUM_CELLS = 12    # candidate cells per target block
K_NN = 8          # calibration_inverter.cpp:99
CHUNK = 512       # target blocks per step of the search


def _cellify(samples: np.ndarray):
    """Group forward samples [Dz, Dy, Dx, 3] into cells: returns (cells
    [C, CELL^3, 3], their (x, y, z) grid indices [C, CELL^3, 3], centroids
    [C, 3]). The volume is padded to CELL multiples by repeating edge
    samples (a duplicate carries its original's index, so a tie between
    them picks the same value)."""
    dz, dy, dx, _ = samples.shape
    pz, py, px = (-dz) % CELL, (-dy) % CELL, (-dx) % CELL
    padded = np.pad(samples, ((0, pz), (0, py), (0, px), (0, 0)), mode="edge")
    zz, yy, xx = np.meshgrid(np.arange(dz), np.arange(dy), np.arange(dx), indexing="ij")
    idx = np.stack([xx, yy, zz], axis=-1).astype(np.float32)
    idx = np.pad(idx, ((0, pz), (0, py), (0, px), (0, 0)), mode="edge")

    def to_cells(a):
        gz, gy, gx = a.shape[0] // CELL, a.shape[1] // CELL, a.shape[2] // CELL
        a = a.reshape(gz, CELL, gy, CELL, gx, CELL, 3)
        return a.transpose(0, 2, 4, 1, 3, 5, 6).reshape(gz * gy * gx, CELL ** 3, 3)

    cells = to_cells(padded)
    return cells, to_cells(idx), cells.mean(axis=1)


def invert_blocks(cells: torch.Tensor, cell_idx: torch.Tensor, centroids: torch.Tensor,
                  targets: torch.Tensor) -> torch.Tensor:
    """targets f32[N, TBLOCK^3, 3] -> the inverse-distance-weighted forward
    index f32[N, TBLOCK^3, 3] of each target's 8 nearest samples."""
    out = torch.empty_like(targets)
    for s in range(0, targets.shape[0], CHUNK):
        tgt = targets[s:s + CHUNK]                                   # [B, T3, 3]
        b, t3 = tgt.shape[:2]
        center = tgt.mean(dim=1)
        d2c = ((centroids[None] - center[:, None]) ** 2).sum(-1)      # [B, C]
        cand = torch.topk(-d2c, NUM_CELLS, dim=1).indices             # [B, 12]
        cs = cells[cand].reshape(b, -1, 3)                            # [B, 12*512, 3]
        ci = cell_idx[cand].reshape(b, -1, 3)
        with full_f32():
            cross = torch.bmm(tgt, cs.transpose(1, 2))                # [B, T3, 6144]
        d2 = (tgt ** 2).sum(-1, keepdim=True) + (cs ** 2).sum(-1)[:, None, :] - 2.0 * cross
        nn = torch.topk(-d2, K_NN, dim=2).indices.reshape(b, t3 * K_NN, 1).expand(-1, -1, 3)
        nn_pos = torch.gather(cs, 1, nn).reshape(b, t3, K_NN, 3)
        nn_idx = torch.gather(ci, 1, nn).reshape(b, t3, K_NN, 3)
        dist = torch.linalg.vector_norm(tgt[:, :, None] - nn_pos, dim=-1)
        w = 1.0 / torch.clamp(dist, min=1e-12)                        # inverseDistance (:55-67)
        out[s:s + CHUNK] = (w[..., None] * nn_idx).sum(2) / w.sum(2)[..., None]
    return out


class CalibrationInverter:
    """The reference class (the same outputs on disk). The search runs on
    ``device``: the card unless the caller asks for the CPU."""

    def __init__(self, calib_volume_files: list[str], bbox: Bbox,
                 device: torch.device | str = "cuda"):
        self.bbox = bbox
        self.device = torch.device(device)
        self.cv_xyz_names: list[str] = []
        self.volumes: list[CalibrationVolume] = []
        self.frustums: list[Frustum] = []
        for f in calib_volume_files:
            name = f[:-3] + "cv_xyz"  # calibration_inverter.cpp:17-21
            self.cv_xyz_names.append(name)
            vol = CalibrationVolume.read(name, 3)
            self.volumes.append(vol)
            self.frustums.append(Frustum(vol.corner_points()))
        self.inverted: list[CalibrationVolume] = []

    @classmethod
    def from_volumes(cls, volumes: list[CalibrationVolume], bbox: Bbox,
                     device: torch.device | str = "cuda"):
        self = cls.__new__(cls)
        self.bbox = bbox
        self.device = torch.device(device)
        self.cv_xyz_names = [f"sensor{i}.cv_xyz" for i in range(len(volumes))]
        self.volumes = list(volumes)
        self.frustums = [Frustum(v.corner_points()) for v in volumes]
        self.inverted = []
        return self

    def calculate_inverse_volumes(self, volume_res) -> None:
        """≙ calculateInverseVolumes (calibration_inverter.cpp:68-115)."""
        rx, ry, rz = (int(v) for v in volume_res)
        size = self.bbox.size.astype(np.float64)
        step = size / np.array([rx, ry, rz])
        start = self.bbox.min.astype(np.float64) + step * 0.5  # half-voxel (:76-77)
        xs = start[0] + step[0] * np.arange(rx)
        ys = start[1] + step[1] * np.arange(ry)
        zs = start[2] + step[2] * np.arange(rz)
        zz, yy, xx = np.meshgrid(zs, ys, xs, indexing="ij")
        pts = np.stack([xx, yy, zz], axis=-1).astype(np.float32)  # [rz, ry, rx, 3]

        # blocks of TBLOCK^3 voxels (padded to multiples)
        pz, py, px = (-rz) % TBLOCK, (-ry) % TBLOCK, (-rx) % TBLOCK
        ppts = np.pad(pts, ((0, pz), (0, py), (0, px), (0, 0)), mode="edge")
        bz, by, bx = (ppts.shape[0] // TBLOCK, ppts.shape[1] // TBLOCK,
                      ppts.shape[2] // TBLOCK)
        blocks = torch.as_tensor(
            ppts.reshape(bz, TBLOCK, by, TBLOCK, bx, TBLOCK, 3)
            .transpose(0, 2, 4, 1, 3, 5, 6).reshape(-1, TBLOCK ** 3, 3), device=self.device)
        del ppts

        self.inverted = [self._invert_one(vol, frustum, pts, blocks, (bz, by, bx))
                         for vol, frustum in zip(self.volumes, self.frustums)]

    def _invert_one(self, vol: CalibrationVolume, frustum: Frustum, pts: np.ndarray,
                    blocks: torch.Tensor, nblocks) -> CalibrationVolume:
        """One sensor's inverse volume."""
        rz, ry, rx = pts.shape[:3]
        bz, by, bx = nblocks
        cells, cell_idx, centroids = (torch.as_tensor(a, device=self.device)
                                      for a in _cellify(vol.volume))
        widx = invert_blocks(cells, cell_idx, centroids, blocks).cpu().numpy()
        widx = (widx.reshape(bz, by, bx, TBLOCK, TBLOCK, TBLOCK, 3)
                .transpose(0, 3, 1, 4, 2, 5, 6)
                .reshape(bz * TBLOCK, by * TBLOCK, bx * TBLOCK, 3))[:rz, :ry, :rx]
        dims = vol.res.astype(np.float32)  # (x, y, z)
        out = (widx + 0.5) / dims[None, None, None, :]  # (calibration_inverter.cpp:101)
        out4 = np.concatenate([out, np.ones_like(out[..., :1])], axis=-1)
        inside = frustum.inside(pts)  # frustum cull (:95-98)
        out4 = np.where(inside[..., None], out4, -1.0).astype(np.float32)
        return CalibrationVolume(np.array([rx, ry, rz], np.uint32),
                                 np.array([0.5, 4.5], np.float32), out4)  # (:113)

    def write_inverse_volumes(self, path: str) -> None:
        """≙ writeInverseVolumes (calibration_inverter.cpp:29-36)."""
        for name, vol in zip(self.cv_xyz_names, self.inverted):
            out = os.path.join(path, os.path.basename(name) + "_inv")
            print(f"writing to file {out}")
            vol.write(out)

"""RigCalibration (mirrors ``rgbd_recon_tpu/calibration/rig.py``).

The JAX version holds ``jnp`` arrays; here the rig is a NamedTuple of numpy
arrays, built and kept on the host. Stages move to the device only what
they read (the pipeline uploads ``depth_limits``, ``camera_positions`` and
the bbox; the cv volumes feed the session bakes).

Conventions:
  cv_xyz      f32[K, Dz, Dy, Dx, 3]   sensor (u, v, d_norm) -> world xyz
  cv_uv       f32[K, Dz, Dy, Dx, 2]   sensor (u, v, d_norm) -> color texcoord
  cv_xyz_inv  f32[K, Vz, Vy, Vx, 3]   volume-normalized world -> (u, v, d_norm)
  depth_limits f32[K, 2]              (cv_min_ds, cv_max_ds) per sensor
"""
from __future__ import annotations

import os
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..utils.math import Bbox
from .frustum import Frustum
from .volume import CalibrationVolume


class RigCalibration(NamedTuple):
    cv_xyz: np.ndarray
    cv_uv: np.ndarray
    cv_xyz_inv: np.ndarray
    depth_limits: np.ndarray
    camera_positions: np.ndarray
    bbox_min: np.ndarray
    bbox_max: np.ndarray

    @property
    def num_sensors(self) -> int:
        return self.cv_xyz.shape[0]

    @property
    def bbox(self) -> Bbox:
        return Bbox(np.asarray(self.bbox_min), np.asarray(self.bbox_max))


def build_rig(
    volumes_xyz: Sequence[CalibrationVolume],
    volumes_uv: Sequence[CalibrationVolume],
    volumes_inv: Sequence[CalibrationVolume],
    bbox: Bbox,
) -> RigCalibration:
    """Stack per-sensor volumes; camera positions from the frustum
    corner-ray estimate (CalibVolumes.cpp:224-230)."""
    cam_pos = np.stack(
        [Frustum(v.corner_points()).camera_position() for v in volumes_xyz]
    )
    limits = np.stack([v.depth_limits for v in volumes_xyz]).astype(np.float32)
    return RigCalibration(
        cv_xyz=np.stack([np.asarray(v.volume) for v in volumes_xyz]),
        cv_uv=np.stack([np.asarray(v.volume) for v in volumes_uv]),
        # the inverse bake stores fvec4 (calibration_inverter.cpp:87); the
        # shaders only read .xyz (tsdf_integration.vs:31)
        cv_xyz_inv=np.stack([np.asarray(v.volume[..., :3]) for v in volumes_inv]),
        depth_limits=limits,
        camera_positions=cam_pos,
        bbox_min=np.asarray(bbox.min),
        bbox_max=np.asarray(bbox.max),
    )


def load_rig(calib_files: Sequence[str], bbox: Bbox,
             inv_path: str | None = None) -> RigCalibration:
    """Load a rig from reference-format assets.

    ``calib_files`` are the ``.yml`` paths listed in the ``.ks`` scene file;
    the binary volumes live next to them with the ``.yml`` suffix replaced by
    ``cv_xyz`` / ``cv_uv`` (CalibVolumes.cpp:34-39) and the baked inverses as
    ``<name>cv_xyz_inv`` under ``inv_path`` (CalibVolumes.cpp:64-69).
    """
    xyz, uv, inv = [], [], []
    for path in calib_files:
        base = path[:-3]  # strip "yml" (CalibVolumes.cpp:36)
        xyz.append(CalibrationVolume.read(base + "cv_xyz", 3))
        uv.append(CalibrationVolume.read(base + "cv_uv", 2))
        directory = inv_path if inv_path is not None else os.path.dirname(path)
        name = os.path.basename(base + "cv_xyz") + "_inv"
        inv.append(CalibrationVolume.read(os.path.join(directory, name), 4))
    return build_rig(xyz, uv, inv, bbox)


class DeviceRig(NamedTuple):
    """The rig fields the per-frame stages read, as tensors on the
    pipeline's device. The cv volumes come along only for the stages that
    sample them per frame: the gather tier (no pixel warp baked) and the
    reference path (the dense integrators and the per-ray marcher's exact
    color blend); otherwise only the session bakes read them, on the host
    copy."""

    depth_limits: torch.Tensor      # f32[K, 2]
    camera_positions: torch.Tensor  # f32[K, 3]
    bbox_min: torch.Tensor          # f32[3]
    bbox_max: torch.Tensor          # f32[3]
    cv_xyz: torch.Tensor | None = None       # f32[K, Dz, Dy, Dx, 3]
    cv_uv: torch.Tensor | None = None        # f32[K, Dz, Dy, Dx, 2]
    cv_xyz_inv: torch.Tensor | None = None   # f32[K, Vz, Vy, Vx, 3]

    @property
    def num_sensors(self) -> int:
        return self.depth_limits.shape[0]


def device_rig(rig: RigCalibration, device, volumes: bool = False) -> DeviceRig:
    """``volumes``: also carry cv_xyz, cv_uv and cv_xyz_inv."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    vols = ((t(rig.cv_xyz), t(rig.cv_uv), t(rig.cv_xyz_inv)) if volumes
            else (None, None, None))
    return DeviceRig(t(rig.depth_limits), t(rig.camera_positions),
                     t(rig.bbox_min), t(rig.bbox_max), *vols)

"""Carry state of the JAX package over to the port.

``from_jax(obj, device)`` turns a JAX-side ``RigCalibration``,
``PixelWarp``, ``PiecewiseWarp``, ``AffineTables``, ``IntegrationTables``,
``CullBake``, ``ProcessedFrames`` or a bare array (e.g. ``win_off``) into
the port's counterpart, via numpy, on ``device``. It lets a test feed both implementations the same bakes and
hold each stage alone. It imports nothing of JAX (the JAX arrays are read
through ``numpy.asarray``) and the port's runtime never calls it.
"""
from __future__ import annotations

import numpy as np
import torch

from .calibration.rig import RigCalibration
from .ops.preprocess import ProcessedFrames
from .ops.tsdf_affine import AffineTables, CullBake
from .ops.tsdf_fast import IntegrationTables
from .ops.warp import PiecewiseWarp, PixelWarp


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes: carried over through float32
        return torch.as_tensor(a.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.as_tensor(a, device=device)


def from_jax(obj, device: torch.device | str = "cpu"):
    name = type(obj).__name__
    if name == "RigCalibration":
        return RigCalibration(*(np.asarray(getattr(obj, f))
                                for f in RigCalibration._fields))
    if name == "PixelWarp":
        return PixelWarp(
            *(_tensor(getattr(obj, f), device) for f in ("xyz_a", "xyz_b", "uv_a", "uv_b")),
            float(obj.d_min), float(obj.d_max),
            float(obj.max_err_xyz), float(obj.max_err_uv))
    if name == "PiecewiseWarp":
        return PiecewiseWarp(
            *(_tensor(getattr(obj, f), device)
              for f in ("xyz_a", "xyz_b", "uv_a", "uv_b", "xyz_r", "uv_r")),
            float(obj.d_min), float(obj.d_max),
            float(obj.max_err_xyz), float(obj.max_err_uv))
    if name in ("AffineTables", "CullBake", "ProcessedFrames", "IntegrationTables"):
        cls = {"AffineTables": AffineTables, "CullBake": CullBake,
               "ProcessedFrames": ProcessedFrames,
               "IntegrationTables": IntegrationTables}[name]
        return cls(*(_tensor(getattr(obj, f), device) for f in cls._fields))
    if hasattr(obj, "__array__"):
        return _tensor(obj, device)
    raise TypeError(f"from_jax: no counterpart for {name}")

"""Camera / bounding-box math (mirrors ``rgbd_recon_tpu/utils/math.py``).

``Bbox``, ``perspective``, ``look_at`` and ``transform_point`` are the
numpy originals, copied so the port imports nothing of the JAX package.
``pmat``
is the torch form of the precise small-matrix product: float32 with TF32
switched off (the JAX version asks for ``Precision.HIGHEST``; unprojecting
the far plane cancels to 0/NaN at reduced precision).
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import NamedTuple

import numpy as np
import torch


class Bbox(NamedTuple):
    """Axis-aligned bounding box; default matches kinect_client.cpp:205-207."""

    min: np.ndarray  # f32[3]
    max: np.ndarray  # f32[3]

    @staticmethod
    def create(pmin, pmax) -> "Bbox":
        return Bbox(np.asarray(pmin, np.float32), np.asarray(pmax, np.float32))

    @staticmethod
    def default() -> "Bbox":
        return Bbox.create([-1.0, 0.0, -1.0], [1.0, 2.2, 1.0])

    @property
    def size(self) -> np.ndarray:
        return self.max - self.min

    def contains(self, p) -> np.ndarray:
        """Vectorised inside test over the last axis, faces included
        (reference: inc_bbox_test.glsl:11-21)."""
        p = np.asarray(p)
        return np.logical_and(
            np.all(p >= self.min, axis=-1), np.all(p <= self.max, axis=-1)
        )


def perspective(fovy_deg: float, aspect: float, near: float, far: float) -> np.ndarray:
    """gluPerspective, returned row-major."""
    f = 1.0 / np.tan(np.radians(fovy_deg) / 2.0)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = 2.0 * far * near / (near - far)
    m[3, 2] = -1.0
    return m


def look_at(eye, center, up) -> np.ndarray:
    """gluLookAt view matrix, world -> eye space."""
    eye = np.asarray(eye, np.float64)
    center = np.asarray(center, np.float64)
    up = np.asarray(up, np.float64)
    fwd = center - eye
    fwd = fwd / np.linalg.norm(fwd)
    side = np.cross(fwd, up)
    side = side / np.linalg.norm(side)
    up2 = np.cross(side, fwd)
    m = np.eye(4, dtype=np.float64)
    m[0, :3] = side
    m[1, :3] = up2
    m[2, :3] = -fwd
    m[:3, 3] = -m[:3, :3] @ eye
    return m.astype(np.float32)


def transform_point(mat: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Apply a 4x4 row-major matrix to a 3-point with w-divide."""
    ph = mat @ np.append(np.asarray(p, np.float64), 1.0)
    return (ph[:3] / ph[3]).astype(np.float32)


_F32_LOCK = threading.Lock()
_F32_STATE = {"depth": 0, "saved": None}


@contextlib.contextmanager
def full_f32():
    """Run float32 products at full precision: TF32 off for matmuls and
    convolutions (cuDNN's default is TF32), restored when the last thread
    inside leaves (the flags are process-wide; a variant captured on
    another thread must not see them restored under it)."""
    with _F32_LOCK:
        if _F32_STATE["depth"] == 0:
            _F32_STATE["saved"] = (torch.backends.cuda.matmul.allow_tf32,
                                   torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _F32_STATE["depth"] += 1
    try:
        yield
    finally:
        with _F32_LOCK:
            _F32_STATE["depth"] -= 1
            if _F32_STATE["depth"] == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _F32_STATE["saved"]


@functools.lru_cache(maxsize=None)
def device_const(values: tuple, device: torch.device,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``torch.tensor(values)`` on ``device``, copied from the host once and
    shared after that: a frame reads its small constants with no copy from
    the host, which a CUDA graph capture refuses (the first call happens in
    the eager warm-up before any capture). Callers never write to it. Never
    evicted: a captured graph holds the tensor's address, not a
    reference."""
    return torch.tensor(values, dtype=dtype, device=device)


def pmat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Precise float32 matmul for the camera / point algebra (TF32 off)."""
    with full_f32():
        return torch.matmul(a, b)

"""Sensor view frustum from the 8 calibration-volume corner points (a
numpy copy of ``rgbd_recon_tpu/calibration/frustum.py``).

Reference: framework/calibration/frustum.cpp — 6 planes from 8 corners
(:167-177), point-inside test (:36-43), camera-position estimate via
closest points of two corner rays (:21-34).

Corner order (CalibVolumes.cpp:98-113): 0-3 = near slab (z=0) corners
(u0v0, u0v1, u1v1, u1v0), 4-7 = far slab (z=end), same winding.
"""
from __future__ import annotations

import numpy as np


def _plane(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Plane (nx, ny, nz, d) through 3 points; normal = (b-a) x (c-a)."""
    n = np.cross(b - a, c - a)
    n = n / np.linalg.norm(n)
    return np.append(n, -np.dot(n, a))


def _closest_point_between_lines(p1, d1, p2, d2) -> np.ndarray:
    """Midpoint of the shortest segment between two lines (frustum.cpp:21-34)."""
    d1 = d1 / np.linalg.norm(d1)
    d2 = d2 / np.linalg.norm(d2)
    n = np.cross(d1, d2)
    nn = np.dot(n, n)
    if nn < 1e-12:
        return (p1 + p2) * 0.5
    t1 = np.dot(np.cross(p2 - p1, d2), n) / nn
    t2 = np.dot(np.cross(p2 - p1, d1), n) / nn
    return ((p1 + d1 * t1) + (p2 + d2 * t2)) * 0.5


class Frustum:
    def __init__(self, corners: np.ndarray):
        c = np.asarray(corners, np.float64)
        self.corners = c
        # 6 planes, each oriented to face the frustum centroid (either file
        # winding works)
        centroid = c.mean(axis=0)
        raw = [
            _plane(c[0], c[1], c[3]),  # near
            _plane(c[4], c[7], c[5]),  # far
            _plane(c[0], c[4], c[1]),  # left
            _plane(c[3], c[2], c[7]),  # right
            _plane(c[1], c[5], c[2]),  # top
            _plane(c[0], c[3], c[4]),  # bottom
        ]
        planes = []
        for p in raw:
            if np.dot(p[:3], centroid) + p[3] < 0:
                p = -p
            planes.append(p)
        self.planes = np.stack(planes).astype(np.float32)

    def inside(self, points: np.ndarray) -> np.ndarray:
        """Vectorised point-in-frustum test, ``points [..., 3]`` -> bool[...]."""
        p = np.asarray(points, np.float32)
        d = p @ self.planes[:, :3].T + self.planes[:, 3]
        return np.all(d >= 0.0, axis=-1)

    def camera_position(self) -> np.ndarray:
        """Estimate the sensor origin: intersection of two corner rays
        (near corner -> far corner), as in frustum.cpp:21-34."""
        c = self.corners
        return _closest_point_between_lines(
            c[0], c[0] - c[4], c[2], c[2] - c[6]
        ).astype(np.float32)

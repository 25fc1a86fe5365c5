"""Sensor camera position from the 8 calibration-volume corner points
(mirrors the part of ``rgbd_recon_tpu/calibration/frustum.py`` that
``build_rig`` reaches, a numpy copy; the frustum planes and the
point-inside test are not copied).

Reference: framework/calibration/frustum.cpp — camera-position estimate via
closest points of two corner rays (:21-34).

Corner order (CalibVolumes.cpp:98-113): 0-3 = near slab (z=0) corners
(u0v0, u0v1, u1v1, u1v0), 4-7 = far slab (z=end), same winding.
"""
from __future__ import annotations

import numpy as np


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
        self.corners = np.asarray(corners, np.float64)

    def camera_position(self) -> np.ndarray:
        """Estimate the sensor origin: intersection of two corner rays
        (near corner -> far corner), as in frustum.cpp:21-34."""
        c = self.corners
        return _closest_point_between_lines(
            c[0], c[0] - c[4], c[2], c[2] - c[6]
        ).astype(np.float32)

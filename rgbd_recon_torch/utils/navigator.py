"""Arcball camera navigation (mirrors ``rgbd_recon_tpu/utils/navigator.py``).

≙ pmd::CameraNavigator + gl::ArcBall (framework/navigation/
CameraNavigator.cpp:15-150, arcball.hpp — Shoemake trackball): left-drag
orbits via a virtual-sphere quaternion, middle/right-drag offsets feed
pan/zoom speeds, ``get(speed)`` integrates pan/zoom and returns the camera
matrix. The reference returns the INVERSE modelview (camera pose) and the
caller re-inverts at use; here ``modelview()`` returns the world->eye GL
matrix directly.

Scripted trajectories (benchmark orbits, headless demos) drive the same code
through ``orbit()`` instead of mouse events.
"""
from __future__ import annotations

import numpy as np

from .math import look_at


def _quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(x, y, z, w) Hamilton product a*b."""
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ])


def _quat_to_mat(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q / max(np.linalg.norm(q), 1e-12)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


class ArcBall:
    """Shoemake virtual trackball (arcball.hpp): screen position -> sphere
    point; a drag composes the rotation quaternion."""

    def __init__(self):
        self.width = 1.0
        self.height = 1.0
        self.drag = False
        self.v_down = np.array([0.0, 0.0, 1.0])
        self.q_end = np.array([0.0, 0.0, 0.0, 1.0])
        self.q_cur = self.q_end.copy()

    def set_win_size(self, w: int, h: int) -> None:
        self.width = float(w)
        self.height = float(h)

    def _map_sphere(self, x: float, y: float) -> np.ndarray:
        r = min(self.width, self.height) * 0.5
        c = np.array([self.width * 0.5, self.height * 0.5])
        bm = np.array([(x - c[0]) / r, -(y - c[1]) / r, 0.0])
        mag = bm[0] ** 2 + bm[1] ** 2
        if mag > 1.0:
            bm /= np.sqrt(mag)
        else:
            bm[2] = np.sqrt(1.0 - mag)
        return bm

    def begin_drag(self) -> None:
        self.drag = True
        self.v_down = self._v_cur.copy()

    def end_drag(self) -> None:
        self.drag = False
        self.q_end = self.q_cur.copy()

    def set_cur(self, x: float, y: float) -> None:
        self._v_cur = self._map_sphere(x, y)
        if self.drag:
            d = np.cross(self.v_down, self._v_cur)
            w = float(np.dot(self.v_down, self._v_cur))
            q_drag = np.array([d[0], d[1], d[2], w])
            self.q_cur = _quat_mul(q_drag, self.q_end)

    def matrix(self) -> np.ndarray:
        """Current rotation as 4x4."""
        m = np.eye(4)
        m[:3, :3] = _quat_to_mat(self.q_cur)
        return m


class CameraNavigator:
    """Orbit camera: poi + zoomed offset along the arcball-rotated z axis
    (CameraNavigator.cpp:87-117)."""

    def __init__(self, zoom: float = 2.5):
        self.poi = np.array([0.0, 1.0, 0.0])
        self._x = np.array([1.0, 0.0, 0.0])
        self._y = np.array([0.0, 1.0, 0.0])
        self._z = np.array([0.0, 0.0, 6.0])
        self.zoom = zoom
        self._zoom_reset = zoom
        self.arcball = ArcBall()
        self._offsets = [np.zeros(2), np.zeros(2)]  # middle (pan), right (zoom)
        self._curr_button = -1
        self._start = np.zeros(2)

    def set_zoom(self, z: float) -> None:
        self.zoom = z
        self._zoom_reset = z

    def resize(self, w: int, h: int) -> None:
        self.arcball.set_win_size(w, h)

    # -- mouse protocol (CameraNavigator.cpp:28-69) ------------------------

    def mouse(self, button: int, pressed: bool, x: float, y: float) -> None:
        """button: 0 left (orbit), 1 right (zoom), 2 middle (pan)."""
        if button == 0:
            self.arcball.set_cur(x, y)
            if pressed:
                self.arcball.begin_drag()
            else:
                self.arcball.end_drag()
        elif button in (1, 2):
            idx = 1 if button == 1 else 0
            if pressed:
                self._curr_button = idx
                self._start = np.array([x, y], float)
            else:
                self._offsets[self._curr_button] = np.zeros(2)
                self._curr_button = -1

    def motion(self, x: float, y: float) -> None:
        self.arcball.set_cur(x, y)
        if self._curr_button >= 0:
            p = np.array([x, y], float)
            self._offsets[self._curr_button] = p - self._start
            self._start = p

    def offset(self, index: int) -> np.ndarray:
        return self._offsets[index]

    def reset_offsets(self) -> None:
        self._offsets = [np.zeros(2), np.zeros(2)]

    # -- camera ------------------------------------------------------------

    def modelview(self, speed=(0.0, 0.0, 0.0)) -> np.ndarray:
        """Integrate pan/zoom speed, return the world->eye GL matrix
        (CameraNavigator::get without the final inversion)."""
        rot = np.linalg.inv(self.arcball.matrix())[:3, :3]
        x = rot @ self._x
        y = rot @ self._y
        z = rot @ self._z
        self.poi = self.poi - x * speed[0] - y * speed[1]
        self.zoom = max(0.01, self.zoom - speed[2])
        o = self.zoom * z + self.poi
        return look_at(o.astype(np.float32), self.poi.astype(np.float32),
                       y.astype(np.float32))

    def reset(self) -> None:
        self.poi = np.array([0.0, 0.0, 0.0])
        self.zoom = self._zoom_reset
        self.arcball = ArcBall()

    # -- scripted trajectories --------------------------------------------

    def orbit(self, angle_rad: float, axis=(0.0, 1.0, 0.0)) -> None:
        """Set the arcball rotation to ``angle`` around ``axis`` (scripted
        novel-view orbits; replaces a mouse drag)."""
        a = np.asarray(axis, float)
        a /= max(np.linalg.norm(a), 1e-12)
        half = angle_rad * 0.5
        self.arcball.q_end = np.array(
            [*(a * np.sin(half)), np.cos(half)]
        )
        self.arcball.q_cur = self.arcball.q_end.copy()

    def orbit_frames(self, n: int, axis=(0.0, 1.0, 0.0)):
        """n modelview matrices sweeping a full orbit."""
        out = []
        for i in range(n):
            self.orbit(2.0 * np.pi * i / n, axis)
            out.append(self.modelview())
        return out

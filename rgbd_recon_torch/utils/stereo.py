"""Off-axis stereo camera, ≙ gloost::StereoCamera / ScreenCamera (mirrors
``rgbd_recon_tpu/utils/stereo.py``).

Replicates the reference's head-tracked projection math
(external/gloost/ScreenCamera.cpp:283-334 ``update``,
StereoCamera.cpp:100-120 ``setLeft``/``setRight``): the viewer's cyclops
matrix places the head, the screen matrix places the physical display in
world space, and each eye is offset ±eye_separation/2 along the head's x
axis. The projection is the asymmetric ``glFrustum`` through the screen
rectangle; the modelview maps world -> eye space relative to the screen.

kinect_client drives this in two modes (source/kinect_client.cpp:609-670):
  mode 1 (anaglyph): fixed cyclops translate(0,0,1), identity screen;
          left eye writes R, right eye writes GB (recon_integration.cpp:
          212-217, 321-332 glColorMask).
  mode 2 (side-by-side): cyclops/screen/model matrices streamed from the
          FeedbackReceiver; two viewports inside one window.
"""
from __future__ import annotations

import numpy as np


def translate(x: float, y: float, z: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    m[:3, 3] = (x, y, z)
    return m


def frustum(left: float, right: float, bottom: float, top: float,
            near: float, far: float) -> np.ndarray:
    """glFrustum, row-major (same convention as utils.math.perspective)."""
    m = np.zeros((4, 4), np.float64)
    m[0, 0] = 2.0 * near / (right - left)
    m[0, 2] = (right + left) / (right - left)
    m[1, 1] = 2.0 * near / (top - bottom)
    m[1, 2] = (top + bottom) / (top - bottom)
    m[2, 2] = -(far + near) / (far - near)
    m[2, 3] = -2.0 * far * near / (far - near)
    m[3, 2] = -1.0
    return m


class StereoCamera:
    """Two-eye off-axis camera. Defaults = init_stereo_camera
    (kinect_client.cpp:128-148): cyclops 1 m in front of the screen,
    near 0.2, far 20, eye separation 0.064 m, screen 1.28 x 0.72 m."""

    def __init__(self, cyclops: np.ndarray | None = None,
                 near: float = 0.2, far: float = 20.0,
                 eye_separation: float = 0.064,
                 screen: np.ndarray | None = None,
                 screen_width: float = 1.28, screen_height: float = 0.72):
        self.cyclops = translate(0, 0, 1) if cyclops is None else np.asarray(
            cyclops, np.float64)
        self.screen = np.eye(4) if screen is None else np.asarray(
            screen, np.float64)
        self.near = near
        self.far = far
        self.eye_separation = eye_separation
        self.screen_width = screen_width
        self.screen_height = screen_height

    def set_cyclops_matrix(self, m: np.ndarray) -> None:
        self.cyclops = np.asarray(m, np.float64)

    def set_screen_matrix(self, m: np.ndarray) -> None:
        self.screen = np.asarray(m, np.float64)

    def eye_view(self, side: str) -> tuple[np.ndarray, np.ndarray]:
        """(modelview, projection) for 'left'/'right'/'cyclops'
        (ScreenCamera::update, ScreenCamera.cpp:283-334)."""
        sep = {"left": -0.5, "right": 0.5, "cyclops": 0.0}[side]
        eye_local = np.array([sep * self.eye_separation, 0.0, 0.0, 1.0])
        eye_world = self.cyclops @ eye_local
        screen_inv = np.linalg.inv(self.screen)
        eye_screen = screen_inv @ eye_world
        eye_screen = eye_screen[:3] / eye_screen[3]
        modelview = translate(*(-eye_screen)) @ screen_inv

        d = eye_screen[2]
        ox, oy = -eye_screen[0], -eye_screen[1]
        n = self.near
        left = (ox - self.screen_width / 2.0) * n / d
        right = (ox + self.screen_width / 2.0) * n / d
        bottom = (oy - self.screen_height / 2.0) * n / d
        top = (oy + self.screen_height / 2.0) * n / d
        proj = frustum(left, right, bottom, top, n, self.far)
        return modelview.astype(np.float32), proj.astype(np.float32)


def anaglyph_composite(left_rgba: np.ndarray, right_rgba: np.ndarray,
                       clear_alpha: float = 0.0) -> np.ndarray:
    """Red/cyan anaglyph: the left pass writes only R, the right pass only
    G and B; alpha stays at the clear value (glColorMask(…, GL_FALSE),
    recon_integration.cpp:212-217)."""
    out = np.empty_like(np.asarray(left_rgba))
    out[..., 0] = np.asarray(left_rgba)[..., 0]
    out[..., 1:3] = np.asarray(right_rgba)[..., 1:3]
    out[..., 3] = clear_alpha
    return out


def side_by_side_composite(window_hw: tuple[int, int],
                           left_rgba: np.ndarray, left_pos: tuple[int, int],
                           right_rgba: np.ndarray, right_pos: tuple[int, int],
                           ) -> np.ndarray:
    """Place the two eye renders at their viewport positions inside one
    window (glViewport calls, kinect_client.cpp:652-667). Positions are GL
    (x, y from bottom-left); rows here are top-down, hence the flip."""
    wh, ww = window_hw
    left_rgba = np.asarray(left_rgba)
    right_rgba = np.asarray(right_rgba)
    out = np.zeros((wh, ww, 4), left_rgba.dtype)

    def paste(img, pos):
        h, w = img.shape[:2]
        x, y = pos
        y_top = wh - y - h  # GL viewport y is bottom-left
        ys, xs = max(y_top, 0), max(x, 0)
        ye, xe = min(y_top + h, wh), min(x + w, ww)
        if ye > ys and xe > xs:
            out[ys:ye, xs:xe] = img[ys - y_top:ye - y_top, xs - x:xe - x]

    paste(left_rgba, left_pos)
    paste(right_rgba, right_pos)
    return out

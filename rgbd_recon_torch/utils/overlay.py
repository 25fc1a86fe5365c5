"""Debug wireframe overlays composited onto the rendered frame (mirrors
``rgbd_recon_tpu/utils/overlay.py``).

The reference draws these as GL line primitives over the reconstruction in
mono mode (source/kinect_client.cpp:672-708): the bounding-box "grid"
(``draw_grid`` -> g_bbox.draw()) and per-sensor calibration frustums
(CalibVolumes::drawFrustums -> Frustum::draw, frustum.cpp:40-100). Headless,
the same lines are rasterized host-side (numpy) onto the output image,
depth-tested against the renderer's depth buffer like GL would. The
occupied-brick cubes (``brick_segments``, drawOccupiedBricks) draw only in
recon modes other than integration (kinect_client.cpp:682-684).
"""
from __future__ import annotations

import numpy as np

from .math import Bbox

# cube edge list as corner-index pairs for corners in (x, y, z) bit order
_CUBE_EDGES = np.array([
    (0, 1), (1, 3), (3, 2), (2, 0),
    (4, 5), (5, 7), (7, 6), (6, 4),
    (0, 4), (1, 5), (3, 7), (2, 6),
])
# frustum corner order is (near quad 0-3, far quad 4-7) with quads wound
# 0-1-2-3 (CalibVolumes.cpp:98-113, Frustum::draw frustum.cpp:46-85)
_FRUSTUM_EDGES = np.array([
    (0, 4), (1, 5), (2, 6), (3, 7),
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
])


def box_corners(bmin, bmax) -> np.ndarray:
    """8 corners of an AABB in (x, y, z) bit order."""
    bmin = np.asarray(bmin, np.float32)
    bmax = np.asarray(bmax, np.float32)
    out = np.empty((8, 3), np.float32)
    for i in range(8):
        out[i] = [
            bmax[0] if i & 1 else bmin[0],
            bmax[1] if i & 2 else bmin[1],
            bmax[2] if i & 4 else bmin[2],
        ]
    return out


def bbox_segments(bbox: Bbox) -> np.ndarray:
    """[12, 2, 3] world-space bbox wireframe (g_bbox.draw())."""
    c = box_corners(bbox.min, bbox.max)
    return c[_CUBE_EDGES]


def frustum_segments(corners: np.ndarray) -> np.ndarray:
    """[12, 2, 3] frustum wireframe from the 8 corner points."""
    return np.asarray(corners, np.float32)[_FRUSTUM_EDGES]


def brick_segments(mask: np.ndarray, grid, max_bricks: int = 256) -> np.ndarray:
    """Wire cubes for occupied bricks (drawOccupiedBricks). ``mask``
    bool[bz, by, bx]; at most ``max_bricks`` are drawn (display cap)."""
    idx = np.argwhere(np.asarray(mask))[:max_bricks]           # rows (z, y, x)
    if idx.size == 0:
        return np.zeros((0, 2, 3), np.float32)
    bmin = np.asarray(grid.bbox_min, np.float32)
    s = np.float32(grid.brick_size)
    segs = []
    for z, y, x in idx:
        lo = bmin + np.array([x, y, z], np.float32) * s
        segs.append(box_corners(lo, lo + s)[_CUBE_EDGES])
    return np.concatenate(segs)


def draw_segments(
    rgba: np.ndarray,
    segments: np.ndarray,
    modelview: np.ndarray,
    proj: np.ndarray,
    color=(0.0, 1.0, 0.0, 1.0),
    depth: np.ndarray | None = None,
    samples_per_px: float = 1.5,
) -> np.ndarray:
    """Rasterize world-space line segments onto ``rgba`` [H, W, 4].

    Each segment is sampled densely in NDC, clipped, and plotted; with a
    ``depth`` buffer (the renderer's window-space depth, 1 = far) fragments
    behind geometry are discarded — the GL depth test the reference's line
    passes run under.
    """
    out = np.array(rgba, copy=True)
    if segments.size == 0:
        return out
    h, w = out.shape[:2]
    mvp = (np.asarray(proj, np.float64) @ np.asarray(modelview, np.float64))
    pts = np.concatenate([segments.reshape(-1, 3),
                          np.ones((segments.shape[0] * 2, 1))], axis=1)
    clip = pts @ mvp.T                              # [2S, 4]
    p0, p1 = clip[0::2], clip[1::2]

    for a, b in zip(p0, p1):
        # near-plane clip in homogeneous space (w > eps)
        eps = 1e-6
        if a[3] <= eps and b[3] <= eps:
            continue
        if a[3] <= eps or b[3] <= eps:
            t = (eps - a[3]) / (b[3] - a[3])
            c = a + (b - a) * t
            if a[3] <= eps:
                a = c
            else:
                b = c
        na, nb = a[:3] / a[3], b[:3] / b[3]
        sa = np.array([(na[0] * 0.5 + 0.5) * w, (0.5 - na[1] * 0.5) * h])
        sb = np.array([(nb[0] * 0.5 + 0.5) * w, (0.5 - nb[1] * 0.5) * h])
        n = max(2, int(np.linalg.norm(sb - sa) * samples_per_px))
        t = np.linspace(0.0, 1.0, n)
        xs = np.round(sa[0] + (sb[0] - sa[0]) * t).astype(int)
        ys = np.round(sa[1] + (sb[1] - sa[1]) * t).astype(int)
        zs = (na[2] + (nb[2] - na[2]) * t) * 0.5 + 0.5
        ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h) & (zs > 0) & (zs < 1)
        if depth is not None:
            okd = np.zeros_like(ok)
            okd[ok] = zs[ok] <= np.asarray(depth)[ys[ok], xs[ok]] + 1e-4
            ok = okd
        out[ys[ok], xs[ok]] = np.asarray(color, out.dtype)
    return out

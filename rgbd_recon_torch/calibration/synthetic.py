"""Synthetic calibrated pinhole rig + analytic test scenes (mirrors
``rgbd_recon_tpu/calibration/synthetic.py``).

A numpy copy of what ``synthetic_rig``, ``make_scene`` and
``render_frames`` reach for pinhole rigs, so the port can build the bench
rig and frames on a machine without JAX. The lens-distorted cameras
(``DistortedCamera``) are not copied: the port rejects distorted rigs.

Kinect depth convention: depth = camera-space z (not ray length); the depth
axis of the lookup volumes is normalized d_norm = (z - near) / (far - near).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

from ..utils.math import Bbox, look_at
from .volume import CalibrationVolume
from .rig import build_rig


class PinholeCamera(NamedTuple):
    """world->cam extrinsics (x_cam = R @ x_world + t) + intrinsics in pixels."""

    rot: np.ndarray    # f32[3,3]
    trans: np.ndarray  # f32[3]
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    near: float
    far: float

    def world_to_cam(self, p: np.ndarray) -> np.ndarray:
        return p @ self.rot.T + self.trans

    def cam_to_world(self, p: np.ndarray) -> np.ndarray:
        return (p - self.trans) @ self.rot

    @property
    def position(self) -> np.ndarray:
        return (-self.trans @ self.rot).astype(np.float32)

    def unproject(self, u: np.ndarray, v: np.ndarray, z: np.ndarray) -> np.ndarray:
        """Normalized texcoords (u, v) + cam-space z -> world point."""
        x = (u * self.width - self.cx) / self.fx * z
        y = (v * self.height - self.cy) / self.fy * z
        cam = np.stack(np.broadcast_arrays(x, y, z), axis=-1)
        return self.cam_to_world(cam)

    def project(self, p_world: np.ndarray):
        """World points -> (normalized u, normalized v, cam z)."""
        cam = self.world_to_cam(p_world)
        z = cam[..., 2]
        zs = np.where(np.abs(z) < 1e-9, 1e-9, z)
        u = (cam[..., 0] / zs * self.fx + self.cx) / self.width
        v = (cam[..., 1] / zs * self.fy + self.cy) / self.height
        return u, v, z



def make_cameras(
    num: int,
    bbox: Bbox,
    width: int = 512,
    height: int = 424,
    near: float = 0.5,
    far: float = 4.5,
    radius: float = 2.4,
    fov_deg: float = 62.0,
) -> list[PinholeCamera]:
    """K cameras on a ring around the bbox center, Kinect-v2-ish intrinsics
    (512x424 depth, ~62 deg hfov, 0.5-4.5 m validity window,
    cf. glsl/pre_morph.fs:32-33)."""
    center = (bbox.min + bbox.max) * 0.5
    fx = width / (2.0 * np.tan(np.radians(fov_deg) / 2.0))
    cams = []
    for k in range(num):
        ang = 2.0 * np.pi * k / max(num, 1) + 0.35
        eye = center + np.array(
            [radius * np.cos(ang), 0.35 + 0.12 * k, radius * np.sin(ang)], np.float32
        )
        view = look_at(eye, center, [0.0, 1.0, 0.0]).astype(np.float64)
        # look_at gives GL eye space (camera looks down -z); Kinect depth is
        # +z in front, so flip z (and x to stay right-handed).
        flip = np.diag([-1.0, 1.0, -1.0])
        rot = flip @ view[:3, :3]
        trans = flip @ view[:3, 3]
        cams.append(
            PinholeCamera(
                rot.astype(np.float32), trans.astype(np.float32),
                fx, fx, width / 2.0, height / 2.0, width, height, near, far,
            )
        )
    return cams


def bake_forward_volumes(cam, res=(128, 256, 128), color_cam=None):
    """cv_xyz + cv_uv on the (u, v, d_norm) grid, like the reference's offline
    bake output (CalibVolumes.cpp:19 uses 128x256x128). Grid points sit on
    texel centers so GL-LINEAR sampling reconstructs the analytic model.
    ``color_cam``: the rgb camera for cv_uv (defaults to the depth camera)."""
    rx, ry, rz = res
    u = (np.arange(rx, dtype=np.float64) + 0.5) / rx
    v = (np.arange(ry, dtype=np.float64) + 0.5) / ry
    d = (np.arange(rz, dtype=np.float64) + 0.5) / rz
    dd, vv, uu = np.meshgrid(d, v, u, indexing="ij")  # [Dz, Dy, Dx]
    z = cam.near + dd * (cam.far - cam.near)
    world = cam.unproject(uu, vv, z)
    cu, cv_, _ = (color_cam or cam).project(world)
    cv_xyz = CalibrationVolume(
        np.array([rx, ry, rz], np.uint32),
        np.array([cam.near, cam.far], np.float32),
        world.astype(np.float32),
    )
    cv_uv = CalibrationVolume(
        np.array([rx, ry, rz], np.uint32),
        np.array([cam.near, cam.far], np.float32),
        np.stack([cu, cv_], axis=-1).astype(np.float32),
    )
    return cv_xyz, cv_uv


def bake_inverse_volume(cam, bbox: Bbox, res=(128, 128, 128)):
    """Analytic cv_xyz_inv: voxel center (half-voxel offset like
    calibration_inverter.cpp:76-77) -> (u, v, d_norm); -1 outside the view
    (frustum cull, calibration_inverter.cpp:95-98). res is (x, y, z)."""
    rx, ry, rz = res
    size = bbox.size.astype(np.float64)
    start = bbox.min.astype(np.float64) + size / np.array([rx, ry, rz]) * 0.5
    xs = start[0] + size[0] / rx * np.arange(rx)
    ys = start[1] + size[1] / ry * np.arange(ry)
    zs = start[2] + size[2] / rz * np.arange(rz)
    zz, yy, xx = np.meshgrid(zs, ys, xs, indexing="ij")
    world = np.stack([xx, yy, zz], axis=-1)
    u, v, z = cam.project(world)
    d_norm = (z - cam.near) / (cam.far - cam.near)
    valid = (
        (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
        & (z >= cam.near) & (z <= cam.far)
    )
    out = np.stack([u, v, d_norm, np.ones_like(u)], axis=-1)
    out = np.where(valid[..., None], out, -1.0)
    return CalibrationVolume(
        np.array([rx, ry, rz], np.uint32),
        np.array([0.5, 4.5], np.float32),  # calibration_inverter.cpp:113
        out.astype(np.float32),
    )


def synthetic_rig(
    num_sensors: int = 4,
    bbox: Bbox | None = None,
    fwd_res=(64, 128, 64),
    inv_res=(96, 96, 96),
    width: int = 512,
    height: int = 424,
):
    """Synthetic calibrated pinhole rig. Returns (rig, depth_cams)."""
    bbox = bbox or Bbox.default()
    cams = make_cameras(num_sensors, bbox, width=width, height=height)
    xyz, uv, inv = [], [], []
    for cam in cams:
        a, b = bake_forward_volumes(cam, fwd_res)
        xyz.append(a)
        uv.append(b)
        inv.append(bake_inverse_volume(cam, bbox, inv_res))
    rig = build_rig(xyz, uv, inv, bbox)
    # synthetic camera positions are known exactly; prefer them over the
    # frustum estimate
    rig = rig._replace(
        camera_positions=np.stack([c.position for c in cams]).astype(np.float32)
    )
    return rig, cams


# --------------------------------------------------------------------------
# analytic test scene: spheres


class SphereScene(NamedTuple):
    centers: np.ndarray  # f32[S, 3]
    radii: np.ndarray    # f32[S]
    colors: np.ndarray   # f32[S, 3]

    @staticmethod
    def default(bbox: Bbox | None = None) -> "SphereScene":
        bbox = bbox or Bbox.default()
        c = (bbox.min + bbox.max) * 0.5
        return SphereScene(
            centers=np.array([[c[0], c[1], c[2]], [c[0] + 0.45, c[1] - 0.3, c[2] + 0.2]], np.float32),
            radii=np.array([0.5, 0.22], np.float32),
            colors=np.array([[0.85, 0.35, 0.25], [0.25, 0.55, 0.85]], np.float32),
        )

    def sdf(self, p: np.ndarray) -> np.ndarray:
        d = np.linalg.norm(p[..., None, :] - self.centers, axis=-1) - self.radii
        return d.min(axis=-1)


class ComplexScene(NamedTuple):
    """Adversarial multi-part scene (VERDICT r4 weak #5): a human-ish
    multi-blob figure (sphere head + capsule torso/arms/legs) plus a THIN
    free-standing panel (~2 voxels thick at 256^3) and a concave open box.
    Exercises what the 2-sphere scene never does: thin sheets against the
    TSDF truncation band (limit 0.01 m vs 0.02 m panel), concave interiors
    (carving + occlusion between parts), crowded brick occupancy, and
    oblique splat/trigrid footprints.

    Parts are SDF primitives; ``sdf``/``color_at``/``normal_at`` drive the
    generic renderer (_render_depth_general), so depth maps stay exactly
    consistent with any camera model including distorted ones."""

    cap_a: np.ndarray     # f32[C, 3] capsule segment starts
    cap_b: np.ndarray     # f32[C, 3] capsule segment ends
    cap_r: np.ndarray     # f32[C]
    cap_color: np.ndarray  # f32[C, 3]
    box_c: np.ndarray     # f32[B, 3] box centers
    box_h: np.ndarray     # f32[B, 3] half extents
    box_color: np.ndarray  # f32[B, 3]

    @staticmethod
    def default(bbox: Bbox | None = None) -> "ComplexScene":
        bbox = bbox or Bbox.default()
        c = (bbox.min + bbox.max) * 0.5
        x, y, z = float(c[0]), float(c[1]), float(c[2])

        def P(dx, dy, dz):
            return [x + dx, y + dy, z + dz]

        cap_a = np.array([
            P(0.00, 0.55, 0.00),   # head (degenerate capsule = sphere)
            P(0.00, 0.40, 0.00),   # torso
            P(0.00, 0.35, 0.00),   # left arm (raised oblique)
            P(0.00, 0.35, 0.00),   # right arm
            P(-0.08, -0.25, 0.00),  # left leg
            P(0.08, -0.25, 0.00),  # right leg
        ], np.float32)
        cap_b = np.array([
            P(0.00, 0.55, 0.00),
            P(0.00, -0.20, 0.00),
            P(-0.42, 0.62, 0.12),
            P(0.40, 0.10, -0.18),
            P(-0.13, -0.85, 0.05),
            P(0.13, -0.85, -0.05),
        ], np.float32)
        cap_r = np.array([0.13, 0.17, 0.055, 0.055, 0.07, 0.07], np.float32)
        cap_color = np.array([
            [0.85, 0.65, 0.50], [0.30, 0.40, 0.70], [0.30, 0.40, 0.70],
            [0.30, 0.40, 0.70], [0.35, 0.30, 0.28], [0.35, 0.30, 0.28],
        ], np.float32)
        box_c = np.array([
            P(0.55, -0.10, 0.35),    # thin panel, tilted placement region
            P(-0.55, -0.45, -0.30),  # open box: floor slab
            P(-0.55, -0.25, -0.48),  # open box: back wall
            P(-0.73, -0.25, -0.30),  # open box: side wall
        ], np.float32)
        box_h = np.array([
            [0.010, 0.35, 0.22],     # 2 cm thick sheet
            [0.18, 0.015, 0.18],
            [0.18, 0.20, 0.015],
            [0.015, 0.20, 0.18],
        ], np.float32)
        box_color = np.array([
            [0.80, 0.75, 0.30], [0.45, 0.60, 0.45], [0.45, 0.60, 0.45],
            [0.45, 0.60, 0.45],
        ], np.float32)
        return ComplexScene(cap_a, cap_b, cap_r, cap_color,
                            box_c, box_h, box_color)

    def _part_d(self, p: np.ndarray) -> np.ndarray:
        """[..., C+B] distance to every part."""
        ab = self.cap_b - self.cap_a                       # [C, 3]
        ap = p[..., None, :] - self.cap_a                  # [..., C, 3]
        denom = np.maximum(np.sum(ab * ab, axis=-1), 1e-12)
        t = np.clip(np.sum(ap * ab, axis=-1) / denom, 0.0, 1.0)
        closest = self.cap_a + t[..., None] * ab
        dc = np.linalg.norm(p[..., None, :] - closest, axis=-1) - self.cap_r
        q = np.abs(p[..., None, :] - self.box_c) - self.box_h
        qp = np.maximum(q, 0.0)
        db = (np.linalg.norm(qp, axis=-1)
              + np.minimum(np.max(q, axis=-1), 0.0))
        return np.concatenate([dc, db], axis=-1)

    def sdf(self, p: np.ndarray) -> np.ndarray:
        return self._part_d(p).min(axis=-1)

    def color_at(self, p: np.ndarray) -> np.ndarray:
        colors = np.concatenate([self.cap_color, self.box_color])
        idx = np.argmin(self._part_d(p), axis=-1)
        return colors[idx]

    def normal_at(self, p: np.ndarray, eps: float = 1e-4) -> np.ndarray:
        n = np.stack([
            self.sdf(p + np.array(o) * eps) - self.sdf(p - np.array(o) * eps)
            for o in ((1, 0, 0), (0, 1, 0), (0, 0, 1))
        ], axis=-1)
        nn = np.linalg.norm(n, axis=-1, keepdims=True)
        return n / np.where(nn < 1e-12, 1.0, nn)


def make_scene(kind: str, bbox: Bbox | None = None):
    """Scene factory: ``sphere`` (the historical 2-sphere fixture) or
    ``complex`` (adversarial multi-blob + thin panel + concave box)."""
    if kind == "sphere":
        return SphereScene.default(bbox)
    if kind == "complex":
        return ComplexScene.default(bbox)
    raise ValueError(f"unknown scene kind {kind!r} (sphere|complex)")


def _render_depth_general(cam, scene: SphereScene) -> np.ndarray:
    """Depth for ANY camera exposing unproject (curved rays included):
    per pixel, the smallest z in [near, far] with sdf(unproject(u,v,z))=0 —
    coarse march + bisection, so the depth maps stay exactly consistent
    with the calibration volumes baked from the same model."""
    h, w = cam.height, cam.width
    u = (np.arange(w, dtype=np.float64) + 0.5) / w
    v = (np.arange(h, dtype=np.float64) + 0.5) / h
    uu, vv = np.meshgrid(u, v, indexing="xy")

    n_coarse = 256
    zs = np.linspace(cam.near, cam.far, n_coarse)
    prev_s = scene.sdf(cam.unproject(uu, vv, np.full_like(uu, zs[0])))
    z_lo = np.full((h, w), np.nan)
    z_hi = np.full((h, w), np.nan)
    for zk in zs[1:]:
        s = scene.sdf(cam.unproject(uu, vv, np.full_like(uu, zk)))
        crossing = (prev_s > 0) & (s <= 0) & np.isnan(z_lo)
        z_lo = np.where(crossing, zk - (zs[1] - zs[0]), z_lo)
        z_hi = np.where(crossing, zk, z_hi)
        prev_s = s
    hit = ~np.isnan(z_lo)
    z_lo = np.where(hit, z_lo, cam.near)
    z_hi = np.where(hit, z_hi, cam.far)
    for _ in range(40):
        zm = 0.5 * (z_lo + z_hi)
        sm = scene.sdf(cam.unproject(uu, vv, zm))
        z_hi = np.where(sm <= 0, zm, z_hi)
        z_lo = np.where(sm <= 0, z_lo, zm)
    z = 0.5 * (z_lo + z_hi)
    return np.where(hit, z, 0.0).astype(np.float32)


def render_depth(cam, scene) -> np.ndarray:
    """Analytic Kinect-style depth map f32[H, W] in meters (z-depth of the
    first surface hit; 0 where no hit, mimicking invalid Kinect pixels).
    SphereScene + pinhole uses the closed-form ray-sphere path; any other
    (scene, camera) combination goes through the generic SDF marcher."""
    if not isinstance(scene, SphereScene):
        return _render_depth_general(cam, scene)
    h, w = cam.height, cam.width
    u = (np.arange(w, dtype=np.float64) + 0.5) / w
    v = (np.arange(h, dtype=np.float64) + 0.5) / h
    uu, vv = np.meshgrid(u, v, indexing="xy")
    # ray through each pixel: cam-space dir with z=1
    dx = (uu * w - cam.cx) / cam.fx
    dy = (vv * h - cam.cy) / cam.fy
    dirs_cam = np.stack([dx, dy, np.ones_like(dx)], axis=-1)
    dirs_world = dirs_cam @ np.asarray(cam.rot, np.float64)  # R^T @ dir
    origin = cam.position.astype(np.float64)

    best_z = np.full((h, w), np.inf)
    for c, r in zip(scene.centers, scene.radii):
        oc = origin - c
        a = np.sum(dirs_world**2, axis=-1)
        b = 2.0 * dirs_world @ oc
        cc = np.dot(oc, oc) - r * r
        disc = b * b - 4 * a * cc
        hit = disc > 0
        t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0.0))) / (2 * a), np.inf)
        z = t  # cam-space z = t * dir_z with dir_z == 1
        z = np.where((z > cam.near) & (z < cam.far), z, np.inf)
        best_z = np.minimum(best_z, z)
    return np.where(np.isfinite(best_z), best_z, 0.0).astype(np.float32)


def render_color(cam, scene) -> np.ndarray:
    """Analytic color image f32[H, W, 3] in [0, 1]: surface base color shaded
    by a fixed directional light; a grey gradient background elsewhere."""
    h, w = cam.height, cam.width
    depth = render_depth(cam, scene)
    u = (np.arange(w, dtype=np.float64) + 0.5) / w
    v = (np.arange(h, dtype=np.float64) + 0.5) / h
    uu, vv = np.meshgrid(u, v, indexing="xy")
    world = cam.unproject(uu, vv, np.where(depth > 0, depth, 1.0))
    if isinstance(scene, SphereScene):
        dist = np.linalg.norm(world[..., None, :] - scene.centers, axis=-1) - scene.radii
        idx = np.argmin(dist, axis=-1)
        base = scene.colors[idx]
        nearest_center = scene.centers[idx]
        normal = world - nearest_center
        nrm = np.linalg.norm(normal, axis=-1, keepdims=True)
        normal = normal / np.where(nrm < 1e-9, 1.0, nrm)
    else:
        base = scene.color_at(world)
        normal = scene.normal_at(world)
    light = np.array([0.4, 0.8, 0.45])
    light = light / np.linalg.norm(light)
    shade = np.clip(normal @ light, 0.0, 1.0) * 0.7 + 0.3
    color = base * shade[..., None]
    bg = np.stack([0.2 + 0.3 * vv] * 3, axis=-1)
    return np.where((depth > 0)[..., None], color, bg).astype(np.float32)


def render_frames(cams: Sequence, scene: SphereScene, color_cams=None):
    """Stacked per-sensor frames: depth f32[K, H, W] (meters), color
    f32[K, H, W, 3] in [0, 1]. ``color_cams``: render color from separate
    rgb cameras when they differ from the depth cameras."""
    depth = np.stack([render_depth(c, scene) for c in cams])
    color = np.stack(
        [render_color(c, scene) for c in (color_cams or cams)]
    )
    return depth, color

"""Synthetic calibrated rigs + analytic test scenes (mirrors
``rgbd_recon_tpu/calibration/synthetic.py``).

What ``synthetic_rig``, ``make_scene`` and ``render_frames`` reach, so the
port can build the bench rigs and frames on a machine without JAX, and
``write_reference_scene``, the reference-format scene bundle the app
reads (``.ks`` + ``.yml`` + side files + cv volumes). The
pinhole camera is the numpy original. The lens-distorted camera
(``DistortedCamera``) runs on float64 torch tensors on an explicit
``device``: its undistort / unwarp fixed points over the bench's 4.2M-point
calibration grids and the SDF depth march (296 unprojects per pixel) cost
~20 min in host numpy, seconds on the card.

Kinect depth convention: depth = camera-space z (not ray length); the depth
axis of the lookup volumes is normalized d_norm = (z - near) / (far - near).
"""
from __future__ import annotations

import os
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..utils.math import Bbox, look_at
from .volume import CalibrationVolume
from .rig import build_rig


def _host(x) -> np.ndarray:
    """numpy view of a tensor (copied to the host) or array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


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


class DistortedCamera(NamedTuple):
    """Non-pinhole camera: Brown-Conrady lens distortion + a smooth
    low-frequency world-space deformation emulating the NNI-interpolated
    calibration bake of real rigs (KinectCalibrationFile.cpp:148-580).

    Duck-types PinholeCamera's interface; ``project`` / ``unproject`` take
    arrays or tensors and return float64 tensors on ``device``. Same
    operations, iteration counts and early exit as the numpy original."""

    base: PinholeCamera
    k1: float = 0.0
    k2: float = 0.0
    k3: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    warp_amp: float = 0.0              # meters
    warp_freq: tuple = (2.1, 1.7, 2.6)   # rad/m per axis
    warp_phase: tuple = (0.3, 1.1, 2.0)
    device: str = "cpu"

    width = property(lambda self: self.base.width)
    height = property(lambda self: self.base.height)
    near = property(lambda self: self.base.near)
    far = property(lambda self: self.base.far)
    rot = property(lambda self: self.base.rot)
    trans = property(lambda self: self.base.trans)
    fx = property(lambda self: self.base.fx)
    fy = property(lambda self: self.base.fy)
    cx = property(lambda self: self.base.cx)
    cy = property(lambda self: self.base.cy)
    position = property(lambda self: self.base.position)

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float64, device=self.device)

    def _distort(self, x, y):
        r2 = x * x + y * y
        f = 1.0 + r2 * (self.k1 + r2 * (self.k2 + r2 * self.k3))
        xd = x * f + 2.0 * self.p1 * x * y + self.p2 * (r2 + 2.0 * x * x)
        yd = y * f + self.p1 * (r2 + 2.0 * y * y) + 2.0 * self.p2 * x * y
        return xd, yd

    def _undistort(self, xd, yd, iters: int = 100):
        # fixed point to machine precision with an early exit (one host
        # sync per round)
        x, y = xd.clone(), yd.clone()
        for _ in range(iters):
            r2 = x * x + y * y
            f = 1.0 + r2 * (self.k1 + r2 * (self.k2 + r2 * self.k3))
            dx = 2.0 * self.p1 * x * y + self.p2 * (r2 + 2.0 * x * x)
            dy = self.p1 * (r2 + 2.0 * y * y) + 2.0 * self.p2 * x * y
            xn = (xd - dx) / f
            yn = (yd - dy) / f
            step = float(torch.maximum((xn - x).abs().max(), (yn - y).abs().max()))
            x, y = xn, yn
            if step < 1e-14:
                break
        return x, y

    def _warp_field(self, p):
        """Smooth world-space displacement (the NNI-bake emulation)."""
        if self.warp_amp == 0.0:
            return torch.zeros_like(p)
        fr, ph = self.warp_freq, self.warp_phase
        s = torch.stack([
            torch.sin(fr[0] * p[..., 1] + fr[1] * p[..., 2] + ph[0]),
            torch.sin(fr[1] * p[..., 2] + fr[2] * p[..., 0] + ph[1]),
            torch.sin(fr[2] * p[..., 0] + fr[0] * p[..., 1] + ph[2]),
        ], dim=-1)
        return self.warp_amp * s

    def _unwarp(self, q, iters: int = 15):
        p = q.clone()
        for _ in range(iters):
            p = q - self._warp_field(p)
        return p

    def project(self, p_world):
        w = self._t(p_world)
        w = w + self._warp_field(w)
        cam = w @ self._t(self.base.rot).T + self._t(self.base.trans)
        z = cam[..., 2]
        zs = torch.where(z.abs() < 1e-9, 1e-9, z)
        xd, yd = self._distort(cam[..., 0] / zs, cam[..., 1] / zs)
        u = (xd * self.base.fx + self.base.cx) / self.base.width
        v = (yd * self.base.fy + self.base.cy) / self.base.height
        return u, v, z

    def unproject(self, u, v, z) -> torch.Tensor:
        xd = (self._t(u) * self.base.width - self.base.cx) / self.base.fx
        yd = (self._t(v) * self.base.height - self.base.cy) / self.base.fy
        x, y = self._undistort(xd, yd)
        zb = self._t(z)
        cam = torch.stack(torch.broadcast_tensors(x * zb, y * zb, zb), dim=-1)
        world = (cam - self._t(self.base.trans)) @ self._t(self.base.rot)
        return self._unwarp(world)


def kinect_distortion(cam: PinholeCamera, warp_amp: float = 0.004,
                      device: str = "cpu") -> DistortedCamera:
    """Wrap with Kinect-v2-magnitude lens distortion (typical factory
    IR-camera coefficients) + a ~4 mm NNI-like bake deformation."""
    return DistortedCamera(base=cam, k1=0.09, k2=-0.27, k3=0.09, p1=6e-4,
                           p2=-4e-4, warp_amp=warp_amp, device=device)


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
    ``color_cam``: the rgb camera for cv_uv (defaults to the depth camera;
    distorted rigs pass an offset camera)."""
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
        _host(world).astype(np.float32),
    )
    cv_uv = CalibrationVolume(
        np.array([rx, ry, rz], np.uint32),
        np.array([cam.near, cam.far], np.float32),
        np.stack([_host(cu), _host(cv_)], axis=-1).astype(np.float32),
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
    u, v, z = (_host(a) for a in cam.project(world))
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


def _offset_color_cam(cam: PinholeCamera) -> PinholeCamera:
    """Rgb camera a few cm / ~0.6 deg off the depth camera (real Kinects
    have distinct IR and RGB sensors, KinectCalibrationFile.cpp:231-254)."""
    ang = 0.01
    rd = np.array(
        [[np.cos(ang), 0.0, np.sin(ang)],
         [0.0, 1.0, 0.0],
         [-np.sin(ang), 0.0, np.cos(ang)]], np.float64
    )
    return cam._replace(
        rot=(rd @ cam.rot).astype(np.float32),
        trans=(rd @ cam.trans + np.array([-0.052, 0.002, 0.004])).astype(np.float32),
    )


def synthetic_rig(
    num_sensors: int = 4,
    bbox: Bbox | None = None,
    fwd_res=(64, 128, 64),
    inv_res=(96, 96, 96),
    width: int = 512,
    height: int = 424,
    distortion: float | None = None,
    device: str = "cpu",
):
    """Synthetic calibrated rig. ``distortion=None``: exact pinholes,
    returns (rig, depth_cams). ``distortion=warp_amp`` (meters, e.g.
    0.004): Kinect-magnitude lens distortion + an NNI-like world
    deformation of that amplitude + offset rgb cameras, returns (rig,
    depth_cams, color_cams); the distorted cameras compute on ``device``."""
    bbox = bbox or Bbox.default()
    cams = make_cameras(num_sensors, bbox, width=width, height=height)
    color_cams = None
    if distortion is not None:
        cams = [kinect_distortion(c, warp_amp=distortion, device=device) for c in cams]
        color_cams = [
            DistortedCamera(
                base=_offset_color_cam(c.base), k1=0.05, k2=-0.16, k3=0.05,
                p1=4e-4, p2=3e-4, warp_amp=c.warp_amp, warp_freq=c.warp_freq,
                warp_phase=c.warp_phase, device=device)
            for c in cams
        ]
    xyz, uv, inv = [], [], []
    for i, cam in enumerate(cams):
        a, b = bake_forward_volumes(
            cam, fwd_res, color_cam=color_cams[i] if color_cams else None)
        xyz.append(a)
        uv.append(b)
        inv.append(bake_inverse_volume(cam, bbox, inv_res))
    rig = build_rig(xyz, uv, inv, bbox)
    # synthetic camera positions are known exactly; prefer them over the
    # frustum estimate
    rig = rig._replace(
        camera_positions=np.stack([c.position for c in cams]).astype(np.float32)
    )
    if distortion is not None:
        return rig, cams, color_cams
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

    def sdf(self, p):
        if isinstance(p, torch.Tensor):
            c = torch.as_tensor(self.centers, dtype=p.dtype, device=p.device)
            r = torch.as_tensor(self.radii, dtype=p.dtype, device=p.device)
            return (torch.linalg.vector_norm(p[..., None, :] - c, dim=-1) - r).amin(dim=-1)
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
    with the calibration volumes baked from the same model. Float64
    tensors on the camera's device (a distorted camera's own; the CPU for
    a pinhole camera, whose numpy unproject then runs on the same values)."""
    dev = cam.device if isinstance(cam, DistortedCamera) else "cpu"
    h, w = cam.height, cam.width
    u = (torch.arange(w, dtype=torch.float64, device=dev) + 0.5) / w
    v = (torch.arange(h, dtype=torch.float64, device=dev) + 0.5) / h
    vv, uu = torch.meshgrid(v, u, indexing="ij")

    def sdf_at(z):
        if isinstance(cam, DistortedCamera):
            p = cam.unproject(uu, vv, z)
        else:
            p = torch.as_tensor(cam.unproject(uu.numpy(), vv.numpy(), z.numpy()))
        if isinstance(scene, SphereScene):
            return scene.sdf(p)
        return torch.as_tensor(scene.sdf(_host(p)), device=dev)

    n_coarse = 256
    zs = np.linspace(cam.near, cam.far, n_coarse)
    prev_s = sdf_at(torch.full_like(uu, zs[0]))
    z_lo = torch.full((h, w), float("nan"), dtype=torch.float64, device=dev)
    z_hi = z_lo.clone()
    for zk in zs[1:]:
        s = sdf_at(torch.full_like(uu, zk))
        crossing = (prev_s > 0) & (s <= 0) & torch.isnan(z_lo)
        z_lo = torch.where(crossing, zk - (zs[1] - zs[0]), z_lo)
        z_hi = torch.where(crossing, zk, z_hi)
        prev_s = s
    hit = ~torch.isnan(z_lo)
    z_lo = torch.where(hit, z_lo, cam.near)
    z_hi = torch.where(hit, z_hi, cam.far)
    for _ in range(40):
        zm = 0.5 * (z_lo + z_hi)
        sm = sdf_at(zm)
        z_hi = torch.where(sm <= 0, zm, z_hi)
        z_lo = torch.where(sm <= 0, z_lo, zm)
    z = 0.5 * (z_lo + z_hi)
    return _host(torch.where(hit, z, 0.0).to(torch.float32))


def render_depth(cam, scene) -> np.ndarray:
    """Analytic Kinect-style depth map f32[H, W] in meters (z-depth of the
    first surface hit; 0 where no hit, mimicking invalid Kinect pixels).
    SphereScene + pinhole uses the closed-form ray-sphere path; any other
    (scene, camera) combination goes through the generic SDF marcher."""
    if isinstance(cam, DistortedCamera) or not isinstance(scene, SphereScene):
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
    world = _host(cam.unproject(uu, vv, np.where(depth > 0, depth, 1.0)))
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
    f32[K, H, W, 3] in [0, 1]. ``color_cams``: render color from the rgb
    cameras when they differ from the depth cameras (distorted rigs)."""
    depth = np.stack([render_depth(c, scene) for c in cams])
    color = np.stack(
        [render_color(c, scene) for c in (color_cams or cams)]
    )
    return depth, color


def bench_inputs(num_sensors: int, width: int, height: int, fwd_res, inv_res, seed: int,
                 frames: int = 4, distortion: float | None = None, device="cpu"):
    """The bench inputs of ``chip_smoke.py``: the synthetic rig over
    ``Bbox.default()`` (distorted cameras computing on ``device``) and
    ``frames`` distinct noisy copies of its rendered sphere-scene frames
    (uniform depth noise up to 2 mm, color noise up to 1e-2, drawn from
    ``seed``). Returns (rig, bbox, [(depth, color), ...])."""
    bbox = Bbox.default()
    built = synthetic_rig(num_sensors=num_sensors, bbox=bbox, fwd_res=fwd_res,
                          inv_res=inv_res, width=width, height=height,
                          distortion=distortion, device=device)
    rig, cams, ccams = built if distortion is not None else (*built, None)
    depth, color = render_frames(cams, SphereScene.default(bbox), color_cams=ccams)
    rng = np.random.default_rng(seed)
    out = [(depth + rng.uniform(0, 2e-3, depth.shape).astype(np.float32),
            np.clip(color + rng.uniform(0, 1e-2, color.shape).astype(np.float32), 0, 1))
           for _ in range(frames)]
    return rig, bbox, out


# --------------------------------------------------------------------------
# reference-format scene fixtures


def write_reference_scene(
    directory: str,
    num_sensors: int = 2,
    bbox: Bbox | None = None,
    fwd_res=(32, 48, 32),
    inv_res=(32, 32, 32),
    width: int = 128,
    height: int = 104,
    compressed_rgb: int = 0,
    compressed_depth: bool = False,
) -> str:
    """Write a complete reference-format scene: ``.ks`` + RGBDemo ``.yml`` +
    ``.ext``/``.bbx`` side files + binary cv volumes. Returns the .ks path.

    Format fidelity: the yml mirrors OpenCV YAML token layout so the
    token-stream parser quirks (comma chopping, ``[`` scanning —
    KinectCalibrationFile.cpp:148-360) are exercised on realistic input.
    """
    bbox = bbox or Bbox.default()
    cams = make_cameras(num_sensors, bbox, width=width, height=height)
    os.makedirs(directory, exist_ok=True)

    def mat_block(name, rows, cols, vals):
        data = ", ".join(f"{v:.16e}" for v in vals)
        return (
            f"{name}: !!opencv-matrix\n   rows: {rows}\n   cols: {cols}\n"
            f"   dt: d\n   data: [ {data} ]\n"
        )

    names = []
    for i, cam in enumerate(cams):
        base = os.path.join(directory, f"sensor{i}.")
        names.append(f"sensor{i}.yml")
        k_rgb = [cam.fx, 0.0, cam.cx, 0.0, cam.fy, cam.cy, 0.0, 0.0, 1.0]
        with open(base + "yml", "w") as f:
            f.write("%YAML:1.0\n")
            f.write(mat_block("rgb_intrinsics", 3, 3, k_rgb))
            f.write(mat_block("rgb_distortion", 1, 5, [0.0] * 5))
            f.write(mat_block("depth_intrinsics", 3, 3, k_rgb))
            f.write(mat_block("depth_distortion", 1, 5, [0.0] * 5))
            f.write(mat_block("R", 3, 3, [1, 0, 0, 0, 1, 0, 0, 0, 1]))
            f.write(mat_block("T", 3, 1, [0.0, 0.0, 0.0]))
            f.write(mat_block("rgb_size", 1, 2, [cam.width, cam.height]))
            f.write(mat_block("depth_size", 1, 2, [cam.width, cam.height]))
            f.write(mat_block("near_far", 1, 2, [cam.near, cam.far]))
            f.write(mat_block("compress_rgb", 1, 1, [compressed_rgb]))
            f.write(mat_block("compress_depth", 1, 1, [int(compressed_depth)]))
        # .ext: world T then R (world_to_cam inverse: sensor pose)
        pose_r = cam.rot.T
        with open(base + "ext", "w") as f:
            f.write(" ".join(f"{v:.9f}" for v in cam.position) + "\n")
            for row in pose_r:
                f.write(" ".join(f"{v:.9f}" for v in row) + "\n")
        # .bbx: positive box = scene bbox, negative box empty (reference
        # default convention, KinectCalibrationFile.cpp:567-574)
        with open(base + "bbx", "w") as f:
            f.write(" ".join(f"{v:.4f}" for v in bbox.min) + "\n")
            f.write(" ".join(f"{v:.4f}" for v in bbox.max) + "\n")
            f.write("-100 -100 -100\n-100 -100 -100\n")
        with open(base + "serial", "w") as f:
            f.write(f"SYNTH{i:04d}\n")

        cv_xyz, cv_uv = bake_forward_volumes(cam, fwd_res)
        cv_inv = bake_inverse_volume(cam, bbox, inv_res)
        cv_xyz.write(base + "cv_xyz")
        cv_uv.write(base + "cv_uv")
        cv_inv.write(base + "cv_xyz_inv")

    ks_path = os.path.join(directory, "scene.ks")
    with open(ks_path, "w") as f:
        for n in names:
            f.write(f"kinect {n}\n")
        f.write("bbx " + " ".join(f"{v:.4f}" for v in np.concatenate([bbox.min, bbox.max])) + "\n")
    return ks_path

"""The benchmark's input generator: a pinhole Kinect-v2 rig and its frames.

Frozen copy of the port's generator at commit c43690d
(``rgbd_recon_torch/calibration/synthetic.py``: ``make_cameras``,
``bake_forward_volumes``, ``bake_inverse_volume``, ``synthetic_rig``
without distortion, ``SphereScene.default``, ``render_depth``'s closed-form
ray-sphere path, ``render_color``, and ``bench_inputs``' noise), re-expressed
as batched float64 torch so that a run makes its rig and all its frames on
the card in a few calls. The sphere path, the frame count and the noise's
generator are the benchmark's own: the smaller sphere moves along a seeded
path, the noise comes from a ``torch.Generator`` on the run's device, and
the color image has a size of its own (a Kinect v2 stream's 1280x1080
beside its 512x424 depth), shot over the depth camera's view.

It imports neither the program nor JAX (``guard`` checks at import).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import guard

guard.check_source(__file__, guard.JAX_NAMES | {guard.PROGRAM})

F64 = torch.float64


class Bbox(NamedTuple):
    min: np.ndarray   # f32[3]
    max: np.ndarray   # f32[3]

    @property
    def size(self) -> np.ndarray:
        return self.max - self.min

    @property
    def center(self) -> np.ndarray:
        return (self.min + self.max) * 0.5


def bbox_of(cfg: dict) -> Bbox:
    return Bbox(np.asarray(cfg["bbox"][0], np.float32), np.asarray(cfg["bbox"][1], np.float32))


class Pinhole(NamedTuple):
    """world -> cam: x_cam = rot @ x_world + trans; intrinsics in pixels."""

    rot: np.ndarray     # f32[3, 3]
    trans: np.ndarray   # f32[3]
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    near: float
    far: float

    @property
    def position(self) -> np.ndarray:
        return (-self.trans @ self.rot).astype(np.float32)


def look_at(eye, center, up) -> np.ndarray:
    """gluLookAt view matrix (world -> eye), row-major f32[4, 4]."""
    eye, center, up = (np.asarray(v, np.float64) for v in (eye, center, up))
    fwd = center - eye
    fwd = fwd / np.linalg.norm(fwd)
    side = np.cross(fwd, up)
    side = side / np.linalg.norm(side)
    up2 = np.cross(side, fwd)
    m = np.eye(4, dtype=np.float64)
    m[0, :3], m[1, :3], m[2, :3] = side, up2, -fwd
    m[:3, 3] = -m[:3, :3] @ eye
    return m.astype(np.float32)


def perspective(fovy_deg: float, aspect: float, near: float, far: float) -> np.ndarray:
    """gluPerspective, row-major f32[4, 4]."""
    f = 1.0 / np.tan(np.radians(fovy_deg) / 2.0)
    m = np.zeros((4, 4), np.float32)
    m[0, 0], m[1, 1] = f / aspect, f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = 2.0 * far * near / (near - far)
    m[3, 2] = -1.0
    return m


def make_cameras(num: int, bbox: Bbox, width: int, height: int, near: float = 0.5,
                 far: float = 4.5, radius: float = 2.4, fov_deg: float = 62.0) -> list[Pinhole]:
    """K cameras on a ring around the bbox center (Kinect-v2 intrinsics)."""
    center = bbox.center
    fx = width / (2.0 * np.tan(np.radians(fov_deg) / 2.0))
    cams = []
    for k in range(num):
        ang = 2.0 * np.pi * k / max(num, 1) + 0.35
        eye = center + np.array([radius * np.cos(ang), 0.35 + 0.12 * k,
                                 radius * np.sin(ang)], np.float32)
        view = look_at(eye, center, [0.0, 1.0, 0.0]).astype(np.float64)
        flip = np.diag([-1.0, 1.0, -1.0])      # GL eye space -> Kinect +z depth
        cams.append(Pinhole((flip @ view[:3, :3]).astype(np.float32),
                            (flip @ view[:3, 3]).astype(np.float32),
                            fx, fx, width / 2.0, height / 2.0, width, height, near, far))
    return cams


def cameras(cfg: dict) -> list[Pinhole]:
    """The configuration's depth cameras."""
    return make_cameras(cfg["sensors"], bbox_of(cfg), cfg["sensor"]["width"],
                        cfg["sensor"]["height"])


def _t(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), device=dev).to(F64)


def _unproject(cam: Pinhole, u, v, z, dev):
    """Normalized texcoords (u, v) + cam-space z -> world, float64."""
    x = (u * cam.width - cam.cx) / cam.fx * z
    y = (v * cam.height - cam.cy) / cam.fy * z
    p = torch.stack(torch.broadcast_tensors(x, y, z), dim=-1)
    return (p - _t(cam.trans, dev)) @ _t(cam.rot, dev)


def _project(cam: Pinhole, p, dev):
    """World -> (normalized u, normalized v, cam z), float64."""
    c = p @ _t(cam.rot, dev).T + _t(cam.trans, dev)
    z = c[..., 2]
    zs = torch.where(z.abs() < 1e-9, 1e-9, z)
    return ((c[..., 0] / zs * cam.fx + cam.cx) / cam.width,
            (c[..., 1] / zs * cam.fy + cam.cy) / cam.height, z)


def _centers(n: int, dev) -> torch.Tensor:
    return (torch.arange(n, dtype=F64, device=dev) + 0.5) / n


class Rig(NamedTuple):
    """The rig as host float32 arrays, in the port's ``RigCalibration``
    field order."""

    cv_xyz: np.ndarray            # [K, Dz, Dy, Dx, 3]
    cv_uv: np.ndarray             # [K, Dz, Dy, Dx, 2]
    cv_xyz_inv: np.ndarray        # [K, Vz, Vy, Vx, 3]
    depth_limits: np.ndarray      # [K, 2]
    camera_positions: np.ndarray  # [K, 3]
    bbox_min: np.ndarray
    bbox_max: np.ndarray


def make_rig(cfg: dict, device) -> tuple[Rig, list[Pinhole]]:
    """The configuration's rig: forward volumes on texel centers of the
    (u, v, d_norm) grid, the analytic inverse volume (-1 outside the view),
    exact camera positions."""
    dev = torch.device(device)
    bbox = bbox_of(cfg)
    cams = cameras(cfg)
    fx_, fy_, fz_ = cfg["cv_forward_res"]
    ix, iy, iz = cfg["cv_inverse_res"]
    xyz, uv, inv = [], [], []
    dd, vv, uu = torch.meshgrid(_centers(fz_, dev), _centers(fy_, dev), _centers(fx_, dev),
                                indexing="ij")
    size = torch.as_tensor(bbox.size.astype(np.float64), device=dev)
    start = torch.as_tensor(bbox.min.astype(np.float64), device=dev) \
        + size / torch.tensor([ix, iy, iz], dtype=F64, device=dev) * 0.5
    axes = [start[a] + size[a] / n * torch.arange(n, dtype=F64, device=dev)
            for a, n in enumerate((ix, iy, iz))]
    zz, yy, xx = torch.meshgrid(axes[2], axes[1], axes[0], indexing="ij")
    grid = torch.stack([xx, yy, zz], dim=-1)
    for cam in cams:
        world = _unproject(cam, uu, vv, cam.near + dd * (cam.far - cam.near), dev)
        cu, cv_, _ = _project(cam, world, dev)
        xyz.append(world.float())
        uv.append(torch.stack([cu, cv_], -1).float())
        u, v, z = _project(cam, grid, dev)
        d_norm = (z - cam.near) / (cam.far - cam.near)
        valid = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1) & (z >= cam.near) & (z <= cam.far)
        inv.append(torch.where(valid[..., None], torch.stack([u, v, d_norm], -1), -1.0).float())
    rig = Rig(torch.stack(xyz).cpu().numpy(), torch.stack(uv).cpu().numpy(),
              torch.stack(inv).cpu().numpy(),
              np.array([[c.near, c.far] for c in cams], np.float32),
              np.stack([c.position for c in cams]).astype(np.float32),
              bbox.min.copy(), bbox.max.copy())
    return rig, cams


class Scene(NamedTuple):
    centers: np.ndarray   # f32[F, S, 3]: the spheres' centers in each frame
    radii: np.ndarray     # f32[S]
    colors: np.ndarray    # f32[S, 3]


def scene_path(cfg: dict, traffic: dict, seed: int) -> Scene:
    """``SphereScene.default`` with the smaller sphere moved along a seeded
    path: ``frames`` positions, ``step_m`` a frame in a seeded direction,
    held within ``max_m`` of its start."""
    c = bbox_of(cfg).center
    base = np.array([[c[0], c[1], c[2]], [c[0] + 0.45, c[1] - 0.3, c[2] + 0.2]], np.float32)
    n = traffic["frames"]
    mv = traffic["subject"]
    rng = np.random.default_rng(seed_int(seed))
    d = rng.normal(size=(n - 1, 3))
    d = d / np.linalg.norm(d, axis=1, keepdims=True) * mv["step_m"]
    off = np.concatenate([np.zeros((1, 3)), np.cumsum(d, axis=0)])
    r = np.linalg.norm(off, axis=1, keepdims=True)
    off = np.where(r > mv["max_m"], off / np.maximum(r, 1e-12) * mv["max_m"], off)
    centers = np.repeat(base[None], n, axis=0)
    centers[:, mv["sphere"]] += off.astype(np.float32)
    return Scene(centers, np.array([0.5, 0.22], np.float32),
                 np.array([[0.85, 0.35, 0.25], [0.25, 0.55, 0.85]], np.float32))


def seed_int(seed: int) -> int:
    """Any whole number -> a non-negative seed that numpy and torch take."""
    return int(seed) % (1 << 63)


def _rays(cam: Pinhole, uu, vv, dev):
    """World directions of the rays through normalized texcoords (uu, vv)."""
    return torch.stack([(uu * cam.width - cam.cx) / cam.fx, (vv * cam.height - cam.cy) / cam.fy,
                        torch.ones_like(uu)], -1) @ _t(cam.rot, dev)


def _depth(cam: Pinhole, uu, vv, centers, rr, dev):
    """Camera-space depth f32[F, h, w] of the nearest sphere on each ray
    (0 where none lies in [near, far])."""
    dirs = _rays(cam, uu, vv, dev)                                           # [h, w, 3]
    oc = _t(cam.position, dev) - centers                                     # [F, S, 3]
    a = (dirs * dirs).sum(-1)                                                # [h, w]
    b = 2.0 * torch.einsum("hwc,fsc->fshw", dirs, oc)
    cc = (oc * oc).sum(-1) - rr                                              # [F, S]
    disc = b * b - 4 * a * cc[..., None, None]
    t = torch.where(disc > 0, (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2 * a),
                    math.inf)
    t = torch.where((t > cam.near) & (t < cam.far), t, math.inf)
    best = t.amin(dim=1)                                                     # [F, h, w]
    return torch.where(torch.isfinite(best), best, 0.0).float()


def _shade(cam: Pinhole, uu, vv, depth, scene: Scene, centers, dev):
    """The shaded base colors f32[F, h, w, 3] where ``depth`` hits, over a
    grey gradient background."""
    light = torch.tensor([0.4, 0.8, 0.45], dtype=F64, device=dev)
    light = light / torch.linalg.vector_norm(light)
    colors = torch.as_tensor(scene.colors, device=dev)
    world = _unproject(cam, uu, vv, torch.where(depth > 0, depth, 1.0).to(F64), dev)
    dist = torch.linalg.vector_norm(world[:, :, :, None] - centers[:, None, None], dim=-1) \
        - torch.as_tensor(scene.radii, device=dev).to(F64)
    idx = dist.argmin(dim=-1)                                                # [F, h, w]
    near_c = torch.gather(centers, 1, idx.reshape(idx.shape[0], -1, 1).expand(-1, -1, 3))
    normal = world - near_c.reshape(world.shape)
    nrm = torch.linalg.vector_norm(normal, dim=-1, keepdim=True)
    normal = normal / torch.where(nrm < 1e-9, 1.0, nrm)
    shade = torch.clamp(normal @ light, 0.0, 1.0) * 0.7 + 0.3
    color = colors[idx].to(F64) * shade[..., None]
    bg = (0.2 + 0.3 * vv)[..., None].expand(*vv.shape, 3)
    return torch.where((depth > 0)[..., None], color, bg).float()


def render(cams: list[Pinhole], scene: Scene, device, color_size=None):
    """Depth f32[F, K, H, W] (meters, 0 where no hit) and color f32[F, K, Hc,
    Wc, 3] in [0, 1] of every frame: the closed-form ray-sphere depth and the
    shaded base colors over a grey gradient background. ``color_size``
    (Wc, Hc), default the depth size: the color camera spans the depth
    camera's view, so a texcoord names the same ray in both images and the
    rig's ``cv_uv`` holds for either."""
    dev = torch.device(device)
    h, w = cams[0].height, cams[0].width
    wc, hc = color_size or (w, h)
    vv, uu = torch.meshgrid(_centers(h, dev), _centers(w, dev), indexing="ij")
    cvv, cuu = torch.meshgrid(_centers(hc, dev), _centers(wc, dev), indexing="ij")
    centers = torch.as_tensor(scene.centers, device=dev).to(F64)        # [F, S, 3]
    rr = torch.as_tensor(scene.radii * scene.radii, device=dev).to(F64)  # f32 r*r as numpy
    depths, cols = [], []
    for cam in cams:
        depth = _depth(cam, uu, vv, centers, rr, dev)
        cdepth = depth if (wc, hc) == (w, h) else _depth(cam, cuu, cvv, centers, rr, dev)
        cols.append(_shade(cam, cuu, cvv, cdepth, scene, centers, dev))
        depths.append(depth)
    return torch.stack(depths, 1), torch.stack(cols, 1)


def add_noise(depth: torch.Tensor, color: torch.Tensor, traffic: dict, seed: int):
    """``bench_inputs``' noise, drawn on the frames' device from ``seed``:
    depth + U[0, depth_m), color + U[0, color) clipped to [0, 1]."""
    g = torch.Generator(device=depth.device)
    g.manual_seed(seed_int(seed))
    nz = traffic["noise"]
    depth = depth + torch.rand(depth.shape, generator=g, device=depth.device) * nz["depth_m"]
    color = torch.clamp(color + torch.rand(color.shape, generator=g, device=color.device)
                        * nz["color"], 0.0, 1.0)
    return depth, color


def make_frames(cfg: dict, traffic: dict, seed: int, cams: list[Pinhole], device):
    """The traffic's distinct frames as host arrays, depth f32[F, K, H, W]
    at the sensor's size and color u8[F, K, Hc, Wc, 3] at the
    configuration's color size (format ``rgb8``, as the wire delivers it),
    made on ``device``."""
    size = (cfg["color"]["width"], cfg["color"]["height"])
    depth, color = render(cams, scene_path(cfg, traffic, seed), device, size)
    depth, color = add_noise(depth, color, traffic, seed)
    if cfg["color"]["format"] != "rgb8":
        raise ValueError(f"color format {cfg['color']['format']!r}: the wire's is rgb8")
    color = torch.round(color * 255.0).to(torch.uint8)
    return depth.cpu().numpy(), color.cpu().numpy()

"""TSDF raymarching: the render camera, parameters and shading the sweep
renderer and the splatting strategies use, and the per-ray oracle marcher
(mirrors ``rgbd_recon_tpu/ops/raymarch.py``).

The oracle (``render``) is glsl/tsdf_raymarch.fs re-expressed as in the
JAX package: every pixel marches a fixed-trip loop of ``max_steps`` steps
with hit masking (every trip runs: asking the host whether all rays are
done would sync every step), sampling the TSDF trilinearly like the GL
sampler, with the secant refinement and an optional coarse march over the
brick grid that narrows each ray's span. Shading reads the per-voxel
color volume of ``tsdf.integrate_colors``; ``blend_colors_exact`` keeps
the shader's per-hit blend. It is plain PyTorch on the card too.

The volume occupies the unit cube in "volume space"; vol_to_world maps it
to the world bbox (recon_integration.cpp:66-71).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils.math import Bbox, device_const, pmat
from .sample import sample2d, sample3d

# shading constants (glsl/shading.glsl:4-12)
_LIGHT_POSITION = (1.5, 1.0, 1.0)
_LIGHT_DIFFUSE = (1.0, 0.9, 0.7)
_LIGHT_SPECULAR = (1.0, 1.0, 1.0)
_KS = 0.5
_SHINE = 20.0
_SOLID_DIFFUSE = (0.5, 0.5, 0.5)

# per-camera debug colors (shading.glsl:24-30), f32[5, 3] on the CPU; move
# to the frame's device at use
CAMERA_COLORS = torch.from_numpy(np.array(
    [[228, 26, 28], [55, 126, 184], [77, 175, 74], [152, 78, 163], [255, 127, 0]],
    np.float32) / np.float32(255.0))
_CAMERA_COLORS = tuple(map(tuple, CAMERA_COLORS.tolist()))   # device_const's key


class RenderCamera(NamedTuple):
    """Pinhole render camera: ``modelview`` world -> eye (GL, looking down
    -z), ``proj`` the GL projection; both row-major f32[4, 4]."""

    modelview: torch.Tensor
    proj: torch.Tensor
    width: int
    height: int


class RenderParams(NamedTuple):
    shade_mode: int = 0     # 0 color / 1 shaded / 2 normal / 3 camera blend
    max_steps: int = 0      # 0 = derive from limit (cube diagonal / step)


class RenderOutput(NamedTuple):
    color: torch.Tensor   # f32[H, W, 4] rgba (a = blend flag / 0 for miss)
    depth: torch.Tensor   # f32[H, W] window depth in [0, 1]; 1 for miss
    hit: torch.Tensor     # bool[H, W]
    num_samples: torch.Tensor  # i32[H, W]


def vol_to_world_matrix(bbox: Bbox) -> np.ndarray:
    """translate(bbox_min) @ scale(bbox_size) (recon_integration.cpp:72-73)."""
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = bbox.size
    m[:3, 3] = bbox.min
    return m


def vol_to_world_tensor(bbox: Bbox, device: torch.device) -> torch.Tensor:
    """``vol_to_world_matrix`` on ``device``, copied once per bbox
    (``device_const``)."""
    return device_const(tuple(map(tuple, vol_to_world_matrix(bbox).tolist())),
                        torch.device(device))


def _vec(v, ref: torch.Tensor) -> torch.Tensor:
    return device_const(tuple(v), ref.device)


@functools.lru_cache(maxsize=None)
def _ndc_centers(n: int, device: torch.device) -> torch.Tensor:
    """Pixel centers of an n-pixel axis in NDC, each float32 operation
    rounded as in JAX; made once per (n, device) (``device_const``'s
    rule)."""
    c = (np.arange(n, dtype=np.float32) + np.float32(0.5)) / np.float32(n) \
        * np.float32(2.0) - np.float32(1.0)
    return torch.as_tensor(c, device=device)


def phong_shade(view_pos: torch.Tensor, view_normal: torch.Tensor) -> torch.Tensor:
    """shading.glsl:32-63 mode 1 (view-space Blinn-Phong on solid grey)."""
    def normalize(v):
        return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-20)

    diffuse = _vec(_LIGHT_DIFFUSE, view_pos)
    solid = _vec(_SOLID_DIFFUSE, view_pos)
    to_light = normalize(_vec(_LIGHT_POSITION, view_pos) - view_pos)
    light_angle = (view_normal * to_light).sum(dim=-1)
    lit = light_angle > 0.0
    diff = torch.clamp(light_angle, min=0.0)
    half = normalize(to_light + normalize(-view_pos))
    spec = torch.pow(torch.clamp((half * view_normal).sum(dim=-1), min=0.0), _SHINE)
    a = (1.0 - light_angle) ** 2
    spec = spec * (1.0 - a * a * a)
    diff = torch.where(lit, diff, 0.0)
    spec = torch.where(lit, spec, 0.0)
    return (diffuse * 0.2 * solid + diffuse * solid * diff[..., None]
            + _vec(_LIGHT_SPECULAR, view_pos) * _KS * spec[..., None])


def _ray_grid(cam: RenderCamera, bbox: Bbox, rows: tuple[int, int] | None = None):
    """Per-pixel ray origin (the camera position) and unit direction in
    volume space, unprojected through the precise camera algebra (TF32
    would cancel the far plane's w). ``rows`` (y0, y1): only those screen
    rows."""
    w, h = cam.width, cam.height
    dev = cam.modelview.device
    v2w = vol_to_world_tensor(bbox, dev)
    mv = cam.modelview.to(torch.float32)
    ys = _ndc_centers(h, dev)
    if rows is not None:
        ys = ys[rows[0]:rows[1]]
    yy, xx = torch.meshgrid(ys, _ndc_centers(w, dev), indexing="ij")
    one = torch.ones_like(xx)
    mv_vol = pmat(mv, v2w)
    inv = torch.linalg.inv_ex(pmat(cam.proj.to(torch.float32), mv_vol)).inverse
    p_near = pmat(torch.stack([xx, yy, -one, one], -1), inv.T)
    p_far = pmat(torch.stack([xx, yy, one, one], -1), inv.T)
    cam_pos = torch.linalg.inv_ex(mv_vol).inverse[:3, 3]
    d = p_far[..., :3] / p_far[..., 3:4] - p_near[..., :3] / p_near[..., 3:4]
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-20)
    return cam_pos, d


def intersect_box(origin: torch.Tensor, direction: torch.Tensor):
    """Unit-cube slab intersection (tsdf_raymarch.fs:363-374). ``direction``
    need not be normalized; t is in units of |direction|."""
    inv_r = 1.0 / direction
    tbot = inv_r * (0.0 - origin)
    ttop = inv_r * (1.0 - origin)
    tmin = torch.minimum(ttop, tbot)
    tmax = torch.maximum(ttop, tbot)
    t0 = torch.maximum(torch.maximum(tmin[..., 0], tmin[..., 1]), tmin[..., 2])
    t1 = torch.minimum(torch.minimum(tmax[..., 0], tmax[..., 1]), tmax[..., 2])
    return t0, t1, t0 <= t1


class RaymarchResult(NamedTuple):
    hit: torch.Tensor          # bool[H, W]
    position: torch.Tensor     # f32[H, W, 3] refined hit position (volume space)
    num_samples: torch.Tensor  # i32[H, W] (≙ tex_num_samples, fs:395-398)


def march(tsdf: torch.Tensor, cam: RenderCamera, bbox: Bbox, limit: float,
          params: RenderParams = RenderParams(), brick_mask: torch.Tensor | None = None,
          brick_size_vol: float | None = None, brick_extent=None,
          rows: tuple[int, int] | None = None) -> RaymarchResult:
    """Fixed-trip masked raymarch (tsdf_raymarch.fs:62-114) of the f32
    TSDF [Vz, Vy, Vx].

    ``brick_mask`` (bool[bz, by, bx]) enables space skipping, the
    counterpart of the reference's MIN-blend depth peel
    (recon_integration.cpp:408-428): a coarse march over the brick grid at
    one-brick strides shrinks each ray's [t_near, t_far] to its occupied
    span. ``brick_extent``: the per-axis (x, y, z) span of the brick grid
    in volume units (``res * snapped_brick_size / bbox.size``, over 1 where
    the brick size does not divide the bbox). ``rows`` (y0, y1): march
    only those screen rows (every ray is independent, so each row equals
    the whole march's)."""
    sample_distance = limit * 0.5  # fs:34
    origin, dirs = _ray_grid(cam, bbox, rows)
    step_vec = dirs * sample_distance
    dev = step_vec.device
    shape = step_vec.shape[:-1]

    t0, t1, _ = intersect_box(origin, step_vec)  # t in step units (fs:78)
    t_near = torch.clamp(t0, min=0.0)
    t_far = t1

    if brick_mask is not None:
        bsz = brick_size_vol if brick_size_vol is not None else 1.0 / brick_mask.shape[0]
        coarse_step = np.float32(bsz / sample_distance)  # in fine-step units
        n_coarse = int(math.ceil(math.sqrt(3.0) / bsz)) + 2
        occ = brick_mask.to(torch.float32)[..., None]
        extent = (device_const(tuple(np.asarray(brick_extent, np.float32).tolist()), dev)
                  if brick_extent is not None else torch.ones(3, device=dev))
        t_entry = torch.full(shape, math.inf, device=dev)
        t_exit = torch.full(shape, -math.inf, device=dev)
        for i in range(n_coarse):
            t = t_near + float(np.float32(i + 0.5) * coarse_step)
            pos = origin + step_vec * t[..., None]
            inside = ((pos >= 0.0) & (pos <= 1.0)).all(dim=-1) & (t <= t_far)
            o = sample3d(occ, pos / extent, method="nearest")[..., 0] > 0.5
            hit = inside & o
            t_entry = torch.where(hit, torch.minimum(t_entry, t - float(coarse_step)), t_entry)
            t_exit = torch.where(hit, torch.maximum(t_exit, t + float(coarse_step)), t_exit)
        has_span = torch.isfinite(t_entry)
        t_near = torch.where(has_span, torch.maximum(t_entry, t_near), t_far)
        t_far = torch.where(has_span, torch.minimum(t_exit, t_far), t_far)

    max_steps = params.max_steps or int(math.ceil(math.sqrt(3.0) / sample_distance)) + 1
    start = origin + step_vec * t_near[..., None]
    span = torch.ceil((t_far - t_near).abs())  # fs:85
    tsdf4 = tsdf[..., None]
    hit = torch.zeros(shape, dtype=torch.bool, device=dev)
    hit_pos = torch.zeros_like(start)
    prev_d = torch.full(shape, -limit, device=dev)  # fs:89
    nsamp = torch.zeros(shape, dtype=torch.int32, device=dev)
    for i in range(max_steps):
        active = ~hit & (i < span)
        pos = start + step_vec * float(i)
        d = sample3d(tsdf4, pos)[..., 0]
        crossed = active & (d > 0.0)  # IsoValue = 0 (fs:98)
        # secant refinement (fs:100)
        denom = d - prev_d
        frac = prev_d / torch.where(denom.abs() > 1e-20, denom, 1e-20)
        refined = (pos - step_vec) - step_vec * frac[..., None]
        hit_pos = torch.where(crossed[..., None], refined, hit_pos)
        nsamp = nsamp + active.to(torch.int32)
        prev_d = torch.where(active, d, prev_d)
        hit = hit | crossed
    return RaymarchResult(hit, hit_pos, nsamp)


def gradient_normal(tsdf: torch.Tensor, pos: torch.Tensor, limit: float) -> torch.Tensor:
    """Central-difference gradient normal at volume positions
    (tsdf_raymarch.fs:140-149; offsets = sampleDistance, sign-flipped)."""
    t4 = tsdf[..., None]
    g = []
    for axis in range(3):
        e = [0.0, 0.0, 0.0]
        e[axis] = limit * 0.5
        e = _vec(e, pos)
        g.append(sample3d(t4, pos + e)[..., 0] - sample3d(t4, pos - e)[..., 0])
    n = -torch.stack(g, dim=-1)
    nn = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    return n / torch.where(nn < 1e-20, 1.0, nn)


def blend_colors_exact(frames, rig, pos: torch.Tensor, limit: float) -> torch.Tensor:
    """Shader-faithful color blend at volume positions ``pos`` [..., 3]
    (tsdf_raymarch.fs:295-330 ``blendColors``): quality/(dist+0.01)
    weights, 1/dist fallback. ``rig``: a DeviceRig with the cv volumes.
    Returns rgba [..., 4], alpha 1 for a quality-weighted blend, -1 for the
    fallback."""
    shape = pos.shape[:-1]
    total_color = torch.zeros(shape + (3,), dtype=torch.float32, device=pos.device)
    total_weight = torch.zeros(shape, dtype=torch.float32, device=pos.device)
    total_color2 = torch.zeros_like(total_color)
    total_weight2 = torch.zeros_like(total_weight)
    for i in range(rig.num_sensors):
        pos_calib = sample3d(rig.cv_xyz_inv[i], pos)
        pos_color = sample3d(rig.cv_uv[i], pos_calib)  # fs:304
        color = sample2d(frames.color[i], pos_color)
        depth = sample2d(frames.depth[i][..., :1], pos_calib[..., :2], method="nearest")[..., 0]
        dist = (depth - pos_calib[..., 2]).abs()
        qual = sample2d(frames.quality[i][..., None], pos_calib[..., :2])[..., 0]
        qual = torch.where(dist < limit, qual, 0.0)  # :311-313
        w = qual / (dist + 0.01)  # :315-316
        total_color = total_color + color * w[..., None]
        total_weight = total_weight + w
        w2 = 1.0 / torch.clamp(dist, min=1e-9)  # :318-319
        total_color2 = total_color2 + color * w2[..., None]
        total_weight2 = total_weight2 + w2
    has_quality = total_weight > 0.0
    rgb = torch.where(
        has_quality[..., None],
        total_color / torch.clamp(total_weight, min=1e-20)[..., None],
        total_color2 / torch.clamp(total_weight2, min=1e-20)[..., None])
    flag = torch.where(has_quality, 1.0, -1.0)
    return torch.cat([rgb, flag[..., None]], dim=-1)


def blend_cameras(frames, rig, pos: torch.Tensor, limit: float) -> torch.Tensor:
    """Camera-influence debug colors (tsdf_raymarch.fs:346-361 with
    getWeights :151-166): rgb [..., 3], white where no sensor sees."""
    colors = device_const(_CAMERA_COLORS, pos.device)
    total_color = torch.zeros(pos.shape[:-1] + (3,), dtype=torch.float32, device=pos.device)
    total_weight = torch.zeros(pos.shape[:-1], dtype=torch.float32, device=pos.device)
    for i in range(rig.num_sensors):
        pos_calib = sample3d(rig.cv_xyz_inv[i], pos)
        depth = sample2d(frames.depth[i][..., :1], pos_calib[..., :2], method="nearest")[..., 0]
        dist = (depth - pos_calib[..., 2]).abs()
        qual = sample2d(frames.quality[i][..., None], pos_calib[..., :2])[..., 0]
        w = torch.where(dist < limit, qual, 0.0)
        total_color = total_color + colors[i] * w[..., None]
        total_weight = total_weight + w
    c = total_color / torch.clamp(total_weight, min=1e-20)[..., None]
    return torch.where((total_weight > 0.0)[..., None], c, 1.0)


def render(tsdf: torch.Tensor, color_volume: torch.Tensor | None, frames, rig,
           cam: RenderCamera, bbox: Bbox, limit: float,
           params: RenderParams = RenderParams(), brick_mask: torch.Tensor | None = None,
           brick_size_vol: float | None = None, brick_extent=None,
           exact_colors: bool = False, rows: tuple[int, int] | None = None) -> RenderOutput:
    """Full draw (≙ ReconIntegration::draw, recon_integration.cpp:176-240):
    march, refine, shade, write color + window-space depth.

    ``tsdf`` [Vz, Vy, Vx] and ``color_volume`` (channels-last [Vz, Vy, Vx,
    4] or the dense emit's z-major [Vz, 4, Vy, Vx]) may be bf16: both are
    converted to float32 channels-last once, here (the JAX function's taps
    promote bf16 to float32 the same way). ``frames`` and ``rig`` (a
    DeviceRig with the cv volumes) are read only by shade mode 3 and the
    exact color blend (``exact_colors`` or no color volume). ``rows`` (y0,
    y1): draw only those screen rows (the row-sharded dense step)."""
    tsdf = tsdf.to(torch.float32).contiguous()
    if color_volume is not None:
        if tuple(color_volume.shape) != tuple(tsdf.shape) + (4,):
            color_volume = color_volume.movedim(1, -1)
        color_volume = color_volume.to(torch.float32).contiguous()
    res = march(tsdf, cam, bbox, limit, params, brick_mask, brick_size_vol, brick_extent,
                rows)
    pos = res.position

    if params.shade_mode == 3:
        rgb = blend_cameras(frames, rig, pos, limit)
        rgba = torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)
    elif exact_colors or color_volume is None:
        rgba = blend_colors_exact(frames, rig, pos, limit)
    else:
        rgba = sample3d(color_volume, pos)

    v2w = vol_to_world_tensor(bbox, pos.device)
    mvt = cam.modelview.to(torch.float32)
    normal_vol = gradient_normal(tsdf, pos, limit)
    mv = pmat(mvt, v2w)
    # NormalMatrix in the reference is the modelview rotation
    normal_view = pmat(normal_vol, mvt[:3, :3].T)
    nn = torch.linalg.vector_norm(normal_view, dim=-1, keepdim=True)
    normal_view = normal_view / torch.where(nn < 1e-20, 1.0, nn)
    view_pos = pmat(pos, mv[:3, :3].T) + mv[:3, 3]

    if params.shade_mode == 1:
        rgba = torch.cat([phong_shade(view_pos, normal_view), rgba[..., 3:4]], dim=-1)
    elif params.shade_mode == 2:
        rgba = torch.cat([normal_vol, rgba[..., 3:4]], dim=-1)

    # gl_FragDepth from view-space z (tsdf_raymarch.fs:133)
    z = view_pos[..., 2]
    zs = torch.where(z.abs() < 1e-20, -1e-20, z)
    proj = cam.proj.to(torch.float32)
    frag_depth = (proj[2, 2] * z + proj[2, 3]) / -zs * 0.5 + 0.5

    miss = ~res.hit
    rgba = torch.where(miss[..., None], 0.0, rgba)
    frag_depth = torch.where(miss, 1.0, frag_depth)
    return RenderOutput(rgba, frag_depth, res.hit, res.num_samples)

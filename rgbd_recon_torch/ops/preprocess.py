"""Per-sensor depth/color preprocessing (mirrors
``rgbd_recon_tpu/ops/preprocess.py``, the pixel-warp branch).

The five fullscreen GLSL passes of ``NetKinectArray::processTextures``
(NetKinectArray.cpp:309-426) on stacked ``[K, H, W]`` tensors with
edge-clamped stencils:

  morph     pre_morph.fs     3x3 validity-aware depth dilation
  bilateral pre_depth.fs     13x13 bilateral filter + bbox cull + registered
                             color -> CIELAB
  boundary  pre_boundary.fs  silhouette classification + LAB-vote refinement
  normals   pre_normal.fs    central-difference world-space normals
  quality   pre_quality.fs   per-pixel fusion weight

The calibration lookups go through the baked pixel warp (affine
``PixelWarp`` or ``PiecewiseWarp``, kernel 5 on the card) or, with
``warp=None``, the exact per-pixel gather of the cv volumes (``sample3d``,
the gather tier). Besides kernel 5 three hand-written kernels run here:
``bilateral_accum`` (the port of ``preprocess_pallas.bilateral_accum_pallas``,
``csrc/bilateral_accum.cu``), ``quality`` (kernel 10, ``csrc/quality.cu``,
which replaces no TPU kernel) and the color registration through
``warp.warp_screen`` (warp tiers; the gather tier registers color with
exact per-pixel taps, as the JAX package does).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import native
from ..utils.math import device_const
from .colors import rgb_to_lab
from .sample import pixel_texcoords, sample2d, sample3d
from .warp import warp_screen

MIN_DEPTH_M = 0.5
MAX_DEPTH_M = 4.5
MIN_RANGE = 0.65
MAX_COLOR_DIST = 0.5
KS = 6  # bilateral kernel_size (pre_depth.fs:27)


class PreprocessConfig(NamedTuple):
    filter_textures: bool = True
    use_processed_depth: bool = True
    refine_boundary: bool = True


def _pad_edge(x: torch.Tensor, k: int) -> torch.Tensor:
    """Edge-pad dims 1 and 2 of [K, H, W, ...] by k."""
    h, w = x.shape[1], x.shape[2]
    iy = torch.clamp(torch.arange(-k, h + k, device=x.device), 0, h - 1)
    ix = torch.clamp(torch.arange(-k, w + k, device=x.device), 0, w - 1)
    return x[:, iy][:, :, ix]


def _shifted(padded: torch.Tensor, dy: int, dx: int, h: int, w: int, k: int):
    return padded[:, k + dy:k + dy + h, k + dx:k + dx + w]


def morph_dilate(depth_m: torch.Tensor) -> torch.Tensor:
    """3x3 validity-aware dilation (pre_morph.fs:73-112, kernel_size=1)."""
    k = 1
    max_dist = 0.2
    _, h, w = depth_m.shape
    padded = _pad_edge(depth_m, k)
    valid_c = (depth_m > MIN_DEPTH_M) & (depth_m < MAX_DEPTH_M)
    taps = [_shifted(padded, dy, dx, h, w, k)
            for dy in range(-k, k + 1) for dx in range(-k, k + 1)]
    sum1 = torch.zeros_like(depth_m)
    cnt1 = torch.zeros_like(depth_m)
    for s in taps:
        v = (s > MIN_DEPTH_M) & (s < MAX_DEPTH_M)
        sum1 = sum1 + torch.where(v, s, 0.0)
        cnt1 = cnt1 + v.to(depth_m.dtype)
    avg = sum1 / torch.clamp(cnt1, min=1.0)
    sum2 = torch.zeros_like(depth_m)
    cnt2 = torch.zeros_like(depth_m)
    for s in taps:
        v = (s > MIN_DEPTH_M) & (s < MAX_DEPTH_M) & ((avg - s).abs() < max_dist)
        sum2 = sum2 + torch.where(v, s, 0.0)
        cnt2 = cnt2 + v.to(depth_m.dtype)
    filled = torch.where(cnt2 > 0, sum2 / torch.clamp(cnt2, min=1.0), 0.0)
    filled = torch.where(cnt1 > 0, filled, 0.0)
    return torch.where(valid_c, depth_m, filled)


# ---------------------------------------------------------------------------
# bilateral accumulators (kernel 3)


def bilateral_accum_plain(depth_m: torch.Tensor, depth_limits: torch.Tensor):
    """PyTorch form of kernel 3: the 13x13 accumulators of pre_depth.fs:85-127
    (weighted depth, total weight, range weight), edge-clamped, with the
    tent spatial weight that goes negative in the corners."""
    _, h, w = depth_m.shape
    cv_min = depth_limits[:, 0][:, None, None]
    cv_max = depth_limits[:, 1][:, None, None]
    drm = 0.35 * (depth_m / MAX_DEPTH_M)
    drm_div = torch.clamp(drm, min=1e-20)
    padded = _pad_edge(depth_m, KS)
    depth_bf = torch.zeros_like(depth_m)
    w_acc = torch.zeros_like(depth_m)
    w_range = torch.zeros_like(depth_m)
    for dy in range(-KS, KS + 1):
        for dx in range(-KS, KS + 1):
            s = _shifted(padded, dy, dx, h, w, KS)
            dist = (s - depth_m).abs()
            accept = (s >= cv_min) & (s <= cv_max) & (dist <= drm)
            # the f32 value of the JAX form 1 - sqrt(f32(dx^2 + dy^2)) / 6
            gs = float(np.float32(1.0) - np.sqrt(np.float32(dx * dx + dy * dy))
                       / np.float32(KS))
            gr = 1.0 - torch.minimum(dist, drm) / drm_div
            ws = gs * gr
            depth_bf = depth_bf + torch.where(accept, ws * s, 0.0)
            w_acc = w_acc + torch.where(accept, ws, 0.0)
            w_range = w_range + torch.where(accept, gr, 0.0)
    return depth_bf, w_acc, w_range


_BILATERAL = native.Kernel("bilateral_accum", [native.P] * 3 + [native.I] * 3)


def bilateral_accum(depth_m: torch.Tensor, depth_limits: torch.Tensor):
    """(depth_bf, w_acc, w_range), each f32[K, H, W], from depth f32[K, H, W]
    meters and depth_limits f32[K, 2] — ``bilateral_accum_pallas``'s output."""
    if not native.is_cuda(depth_m):
        return bilateral_accum_plain(depth_m, depth_limits)
    kk, h, w = depth_m.shape
    native.check(depth_m, "depth_m", torch.float32, device=depth_m.device)
    native.check(depth_limits, "depth_limits", torch.float32, (kk, 2), depth_m.device)
    out = torch.empty((3, kk, h, w), dtype=torch.float32, device=depth_m.device)
    _BILATERAL(depth_m.data_ptr(), depth_limits.data_ptr(), out.data_ptr(), kk, h, w)
    return out[0], out[1], out[2]


def registration_tile(h: int, w: int, hc: int, wc: int):
    """The registration tile of ``preprocess.py:179-186``: the largest tile
    whose source footprint (+ margins) fits one 128-px window and whose
    pixel count the TPU kernel's chunking accepts; None if no tile fits."""
    return next(
        ((t_h, t_w) for t_h in (48, 24, 16, 8) for t_w in (128, 64, 32)
         if h % t_h == 0 and w % t_w == 0
         and math.ceil(t_w * wc / w * 1.5) + 16 <= 128
         and (t_h * t_w) % 128 == 0
         and ((t_h * t_w) % 1024 == 0 or t_h * t_w < 1024)),
        None,
    )


def _sample_cv_per_pixel(cv: torch.Tensor, d_norm: torch.Tensor,
                         uv: torch.Tensor) -> torch.Tensor:
    """Sample stacked cv volumes [K, Dz, Dy, Dx, C] at each pixel's (u, v,
    d_norm): d_norm [K, H, W], uv the [H, W, 2] texcoord grid -> [K, H, W, C]."""
    return torch.stack([
        sample3d(cv[k], torch.cat([uv, d_norm[k][..., None]], dim=-1))
        for k in range(cv.shape[0])
    ])


def bilateral_lab(depth_m, color, rig, cfg: PreprocessConfig, warp):
    """pre_depth.fs main: (depth2 [K,H,W,2] = (depth_norm, w_range/n),
    color_lab [K,H,W,3], color_registered [K,H,W,3]). ``warp`` None: the
    gather tier (``rig`` carries the cv volumes)."""
    kk, h, w = depth_m.shape
    uv = pixel_texcoords(h, w, depth_m.device)
    cv_min = rig.depth_limits[:, 0][:, None, None]
    cv_max = rig.depth_limits[:, 1][:, None, None]
    depth_norm = (depth_m - cv_min) / (cv_max - cv_min)
    if warp is not None:
        pos_world = warp.xyz(depth_norm)
    else:
        pos_world = _sample_cv_per_pixel(rig.cv_xyz, depth_norm, uv)
    in_box = ((pos_world >= rig.bbox_min).all(dim=-1)
              & (pos_world <= rig.bbox_max).all(dim=-1))

    d_for_color = torch.where((depth_norm <= 0.0) | (depth_norm >= 1.0), 1.0,
                              depth_norm)
    hc, wc = color.shape[1], color.shape[2]
    if warp is not None:
        coords_c = warp.uv(d_for_color)
    else:
        coords_c = _sample_cv_per_pixel(rig.cv_uv, d_for_color, uv)
    tile = registration_tile(h, w, hc, wc)
    if warp is not None and tile is not None:
        fx = torch.clamp(coords_c[..., 0] * wc - 0.5, 0.0, wc - 1.0)
        fy = torch.clamp(coords_c[..., 1] * hc - 0.5, 0.0, hc - 1.0)
        color_rgb = torch.stack([
            warp_screen(color[k].contiguous(), fy[k].contiguous(),
                        fx[k].contiguous(), tile)
            for k in range(kk)
        ])
    else:
        # gather tier, or no tile fits: exact per-pixel taps
        color_rgb = torch.stack([sample2d(color[k], coords_c[k]) for k in range(kk)])
    color_lab = rgb_to_lab(color_rgb)

    if not cfg.filter_textures:
        dn = torch.where(in_box, depth_norm, 0.0)
        lat = torch.where(in_box, 1.0, 0.0)
        return torch.stack([dn, lat], dim=-1), color_lab, color_rgb

    n_samples = float((2 * KS + 1) ** 2)
    depth_bf, w_acc, w_range = bilateral_accum(depth_m.contiguous(),
                                               rig.depth_limits.contiguous())
    filtered = depth_bf / torch.where(w_acc != 0.0, w_acc, 1.0)
    filtered = torch.where(w_acc != 0.0, filtered, 0.0)
    out_x = (filtered - cv_min) / (cv_max - cv_min)
    out_y = w_range / n_samples
    dn = torch.where(in_box, out_x, 0.0)
    lat = torch.where(in_box, out_y, 0.0)
    return torch.stack([dn, lat], dim=-1), color_lab, color_rgb


def boundary(depth2: torch.Tensor, color_lab: torch.Tensor,
             cfg: PreprocessConfig = PreprocessConfig()):
    """pre_boundary.fs main: (depth_b [K,H,W,2], silhouette [K,H,W])."""
    _, h, w, _ = depth2.shape
    ks = 2
    total = float((2 * ks) * (2 * ks))  # the reference's (2k)^2 quirk
    dx_ = depth2[..., 0]
    dy_ = depth2[..., 1]
    pad_x = _pad_edge(dx_, ks)
    pad_y = _pad_edge(dy_, ks)
    pad_lab = _pad_edge(color_lab, ks)
    dist_sum = torch.zeros_like(dx_)
    cnt = torch.zeros_like(dx_)
    for oy in range(-ks, ks + 1):
        for ox in range(-ks, ks + 1):
            sx = _shifted(pad_x, oy, ox, h, w, ks)
            sy = _shifted(pad_y, oy, ox, h, w, ks)
            sl = _shifted(pad_lab, oy, ox, h, w, ks)
            valid = (sx > 0.0) & (sy > MIN_RANGE)
            d = torch.linalg.vector_norm(sl - color_lab, dim=-1)
            dist_sum = dist_sum + torch.where(valid, d, 0.0)
            cnt = cnt + valid.to(dx_.dtype)
    color_diff = torch.where(cnt < total * 0.5, 1.0,
                             dist_sum / torch.clamp(cnt, min=1.0))
    is_empty = dx_ <= 0.0
    is_boundary = (~is_empty) & ~(dy_ > MIN_RANGE)
    keep = (color_diff <= MAX_COLOR_DIST) & bool(cfg.refine_boundary)
    out_x = torch.where(is_empty, dx_,
                        torch.where(is_boundary & ~keep, -1.0, dx_))
    out_y = torch.where(
        is_empty, 0.0,
        torch.where(is_boundary, torch.where(keep, 1.0, 0.1), 0.0))
    silhouette = torch.where(is_empty | is_boundary, 0.0, 1.0)
    return torch.stack([out_x, out_y], dim=-1), silhouette


def normals(depth_b: torch.Tensor, rig, warp):
    """pre_normal.fs: (normals [K,H,W,3], world_pos [K,H,W,3], valid)."""
    dn = depth_b[..., 0]
    _, h, w = dn.shape
    outside = (dn <= 0.0) | (dn >= 1.0)
    pad = _pad_edge(dn, 1)

    def neighbor(dyy, dxx):
        s = _shifted(pad, dyy, dxx, h, w, 1)
        return torch.where((s <= 0.0) | (s >= 1.0), dn, s)

    d_t, d_b, d_l, d_r = neighbor(1, 0), neighbor(-1, 0), neighbor(0, -1), neighbor(0, 1)
    if warp is not None:
        world_c, world_t, world_b, world_l, world_r = warp.xyz_neighborhood(
            dn, d_t, d_b, d_l, d_r)
    else:
        # one-pixel texcoord shifts, sampled exactly (GL clamps the edges)
        uv = pixel_texcoords(h, w, dn.device)

        def shifted(sy, sx):
            return uv + device_const((sx / w, sy / h), dn.device)

        world_c = _sample_cv_per_pixel(rig.cv_xyz, dn, uv)
        world_t = _sample_cv_per_pixel(rig.cv_xyz, d_t, shifted(1.0, 0.0))
        world_b = _sample_cv_per_pixel(rig.cv_xyz, d_b, shifted(-1.0, 0.0))
        world_l = _sample_cv_per_pixel(rig.cv_xyz, d_l, shifted(0.0, -1.0))
        world_r = _sample_cv_per_pixel(rig.cv_xyz, d_r, shifted(0.0, 1.0))
    n = torch.linalg.cross(world_b - world_t, world_l - world_r, dim=-1)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    n = n / torch.where(norm < 1e-20, 1.0, norm)
    n = torch.where(outside[..., None], 0.0, n)
    return n, world_c, ~outside


def quality_plain(depth_b: torch.Tensor, normal_map: torch.Tensor, world_pos: torch.Tensor,
                  camera_positions: torch.Tensor) -> torch.Tensor:
    """pre_quality.fs: (1-border_frac)^6 * (w_range/n)^6 / (6.5*d) * angle^2.
    PyTorch form of kernel 10 (``quality``): 169 shifted passes of the
    13x13 stencil, then the epilogue; ``world_pos`` f32[K, H, W, 3] is the
    pixels' world position at d, ``camera_positions`` f32[K, 3]."""
    dn = depth_b[..., 0]
    _, h, w = dn.shape
    ks = 6
    n_samples = float((2 * ks + 1) ** 2)
    outside_c = (dn <= 0.0) | (dn >= 1.0)
    drm = 0.35 * dn
    drm_div = torch.where(drm > 0, drm, 1.0)
    padded = _pad_edge(dn, ks)
    border = torch.zeros_like(dn)
    w_range = torch.zeros_like(dn)
    for dy in range(-ks, ks + 1):
        for dx in range(-ks, ks + 1):
            s = _shifted(padded, dy, dx, h, w, ks)
            dist = (s - dn).abs()
            reject = (s <= 0.0) | (s >= 1.0) | (dist > drm)
            gr = 1.0 - torch.minimum(dist, drm) / drm_div
            border = border + reject.to(dn.dtype)
            w_range = w_range + torch.where(reject, 0.0, gr)
    lateral_q = 1.0 - border / n_samples
    strong = lateral_q ** 6 * (w_range / n_samples) ** 6
    strong = strong / torch.clamp(dn * 6.5, min=1e-20)
    to_cam = camera_positions[:, None, None, :] - world_pos
    to_cam = to_cam / torch.clamp(
        torch.linalg.vector_norm(to_cam, dim=-1, keepdim=True), min=1e-20)
    angle = (to_cam * normal_map).sum(dim=-1)
    strong = strong * angle ** 2
    return torch.where(outside_c, 0.0, strong)


_QUALITY = native.Kernel("quality", [native.P] * 5 + [native.I] * 3)


def quality_cuda(depth_b: torch.Tensor, normal_map: torch.Tensor, world_pos: torch.Tensor,
                 camera_positions: torch.Tensor) -> torch.Tensor:
    """Kernel 10 (``csrc/quality.cu``): ``quality_plain``'s output, bit for
    bit, in one launch over [K, H, W]."""
    kk, h, w, _ = depth_b.shape
    dev = depth_b.device
    native.check(depth_b, "depth_b", torch.float32, (kk, h, w, 2), dev)
    native.check(normal_map, "normal_map", torch.float32, (kk, h, w, 3), dev)
    native.check(world_pos, "world_pos", torch.float32, (kk, h, w, 3), dev)
    native.check(camera_positions, "camera_positions", torch.float32, (kk, 3), dev)
    out = torch.empty((kk, h, w), dtype=torch.float32, device=dev)
    _QUALITY(depth_b.data_ptr(), normal_map.data_ptr(), world_pos.data_ptr(),
             camera_positions.data_ptr(), out.data_ptr(), kk, h, w)
    return out


def quality(depth_b: torch.Tensor, normal_map: torch.Tensor, rig, warp) -> torch.Tensor:
    """pre_quality.fs, the per-pixel fusion weight f32[K, H, W]: kernel 10
    for CUDA tensors, ``quality_plain`` for CPU tensors. The world position
    at d comes from ``warp`` (None: the gather tier's exact taps)."""
    dn = depth_b[..., 0]
    if warp is not None:
        world_pos = warp.xyz(dn)
    else:
        _, h, w = dn.shape
        world_pos = _sample_cv_per_pixel(rig.cv_xyz, dn, pixel_texcoords(h, w, dn.device))
    if not native.is_cuda(depth_b):
        return quality_plain(depth_b, normal_map, world_pos, rig.camera_positions)
    return quality_cuda(depth_b, normal_map, world_pos, rig.camera_positions)


class ProcessedFrames(NamedTuple):
    """Per-sensor texture set (≙ NetKinectArray's processed textures)."""

    depth: torch.Tensor       # f32[K, H, W, 2] (depth_norm | -1/0, boundary flag)
    silhouette: torch.Tensor  # f32[K, H, W]
    normals: torch.Tensor     # f32[K, H, W, 3] world space
    quality: torch.Tensor     # f32[K, H, W]
    color: torch.Tensor       # f32[K, Hc, Wc, 3] rgb in [0, 1]
    color_registered: torch.Tensor  # f32[K, H, W, 3]
    color_lab: torch.Tensor   # f32[K, H, W, 3]
    world: torch.Tensor       # f32[K, H, W, 3]
    world_valid: torch.Tensor  # bool[K, H, W]
    depth_morphed: torch.Tensor  # f32[K, H, W] meters
    depth_raw: torch.Tensor   # f32[K, H, W] meters


def preprocess(depth_m: torch.Tensor, color: torch.Tensor, rig,
               cfg: PreprocessConfig, warp) -> ProcessedFrames:
    """Full preprocessing chain (NetKinectArray::processTextures order).
    ``rig``: a DeviceRig; ``color`` f32 in [0, 1] or u8; ``warp``: the
    baked PixelWarp or PiecewiseWarp, or None for the gather tier (then
    ``rig`` must carry the cv volumes)."""
    if warp is None and rig.cv_xyz is None:
        raise ValueError("the gather tier needs a DeviceRig with the cv volumes")
    if color.dtype == torch.uint8:
        color = color.to(torch.float32) / 255.0
    morphed = morph_dilate(depth_m)
    feed = morphed if cfg.use_processed_depth else depth_m
    depth2, color_lab, color_reg = bilateral_lab(feed, color, rig, cfg, warp)
    depth_b, sil = boundary(depth2, color_lab, cfg)
    nrm, world, world_valid = normals(depth_b, rig, warp)
    qual = quality(depth_b, nrm, rig, warp)
    return ProcessedFrames(
        depth=depth_b, silhouette=sil, normals=nrm, quality=qual, color=color,
        color_registered=color_reg, color_lab=color_lab, world=world,
        world_valid=world_valid, depth_morphed=morphed, depth_raw=depth_m,
    )

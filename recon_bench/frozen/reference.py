"""The plain reference of one frame: what the program's frame computes,
worked out again from the rig and the frame's inputs alone.

Frozen copy of the port's reference path at commit c43690d, plain PyTorch
with no kernel, bake or table of the program:

- 1preprocess: ``ops/preprocess.py`` on the exact per-pixel gather of the
  cv volumes (the gather tier: morph, the 13x13 bilateral filter as
  ``bilateral_accum_plain``, the color registration by bilinear taps,
  boundary, normals, quality), ``ops/colors.rgb_to_lab``, ``ops/sample.py``;
  brick marking as ``ops/bricks.mark_bricks_plain`` with the brick mask
  expanded to voxels and to 16^3 blocks;
- 2integrate: ``ops/tsdf.integrate`` and ``integrate_colors`` through the
  inverse cv volume, over every voxel of each 16^3 block that holds a
  voxel of an occupied brick, as the program's brick-sparse path fuses
  whole blocks (in z-slabs; a slab with no such voxel is skipped, its
  values are the clear ones);
- 3recon: ``ops/raymarch.render``, the per-ray marcher with the secant
  refinement over the whole volume (no coarse skip: every trip runs
  anyway), shade mode 0, colors sampled from the color volume;
- holefill: ``ops/inpaint.build_pyramid`` and ``colorfill``, with a plain
  float32 GL-linear upsample.

``computing(dtype, store)`` runs it in another precision: every float
tensor it makes and every input it reads in ``dtype``, the two volumes
rounded through ``store``. That is the control of the comparison.

It imports neither the program nor JAX (``guard`` checks at import).
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import guard

guard.check_source(__file__, guard.JAX_NAMES | {guard.PROGRAM})

SLAB_VOXELS = 1 << 22
MIN_DEPTH_M, MAX_DEPTH_M = 0.5, 4.5
MIN_RANGE, MAX_COLOR_DIST = 0.65, 0.5
KS = 6
BLOCK = 16

_PREC = {"dtype": torch.float32, "store": torch.float32}


@contextlib.contextmanager
def computing(dtype: torch.dtype = torch.float32, store: torch.dtype | None = None):
    """Run the reference with float tensors in ``dtype`` and the volumes
    rounded through ``store`` (default: ``dtype``)."""
    saved = dict(_PREC)
    _PREC.update(dtype=dtype, store=store or dtype)
    try:
        yield
    finally:
        _PREC.update(saved)


def _f() -> torch.dtype:
    return _PREC["dtype"]


@contextlib.contextmanager
def _full_f32():
    """TF32 off for the products (the reference is float32 throughout)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _c(values, dev) -> torch.Tensor:
    return torch.tensor(values, dtype=_f(), device=dev)


# --------------------------------------------------------------------------
# GL-exact texture sampling (ops/sample.py)


def _linear_prep(t, n: int):
    c = torch.clamp(t * n - 0.5, 0.0, float(n - 1))
    i0f = torch.floor(c)
    # the index clamped again as an integer: below float32, n - 1 itself
    # may round up to n
    i0 = torch.clamp(i0f.to(torch.int64), 0, n - 1)
    return i0, torch.clamp(i0 + 1, max=n - 1), c - i0f


def _nearest(t, n: int):
    i = torch.nan_to_num(torch.floor(t * n), nan=0.0)
    return torch.clamp(torch.clamp(i, 0.0, float(n - 1)).to(torch.int64), 0, n - 1)


def sample2d(img, uv, method: str = "linear"):
    """``img [H, W, C]`` at texcoords ``uv [..., 2]`` -> ``[..., C]``."""
    h, w = img.shape[0], img.shape[1]
    flat = img.reshape(h * w, -1)
    s, t = uv[..., 0], uv[..., 1]
    if method == "nearest":
        return flat[_nearest(t, h) * w + _nearest(s, w)]
    x0, x1, fx = _linear_prep(s, w)
    y0, y1, fy = _linear_prep(t, h)
    fx, fy = fx[..., None], fy[..., None]
    top = flat[y0 * w + x0] * (1.0 - fx) + flat[y0 * w + x1] * fx
    bot = flat[y1 * w + x0] * (1.0 - fx) + flat[y1 * w + x1] * fx
    return top * (1.0 - fy) + bot * fy


def sample3d(vol, stq, method: str = "linear"):
    """``vol [D, H, W, C]`` at texcoords ``stq [..., 3]`` (s along W, t
    along H, r along D) -> ``[..., C]``."""
    d, h, w = vol.shape[0], vol.shape[1], vol.shape[2]
    flat = vol.reshape(d * h * w, -1)
    if method == "nearest":
        return flat[(_nearest(stq[..., 2], d) * h + _nearest(stq[..., 1], h)) * w
                    + _nearest(stq[..., 0], w)]
    x0, x1, fx = _linear_prep(stq[..., 0], w)
    y0, y1, fy = _linear_prep(stq[..., 1], h)
    z0, z1, fz = _linear_prep(stq[..., 2], d)

    def tap(z, y, x):
        return flat[(z * h + y) * w + x]

    fx, fy, fz = fx[..., None], fy[..., None], fz[..., None]
    c00 = tap(z0, y0, x0) * (1.0 - fx) + tap(z0, y0, x1) * fx
    c01 = tap(z0, y1, x0) * (1.0 - fx) + tap(z0, y1, x1) * fx
    c10 = tap(z1, y0, x0) * (1.0 - fx) + tap(z1, y0, x1) * fx
    c11 = tap(z1, y1, x0) * (1.0 - fx) + tap(z1, y1, x1) * fx
    return (c00 * (1.0 - fy) + c01 * fy) * (1.0 - fz) + (c10 * (1.0 - fy) + c11 * fy) * fz


def pixel_texcoords(h: int, w: int, dev):
    s = (torch.arange(w, dtype=_f(), device=dev) + 0.5) / w
    t = (torch.arange(h, dtype=_f(), device=dev) + 0.5) / h
    tt, ss = torch.meshgrid(t, s, indexing="ij")
    return torch.stack([ss, tt], dim=-1)


# --------------------------------------------------------------------------
# the rig on the device


class Rig(NamedTuple):
    cv_xyz: torch.Tensor        # [K, Dz, Dy, Dx, 3]
    cv_uv: torch.Tensor         # [K, Dz, Dy, Dx, 2]
    cv_xyz_inv: torch.Tensor    # [K, Vz, Vy, Vx, 3]
    depth_limits: torch.Tensor  # [K, 2]
    camera_positions: torch.Tensor
    bbox_min: torch.Tensor
    bbox_max: torch.Tensor
    bbox_min_np: np.ndarray
    bbox_max_np: np.ndarray

    @property
    def num_sensors(self) -> int:
        return self.depth_limits.shape[0]


def device_rig(rig, dev) -> Rig:
    """``rig``: host arrays in ``frozen.inputs.Rig``'s fields."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev).to(_f())

    return Rig(t(rig.cv_xyz), t(rig.cv_uv), t(rig.cv_xyz_inv), t(rig.depth_limits),
               t(rig.camera_positions), t(rig.bbox_min), t(rig.bbox_max),
               np.asarray(rig.bbox_min, np.float32), np.asarray(rig.bbox_max, np.float32))


# --------------------------------------------------------------------------
# 1preprocess (ops/preprocess.py, gather tier; ops/colors.py)


def rgb_to_lab(rgb):
    p = torch.where(rgb / 255.0 > 0.04045, torch.pow((rgb / 255.0 + 0.055) / 1.055, 2.4),
                    rgb / 255.0 / 12.92) * 100.0
    r, g, b = p[..., 0], p[..., 1], p[..., 2]
    x = (r * 0.4124 + g * 0.3576 + b * 0.1805) / 95.047
    y = (r * 0.2126 + g * 0.7152 + b * 0.0722) / 100.000
    z = (r * 0.0193 + g * 0.1192 + b * 0.9505) / 108.883

    def pivot(n):
        return torch.where(n > 0.008856, torch.pow(torch.clamp(n, min=0.0), 1.0 / 3.0),
                           (903.3 * n + 16.0) / 116.0)

    px, py, pz = pivot(x), pivot(y), pivot(z)
    return torch.stack([torch.clamp(116.0 * py - 16.0, min=0.0), 500.0 * (px - py),
                        200.0 * (py - pz)], dim=-1)


def _pad_edge(x, k: int):
    h, w = x.shape[1], x.shape[2]
    iy = torch.clamp(torch.arange(-k, h + k, device=x.device), 0, h - 1)
    ix = torch.clamp(torch.arange(-k, w + k, device=x.device), 0, w - 1)
    return x[:, iy][:, :, ix]


def _shifted(padded, dy: int, dx: int, h: int, w: int, k: int):
    return padded[:, k + dy:k + dy + h, k + dx:k + dx + w]


def morph_dilate(depth_m):
    """3x3 validity-aware dilation (pre_morph.fs:73-112)."""
    _, h, w = depth_m.shape
    padded = _pad_edge(depth_m, 1)
    valid_c = (depth_m > MIN_DEPTH_M) & (depth_m < MAX_DEPTH_M)
    taps = [_shifted(padded, dy, dx, h, w, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    sum1, cnt1 = torch.zeros_like(depth_m), torch.zeros_like(depth_m)
    for s in taps:
        v = (s > MIN_DEPTH_M) & (s < MAX_DEPTH_M)
        sum1 = sum1 + torch.where(v, s, 0.0)
        cnt1 = cnt1 + v.to(depth_m.dtype)
    avg = sum1 / torch.clamp(cnt1, min=1.0)
    sum2, cnt2 = torch.zeros_like(depth_m), torch.zeros_like(depth_m)
    for s in taps:
        v = (s > MIN_DEPTH_M) & (s < MAX_DEPTH_M) & ((avg - s).abs() < 0.2)
        sum2 = sum2 + torch.where(v, s, 0.0)
        cnt2 = cnt2 + v.to(depth_m.dtype)
    filled = torch.where(cnt2 > 0, sum2 / torch.clamp(cnt2, min=1.0), 0.0)
    filled = torch.where(cnt1 > 0, filled, 0.0)
    return torch.where(valid_c, depth_m, filled)


def bilateral_accum(depth_m, depth_limits):
    """The 13x13 accumulators of pre_depth.fs:85-127 (weighted depth, total
    weight, range weight), edge-clamped, tent spatial weight."""
    _, h, w = depth_m.shape
    cv_min = depth_limits[:, 0][:, None, None]
    cv_max = depth_limits[:, 1][:, None, None]
    drm = 0.35 * (depth_m / MAX_DEPTH_M)
    drm_div = torch.clamp(drm, min=1e-20)
    padded = _pad_edge(depth_m, KS)
    depth_bf, w_acc, w_range = (torch.zeros_like(depth_m) for _ in range(3))
    for dy in range(-KS, KS + 1):
        for dx in range(-KS, KS + 1):
            s = _shifted(padded, dy, dx, h, w, KS)
            dist = (s - depth_m).abs()
            accept = (s >= cv_min) & (s <= cv_max) & (dist <= drm)
            gs = float(np.float32(1.0) - np.sqrt(np.float32(dx * dx + dy * dy)) / np.float32(KS))
            gr = 1.0 - torch.minimum(dist, drm) / drm_div
            ws = gs * gr
            depth_bf = depth_bf + torch.where(accept, ws * s, 0.0)
            w_acc = w_acc + torch.where(accept, ws, 0.0)
            w_range = w_range + torch.where(accept, gr, 0.0)
    return depth_bf, w_acc, w_range


def _sample_cv(cv, d_norm, uv):
    """Stacked cv volumes [K, Dz, Dy, Dx, C] at each pixel's (u, v, d_norm)."""
    return torch.stack([sample3d(cv[k], torch.cat([uv, d_norm[k][..., None]], dim=-1))
                        for k in range(cv.shape[0])])


def bilateral_lab(depth_m, color, rig: Rig):
    kk, h, w = depth_m.shape
    uv = pixel_texcoords(h, w, depth_m.device)
    cv_min = rig.depth_limits[:, 0][:, None, None]
    cv_max = rig.depth_limits[:, 1][:, None, None]
    depth_norm = (depth_m - cv_min) / (cv_max - cv_min)
    pos_world = _sample_cv(rig.cv_xyz, depth_norm, uv)
    in_box = (pos_world >= rig.bbox_min).all(dim=-1) & (pos_world <= rig.bbox_max).all(dim=-1)
    d_for_color = torch.where((depth_norm <= 0.0) | (depth_norm >= 1.0), 1.0, depth_norm)
    coords_c = _sample_cv(rig.cv_uv, d_for_color, uv)
    color_rgb = torch.stack([sample2d(color[k], coords_c[k]) for k in range(kk)])
    color_lab = rgb_to_lab(color_rgb)
    n_samples = float((2 * KS + 1) ** 2)
    depth_bf, w_acc, w_range = bilateral_accum(depth_m, rig.depth_limits)
    filtered = torch.where(w_acc != 0.0, depth_bf / torch.where(w_acc != 0.0, w_acc, 1.0), 0.0)
    out_x = (filtered - cv_min) / (cv_max - cv_min)
    out_y = w_range / n_samples
    return (torch.stack([torch.where(in_box, out_x, 0.0), torch.where(in_box, out_y, 0.0)], -1),
            color_lab)


def boundary(depth2, color_lab):
    """pre_boundary.fs: (depth_b [K, H, W, 2], silhouette [K, H, W])."""
    _, h, w, _ = depth2.shape
    ks = 2
    total = float((2 * ks) * (2 * ks))
    dx_, dy_ = depth2[..., 0], depth2[..., 1]
    pad_x, pad_y, pad_lab = _pad_edge(dx_, ks), _pad_edge(dy_, ks), _pad_edge(color_lab, ks)
    dist_sum, cnt = torch.zeros_like(dx_), torch.zeros_like(dx_)
    for oy in range(-ks, ks + 1):
        for ox in range(-ks, ks + 1):
            sx = _shifted(pad_x, oy, ox, h, w, ks)
            sy = _shifted(pad_y, oy, ox, h, w, ks)
            sl = _shifted(pad_lab, oy, ox, h, w, ks)
            valid = (sx > 0.0) & (sy > MIN_RANGE)
            d = torch.linalg.vector_norm(sl - color_lab, dim=-1)
            dist_sum = dist_sum + torch.where(valid, d, 0.0)
            cnt = cnt + valid.to(dx_.dtype)
    color_diff = torch.where(cnt < total * 0.5, 1.0, dist_sum / torch.clamp(cnt, min=1.0))
    is_empty = dx_ <= 0.0
    is_boundary = (~is_empty) & ~(dy_ > MIN_RANGE)
    keep = color_diff <= MAX_COLOR_DIST
    out_x = torch.where(is_empty, dx_, torch.where(is_boundary & ~keep, -1.0, dx_))
    out_y = torch.where(is_empty, 0.0, torch.where(is_boundary, torch.where(keep, 1.0, 0.1), 0.0))
    silhouette = torch.where(is_empty | is_boundary, 0.0, 1.0).to(dx_.dtype)
    return torch.stack([out_x, out_y], dim=-1), silhouette


def normals(depth_b, rig: Rig):
    """pre_normal.fs on exact taps: (normals, world, valid)."""
    dn = depth_b[..., 0]
    _, h, w = dn.shape
    outside = (dn <= 0.0) | (dn >= 1.0)
    pad = _pad_edge(dn, 1)

    def neighbor(dyy, dxx):
        s = _shifted(pad, dyy, dxx, h, w, 1)
        return torch.where((s <= 0.0) | (s >= 1.0), dn, s)

    uv = pixel_texcoords(h, w, dn.device)

    def shifted(sy, sx):
        return uv + _c((sx / w, sy / h), dn.device)

    world_c = _sample_cv(rig.cv_xyz, dn, uv)
    world_t = _sample_cv(rig.cv_xyz, neighbor(1, 0), shifted(1.0, 0.0))
    world_b = _sample_cv(rig.cv_xyz, neighbor(-1, 0), shifted(-1.0, 0.0))
    world_l = _sample_cv(rig.cv_xyz, neighbor(0, -1), shifted(0.0, -1.0))
    world_r = _sample_cv(rig.cv_xyz, neighbor(0, 1), shifted(0.0, 1.0))
    n = torch.linalg.cross(world_b - world_t, world_l - world_r, dim=-1)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    n = n / torch.where(norm < 1e-20, 1.0, norm)
    return torch.where(outside[..., None], 0.0, n), world_c, ~outside


def quality(depth_b, normal_map, rig: Rig):
    """pre_quality.fs: (1-border)^6 * (w_range/n)^6 / (6.5 d) * angle^2."""
    dn = depth_b[..., 0]
    _, h, w = dn.shape
    ks = 6
    n_samples = float((2 * ks + 1) ** 2)
    outside_c = (dn <= 0.0) | (dn >= 1.0)
    drm = 0.35 * dn
    drm_div = torch.where(drm > 0, drm, 1.0)
    padded = _pad_edge(dn, ks)
    border, w_range = torch.zeros_like(dn), torch.zeros_like(dn)
    for dy in range(-ks, ks + 1):
        for dx in range(-ks, ks + 1):
            s = _shifted(padded, dy, dx, h, w, ks)
            dist = (s - dn).abs()
            reject = (s <= 0.0) | (s >= 1.0) | (dist > drm)
            gr = 1.0 - torch.minimum(dist, drm) / drm_div
            border = border + reject.to(dn.dtype)
            w_range = w_range + torch.where(reject, 0.0, gr)
    strong = (1.0 - border / n_samples) ** 6 * (w_range / n_samples) ** 6
    strong = strong / torch.clamp(dn * 6.5, min=1e-20)
    world_pos = _sample_cv(rig.cv_xyz, dn, pixel_texcoords(h, w, dn.device))
    to_cam = rig.camera_positions[:, None, None, :] - world_pos
    to_cam = to_cam / torch.clamp(torch.linalg.vector_norm(to_cam, dim=-1, keepdim=True),
                                  min=1e-20)
    angle = (to_cam * normal_map).sum(dim=-1)
    return torch.where(outside_c, 0.0, strong * angle ** 2)


class Frames(NamedTuple):
    depth: torch.Tensor       # [K, H, W, 2]
    silhouette: torch.Tensor  # [K, H, W]
    quality: torch.Tensor     # [K, H, W]
    color: torch.Tensor       # [K, Hc, Wc, 3]
    world: torch.Tensor       # [K, H, W, 3]
    world_valid: torch.Tensor


def preprocess(depth_m, color, rig: Rig) -> Frames:
    """NetKinectArray::processTextures: morph, bilateral + registration,
    boundary, normals, quality (filter_textures, use_processed_depth and
    refine_boundary on)."""
    morphed = morph_dilate(depth_m)
    depth2, color_lab = bilateral_lab(morphed, color, rig)
    depth_b, sil = boundary(depth2, color_lab)
    nrm, world, valid = normals(depth_b, rig)
    return Frames(depth_b, sil, quality(depth_b, nrm, rig), color, world, valid)


# --------------------------------------------------------------------------
# bricks (ops/bricks.py)


class BrickGrid(NamedTuple):
    res: tuple[int, int, int]    # (bx, by, bz)
    brick_size: float
    bbox_min: np.ndarray
    bbox_max: np.ndarray


def make_brick_grid(bbox_min, bbox_max, brick_size: float, voxel_size: float) -> BrickGrid:
    """Brick size snapped to a voxel multiple, the grid covering the bbox."""
    snapped = voxel_size * max(1.0, round(brick_size / voxel_size))
    size = np.asarray(bbox_max, np.float32) - np.asarray(bbox_min, np.float32)
    return BrickGrid(tuple(int(np.ceil(float(s) / snapped)) for s in size), float(snapped),
                     np.asarray(bbox_min, np.float32), np.asarray(bbox_max, np.float32))


def mark_bricks(world, valid, grid: BrickGrid):
    """Per valid point its brick plus the closest-neighbour co-mark
    (inc_bricks.glsl:40-58): counts [bz, by, bx]."""
    bx, by, bz = grid.res
    dev = world.device
    hi = torch.tensor([bx - 1, by - 1, bz - 1], dtype=_f(), device=dev)
    bmin = torch.as_tensor(grid.bbox_min, device=dev).to(_f())
    bsize = torch.tensor(grid.brick_size, dtype=_f(), device=dev)
    pos = world.reshape(-1, 3)
    v = valid.reshape(-1)
    f = torch.nan_to_num(torch.floor((pos - bmin) / bsize), nan=0.0)
    index = torch.minimum(torch.clamp(f, min=0.0), hi).to(torch.int64)
    diff = pos - (bmin + (index.to(_f()) + 0.5) * bsize)
    d_abs = diff.abs()
    offset = torch.where(d_abs >= d_abs.amax(dim=-1, keepdim=True),
                         torch.sign(diff), 0.0).to(torch.int64)
    neighbor = torch.minimum(torch.clamp(index + offset, min=0), hi.to(torch.int64))
    neighbor_inc = (d_abs[:, 0] > bsize * 0.1) & v

    def flat_id(idx):
        return (idx[:, 2] * by + idx[:, 1]) * bx + idx[:, 0]

    counts = torch.zeros(bx * by * bz, dtype=torch.int64, device=dev)
    counts.index_add_(0, flat_id(index), v.to(torch.int64))
    counts.index_add_(0, flat_id(neighbor), neighbor_inc.to(torch.int64))
    return counts.reshape(bz, by, bx)


def _axis_index(grid: BrickGrid, axis: int, n_vox: int) -> np.ndarray:
    size = float(grid.bbox_max[axis] - grid.bbox_min[axis])
    centers = (np.arange(n_vox) + 0.5) / n_vox * size
    return np.clip((centers / grid.brick_size).astype(np.int32), 0, grid.res[axis] - 1)


def voxel_occupancy(mask, grid: BrickGrid, res):
    """Brick mask -> bool[Vz, Vy, Vx]: voxel centers in an occupied brick."""
    vx, vy, vz = res

    def idx(n, a):
        return torch.as_tensor(_axis_index(grid, a, n), dtype=torch.int64, device=mask.device)

    return mask[idx(vz, 2)][:, idx(vy, 1)][:, :, idx(vx, 0)]


def block_occupancy(vox_mask):
    """bool[Vz/16, Vy/16, Vx/16]: blocks holding a voxel of an occupied brick."""
    vz, vy, vx = vox_mask.shape
    return vox_mask.reshape(vz // BLOCK, BLOCK, vy // BLOCK, BLOCK, vx // BLOCK,
                            BLOCK).any(dim=5).any(dim=3).any(dim=1)


def _voxels(blocks):
    """A 16^3 block mask expanded to its voxels."""
    return blocks.repeat_interleave(BLOCK, 0).repeat_interleave(BLOCK, 1) \
        .repeat_interleave(BLOCK, 2)


# --------------------------------------------------------------------------
# 2integrate (ops/tsdf.py, raymarch.blend_colors_exact)


def _axis_centers(n: int, dev):
    return torch.as_tensor((np.arange(n, dtype=np.float32) + np.float32(0.5)) / np.float32(n),
                           device=dev).to(_f())


def _slabs(res, vox_mask, dev):
    """(z0, z1, voxel centers) of each z-slab holding a masked voxel."""
    vx, vy, vz = res
    nz = max(BLOCK, min(vz, SLAB_VOXELS // (vx * vy)) // BLOCK * BLOCK)
    xs, ys = _axis_centers(vx, dev), _axis_centers(vy, dev)
    zc = _axis_centers(vz, dev)
    live = vox_mask.flatten(1).any(dim=1).cpu().numpy()
    for z0 in range(0, vz, nz):
        z1 = min(vz, z0 + nz)
        if not live[z0:z1].any():
            continue
        zz, yy, xx = torch.meshgrid(zc[z0:z1], ys, xs, indexing="ij")
        yield z0, z1, torch.stack([xx, yy, zz], dim=-1)


def integrate(frames: Frames, rig: Rig, res, limit: float, vox_mask):
    """TSDF f32[Vz, Vy, Vx] of every voxel of ``vox_mask``, others at the
    clear value -limit (tsdf_integration.vs:23-59)."""
    limit = float(np.float32(limit))
    vx, vy, vz = res
    dev = frames.depth.device
    out = torch.full((vz, vy, vx), -limit, dtype=_f(), device=dev)
    for z0, z1, pos in _slabs(res, vox_mask, dev):
        wt = torch.full(pos.shape[:-1], limit, dtype=_f(), device=dev)
        tw = torch.zeros(pos.shape[:-1], dtype=_f(), device=dev)
        for i in range(rig.num_sensors):
            pc = sample3d(rig.cv_xyz_inv[i], pos)
            uv = pc[..., :2]
            sil = sample2d(frames.silhouette[i][..., None], uv)[..., 0]
            depth = sample2d(frames.depth[i][..., :1], uv, method="nearest")[..., 0]
            qual = sample2d(frames.quality[i][..., None], uv)[..., 0]
            sdist = pc[..., 2] - depth
            skip = (sil < 0.9999) & (wt >= limit)
            in_front = sdist <= -limit
            in_band = (sdist > -limit) & (sdist < limit)
            new_tw = tw + qual
            pos_tw = new_tw > 0.0
            accum = torch.where(pos_tw, (wt * tw + qual * sdist)
                                / torch.where(pos_tw, new_tw, 1.0), wt)
            wt_next = torch.where(in_front, -limit, torch.where(in_band, accum, wt))
            tw_next = torch.where(in_band & pos_tw, new_tw, tw)
            wt = torch.where(skip, -limit, wt_next)
            tw = torch.where(skip, tw, tw_next)
        out[z0:z1] = torch.where(vox_mask[z0:z1], wt, -limit)
    return out


def blend_colors(frames: Frames, rig: Rig, pos, limit: float):
    """The shader's blendColors (tsdf_raymarch.fs:295-330) at ``pos``:
    rgba, alpha 1 for a quality-weighted blend, -1 for the 1/dist one."""
    shape = pos.shape[:-1]
    tc = torch.zeros(shape + (3,), dtype=_f(), device=pos.device)
    tw = torch.zeros(shape, dtype=_f(), device=pos.device)
    tc2, tw2 = torch.zeros_like(tc), torch.zeros_like(tw)
    for i in range(rig.num_sensors):
        pc = sample3d(rig.cv_xyz_inv[i], pos)
        color = sample2d(frames.color[i], sample3d(rig.cv_uv[i], pc))
        depth = sample2d(frames.depth[i][..., :1], pc[..., :2], method="nearest")[..., 0]
        dist = (depth - pc[..., 2]).abs()
        qual = sample2d(frames.quality[i][..., None], pc[..., :2])[..., 0]
        qual = torch.where(dist < limit, qual, 0.0)
        w = qual / (dist + 0.01)
        tc, tw = tc + color * w[..., None], tw + w
        w2 = 1.0 / torch.clamp(dist, min=1e-9)
        tc2, tw2 = tc2 + color * w2[..., None], tw2 + w2
    has_q = tw > 0.0
    rgb = torch.where(has_q[..., None], tc / torch.clamp(tw, min=1e-20)[..., None],
                      tc2 / torch.clamp(tw2, min=1e-20)[..., None])
    return torch.cat([rgb, torch.where(has_q, 1.0, -1.0).to(rgb.dtype)[..., None]], dim=-1)


def integrate_colors(frames: Frames, rig: Rig, res, limit: float, vox_mask):
    """Color volume f32[Vz, Vy, Vx, 4] at voxel centers; 0 outside the mask."""
    limit = float(np.float32(limit))
    vx, vy, vz = res
    dev = frames.depth.device
    out = torch.zeros((vz, vy, vx, 4), dtype=_f(), device=dev)
    for z0, z1, pos in _slabs(res, vox_mask, dev):
        out[z0:z1] = torch.where(vox_mask[z0:z1, ..., None],
                                 blend_colors(frames, rig, pos, limit), 0.0)
    return out


# --------------------------------------------------------------------------
# 3recon: the per-ray marcher (ops/raymarch.py), shade mode 0


def vol_to_world(bbox_min, bbox_max) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = np.asarray(bbox_max, np.float32) - np.asarray(bbox_min, np.float32)
    m[:3, 3] = bbox_min
    return m


def _pmat(a, b):
    with _full_f32():
        return torch.matmul(a, b)


def _ndc(n: int, dev):
    c = (np.arange(n, dtype=np.float32) + np.float32(0.5)) / np.float32(n) \
        * np.float32(2.0) - np.float32(1.0)
    return torch.as_tensor(c, device=dev).to(_f())


def _ray_grid(mv, proj, w: int, h: int, v2w):
    """Per-pixel ray origin and unit direction in volume space; the camera
    algebra (inverse and unprojection) in float32 with TF32 off."""
    dev = mv.device
    yy, xx = torch.meshgrid(_ndc(h, dev).float(), _ndc(w, dev).float(), indexing="ij")
    one = torch.ones_like(xx)
    mv_vol = _pmat(mv, v2w)
    inv = torch.linalg.inv_ex(_pmat(proj, mv_vol)).inverse
    p_near = _pmat(torch.stack([xx, yy, -one, one], -1), inv.T)
    p_far = _pmat(torch.stack([xx, yy, one, one], -1), inv.T)
    cam_pos = torch.linalg.inv_ex(mv_vol).inverse[:3, 3]
    d = p_far[..., :3] / p_far[..., 3:4] - p_near[..., :3] / p_near[..., 3:4]
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-20)
    return cam_pos.to(_f()), d.to(_f())


def march(tsdf, mv, proj, w: int, h: int, v2w, limit: float):
    """Fixed-trip masked march (tsdf_raymarch.fs:62-114) over the whole
    volume: every ray steps from where it enters the unit cube to where it
    leaves it, half a limit a step, with the secant refinement at the first
    crossing."""
    sd = limit * 0.5
    origin, dirs = _ray_grid(mv, proj, w, h, v2w)
    step = dirs * sd
    dev = step.device
    shape = step.shape[:-1]
    inv_r = 1.0 / step
    tbot, ttop = inv_r * (0.0 - origin), inv_r * (1.0 - origin)
    tmin, tmax = torch.minimum(ttop, tbot), torch.maximum(ttop, tbot)
    t0 = torch.maximum(torch.maximum(tmin[..., 0], tmin[..., 1]), tmin[..., 2])
    t_far = torch.minimum(torch.minimum(tmax[..., 0], tmax[..., 1]), tmax[..., 2])
    t_near = torch.clamp(t0, min=0.0)
    max_steps = int(math.ceil(math.sqrt(3.0) / sd)) + 1
    start = origin + step * t_near[..., None]
    span = torch.ceil((t_far - t_near).abs())
    tsdf4 = tsdf[..., None]
    hit = torch.zeros(shape, dtype=torch.bool, device=dev)
    hit_pos = torch.zeros_like(start)
    prev_d = torch.full(shape, -limit, dtype=_f(), device=dev)
    for i in range(max_steps):
        active = ~hit & (i < span)
        pos = start + step * float(i)
        d = sample3d(tsdf4, pos)[..., 0]
        crossed = active & (d > 0.0)
        den = d - prev_d
        frac = prev_d / torch.where(den.abs() > 1e-20, den, 1e-20)
        hit_pos = torch.where(crossed[..., None], (pos - step) - step * frac[..., None], hit_pos)
        prev_d = torch.where(active, d, prev_d)
        hit = hit | crossed
    return hit, hit_pos


class Image(NamedTuple):
    color: torch.Tensor   # f32[H, W, 4]
    depth: torch.Tensor   # f32[H, W] window depth, 1 for a miss
    hit: torch.Tensor     # bool[H, W]


def render(tsdf, cvol, mv, proj, w: int, h: int, bbox_min, bbox_max, limit: float) -> Image:
    """ReconIntegration::draw in shade mode 0: march, color from the color
    volume, window-space depth."""
    dev = tsdf.device
    mv = torch.as_tensor(mv, device=dev).float()
    proj = torch.as_tensor(proj, device=dev).float()
    v2w = torch.as_tensor(vol_to_world(bbox_min, bbox_max), device=dev)
    hit, pos = march(tsdf, mv, proj, w, h, v2w, limit)
    rgba = sample3d(cvol, pos)
    mvw = _pmat(mv, v2w)
    view_pos = _pmat(pos.float(), mvw[:3, :3].T) + mvw[:3, 3]
    z = view_pos[..., 2]
    zs = torch.where(z.abs() < 1e-20, -1e-20, z)
    frag = (proj[2, 2] * z + proj[2, 3]) / -zs * 0.5 + 0.5
    rgba = torch.where(hit[..., None], rgba, 0.0)
    return Image(rgba, torch.where(hit, frag.to(rgba.dtype), 1.0), hit)


# --------------------------------------------------------------------------
# holefill (ops/inpaint.py)


def _pad_edge2(x, top: int, bottom: int, left: int, right: int):
    h, w = x.shape[0], x.shape[1]
    iy = torch.clamp(torch.arange(-top, h + bottom, device=x.device), 0, h - 1)
    ix = torch.clamp(torch.arange(-left, w + right, device=x.device), 0, w - 1)
    return x[iy][:, ix]


def inpaint_downsample(color, depth):
    """One level (tsdf_inpaint.fs:33-92): 4x4 windows, keep non-hole
    samples at or behind the window's mean depth."""
    h, w = depth.shape
    h2, w2 = h // 2, w // 2
    py, px = 3 - (h & 1), 3 - (w & 1)
    cpad, dpad = _pad_edge2(color, 1, py, 1, px), _pad_edge2(depth, 1, py, 1, px)
    cols = torch.stack([cpad[oy:oy + 2 * h2:2, ox:ox + 2 * w2:2]
                        for oy in range(4) for ox in range(4)])
    deps = torch.stack([dpad[oy:oy + 2 * h2:2, ox:ox + 2 * w2:2]
                        for oy in range(4) for ox in range(4)])
    nonhole = ~(cols[..., 3] <= 0.0)
    cnt = nonhole.sum(dim=0)
    depth_av = torch.where(nonhole, deps, 0.0).sum(dim=0) / torch.clamp(cnt, min=1)
    keep = nonhole & (deps >= depth_av)
    wsum = keep.sum(dim=0).to(depth.dtype)
    c_out = torch.where(keep[..., None], cols, 0.0).sum(dim=0) \
        / torch.clamp(wsum, min=1.0)[..., None]
    d_out = torch.where(keep, deps, 0.0).sum(dim=0) / torch.clamp(wsum, min=1.0)
    c_out = torch.cat([c_out[..., :3], torch.ones_like(c_out[..., 3:4])], dim=-1)
    d_center = dpad[1:1 + 2 * h2:2, 1:1 + 2 * w2:2]
    empty = cnt == 0
    hole = torch.where((d_center < 1.0)[..., None], _c((0.0, 0.0, 0.0, -1.0), depth.device),
                       _c((0.0, 1.0, 0.0, 0.0), depth.device))
    return torch.where(empty[..., None], hole, c_out), torch.where(empty, d_center, d_out)


def _resize_weights(n_src: int, n_dst: int, dev):
    t = (np.arange(n_dst, dtype=np.float64) + 0.5) / n_dst
    c = np.clip(t * n_src - 0.5, 0.0, n_src - 1)
    w = np.clip(1.0 - np.abs(c[:, None] - np.arange(n_src, dtype=np.float64)[None]), 0.0, 1.0)
    return torch.as_tensor((w / w.sum(axis=1, keepdims=True)).astype(np.float32),
                           device=dev).to(_f())


def resize(img, out_hw):
    """GL-linear resize of [h, w, C] to ``out_hw``."""
    wh = _resize_weights(img.shape[0], out_hw[0], img.device)
    ww = _resize_weights(img.shape[1], out_hw[1], img.device)
    with _full_f32():
        return torch.einsum("Ww,Hwc->HWc", ww, torch.einsum("Hh,hwc->Hwc", wh, img))


def holefill(color, depth, num_lods: int):
    """The LOD pyramid and the colorfill resolve (recon_integration.cpp:
    279-338, tsdf_colorfill.fs:30-55)."""
    colors, depths = [color], [depth]
    for _ in range(num_lods - 1):
        if min(colors[-1].shape[0], colors[-1].shape[1]) < 2:
            break
        c, d = inpaint_downsample(colors[-1], depths[-1])
        colors.append(c)
        depths.append(d)
    h, w = depth.shape
    n = len(colors)
    dev = depth.device
    background = (colors[0][..., 3] <= 0.0) & (depths[0] >= 1.0)
    ys, xs = torch.arange(h, device=dev), torch.arange(w, device=dev)
    per_lod = []
    for lvl in range(n):
        hl, wl = colors[lvl].shape[:2]
        per_lod.append(colors[lvl][torch.clamp((ys * hl) // h, 0, hl - 1)]
                       [:, torch.clamp((xs * wl) // w, 0, wl - 1)])
    stack = torch.stack(per_lod)
    valid = stack[..., 3] > 0.0
    first = torch.argmax(valid.to(torch.int8), dim=0)
    first = torch.where(valid.any(dim=0), first, n - 1)

    def select_by_first(arr):
        out = arr[n - 1]
        for lvl in range(n - 2, -1, -1):
            out = torch.where((first == lvl)[..., None], arr[lvl], out)
        return out

    base = select_by_first(stack)
    uv = pixel_texcoords(h, w, dev)
    w1 = torch.sqrt(uv[..., 0] ** 2 + uv[..., 1] ** 2)
    w2 = 1.0 - w1
    up = [resize(c, (h, w)) for c in colors]
    blended = select_by_first(torch.stack([
        (up[min(lvl + 1, n - 1)] * w1[..., None] + up[min(lvl + 2, n - 1)] * w2[..., None])
        / (w1 + w2)[..., None] for lvl in range(n)]))
    out = torch.where((first > 0)[..., None], blended, base)
    return torch.where(background[..., None], colors[0], out)


# --------------------------------------------------------------------------
# one frame


class Result(NamedTuple):
    color: torch.Tensor     # f32[H, W, 4] hole-filled
    depth: torch.Tensor     # f32[H, W]
    hit: torch.Tensor       # bool[H, W]
    tsdf: torch.Tensor      # f32[Vz, Vy, Vx]
    n_blocks: int           # 16^3 blocks holding a voxel of an occupied brick
    n_band: int             # 16^3 blocks holding a voxel strictly inside the band


def frame(rig_host, cfg: dict, depth_m: np.ndarray, color: np.ndarray, mv, proj,
          device) -> Result:
    """The reference of one frame from the host rig arrays (``rig_host``)
    and the frame's host inputs, on ``device``."""
    dev = torch.device(device)
    res = tuple(cfg["tsdf_res"])
    limit = float(cfg["tsdf_limit"])
    rig = device_rig(rig_host, dev)
    store = _PREC["store"]
    voxel = float(np.max(rig.bbox_max_np - rig.bbox_min_np)) / float(res[0])
    grid = make_brick_grid(rig.bbox_min_np, rig.bbox_max_np, cfg["brick_size"], voxel)
    color = torch.as_tensor(color, device=dev)
    color = color.to(_f()) / 255.0 if color.dtype == torch.uint8 else color.to(_f())
    fr = preprocess(torch.as_tensor(depth_m, device=dev).to(_f()), color, rig)
    counts = mark_bricks(fr.world, fr.world_valid, grid)
    mask = counts >= int(cfg["min_voxels_per_brick"])
    blocks = block_occupancy(voxel_occupancy(mask, grid, res))
    vox = _voxels(blocks)
    tsdf = integrate(fr, rig, res, limit, vox).to(store).to(_f())
    cvol = integrate_colors(fr, rig, res, limit, vox).to(store).to(_f())
    img = render(tsdf, cvol, mv, proj, cfg["render"]["width"], cfg["render"]["height"],
                 rig.bbox_min_np, rig.bbox_max_np, limit)
    del cvol
    color_out = holefill(img.color, img.depth, cfg["num_lods"])
    band = tsdf.abs() < limit * (1.0 - 1e-3)
    return Result(color_out.float(), img.depth.float(), img.hit, tsdf.float(),
                  int(blocks.sum()), int(block_occupancy(band).sum()))

"""Hole-filling pyramid: inpaint + colorfill (mirrors
``rgbd_recon_tpu/ops/inpaint.py``; reference ReconIntegration::fillColors,
recon_integration.cpp:279-338).

  inpaint   tsdf_inpaint.fs:33-92   downsample with hole rejection: 4x4
            window, keep non-hole samples with depth >= the window average
  colorfill tsdf_colorfill.fs:30-55 per pixel: first non-hole LOD; if
            coarser than 0, blend the two next-coarser LODs

The 16-tap downsample and the per-pixel colorfill are the forms the JAX
package runs off the TPU; its banded-matmul forms (``*_mm``) are TPU
layouts of the same math and are not ported. Alpha <= 0 marks a hole.
"""
from __future__ import annotations

import torch

from ..utils.math import device_const
from .warp import resize2d_gl


def _pad_edge2(x: torch.Tensor, top: int, bottom: int, left: int, right: int):
    h, w = x.shape[0], x.shape[1]
    iy = torch.clamp(torch.arange(-top, h + bottom, device=x.device), 0, h - 1)
    ix = torch.clamp(torch.arange(-left, w + right, device=x.device), 0, w - 1)
    return x[iy][:, ix]


def inpaint_downsample(color: torch.Tensor, depth: torch.Tensor):
    """One pyramid level: [H, W, 4] + [H, W] -> [H/2, W/2, 4] + [H/2, W/2]."""
    h, w = depth.shape
    h2, w2 = h // 2, w // 2
    py = 3 - (h & 1)
    px = 3 - (w & 1)
    cpad = _pad_edge2(color, 1, py, 1, px)
    dpad = _pad_edge2(depth, 1, py, 1, px)
    cols, deps = [], []
    for oy in range(4):
        for ox in range(4):
            cols.append(cpad[oy:oy + 2 * h2:2, ox:ox + 2 * w2:2])
            deps.append(dpad[oy:oy + 2 * h2:2, ox:ox + 2 * w2:2])
    cols = torch.stack(cols)          # [16, h2, w2, 4]
    deps = torch.stack(deps)          # [16, h2, w2]
    nonhole = ~(cols[..., 3] <= 0.0)
    cnt = nonhole.sum(dim=0)
    depth_av = torch.where(nonhole, deps, 0.0).sum(dim=0) / torch.clamp(cnt, min=1)
    keep = nonhole & (deps >= depth_av)
    wsum = keep.sum(dim=0).to(depth.dtype)
    c_out = torch.where(keep[..., None], cols, 0.0).sum(dim=0) / torch.clamp(
        wsum, min=1.0)[..., None]
    d_out = torch.where(keep, deps, 0.0).sum(dim=0) / torch.clamp(wsum, min=1.0)
    c_out = torch.cat([c_out[..., :3], torch.ones_like(c_out[..., 3:4])], dim=-1)
    # all-hole windows (tsdf_inpaint.fs:59-68): keep the center depth; r=-1
    # holes in front of geometry, background otherwise
    d_center = dpad[1:1 + 2 * h2:2, 1:1 + 2 * w2:2]
    empty = cnt == 0
    front = device_const((0.0, 0.0, 0.0, -1.0), depth.device)
    back = device_const((0.0, 1.0, 0.0, 0.0), depth.device)
    hole_color = torch.where((d_center < 1.0)[..., None], front, back)
    c_out = torch.where(empty[..., None], hole_color, c_out)
    d_out = torch.where(empty, d_center, d_out)
    return c_out, d_out


def build_pyramid(color: torch.Tensor, depth: torch.Tensor, num_lods: int):
    """LOD chain starting at the rendered image (fillColors loop,
    recon_integration.cpp:299-321). Returns lists of per-LOD color/depth."""
    colors, depths = [color], [depth]
    for _ in range(num_lods - 1):
        if min(colors[-1].shape[0], colors[-1].shape[1]) < 2:
            break
        c, d = inpaint_downsample(colors[-1], depths[-1])
        colors.append(c)
        depths.append(d)
    return colors, depths


def colorfill(colors: list[torch.Tensor], depths: list[torch.Tensor]) -> torch.Tensor:
    """Resolve pass (tsdf_colorfill.fs:30-55): per pixel the finest non-hole
    LOD; where that is coarser than LOD 0, the blend of the two next-coarser
    LODs with the reference's weights. Background (LOD-0 hole at far depth)
    stays transparent. Returns [H, W, 4]."""
    h, w = depths[0].shape
    n = len(colors)
    dev = depths[0].device
    lod0_hole = colors[0][..., 3] <= 0.0
    background = lod0_hole & (depths[0] >= 1.0)
    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    per_lod = []
    for lvl in range(n):
        hl, wl = colors[lvl].shape[:2]
        yl = torch.clamp((ys * hl) // h, 0, hl - 1)
        xl = torch.clamp((xs * wl) // w, 0, wl - 1)
        per_lod.append(colors[lvl][yl][:, xl])
    stack = torch.stack(per_lod)                  # [n, H, W, 4]
    valid = stack[..., 3] > 0.0
    first = torch.argmax(valid.to(torch.int8), dim=0)
    first = torch.where(valid.any(dim=0), first, n - 1)

    def select_by_first(arr):
        out = arr[n - 1]
        for lvl in range(n - 2, -1, -1):
            out = torch.where((first == lvl)[..., None], arr[lvl], out)
        return out

    base = select_by_first(stack)
    s = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    t = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    tt, ss = torch.meshgrid(t, s, indexing="ij")
    w1 = torch.sqrt(ss * ss + tt * tt)
    w2 = 1.0 - w1
    upsampled = [resize2d_gl(c, (h, w)) for c in colors]
    blends = []
    for lvl in range(n):
        c1 = upsampled[min(lvl + 1, n - 1)]
        c2 = upsampled[min(lvl + 2, n - 1)]
        blends.append((c1 * w1[..., None] + c2 * w2[..., None]) / (w1 + w2)[..., None])
    blended = select_by_first(torch.stack(blends))
    out = torch.where((first > 0)[..., None], blended, base)
    return torch.where(background[..., None], colors[0], out)

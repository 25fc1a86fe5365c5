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

On the card both are kernel 11 (``csrc/holefill.cu``): one launch a
pyramid level and one resolve a frame, bit for bit ``inpaint_downsample_plain``
and ``colorfill_plain``, which CPU tensors take.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import native
from ..utils.math import device_const
from .warp import _resize_weights_bf16, resize2d_gl

MAX_LODS = 16   # the LODs one resolve takes (csrc/holefill.cu)


def _pad_edge2(x: torch.Tensor, top: int, bottom: int, left: int, right: int):
    h, w = x.shape[0], x.shape[1]
    iy = torch.clamp(torch.arange(-top, h + bottom, device=x.device), 0, h - 1)
    ix = torch.clamp(torch.arange(-left, w + right, device=x.device), 0, w - 1)
    return x[iy][:, ix]


def inpaint_downsample_plain(color: torch.Tensor, depth: torch.Tensor):
    """One pyramid level: [H, W, 4] + [H, W] -> [H/2, W/2, 4] + [H/2, W/2].
    PyTorch form of kernel 11's level (``holefill_level``)."""
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


_LEVEL = native.Kernel("holefill_level", [native.P] * 4 + [native.I] * 2)
_RESOLVE = native.Kernel("holefill_resolve", [native.P] * 3 + [native.I] + [native.P] * 4
                         + [native.I] * 2)


def _check_image(t: torch.Tensor, name: str, shape, dev) -> None:
    native.check(t, name, torch.float32, shape, dev)
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: not 16-byte aligned (kernel 11 reads float4)")


def inpaint_downsample_cuda(color: torch.Tensor, depth: torch.Tensor):
    """Kernel 11's level (``csrc/holefill.cu``): ``inpaint_downsample_plain``'s
    outputs, bit for bit, in one launch."""
    h, w = depth.shape
    dev = depth.device
    _check_image(color, "color", (h, w, 4), dev)
    native.check(depth, "depth", torch.float32, (h, w), dev)
    if min(h, w) < 2:
        raise ValueError(f"holefill level: a {h}x{w} image has no coarser level")
    c_out = torch.empty((h // 2, w // 2, 4), dtype=torch.float32, device=dev)
    d_out = torch.empty((h // 2, w // 2), dtype=torch.float32, device=dev)
    _LEVEL(color.data_ptr(), depth.data_ptr(), c_out.data_ptr(), d_out.data_ptr(), h, w)
    return c_out, d_out


def inpaint_downsample(color: torch.Tensor, depth: torch.Tensor):
    """One pyramid level: [H, W, 4] + [H, W] -> [H/2, W/2, 4] + [H/2, W/2];
    kernel 11's level for CUDA tensors, ``inpaint_downsample_plain`` for CPU
    tensors."""
    if native.is_cuda(depth):
        return inpaint_downsample_cuda(color, depth)
    return inpaint_downsample_plain(color, depth)


def _pyramid(color, depth, num_lods: int, downsample):
    colors, depths = [color], [depth]
    for _ in range(num_lods - 1):
        if min(colors[-1].shape[0], colors[-1].shape[1]) < 2:
            break
        c, d = downsample(colors[-1], depths[-1])
        colors.append(c)
        depths.append(d)
    return colors, depths


def build_pyramid(color: torch.Tensor, depth: torch.Tensor, num_lods: int):
    """LOD chain starting at the rendered image (fillColors loop,
    recon_integration.cpp:299-321). Returns lists of per-LOD color/depth."""
    return _pyramid(color, depth, num_lods, inpaint_downsample)


def build_pyramid_plain(color: torch.Tensor, depth: torch.Tensor, num_lods: int):
    """``build_pyramid`` with ``inpaint_downsample_plain`` on any device:
    the oracle of kernel 11's levels on the card."""
    return _pyramid(color, depth, num_lods, inpaint_downsample_plain)


@functools.lru_cache(maxsize=None)
def _resolve_taps(shapes: tuple, h: int, w: int, device: torch.device):
    """Kernel 11's resize taps: for each LOD of ``shapes`` ((h_l, w_l) each),
    the two source rows of each of the h output rows and the two source
    columns of each of the w output columns, with their weights: the
    non-zeros of the bf16 matrices ``resize2d_gl`` multiplies by (a single
    non-zero gets a second tap of weight 0). Returns (i32[n, h + w, 2],
    f32[n, h + w, 2]) on ``device``, made once per (shapes, size, device)."""
    idx = torch.zeros((len(shapes), h + w, 2), dtype=torch.int32)
    wt = torch.zeros((len(shapes), h + w, 2), dtype=torch.float32)
    for lvl, (hl, wl) in enumerate(shapes):
        for off, n_src, n_dst in ((0, hl, h), (h, wl, w)):
            m = _resize_weights_bf16(n_src, n_dst, torch.device("cpu"))
            nz = m != 0
            per_row = nz.sum(dim=1)
            if int(per_row.max()) > 2 or int(per_row.min()) < 1:
                raise AssertionError(f"resize {n_src} -> {n_dst}: {int(per_row.min())}-"
                                     f"{int(per_row.max())} non-zero weights a row, not 1-2")
            cols = torch.arange(n_src)
            i0 = torch.where(nz, cols, n_src).amin(dim=1)
            i1 = torch.where(nz, cols, -1).amax(dim=1)
            rows = torch.arange(n_dst)
            idx[lvl, off:off + n_dst, 0] = i0.to(torch.int32)
            idx[lvl, off:off + n_dst, 1] = i1.to(torch.int32)
            wt[lvl, off:off + n_dst, 0] = m[rows, i0]
            wt[lvl, off:off + n_dst, 1] = torch.where(i1 != i0, m[rows, i1], 0.0)
    return idx.to(device), wt.to(device)


def colorfill_cuda(colors: list[torch.Tensor], depths: list[torch.Tensor]) -> torch.Tensor:
    """Kernel 11's resolve (``csrc/holefill.cu``): ``colorfill_plain``'s
    output, bit for bit, in one launch."""
    n = len(colors)
    h, w = depths[0].shape
    dev = depths[0].device
    if not 1 <= n <= MAX_LODS:
        raise ValueError(f"holefill resolve: {n} LODs (1 to {MAX_LODS})")
    native.check(depths[0], "depths[0]", torch.float32, (h, w), dev)
    for lvl, c in enumerate(colors):
        shape = (h, w, 4) if lvl == 0 else (c.shape[0], c.shape[1], 4)
        _check_image(c, f"colors[{lvl}]", shape, dev)
    shapes = tuple((int(c.shape[0]), int(c.shape[1])) for c in colors)
    idx, wt = _resolve_taps(shapes, h, w, dev)
    out = torch.empty((h, w, 4), dtype=torch.float32, device=dev)
    ptrs = (ctypes.c_longlong * n)(*(c.data_ptr() for c in colors))
    hs = (ctypes.c_int * n)(*(s[0] for s in shapes))
    ws = (ctypes.c_int * n)(*(s[1] for s in shapes))
    _RESOLVE(ptrs, hs, ws, n, depths[0].data_ptr(), idx.data_ptr(), wt.data_ptr(),
             out.data_ptr(), h, w)
    return out


def colorfill(colors: list[torch.Tensor], depths: list[torch.Tensor]) -> torch.Tensor:
    """Resolve pass (tsdf_colorfill.fs:30-55): per pixel the finest non-hole
    LOD; where that is coarser than LOD 0, the blend of the two next-coarser
    LODs with the reference's weights. Background (LOD-0 hole at far depth)
    stays transparent. Returns [H, W, 4]: kernel 11's resolve for CUDA
    tensors, ``colorfill_plain`` for CPU tensors."""
    if native.is_cuda(depths[0]):
        return colorfill_cuda(colors, depths)
    return colorfill_plain(colors, depths)


def colorfill_plain(colors: list[torch.Tensor], depths: list[torch.Tensor]) -> torch.Tensor:
    """PyTorch form of kernel 11's resolve (``holefill_resolve``): every
    LOD gathered to full size, upsampled and blended, one kept a pixel."""
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

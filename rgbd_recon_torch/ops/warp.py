"""Pixel-warp tables and the windowed screen warp (mirrors
``rgbd_recon_tpu/ops/warp.py`` and ``ops/warp_pallas.py``).

The sampled calibration coordinate is always (u_pixel, v_pixel, d): the
spatial part is the fixed pixel-center grid, so per sensor the cv volumes
reduce to two images A, B with ``value = A + clamp(d) * B`` — exact for
pinhole rigs, measured at bake time (``max_err_*``). ``bake_pixel_warp``
runs once per session in torch on the pipeline's device.

``warp_screen`` is the port of the TPU kernel ``warp_screen_pallas``: a
bilinear resample whose taps are confined to a per-tile window. The CUDA
kernel is ``csrc/warp_screen.cu``; ``warp_screen_plain`` is the same
function in PyTorch.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import native
from ..utils.math import full_f32


def _gl_resize_weights_np(n_src: int, n_dst: int) -> np.ndarray:
    """[n_dst, n_src] hat weights with GL half-texel semantics."""
    t = (np.arange(n_dst, dtype=np.float64) + 0.5) / n_dst
    c = np.clip(t * n_src - 0.5, 0.0, n_src - 1)
    i = np.arange(n_src, dtype=np.float64)
    w = np.clip(1.0 - np.abs(c[:, None] - i[None, :]), 0.0, 1.0)
    w = w / w.sum(axis=1, keepdims=True)
    return w.astype(np.float32)


def _shift2d(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Edge-clamped shift of [K, H, W, C]: out[y, x] = x[clamp(y+dy), clamp(x+dx)]."""
    h, w = x.shape[1], x.shape[2]
    iy = torch.clamp(torch.arange(h, device=x.device) + dy, 0, h - 1)
    ix = torch.clamp(torch.arange(w, device=x.device) + dx, 0, w - 1)
    return x[:, iy][:, :, ix]


class PixelWarp(NamedTuple):
    """Per-pixel affine-in-depth calibration warp for one rig at one (H, W)
    pixel grid. Tensors f32 on the pipeline's device."""

    xyz_a: torch.Tensor   # [K, H, W, 3]
    xyz_b: torch.Tensor   # [K, H, W, 3]
    uv_a: torch.Tensor    # [K, H, W, 2]
    uv_b: torch.Tensor    # [K, H, W, 2]
    d_min: float          # clamp range along d (GL half-texel centers)
    d_max: float
    max_err_xyz: float    # bake-time affinity residual bounds (raw cv grid)
    max_err_uv: float

    def xyz(self, d: torch.Tensor) -> torch.Tensor:
        dc = torch.clamp(d, self.d_min, self.d_max)[..., None]
        return self.xyz_a + dc * self.xyz_b

    def uv(self, d: torch.Tensor) -> torch.Tensor:
        dc = torch.clamp(d, self.d_min, self.d_max)[..., None]
        return self.uv_a + dc * self.uv_b

    def xyz_shifted(self, dy: int, dx: int, d: torch.Tensor) -> torch.Tensor:
        """cv_xyz at the pixel grid shifted by (dy, dx) pixels (edge-clamped)."""
        dc = torch.clamp(d, self.d_min, self.d_max)[..., None]
        return _shift2d(self.xyz_a, dy, dx) + dc * _shift2d(self.xyz_b, dy, dx)

    def xyz_neighborhood(self, dn, d_t, d_b, d_l, d_r):
        """The pre_normal.fs 5-tap stencil (center, +y, -y, -x, +x)."""
        return (
            self.xyz(dn),
            self.xyz_shifted(1, 0, d_t),
            self.xyz_shifted(-1, 0, d_b),
            self.xyz_shifted(0, -1, d_l),
            self.xyz_shifted(0, 1, d_r),
        )


def bake_pixel_warp(rig, height: int, width: int,
                    device: torch.device | str = "cpu") -> PixelWarp:
    """Least-squares affine fit along the d axis of the raw cv grids
    (closed form), then the GL-exact separable resize of the A/B planes to
    pixel centers. Residuals are max |cv - (A + d B)| over the raw grid — an
    upper bound for the resized warp (the resize is a convex combination)."""
    dz = rig.cv_xyz.shape[1]
    t_np = ((np.arange(dz, dtype=np.float64) + 0.5) / dz).astype(np.float32)
    tm = t_np.mean()
    tv = float(((t_np - tm) ** 2).sum())
    t = torch.as_tensor(t_np, device=device)
    wy = torch.as_tensor(_gl_resize_weights_np(rig.cv_xyz.shape[2], height), device=device)
    wx = torch.as_tensor(_gl_resize_weights_np(rig.cv_xyz.shape[3], width), device=device)

    def fit(vol_np):
        vol = torch.tensor(np.asarray(vol_np, np.float32), device=device)
        m = vol.mean(dim=1)                                   # [K, Dy, Dx, C]
        b = torch.einsum("d,kdyxc->kyxc", t - float(tm), vol) / tv
        a = m - b * float(tm)
        resid = 0.0
        for d in range(dz):
            resid = max(resid, float((vol[:, d] - (a + t[d] * b)).abs().max()))
        return a, b, resid

    def resize(p):
        p = torch.einsum("Yy,kyxc->kYxc", wy, p)
        return torch.einsum("Xx,kYxc->kYXc", wx, p).contiguous()

    with full_f32():
        xyz_a, xyz_b, err_xyz = fit(rig.cv_xyz)
        uv_a, uv_b, err_uv = fit(rig.cv_uv)
        return PixelWarp(
            xyz_a=resize(xyz_a), xyz_b=resize(xyz_b),
            uv_a=resize(uv_a), uv_b=resize(uv_b),
            d_min=0.5 / dz, d_max=1.0 - 0.5 / dz,
            max_err_xyz=err_xyz, max_err_uv=err_uv,
        )


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def resize2d_gl(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """GL-LINEAR resize of [h, w, C] to out_hw: two hat-weight products with
    the JAX version's bf16 rounding of weights, input and intermediate
    (float32 accumulation), so both sides resize the same numbers."""
    h2, w2 = out_hw
    wh = _bf16_round(torch.as_tensor(
        _gl_resize_weights_np(img.shape[0], h2), device=img.device))
    ww = _bf16_round(torch.as_tensor(
        _gl_resize_weights_np(img.shape[1], w2), device=img.device))
    with full_f32():
        t = torch.einsum("Hh,hwc->Hwc", wh, _bf16_round(img))
        return torch.einsum("Ww,Hwc->HWc", ww, _bf16_round(t))


# ---------------------------------------------------------------------------
# windowed screen warp (kernel 2)

XSTRIDE = 64    # x-window stride (px)
WXW = 128       # x-window width (px)


def _ru8(n: int) -> int:
    return -(-n // 8) * 8


def warp_windows(ti: int, si: int, fy: torch.Tensor, fx: torch.Tensor,
                 tile: tuple[int, int]):
    """Per-tile window placement of ``warp_screen_pallas`` (its :137-188):
    window height ``wh`` (1.5x the tile's source footprint + 16, 8-aligned),
    y origins 8-aligned around the footprint midpoint, x origins on the
    64-px block grid of 128-px windows. Returns (wh, y0 i32[T], x0 i32[T])
    with tiles in row-major order."""
    h, w = fy.shape
    th, tw = tile
    if h % th or w % tw:
        raise ValueError(f"tile {tile} does not divide {(h, w)}")
    nty, ntx = h // th, w // tw
    wh = min(_ru8(math.ceil(th * ti / h * 1.5) + 16), _ru8(ti))
    ti_p = _ru8(ti) + wh
    si_p = -(-si // XSTRIDE) * XSTRIDE + XSTRIDE
    nxb = si_p // XSTRIDE - 1

    def mid(a):
        t = a.reshape(nty, th, ntx, tw)
        return (t.amin(dim=(1, 3)) + t.amax(dim=(1, 3))) * 0.5

    yf = torch.floor(mid(fy)).to(torch.int32)
    xf = torch.floor(mid(fx)).to(torch.int32)
    y0 = torch.clamp(torch.bitwise_and(yf - wh // 2, -8), 0, ti_p - wh)
    xb = torch.clamp(
        torch.div(xf - WXW // 2 + XSTRIDE // 2, XSTRIDE, rounding_mode="floor"),
        0, nxb - 1)
    return wh, y0.reshape(-1).contiguous(), (xb * XSTRIDE).reshape(-1).contiguous()


def warp_screen_plain(img: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor,
                      tile: tuple[int, int], wh: int, y0: torch.Tensor,
                      x0: torch.Tensor) -> torch.Tensor:
    """PyTorch form of kernel 2 on given window origins (see warp_screen)."""
    ti, si, c = img.shape
    h, w = fy.shape
    th, tw = tile
    nty, ntx = h // th, w // tw
    oy = y0.reshape(nty, ntx).repeat_interleave(th, 0).repeat_interleave(tw, 1)
    ox = x0.reshape(nty, ntx).repeat_interleave(th, 0).repeat_interleave(tw, 1)
    ry = torch.clamp(fy - oy.to(fy.dtype), 0.0, wh - 1.0)
    rx = torch.clamp(fx - ox.to(fx.dtype), 0.0, WXW - 1.0)
    iy = torch.floor(ry)
    ix = torch.floor(rx)
    gy = (ry - iy)[..., None]
    gx = (rx - ix)[..., None]
    iy = iy.to(torch.int64)
    ix = ix.to(torch.int64)
    oy = oy.to(torch.int64)
    ox = ox.to(torch.int64)
    r0 = torch.clamp(oy + iy, max=ti - 1)
    r1 = torch.clamp(oy + torch.clamp(iy + 1, max=wh - 1), max=ti - 1)
    c0 = torch.clamp(ox + ix, max=si - 1)
    c1 = torch.clamp(ox + torch.clamp(ix + 1, max=WXW - 1), max=si - 1)
    flat = img.reshape(ti * si, c)
    a, b = flat[r0 * si + c0], flat[r0 * si + c1]
    cc, d = flat[r1 * si + c0], flat[r1 * si + c1]
    left = (1.0 - gy) * a + gy * cc
    right = (1.0 - gy) * b + gy * d
    return (1.0 - gx) * left + gx * right


_WARP_SCREEN = native.Kernel(
    "warp_screen",
    [native.P] * 6 + [native.I] * 9,
)


def warp_screen_cuda(img: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor,
                     tile: tuple[int, int], wh: int, y0: torch.Tensor,
                     x0: torch.Tensor) -> torch.Tensor:
    """Kernel 2 on the card (``csrc/warp_screen.cu``); the arguments of
    ``warp_screen_plain``."""
    ti, si, c = img.shape
    h, w = fy.shape
    dev = img.device
    native.check(img, "img", torch.float32, device=dev)
    native.check(fy, "fy", torch.float32, (h, w), dev)
    native.check(fx, "fx", torch.float32, (h, w), dev)
    nt = (h // tile[0]) * (w // tile[1])
    native.check(y0, "y0", torch.int32, (nt,), dev)
    native.check(x0, "x0", torch.int32, (nt,), dev)
    out = torch.empty((h, w, c), dtype=torch.float32, device=dev)
    _WARP_SCREEN(img.data_ptr(), fy.data_ptr(), fx.data_ptr(), y0.data_ptr(),
                 x0.data_ptr(), out.data_ptr(), ti, si, c, h, w, tile[0],
                 tile[1], wh, WXW)
    return out


def warp_screen(img: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor,
                tile: tuple[int, int]) -> torch.Tensor:
    """Bilinear resample of ``img`` f32[Ti, Si, C] at per-pixel fractional
    (fy, fx) f32[H, W] (already clamped into the image) onto f32[H, W, C],
    with each pixel's taps confined to its tile's window: the output of
    ``warp_screen_pallas`` in float32 (no bf16 matmul, no hi/lo split)."""
    wh, y0, x0 = warp_windows(img.shape[0], img.shape[1], fy, fx, tile)
    run = warp_screen_cuda if native.is_cuda(img) else warp_screen_plain
    return run(img, fy, fx, tile, wh, y0, x0)

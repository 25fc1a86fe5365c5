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
function in PyTorch. The kernel reads a 9-channel source padded to 12
channels (aligned 16-byte taps): the renderer packs its sweep image so and
passes ``channels=9``.

``piecewise_eval`` is the port of the TPU kernel ``piecewise_eval_pallas``
(``csrc/piecewise_eval.cu``, twin ``piecewise_eval_plain``). The TPU
package evaluates the shifted taps of the normal stencil by shifting each
depth map against the table and the result back, then fixing the border
line; here each map carries its pixel offset and the kernel reads the
table at the edge-clamped shifted pixel, the same float operations on the
same table entries.
"""
from __future__ import annotations

import ctypes
import functools
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
                    device: torch.device | str = "cuda") -> PixelWarp:
    """Least-squares affine fit along the d axis of the raw cv grids
    (closed form), then the GL-exact separable resize of the A/B planes to
    pixel centers. Residuals are max |cv - (A + d B)| over the raw grid — an
    upper bound for the resized warp (the resize is a convex combination)."""
    dz = rig.cv_xyz.shape[1]
    t_np = ((np.arange(dz, dtype=np.float64) + 0.5) / dz).astype(np.float32)
    tm = t_np.mean()
    tv = float(((t_np - tm) ** 2).sum())
    wy = torch.as_tensor(_gl_resize_weights_np(rig.cv_xyz.shape[2], height), device=device)
    wx = torch.as_tensor(_gl_resize_weights_np(rig.cv_xyz.shape[3], width), device=device)

    def fit(vol_np):
        vol = torch.tensor(np.asarray(vol_np, np.float32), device=device)
        a, b = _affine_fit(vol, t_np - tm, float(tm), tv)      # [K, Dy, Dx, C]
        resid = 0.0
        for d in range(dz):
            resid = max(resid, float((vol[:, d] - (a + float(t_np[d]) * b)).abs().max()))
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


# ---------------------------------------------------------------------------
# piecewise-linear-in-depth warp (kernel 5)


NEIGHBORHOOD = ((0, 0), (1, 0), (-1, 0), (0, -1), (0, 1))   # pre_normal.fs: c, +y, -y, -x, +x
MAX_OFFSET_MAPS = 8     # maps one kernel 5 call takes with offsets (csrc/piecewise_eval.cu)


def _tap_pixels(offsets, m: int, h: int, w: int, device) -> torch.Tensor:
    """The flat table pixel each of the ``m`` maps reads at each output
    pixel, (clamp(y + dy), clamp(x + dx)) edge-clamped: i64[M, H, W]."""
    offs = offsets if offsets is not None else ((0, 0),) * m
    ys = torch.stack([torch.clamp(torch.arange(h, device=device) + dy, 0, h - 1)
                      for dy, _ in offs])
    xs = torch.stack([torch.clamp(torch.arange(w, device=device) + dx, 0, w - 1)
                      for _, dx in offs])
    return ys[:, :, None] * w + xs[:, None, :]


def piecewise_eval_plain(D: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                         r: torch.Tensor, d_min: float, d_max: float,
                         offsets=None) -> torch.Tensor:
    """PyTorch form of kernel 5 (see piecewise_eval): per map the clamped
    depth ``dc`` and knot coordinate ``cc``, then ``a + dc b`` plus the two
    knots that bracket ``cc`` with hat weights, in knot order — the other
    knots' weights are exactly 0, so the sum over all knots is the same —
    with a, b and r read at each map's offset pixel by index gathers."""
    m, k, h, w = D.shape
    c, s = r.shape[1], r.shape[2]
    dev = D.device
    dc = torch.clamp(D, d_min, d_max)
    # the divisor is a 0-d tensor on D's device: a CUDA tensor divided by a
    # host scalar is multiplied by its reciprocal instead, the kernel divides
    span = torch.full((), d_max - d_min, dtype=torch.float32, device=dev)
    cc = (dc - d_min) / span * (s - 1)
    i0 = torch.floor(cc)
    w0 = torch.clamp(1.0 - (cc - i0).abs(), min=0.0)
    w1 = torch.clamp(1.0 - (cc - (i0 + 1.0)).abs(), min=0.0)
    s0 = i0.to(torch.int64)
    s1 = torch.clamp(s0 + 1, max=s - 1)
    pix = _tap_pixels(offsets, m, h, w, dev)[:, None]                 # [M, 1, H, W]
    kk = torch.arange(k, device=dev)[:, None, None]
    at = a.reshape(k, h * w, c)[kk, pix]                               # [M, K, H, W, C]
    bt = b.reshape(k, h * w, c)[kk, pix]
    rf = r.reshape(k, c, s * h * w)
    k5, c5 = kk[..., None], torch.arange(c, device=dev)

    def knot(si):   # r[k, c, si, tap pixel] -> [M, K, H, W, C]
        return rf[k5, c5, (si * (h * w) + pix)[..., None]].to(torch.float32)

    acc = at + dc[..., None] * bt
    acc = acc + w0[..., None] * knot(s0)
    return acc + w1[..., None] * knot(s1)


_PIECEWISE = native.Kernel("piecewise_eval", [native.P] * 6 + [native.I] * 6
                           + [native.F] * 3)


def piecewise_eval_cuda(D, a, b, r, d_min: float, d_max: float, offsets=None) -> torch.Tensor:
    """Kernel 5 on the card (``csrc/piecewise_eval.cu``); the arguments of
    ``piecewise_eval_plain``. Offsets: at most MAX_OFFSET_MAPS maps."""
    m, k, h, w = D.shape
    c, s = r.shape[1], r.shape[2]
    dev = D.device
    native.check(D, "D", torch.float32, (m, k, h, w), dev)
    native.check(a, "a", torch.float32, (k, h, w, c), dev)
    native.check(b, "b", torch.float32, (k, h, w, c), dev)
    native.check(r, "r", torch.bfloat16, (k, c, s, h, w), dev)
    if c not in (2, 3):
        raise ValueError(f"piecewise_eval kernel: {c} channels; takes 3 (xyz) or 2 (uv)")
    if max(m * k * h * w * c, r.numel()) >= 2 ** 31:
        raise ValueError("piecewise_eval kernel: 32-bit indices; a tensor reaches 2^31 elements")
    offs = None
    if offsets is not None:
        if len(offsets) != m or m > MAX_OFFSET_MAPS:
            raise ValueError(f"piecewise_eval kernel: {len(offsets)} offsets for {m} maps "
                             f"(one per map, at most {MAX_OFFSET_MAPS})")
        offs = (ctypes.c_int * (2 * MAX_OFFSET_MAPS))(*(int(v) for o in offsets for v in o))
    out = torch.empty((m, k, h, w, c), dtype=torch.float32, device=dev)
    _PIECEWISE(D.data_ptr(), a.data_ptr(), b.data_ptr(), r.data_ptr(), offs, out.data_ptr(),
               m, k, c, s, h, w, d_min, d_max, d_max - d_min)
    return out


def piecewise_eval(D: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   r: torch.Tensor, d_min: float, d_max: float, *,
                   offsets=None) -> torch.Tensor:
    """``A + d B + sum_s hat(c(d) - s) R[s]`` for M stacked depth maps — the
    output of ``piecewise_eval_pallas``. D f32[M, K, H, W]; a, b
    f32[K, H, W, C]; r bf16[K, C, S, H, W]. Returns f32[M, K, H, W, C].
    ``offsets``: one (dy, dx) per map; map m then reads the table at the
    edge-clamped pixel (y + dy, x + dx): out[m, k, y, x] = P[k, clamp(y +
    dy), clamp(x + dx)](D[m, k, y, x])."""
    run = piecewise_eval_cuda if native.is_cuda(D) else piecewise_eval_plain
    return run(D, a, b, r, d_min, d_max, offsets)


class PiecewiseWarp(NamedTuple):
    """Per-pixel PIECEWISE-linear-in-depth calibration warp, the middle
    tier between the affine PixelWarp and the gather oracle: the
    least-squares affine part (A + d B, f32) plus a bf16 residual table
    R[k, c, s, y, x] at ``knots`` uniformly spaced depths over the
    GL-clamped depth domain. Residuals measured at bake time on the raw cv
    depth grid with R already bf16 (callers gate on ``max_err_*``)."""

    xyz_a: torch.Tensor   # [K, H, W, 3] f32
    xyz_b: torch.Tensor   # [K, H, W, 3] f32
    uv_a: torch.Tensor    # [K, H, W, 2] f32
    uv_b: torch.Tensor    # [K, H, W, 2] f32
    xyz_r: torch.Tensor   # [K, 3, S, H, W] bf16 residual knot planes
    uv_r: torch.Tensor    # [K, 2, S, H, W] bf16
    d_min: float
    d_max: float
    max_err_xyz: float
    max_err_uv: float

    @property
    def knots(self) -> int:
        return self.xyz_r.shape[2]

    def _eval(self, D, a, b, r, offsets=None):
        """M stacked depth maps against one table: D [M, K, H, W] ->
        [M, K, H, W, C] (one launch of kernel 5 on the card)."""
        return piecewise_eval(D.contiguous(), a, b, r, self.d_min, self.d_max, offsets=offsets)

    def xyz(self, d: torch.Tensor) -> torch.Tensor:
        return self._eval(d[None], self.xyz_a, self.xyz_b, self.xyz_r)[0]

    def uv(self, d: torch.Tensor) -> torch.Tensor:
        return self._eval(d[None], self.uv_a, self.uv_b, self.uv_r)[0]

    def xyz_shifted(self, dy: int, dx: int, d: torch.Tensor) -> torch.Tensor:
        """xyz_shifted(dy, dx, d)[y, x] = P[clamp(y+dy), clamp(x+dx)](d[y, x]):
        the table read at the edge-clamped shifted pixel."""
        return self._eval(d[None], self.xyz_a, self.xyz_b, self.xyz_r, ((dy, dx),))[0]

    def xyz_neighborhood(self, dn, d_t, d_b, d_l, d_r):
        """The pre_normal.fs 5-tap stencil (center, +y, -y, -x, +x) in one
        kernel launch (M = 5, each map at its tap's offset)."""
        q = self._eval(torch.stack([dn, d_t, d_b, d_l, d_r]), self.xyz_a, self.xyz_b,
                       self.xyz_r, NEIGHBORHOOD)
        return tuple(q.unbind(0))


def _affine_fit(vol: torch.Tensor, tc: np.ndarray, tm: float, tv: float):
    """Per-column least-squares A + t B over the d axis of vol f32[K, Dz,
    Dy, Dx, C] (closed form), ``tc`` = t - mean(t) f32[Dz]. Summed in the
    numpy original's order: the mean slice by slice, the slope as one
    float32 fused multiply-add chain over the slices (OpenBLAS's gemv; the
    float64 product of two float32 values is exact)."""
    dz = vol.shape[1]
    m = vol[:, 0]
    for d in range(1, dz):
        m = m + vol[:, d]
    m = m / dz
    acc = torch.zeros_like(m)
    for d in range(dz):
        acc = (float(tc[d]) * vol[:, d].double() + acc.double()).float()
    b = acc / tv
    return m - b * tm, b


def bake_piecewise_warp(rig, height: int, width: int, knots: int = 32,
                        device: torch.device | str = "cuda") -> PiecewiseWarp:
    """The piecewise warp: affine part as ``bake_pixel_warp``'s fit;
    residual knot planes from the depth-lerp of the raw cv slices (the knot
    value is the exact trilinear sample at that depth), stored bf16; both
    resized to pixel centers. Residual = max |piecewise(d_j) - cv[:, j]|
    over every raw depth texel j with the stored bf16 R. Torch on
    ``device``; the numpy original's operations, float32."""
    dz = rig.cv_xyz.shape[1]
    d_min, d_max = 0.5 / dz, 1.0 - 0.5 / dz
    t_np = ((np.arange(dz, dtype=np.float64) + 0.5) / dz).astype(np.float32)
    tm = float(t_np.mean())
    tv = float(((t_np - np.float32(tm)) ** 2).sum())
    d_knots = np.linspace(d_min, d_max, knots).astype(np.float32)
    c_k = np.clip(d_knots * dz - 0.5, 0.0, dz - 1)
    i0 = np.floor(c_k).astype(np.int64)
    i1 = np.minimum(i0 + 1, dz - 1)
    wk = (c_k - i0).astype(np.float32)
    cc = (t_np - d_min) / (d_max - d_min) * (knots - 1)

    def fit(vol_np):
        vol = torch.tensor(np.asarray(vol_np, np.float32), device=device)
        a, b = _affine_fit(vol, t_np - np.float32(tm), tm, tv)
        r = torch.stack([
            (vol[:, a0] * (1.0 - float(wv)) + vol[:, a1] * float(wv)) - (a + float(dk) * b)
            for a0, a1, wv, dk in zip(i0, i1, wk, d_knots)
        ], dim=1).to(torch.bfloat16)                           # [K, S, Dy, Dx, C]
        rf = r.to(torch.float32)
        resid = 0.0
        for j in range(dz):
            hat = np.clip(1.0 - np.abs(cc[j] - np.arange(knots)), 0.0, 1.0)
            pred = a + float(t_np[j]) * b
            for s in np.nonzero(hat)[0]:
                pred = pred + float(hat[s]) * rf[:, s]
            resid = max(resid, float((pred - vol[:, j]).abs().max()))
        return a, b, r, resid

    wy = torch.as_tensor(_gl_resize_weights_np(rig.cv_xyz.shape[2], height), device=device)
    wx = torch.as_tensor(_gl_resize_weights_np(rig.cv_xyz.shape[3], width), device=device)

    def resize(p):
        p = torch.einsum("Yy,...yxc->...Yxc", wy, p.to(torch.float32))
        return torch.einsum("Xx,...Yxc->...YXc", wx, p).contiguous()

    def to_cf(r):   # [K, S, H, W, C] -> kernel layout [K, C, S, H, W]
        return r.permute(0, 4, 1, 2, 3).contiguous()

    with full_f32():
        xyz_a, xyz_b, xyz_r, err_xyz = fit(rig.cv_xyz)
        uv_a, uv_b, uv_r, err_uv = fit(rig.cv_uv)
        return PiecewiseWarp(
            xyz_a=resize(xyz_a), xyz_b=resize(xyz_b),
            uv_a=resize(uv_a), uv_b=resize(uv_b),
            xyz_r=to_cf(resize(xyz_r).to(torch.bfloat16)),
            uv_r=to_cf(resize(uv_r).to(torch.bfloat16)),
            d_min=d_min, d_max=d_max, max_err_xyz=err_xyz, max_err_uv=err_uv,
        )


@functools.lru_cache(maxsize=None)
def _resize_weights_bf16(n_src: int, n_dst: int, device: torch.device) -> torch.Tensor:
    """``_gl_resize_weights_np`` rounded to bf16, on ``device``, made once
    per (shape, device) (``utils.math.device_const``'s rule)."""
    return _bf16_round(torch.as_tensor(_gl_resize_weights_np(n_src, n_dst), device=device))


def resize2d_gl(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """GL-LINEAR resize of [h, w, C] to out_hw: two hat-weight products with
    the JAX version's bf16 rounding of weights, input and intermediate
    (float32 accumulation), so both sides resize the same numbers."""
    h2, w2 = out_hw
    wh = _resize_weights_bf16(img.shape[0], h2, img.device)
    ww = _resize_weights_bf16(img.shape[1], w2, img.device)
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
                      x0: torch.Tensor, channels: int | None = None) -> torch.Tensor:
    """PyTorch form of kernel 2 on given window origins (see warp_screen)."""
    img = img[..., :channels]
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
    [native.P] * 6 + [native.I] * 10,
)


def warp_screen_cuda(img: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor,
                     tile: tuple[int, int], wh: int, y0: torch.Tensor,
                     x0: torch.Tensor, channels: int | None = None) -> torch.Tensor:
    """Kernel 2 on the card (``csrc/warp_screen.cu``); the arguments of
    ``warp_screen_plain``. It takes 3 channels, or 9 of a source padded to
    12."""
    ti, si, cp = img.shape
    c = cp if channels is None else channels
    if (cp, c) not in ((3, 3), (12, 9)):
        raise ValueError(f"warp_screen kernel: {c} channels of {cp}; takes 3 of 3 or 9 of 12")
    h, w = fy.shape
    dev = img.device
    native.check(img, "img", torch.float32, device=dev)
    if img.data_ptr() % 16:
        raise ValueError("img: the kernel's taps need a 16-byte aligned source")
    native.check(fy, "fy", torch.float32, (h, w), dev)
    native.check(fx, "fx", torch.float32, (h, w), dev)
    nt = (h // tile[0]) * (w // tile[1])
    native.check(y0, "y0", torch.int32, (nt,), dev)
    native.check(x0, "x0", torch.int32, (nt,), dev)
    out = torch.empty((h, w, c), dtype=torch.float32, device=dev)
    _WARP_SCREEN(img.data_ptr(), fy.data_ptr(), fx.data_ptr(), y0.data_ptr(),
                 x0.data_ptr(), out.data_ptr(), ti, si, cp, c, h, w, tile[0],
                 tile[1], wh, WXW)
    return out


def warp_screen(img: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor,
                tile: tuple[int, int], channels: int | None = None) -> torch.Tensor:
    """Bilinear resample of the first ``channels`` (default all) of
    ``img`` f32[Ti, Si, C] at per-pixel fractional (fy, fx) f32[H, W]
    (already clamped into the image) onto f32[H, W, channels], with each
    pixel's taps confined to its tile's window: the output of
    ``warp_screen_pallas`` in float32 (no bf16 matmul, no hi/lo split)."""
    wh, y0, x0 = warp_windows(img.shape[0], img.shape[1], fy, fx, tile)
    run = warp_screen_cuda if native.is_cuda(img) else warp_screen_plain
    return run(img, fy, fx, tile, wh, y0, x0, channels)

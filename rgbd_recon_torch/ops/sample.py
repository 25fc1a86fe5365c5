"""GL-exact texture sampling on torch tensors (mirrors
``rgbd_recon_tpu/ops/sample.py``).

* texel ``i`` has its center at normalized coordinate ``(i + 0.5) / N``
* LINEAR: ``c = t*N - 0.5`` clamped to ``[0, N-1]``, lerp between
  ``floor(c)`` and ``floor(c)+1``
* NEAREST: ``i = floor(t*N)`` clamped to ``[0, N-1]``
"""
from __future__ import annotations

import torch


def _linear_prep(t: torch.Tensor, n: int):
    c = torch.clamp(t * n - 0.5, 0.0, float(n - 1))
    i0f = torch.floor(c)
    f = c - i0f
    i0 = i0f.to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=n - 1)
    return i0, i1, f


def _nearest_index(t: torch.Tensor, n: int) -> torch.Tensor:
    """floor(t*N) clamped to [0, N-1]. The clamp runs on the float, before
    the cast, with NaN -> 0: XLA's saturating float -> int conversion
    (torch's cast of a NaN or an out-of-range float is undefined)."""
    i = torch.nan_to_num(torch.floor(t * n), nan=0.0)
    return torch.clamp(i, 0.0, float(n - 1)).to(torch.int64)


def sample2d(img: torch.Tensor, uv: torch.Tensor, method: str = "linear") -> torch.Tensor:
    """Sample ``img [H, W, C]`` at texcoords ``uv [..., 2]`` -> ``[..., C]``
    (``method``: "linear" or "nearest")."""
    h, w = img.shape[0], img.shape[1]
    flat = img.reshape(h * w, -1)
    s, t = uv[..., 0], uv[..., 1]
    if method == "nearest":
        return flat[_nearest_index(t, h) * w + _nearest_index(s, w)]
    x0, x1, fx = _linear_prep(s, w)
    y0, y1, fy = _linear_prep(t, h)
    v00 = flat[y0 * w + x0]
    v01 = flat[y0 * w + x1]
    v10 = flat[y1 * w + x0]
    v11 = flat[y1 * w + x1]
    fx = fx[..., None]
    fy = fy[..., None]
    top = v00 * (1.0 - fx) + v01 * fx
    bot = v10 * (1.0 - fx) + v11 * fx
    return top * (1.0 - fy) + bot * fy


def sample3d(vol: torch.Tensor, str_: torch.Tensor, method: str = "linear") -> torch.Tensor:
    """Sample ``vol [D, H, W, C]`` at texcoords ``str_ [..., 3]`` in GL
    order (s along W, t along H, r along D) -> ``[..., C]`` (``method``:
    "linear" or "nearest")."""
    d, h, w = vol.shape[0], vol.shape[1], vol.shape[2]
    flat = vol.reshape(d * h * w, -1)
    if method == "nearest":
        x = _nearest_index(str_[..., 0], w)
        y = _nearest_index(str_[..., 1], h)
        z = _nearest_index(str_[..., 2], d)
        return flat[(z * h + y) * w + x]
    x0, x1, fx = _linear_prep(str_[..., 0], w)
    y0, y1, fy = _linear_prep(str_[..., 1], h)
    z0, z1, fz = _linear_prep(str_[..., 2], d)

    def tap(z, y, x):
        return flat[(z * h + y) * w + x]

    fx, fy, fz = fx[..., None], fy[..., None], fz[..., None]
    c00 = tap(z0, y0, x0) * (1.0 - fx) + tap(z0, y0, x1) * fx
    c01 = tap(z0, y1, x0) * (1.0 - fx) + tap(z0, y1, x1) * fx
    c10 = tap(z1, y0, x0) * (1.0 - fx) + tap(z1, y0, x1) * fx
    c11 = tap(z1, y1, x0) * (1.0 - fx) + tap(z1, y1, x1) * fx
    c0 = c00 * (1.0 - fy) + c01 * fy
    c1 = c10 * (1.0 - fy) + c11 * fy
    return c0 * (1.0 - fz) + c1 * fz


def pixel_texcoords(h: int, w: int, device=None) -> torch.Tensor:
    """Texcoord grid hitting every texel center, ``[H, W, 2]`` as (s, t)."""
    s = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
    t = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
    tt, ss = torch.meshgrid(t, s, indexing="ij")
    return torch.stack([ss, tt], dim=-1)

"""Color space conversion (mirrors ``rgbd_recon_tpu/ops/colors.py``;
reference: glsl/inc_color.glsl:1-48).

The reference feeds RGB in [0, 1] into ``rgb_to_lab`` whose first step
divides by 255 (inc_color.glsl:14-16); the quirk is kept because the LAB
distance thresholds (pre_boundary.fs:19) are tuned to it.
"""
from __future__ import annotations

import torch

_WHITE_REF = (95.047, 100.000, 108.883)
_EPSILON = 0.008856
_KAPPA = 903.3


def _pivot_rgb(n: torch.Tensor) -> torch.Tensor:
    return torch.where(
        n > 0.04045, torch.pow((n + 0.055) / 1.055, 2.4), n / 12.92
    ) * 100.0


def _pivot_xyz(n: torch.Tensor) -> torch.Tensor:
    # cube root of a non-negative argument (the branch only takes n > eps)
    cbrt = torch.pow(torch.clamp(n, min=0.0), 1.0 / 3.0)
    return torch.where(n > _EPSILON, cbrt, (_KAPPA * n + 16.0) / 116.0)


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """``[..., 3]`` RGB in [0,1] -> reference-quirk LAB (inc_color.glsl:45-47)."""
    p = _pivot_rgb(rgb / 255.0)
    r, g, b = p[..., 0], p[..., 1], p[..., 2]
    x = (r * 0.4124 + g * 0.3576 + b * 0.1805) / _WHITE_REF[0]
    y = (r * 0.2126 + g * 0.7152 + b * 0.0722) / _WHITE_REF[1]
    z = (r * 0.0193 + g * 0.1192 + b * 0.9505) / _WHITE_REF[2]
    px, py, pz = _pivot_xyz(x), _pivot_xyz(y), _pivot_xyz(z)
    l_ = torch.clamp(116.0 * py - 16.0, min=0.0)
    a_ = 500.0 * (px - py)
    b_ = 200.0 * (py - pz)
    return torch.stack([l_, a_, b_], dim=-1)

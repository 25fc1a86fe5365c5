"""Render camera, parameters, shading and the per-camera debug colors
(mirrors the parts of ``rgbd_recon_tpu/ops/raymarch.py`` the sweep renderer
and the splatting strategies use; the per-ray oracle marcher is not ported
yet).

The volume occupies the unit cube in "volume space"; vol_to_world maps it
to the world bbox (recon_integration.cpp:66-71).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.math import Bbox

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


class RenderCamera(NamedTuple):
    """Pinhole render camera: ``modelview`` world -> eye (GL, looking down
    -z), ``proj`` the GL projection; both row-major f32[4, 4]."""

    modelview: torch.Tensor
    proj: torch.Tensor
    width: int
    height: int


class RenderParams(NamedTuple):
    shade_mode: int = 0     # 0 color / 1 shaded / 2 normal
    max_steps: int = 0


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


def _vec(v, ref: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=ref.device)


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

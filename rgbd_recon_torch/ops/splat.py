"""Forward-splatting rasterization for the non-TSDF reconstruction modes
(mirrors ``rgbd_recon_tpu/ops/splat.py``).

The reference's ReconPoints / ReconTrigrid / ReconMVT rely on the GL
rasterizer (point sprites with distance-scaled size, per-pixel triangle
grids with additive quality-weighted blending — recon_points.cpp:72-112,
recon_trigrid.cpp:82-148, glsl/trigrid_accum.*). The JAX package splats
forward with scatters instead, and so does the port, with PyTorch's
scatters over the stacked footprint offsets (one scatter a pass at any
footprint size):

  pass 1  z-buffer:    ``scatter_reduce_(..., "amin")`` of view depth —
                       exact and independent of the order
  pass 2  accumulate:  an index-add of (shade * quality, quality) for
                       fragments within epsilon of the z-buffer, as
                       ``index_put_(..., accumulate=True)``: on the card
                       that sorts the indices and sums each pixel's
                       fragments in one thread (``index_add_`` adds with
                       float atomics, in another order every run), so a
                       frame repeats bit for bit; the CPU sums in another
                       order, so the two agree to a tolerance
  resolve normalize:   color / alpha (≙ trigrid_normalize.fs:11-31)

``zbuffer_points``' winner write has duplicate pixels wherever two winners
tie within 1e-7. XLA on the CPU applies a scatter's updates in order, so
the JAX function keeps the last of them; ``index_put_`` with duplicates is
undefined on the card. The port picks that same winner deterministically:
a ``scatter_reduce_(..., "amax")`` of the update's position (offset-major,
as the JAX function stacks them), then a gather.

Footprint offsets past the image edge clamp to the edge pixel, and the
frustum mask and the 1e-9 w-guard of ``project`` are the JAX function's.
This is plain PyTorch on both devices: the JAX package computes it in XLA,
outside any Pallas kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.math import pmat
from .raymarch import RenderCamera


class SplatBuffers(NamedTuple):
    color: torch.Tensor  # f32[H, W, 4] accumulated (rgb*q, q)
    depth: torch.Tensor  # f32[H, W] min view -z (+inf empty)


def project(world: torch.Tensor, cam: RenderCamera):
    """World points [..., 3] -> (pixel xy f32[..., 2], view pos [..., 3],
    ndc z, in-frustum mask)."""
    mv = cam.modelview
    pos_es = pmat(world, mv[:3, :3].T) + mv[:3, 3]
    clip = pmat(torch.cat([pos_es, torch.ones_like(pos_es[..., :1])], -1), cam.proj.T)
    w = clip[..., 3]
    safe_w = torch.where(w.abs() < 1e-9, 1e-9, w)
    ndc = clip[..., :3] / safe_w[..., None]
    px = (ndc[..., 0] * 0.5 + 0.5) * cam.width
    py = (ndc[..., 1] * 0.5 + 0.5) * cam.height
    inside = ((w > 0)
              & (ndc[..., 0] >= -1) & (ndc[..., 0] <= 1)
              & (ndc[..., 1] >= -1) & (ndc[..., 1] <= 1)
              & (ndc[..., 2] >= -1) & (ndc[..., 2] <= 1))
    return torch.stack([px, py], -1), pos_es, ndc[..., 2], inside


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float -> int32 conversion: saturating, NaN -> 0 (a plain cast
    of an out-of-range float is undefined)."""
    x = torch.nan_to_num(x, nan=0.0)
    return torch.clamp(x, -2.0 ** 31, 2.0 ** 31 - 128).to(torch.int64)


def _flat_indices(pxy: torch.Tensor, cam: RenderCamera, dx: int, dy: int) -> torch.Tensor:
    """Flat pixel index i64 of each point's footprint pixel (dx, dy), the
    offset clamped to the image edge."""
    x = torch.clamp(_to_i32(torch.floor(pxy[..., 0])) + dx, 0, cam.width - 1)
    y = torch.clamp(_to_i32(torch.floor(pxy[..., 1])) + dy, 0, cam.height - 1)
    return y * cam.width + x


def _zbuffer(idx_all: torch.Tensor, cov_all: torch.Tensor, dist_all: torch.Tensor,
             npix: int) -> torch.Tensor:
    """Pass 1: the least covered view depth of each pixel, +inf where none.
    Only covered entries are scattered: the others would add +inf, and the
    points off the image all land on its clamped border pixels, where the
    card's atomics on one address serialise."""
    zbuf = torch.full((npix,), float("inf"), device=idx_all.device)
    return zbuf.scatter_reduce_(0, idx_all[cov_all], dist_all[cov_all], "amin")


def splat(world: torch.Tensor, colors: torch.Tensor, quality: torch.Tensor,
          valid: torch.Tensor, cam: RenderCamera, epsilon: float = 0.075,
          footprint: int = 2, size: torch.Tensor | None = None) -> SplatBuffers:
    """Two-pass accumulation splat of shaded points (recon_trigrid.cpp
    epsilon uniform). world f32[N, 3]; colors f32[N, 3] (already shaded);
    quality f32[N]; valid bool[N]. Returns accumulated buffers (resolve with
    ``normalize``).

    ``size``: optional per-point footprint f32[N] in pixels (clipped to
    [1, footprint]) — the analogue of the reference rasterizing the
    PROJECTED triangle pair (trigrid_accum.gs:26-57); ``footprint`` is then
    the upper bound. None keeps the full fixed square."""
    pxy, pos_es, _, inside = project(world, cam)
    dist = -pos_es[..., 2]  # view-space depth (camera looks down -z)
    ok = valid & inside & (dist > 0)
    size_f = None if size is None else torch.clamp(size, 1.0, float(footprint))

    def cover(dx, dy):
        if size_f is None:
            return ok
        return ok & (size_f > dx) & (size_f > dy)

    offsets = [(dx, dy) for dy in range(footprint) for dx in range(footprint)]
    nf = len(offsets)
    idx_all = torch.cat([_flat_indices(pxy, cam, dx, dy) for dx, dy in offsets])
    cov_all = torch.cat([cover(dx, dy) for dx, dy in offsets])
    npix = cam.width * cam.height
    dist_all = dist.repeat(nf)
    zbuf = _zbuffer(idx_all, cov_all, dist_all, npix)

    payload = torch.cat([colors * quality[..., None], quality[..., None]], -1)
    zb = zbuf[idx_all]
    # within-epsilon test ≙ |position_curr_es - pos_es| (accum fs :60-66)
    # reconstructed along the same ray: |pos_es| * |1 - zb/dist|
    ratio_all = (torch.linalg.vector_norm(pos_es, dim=-1)
                 / torch.clamp(dist, min=1e-9)).repeat(nf)
    eps_ok = cov_all & ((dist_all - zb).abs() * ratio_all < epsilon)
    # only the fragments that add (the rest add 0: a run of one pixel's
    # duplicates is summed in one thread, and the border pixels would hold
    # every off-image point)
    sel = eps_ok.nonzero().squeeze(1)
    acc = torch.zeros((npix, 4), device=world.device)
    acc.index_put_((idx_all[sel],), payload[sel % world.shape[0]], accumulate=True)
    return SplatBuffers(acc.reshape(cam.height, cam.width, 4),
                        zbuf.reshape(cam.height, cam.width))


def normalize(buffers: SplatBuffers):
    """trigrid_normalize.fs: color/alpha where alpha > 0, else background.
    Returns (rgba f32[H, W, 4], hit bool[H, W], view depth f32[H, W])."""
    a = buffers.color[..., 3]
    hit = a > 0.0
    rgb = buffers.color[..., :3] / torch.clamp(a, min=1e-20)[..., None]
    rgba = torch.where(hit[..., None], torch.cat([rgb, torch.ones_like(a)[..., None]], -1),
                       0.0)
    return rgba, hit, buffers.depth


def zbuffer_points(world: torch.Tensor, colors: torch.Tensor, valid: torch.Tensor,
                   cam: RenderCamera, max_size: float = 10.0):
    """Point splat with a winner-takes-all z-buffer (≙ ReconPoints: GL_POINTS
    with gl_PointSize = max_size / dist, points.gs:35-60): a per-point
    square footprint of 1..3 px. Returns (rgba f32[H, W, 4], depth
    f32[H, W]); ties within 1e-7 go to the last update, as in the JAX
    function (module docstring)."""
    pxy, pos_es, _, inside = project(world, cam)
    dist = torch.linalg.vector_norm(pos_es, dim=-1)
    ok = valid & inside & (-pos_es[..., 2] > 0)
    size = torch.clamp(max_size / torch.clamp(dist, min=1e-6), 1.0, 3.0)

    offsets = [(dx, dy) for dy in range(-1, 2) for dx in range(-1, 2)]
    nf = len(offsets)
    idx_all = torch.cat([_flat_indices(pxy, cam, dx, dy) for dx, dy in offsets])
    cov_all = torch.cat([ok & (size >= max(abs(dx), abs(dy)) * 2.0 - 1.0 + 1e-6)
                         for dx, dy in offsets])
    npix = cam.width * cam.height
    zdist_all = (-pos_es[..., 2]).repeat(nf)
    zbuf = _zbuffer(idx_all, cov_all, zdist_all, npix)

    win = cov_all & (zdist_all <= zbuf[idx_all] + 1e-7)
    pos = torch.arange(idx_all.shape[0], device=world.device)
    last = torch.full((npix,), -1, dtype=torch.int64, device=world.device)
    last.scatter_reduce_(0, idx_all[win], pos[win], "amax")
    # the winner's point (position modulo N), the cleared pixel where none
    n = world.shape[0]
    rgba = torch.cat([torch.cat([colors, torch.ones_like(colors[..., :1])], -1),
                      torch.zeros((1, 4), device=world.device)])
    cbuf = rgba[torch.where(last >= 0, last % max(n, 1), n)]
    return (cbuf.reshape(cam.height, cam.width, 4), zbuf.reshape(cam.height, cam.width))

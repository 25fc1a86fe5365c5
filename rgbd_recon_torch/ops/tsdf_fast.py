"""Brick-sparse integration helpers, the dense voxel -> sensor warp table
and the XLA table integrator (mirrors ``rgbd_recon_tpu/ops/tsdf_fast.py``).

``precompute_tables`` bakes ``sample3d(cv_xyz_inv[k], voxel_centers)`` for
every voxel as a separable GL-exact trilinear resize (three float32
products, TF32 off) on the pipeline's device, in the block-major layout
the table-tier integrators read (``IntegrationTables``; ~805 MB at 256^3 x
4 sensors).

``integrate_sparse`` is the JAX module's XLA integrator (what the JAX
pipeline takes for ``use_pallas=False`` and volumes under 8 bricks on an
axis, and what ``ReconIntegration`` runs): a ``window``-px square window
per brick and sensor at the origins of ``win_offsets``, the silhouette
gate ``sil < SIL_FULL``, clear values filled in by ``assemble_blocks``. On
the card it is one launch of kernel 7's window mode
(``csrc/integrate_sparse.cu``); on the CPU its plain form
(``tsdf_sparse.integrate_sparse_plain(..., window=)``), one vectorised step
per chunk of bricks where the JAX function maps hat-weight products over
the bricks. Both sample in float32 directly where JAX contracts hat
weights, so they are held to the JAX function at the integrator bound of
``tests/test_tsdf_affine.py:109-116``.
"""
from __future__ import annotations

import hashlib
import os
from typing import NamedTuple

import numpy as np
import torch

from .. import native
from ..utils.math import full_f32
from .warp import _gl_resize_weights_np

BRICK = 16          # voxels per brick edge
B3 = BRICK ** 3


class IntegrationTables(NamedTuple):
    """Baked voxel -> (u, v, d_norm) warp in BLOCK-MAJOR layout: brick b of
    the 16^3 partition holds its voxels contiguously, z-major within the
    brick. Off-frustum voxels read (-1, -1, -1)."""

    pos_blocked: torch.Tensor  # f32[K, NB, B3, 3]


def _to_blocked(pos: torch.Tensor) -> torch.Tensor:
    """[K, Vz, Vy, Vx, 3] -> block-major [K, NB, B3, 3]."""
    k, vz, vy, vx, c = pos.shape
    nz, ny, nx = vz // BRICK, vy // BRICK, vx // BRICK
    p = pos.reshape(k, nz, BRICK, ny, BRICK, nx, BRICK, c)
    return p.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(k, nz * ny * nx, B3, c).contiguous()


def resize3d_gl(vol: torch.Tensor, out_res: tuple[int, int, int]) -> torch.Tensor:
    """Separable GL-exact trilinear resize [D, H, W, C] -> out_res (d, h, w
    order): three float32 products with TF32 off (``sample3d`` at the voxel
    centers of the new grid)."""
    d2, h2, w2 = out_res

    def wts(n_src, n_dst):
        return torch.as_tensor(_gl_resize_weights_np(n_src, n_dst), device=vol.device)

    with full_f32():
        out = torch.einsum("Dd,dhwc->Dhwc", wts(vol.shape[0], d2), vol)
        out = torch.einsum("Hh,Dhwc->DHwc", wts(vol.shape[1], h2), out)
        return torch.einsum("Ww,DHwc->DHWc", wts(vol.shape[2], w2), out)


def precompute_tables(rig, cfg, device: torch.device | str = "cuda") -> IntegrationTables:
    """The voxel -> sensor warp of every sensor at the volume res
    (tsdf_integration.vs:31 hoisted out of the frame loop), on ``device``."""
    vx, vy, vz = cfg.res
    src = torch.tensor(np.asarray(rig.cv_xyz_inv, np.float32), device=device)

    def wts(n_src, n_dst):
        return torch.as_tensor(_gl_resize_weights_np(n_src, n_dst), device=device)

    with full_f32():
        pos = torch.einsum("Dd,kdhwc->kDhwc", wts(src.shape[1], vz), src)
        pos = torch.einsum("Hh,kDhwc->kDHwc", wts(src.shape[2], vy), pos)
        pos = torch.einsum("Ww,kDHwc->kDHWc", wts(src.shape[3], vx), pos)
    return IntegrationTables(pos_blocked=_to_blocked(pos))


def tables_cached(rig, cfg, device: torch.device | str = "cuda",
                  cache_dir: str | None = None, log=print) -> IntegrationTables:
    """``precompute_tables`` with an optional on-disk cache under
    ``cache_dir``, keyed by the content of cv_xyz_inv and the volume res
    (the JAX package's key, so both share a cache). A cache that cannot be
    read or written costs a recompute and one ``log`` line, never the run
    (the JAX behaviour)."""
    if cache_dir is None:
        return precompute_tables(rig, cfg, device)
    src = np.asarray(rig.cv_xyz_inv)
    key = hashlib.sha1(
        src.tobytes() + repr(("blocked-v2", tuple(cfg.res))).encode()).hexdigest()[:16]
    path = os.path.join(cache_dir, f"warp-{key}.npy")
    try:
        if os.path.exists(path):
            return IntegrationTables(torch.as_tensor(np.load(path), device=device))
    except (OSError, ValueError, EOFError) as e:
        log(f"warp-table cache {path} unreadable ({type(e).__name__}: {e}); recomputing")
    tables = precompute_tables(rig, cfg, device)
    try:
        os.makedirs(cache_dir, exist_ok=True)
        np.save(path, tables.pos_blocked.cpu().numpy())
    except OSError as e:
        log(f"warp-table cache {path} not written ({type(e).__name__}: {e})")
    return tables


def _footprint_mid(tables: IntegrationTables, h: int, w: int):
    """Footprint midpoints (x_mid, y_mid) f32[K, NB] in pixels of each
    brick's VALID projections (u >= 0), clamped to the image."""
    pc = tables.pos_blocked
    u, v = pc[..., 0], pc[..., 1]
    invalid = u < 0.0
    big = 1e9
    ux = torch.clamp(u * w - 0.5, 0.0, w - 1.0)
    vy = torch.clamp(v * h - 0.5, 0.0, h - 1.0)

    def mid(a):
        return (torch.where(invalid, big, a).amin(dim=-1)
                + torch.where(invalid, -big, a).amax(dim=-1)) * 0.5

    return mid(ux), mid(vy)


def win_offsets(tables: IntegrationTables, h: int, w: int, window: int) -> torch.Tensor:
    """Per-brick per-sensor image-window origins i32[K, NB, 2] as (y, x):
    a ``window``-px square centered on the footprint midpoint, clipped to
    the image (the placement of the JAX package's XLA integrator)."""
    x_mid, y_mid = _footprint_mid(tables, h, w)
    x_lo = torch.clamp(torch.floor(x_mid).to(torch.int32) - window // 2, 0, w - window)
    y_lo = torch.clamp(torch.floor(y_mid).to(torch.int32) - window // 2, 0, h - window)
    return torch.stack([y_lo, x_lo], dim=-1).to(torch.int32).contiguous()


def pack_frames(frames) -> torch.Tensor:
    """f32[K, H, W, 6]: depth | quality | silhouette | registered rgb."""
    return torch.cat(
        [
            frames.depth[..., :1],
            frames.quality[..., None],
            frames.silhouette[..., None],
            frames.color_registered,
        ],
        dim=-1,
    ).contiguous()


def pack_planes(frames) -> tuple[torch.Tensor, torch.Tensor]:
    """The packed frame in the two planes the dense integration kernels
    read: (f32[K, H, W, 4] depth | quality | silhouette | r, f32[K, H, W, 2]
    g | b). A tap is one 16-byte and one 8-byte load over dense rows."""
    rgb = frames.color_registered
    a = torch.cat([frames.depth[..., :1], frames.quality[..., None],
                   frames.silhouette[..., None], rgb[..., :1]], dim=-1).contiguous()
    return a, rgb[..., 1:3].contiguous()


def brick16_mask(voxel_mask: torch.Tensor) -> torch.Tensor:
    """Reduce a per-voxel occupancy mask bool[Vz, Vy, Vx] to 16^3 bricks
    (any voxel)."""
    vz, vy, vx = voxel_mask.shape
    m = voxel_mask.reshape(vz // BRICK, BRICK, vy // BRICK, BRICK, vx // BRICK, BRICK)
    return m.any(dim=5).any(dim=3).any(dim=1)


def occupied_bricks(mask16: torch.Tensor, max_bricks: int):
    """``occupied_list``'s (idx, count) and, from the same cumsum, the
    per-brick slot map slots i32[NB]: brick b's position in ``idx``, -1 for
    a brick that is not fused (unoccupied, or occupied past the capacity).
    Device-resident, no host sync; the dense integration kernels fuse the
    bricks of ``idx`` and clear the ones ``slots`` marks -1."""
    flat = mask16.reshape(-1)
    c = torch.cumsum(flat.to(torch.int32), dim=0)
    slots = torch.where(flat & (c <= max_bricks), c - 1, -1).to(torch.int32)
    idx = torch.zeros(max_bricks + 1, dtype=torch.int32, device=mask16.device)
    idx.scatter_(0, torch.where(slots >= 0, slots, max_bricks).to(torch.int64),
                 torch.arange(flat.shape[0], dtype=torch.int32, device=mask16.device))
    count = torch.clamp(c[-1:], max=max_bricks).to(torch.int32)
    return idx[:max_bricks].contiguous(), count, slots


def occupied_list(mask16: torch.Tensor, max_bricks: int):
    """Fixed-capacity list of occupied brick ids in ascending order,
    device-resident (replaces the reference's GPU->CPU readback,
    recon_integration.cpp:430-445). Returns (idx i32[max_bricks], valid
    bool[max_bricks], count i32[1] = min(#occupied, max_bricks)); bricks
    past the capacity are dropped (``FrameOutput.occupied_bricks`` makes
    that detectable)."""
    idx, count, _ = occupied_bricks(mask16, max_bricks)
    return idx, torch.arange(max_bricks, device=mask16.device) < count, count


def assemble_blocks(blocks, cblocks, idx_list, valid_list, vol_res, limit):
    """[MB, B3] (+ [MB, B3, 4]) brick results -> dense volumes (TSDF
    f32[Vz, Vy, Vx], color f32[Vz, Vy, Vx, 4]): every brick of the volume
    takes its result from the list through an inverse permutation, the
    clear values (-limit, 0) where no valid entry names it."""
    vx, vy, vz = vol_res
    nbx, nby, nbz = vx // BRICK, vy // BRICK, vz // BRICK
    nb = nbx * nby * nbz
    mb = blocks.shape[0]
    dev = blocks.device
    inv = torch.full((nb,), mb, dtype=torch.int64, device=dev)
    sel = valid_list.to(torch.bool)
    inv[idx_list[sel].to(torch.int64)] = torch.arange(mb, device=dev)[sel]
    clear = torch.full((1, B3), -float(limit), device=dev)
    vb = torch.cat([blocks, clear]).index_select(0, inv)
    vol = (vb.reshape(nbz, nby, nbx, BRICK, BRICK, BRICK)
           .permute(0, 3, 1, 4, 2, 5).reshape(vz, vy, vx))
    cclear = torch.zeros((1, B3, 4), device=dev)
    cvb = torch.cat([cblocks, cclear]).index_select(0, inv)
    cvol = (cvb.reshape(nbz, nby, nbx, BRICK, BRICK, BRICK, 4)
            .permute(0, 3, 1, 4, 2, 5, 6).reshape(vz, vy, vx, 4))
    return vol, cvol


def integrate_sparse(frames, tables: IntegrationTables, cfg, mask16: torch.Tensor,
                     max_bricks: int = 1024, window: int = 64,
                     win_off: torch.Tensor | None = None):
    """Brick-sparse fused TSDF f32[Vz, Vy, Vx] + color f32[Vz, Vy, Vx, 4]
    volumes, the XLA table integrator (module docstring). Voxels outside
    the first ``max_bricks`` occupied bricks hold -limit / 0 (the clear
    values, recon_integration.cpp:249-250). ``win_off``: precomputed
    i32[K, NB, 2] window origins (``win_offsets``); derived here if None.
    Sensor frames need H, W >= ``window``."""
    from . import tsdf_sparse   # the kernel's module imports this one

    vx, vy, vz = cfg.res
    if vx % BRICK or vy % BRICK or vz % BRICK:
        raise ValueError(f"volume res must be 16-aligned, got {cfg.res}")
    nb = (vx // BRICK) * (vy // BRICK) * (vz // BRICK)
    if tables.pos_blocked.shape[1] != nb:
        raise ValueError(f"tables hold {tables.pos_blocked.shape[1]} bricks, res {cfg.res} "
                         f"has {nb}")
    packed = pack_frames(frames)
    h, w = packed.shape[1], packed.shape[2]
    if h < window or w < window:
        raise ValueError(f"sensor frames {(h, w)} are smaller than one {window}-px window")
    idx, _, count = occupied_list(mask16, max_bricks)
    if win_off is None:
        win_off = win_offsets(tables, h, w, window)
    run = (tsdf_sparse.integrate_sparse_cuda if native.is_cuda(packed)
           else tsdf_sparse.integrate_sparse_plain)
    return run(packed, tables.pos_blocked, idx, count, win_off, cfg.res, float(cfg.limit),
               window)


def _chunks(idx, count, chunk: int):
    """The first ``count`` ids of ``idx`` as i64 tensors of up to ``chunk``
    (one host sync for the count)."""
    n_occ = int(count.reshape(-1)[0])
    for s in range(0, n_occ, chunk):
        yield idx[s:min(s + chunk, n_occ)].to(torch.int64)


def block_major_bricks(chunk_fn, idx, count, nb: int, chunk: int):
    """``chunk_fn`` as in ``scatter_bricks``, into the block-major layout of
    the block-major integrator's raw output: (TSDF f32[NB, 32, 128], color
    f32[NB, 4, 32, 128], visited bool[NB]), z-major [lz, ly, lx] inside a
    block, channel-major color. Blocks of unoccupied bricks hold 0."""
    dev = idx.device
    vol = torch.zeros((nb, B3), device=dev)
    cvol = torch.zeros((nb, 4, B3), device=dev)
    visited = torch.zeros(nb, dtype=torch.bool, device=dev)
    for bricks in _chunks(idx, count, chunk):
        wt, rgb, flag = chunk_fn(bricks)
        vol[bricks] = wt
        cvol[bricks] = torch.cat([rgb, flag[:, None]], dim=1)
        visited[bricks] = True
    return vol.reshape(nb, 32, 128), cvol.reshape(nb, 4, 32, 128), visited


def scatter_bricks(chunk_fn, idx, count, res, limit: float, chunk: int):
    """Run ``chunk_fn(bricks i64[n])`` -> (wt f32[n, B3], rgb f32[n, 3, B3],
    flag f32[n, B3]) over the first ``count`` ids of ``idx``, ``chunk``
    bricks at a time, into the dense volumes (TSDF f32[Vz, Vy, Vx] cleared
    to -limit, color f32[Vz, Vy, Vx, 4] cleared to 0) — the plain form of
    the integration kernels' one block per brick. Syncs once for the
    count."""
    vx, vy, vz = res
    nby, nbx = vy // BRICK, vx // BRICK
    dev = idx.device
    tsdf = torch.full((vz * vy * vx,), -limit, device=dev)
    color = torch.zeros((vz * vy * vx, 4), device=dev)
    v = torch.arange(B3, device=dev)
    lz, ly, lx = v // (BRICK * BRICK), (v // BRICK) % BRICK, v % BRICK
    for bricks in _chunks(idx, count, chunk):
        wt, rgb, flag = chunk_fn(bricks)
        bz = (bricks // (nby * nbx))[:, None]
        by = ((bricks // nbx) % nby)[:, None]
        bx = (bricks % nbx)[:, None]
        vox = ((bz * BRICK + lz) * vy + by * BRICK + ly) * vx + bx * BRICK + lx
        tsdf[vox] = wt
        color[vox] = torch.cat([rgb, flag[:, None]], dim=1).permute(0, 2, 1)
    return tsdf.reshape(vz, vy, vx), color.reshape(vz, vy, vx, 4)

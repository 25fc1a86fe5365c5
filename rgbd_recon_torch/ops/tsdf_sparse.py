"""Brick-sparse TSDF + color fusion from the dense warp table — the table
tier of the integrator (mirrors ``rgbd_recon_tpu/ops/tsdf_pallas.py``).

``integrate_sparse`` is the port of the TPU kernel
``integrate_sparse_pallas``; the CUDA kernel is ``csrc/integrate_sparse.cu``
and ``integrate_sparse_plain`` is the same function in PyTorch. The TPU
windows are kept because they decide which pixels a brick with an
oversized footprint reads (``win_offsets_pallas``): WY = 48 rows from an
8-aligned origin, WX = 128 columns from an x-block at stride 64, sample
coordinates clamped first to the image, then to the window. The kernel
samples in float32 where the TPU kernel sampled through bf16 hat matmuls
(with a hi/lo depth split), so the two agree to the bound of
``tests/test_tsdf_pallas.py:40-47``, not bitwise.

With ``window`` set, the same kernel (its window mode) and plain form
compute the XLA table integrator ``tsdf_fast.integrate_sparse`` instead:
a ``window``-px square at the origins of ``tsdf_fast.win_offsets`` and the
SIL_FULL gate on the silhouette itself.
"""
from __future__ import annotations

import torch

from .. import native
from .tsdf import TsdfConfig
from .tsdf_dense import bilinear5, fuse_finish, fuse_init, fuse_sampled
from .tsdf_fast import (BRICK, IntegrationTables, _footprint_mid, assemble_blocks,
                        occupied_list, pack_frames, scatter_bricks)

WY = 48            # y window (rows), origins 8-aligned
WX = 128           # x window (cols)
XSTRIDE = 64       # x-block stride
PLAIN_CHUNK = 64   # bricks per vectorized step of the plain version


def win_offsets_pallas(tables: IntegrationTables, h: int, w: int) -> torch.Tensor:
    """Per-brick per-sensor (y8, xb) window selectors i32[K, NB, 2]: y8 the
    8-aligned row origin of a WY-row window, xb the x-block (stride
    XSTRIDE, width WX), both centered on the footprint midpoint of the
    brick's valid projections."""
    nxb = w // XSTRIDE - 1
    x_mid, y_mid = _footprint_mid(tables, h, w)
    xb = torch.clamp(torch.div(torch.floor(x_mid).to(torch.int32) - WX // 2 + XSTRIDE // 2,
                               XSTRIDE, rounding_mode="floor"), 0, nxb - 1)
    y8 = torch.clamp(torch.bitwise_and(torch.floor(y_mid).to(torch.int32) - WY // 2, -8),
                     0, h - WY)
    return torch.stack([y8, xb], dim=-1).to(torch.int32).contiguous()


def _brick_chunk(packed, pos, win_off, bricks, h, w, limit, window=None):
    """Fused (wt, rgb, flag) of the bricks ``bricks`` i64[n] — the plain
    form of one kernel block each; ``window``: the XLA integrator's square
    window mode (module docstring)."""
    state = fuse_init(bricks.shape[0], limit, packed.device)
    direct = window is not None
    wy, wx = (window, window) if direct else (WY, WX)
    for k in range(packed.shape[0]):
        pc = pos[k, bricks]                                       # [n, B3, 3]
        u, v, d_vox = pc[..., 0], pc[..., 1], pc[..., 2]
        y_lo = win_off[k, bricks, 0].to(torch.int64)[:, None]
        x_lo = win_off[k, bricks, 1].to(torch.int64)[:, None]
        if direct:   # origins clamped into the image, as dynamic_slice clamps them
            y_lo, x_lo = torch.clamp(y_lo, 0, h - wy), torch.clamp(x_lo, 0, w - wx)
        else:
            x_lo = x_lo * XSTRIDE
        xl, yl = x_lo.to(torch.float32), y_lo.to(torch.float32)
        ux = torch.clamp(torch.clamp(u * w - 0.5, 0.0, w - 1.0) - xl, 0.0, wx - 1.0)
        vy = torch.clamp(torch.clamp(v * h - 0.5, 0.0, h - 1.0) - yl, 0.0, wy - 1.0)
        nu = torch.clamp(torch.clamp(torch.floor(u * w), 0.0, w - 1.0) - xl, 0.0, wx - 1.0)
        nv = torch.clamp(torch.clamp(torch.floor(v * h), 0.0, h - 1.0) - yl, 0.0, wy - 1.0)
        img = packed[k].reshape(h * w, 6)
        depth = img[(y_lo + nv.to(torch.int64)) * w + x_lo + nu.to(torch.int64), 0]
        iu, iv = torch.floor(ux), torch.floor(vy)
        gu, gv = ux - iu, vy - iv
        iu, iv = iu.to(torch.int64), iv.to(torch.int64)
        lin = bilinear5(img, w, y_lo + iv, y_lo + torch.clamp(iv + 1, max=wy - 1),
                        x_lo + iu, x_lo + torch.clamp(iu + 1, max=wx - 1), gu, gv, direct)
        state = fuse_sampled(state, d_vox, depth, lin, u < 0.0, packed[k, 0, 0], limit,
                             direct)
    return fuse_finish(state)


def integrate_sparse_plain(packed, pos, idx, count, win_off, res, limit, window=None):
    """PyTorch form of kernel 7 (see integrate_sparse); takes the kernel's
    arguments. With ``window`` (the XLA integrator's mode) the bricks are
    assembled by ``tsdf_fast.assemble_blocks``, as the JAX function does."""
    _, h, w, _ = packed.shape

    def chunk(bricks):
        return _brick_chunk(packed, pos, win_off, bricks, h, w, limit, window)

    if window is None:
        return scatter_bricks(chunk, idx, count, res, limit, PLAIN_CHUNK)
    n = int(count.reshape(-1)[0])
    parts = [chunk(idx[s:min(s + PLAIN_CHUNK, n)].to(torch.int64))
             for s in range(0, n, PLAIN_CHUNK)]
    if parts:
        blocks = torch.cat([p[0] for p in parts])
        cblocks = torch.cat([torch.cat([p[1], p[2][:, None]], dim=1) for p in parts])
    else:
        blocks = torch.zeros((0, BRICK ** 3), device=packed.device)
        cblocks = torch.zeros((0, 4, BRICK ** 3), device=packed.device)
    valid = torch.ones(n, dtype=torch.bool, device=packed.device)
    return assemble_blocks(blocks, cblocks.permute(0, 2, 1), idx[:n], valid, res, limit)


_INTEGRATE_SPARSE = native.Kernel(
    "integrate_sparse", [native.P] * 7 + [native.I] * 8 + [native.F])
_INTEGRATE_SPARSE_WINDOW = native.Kernel(
    "integrate_sparse_window", [native.P] * 7 + [native.I] * 9 + [native.F])


def integrate_sparse_cuda(packed, pos, idx, count, win_off, res, limit, window=None):
    """Kernel 7 on the card (``csrc/integrate_sparse.cu``; with ``window``
    its window mode, a counter of its own); the arguments of
    ``integrate_sparse_plain``. No host sync."""
    vx, vy, vz = res
    num_k, h, w, _ = packed.shape
    nb = (vx // BRICK) * (vy // BRICK) * (vz // BRICK)
    max_bricks = idx.shape[0]
    dev = packed.device
    native.check(packed, "packed", torch.float32, (num_k, h, w, 6), dev)
    native.check(pos, "pos", torch.float32, (num_k, nb, BRICK ** 3, 3), dev)
    native.check(idx, "idx", torch.int32, (max_bricks,), dev)
    native.check(count, "count", torch.int32, (1,), dev)
    native.check(win_off, "win_off", torch.int32, (num_k, nb, 2), dev)
    tsdf = torch.empty((vz, vy, vx), dtype=torch.float32, device=dev)
    color = torch.empty((vz, vy, vx, 4), dtype=torch.float32, device=dev)
    args = (packed.data_ptr(), pos.data_ptr(), idx.data_ptr(), count.data_ptr(),
            win_off.data_ptr(), tsdf.data_ptr(), color.data_ptr(), num_k, h, w, nb,
            vx // BRICK, vy // BRICK, vz // BRICK, max_bricks)
    if window is None:
        _INTEGRATE_SPARSE(*args, limit)
    else:
        _INTEGRATE_SPARSE_WINDOW(*args, int(window), limit)
    return tsdf, color


def integrate_sparse(frames, tables: IntegrationTables, cfg: TsdfConfig,
                     mask16: torch.Tensor, max_bricks: int, win_off: torch.Tensor):
    """Fused TSDF f32[Vz, Vy, Vx] + color f32[Vz, Vy, Vx, 4] of the
    occupied 16^3 bricks of ``mask16`` (the first ``max_bricks`` in
    ascending order), the warp read from ``tables``; ``win_off``
    i32[K, NB, 2] from win_offsets_pallas. Sensor frames need H >= 48 and
    W >= 128 (one full window)."""
    vx, vy, vz = cfg.res
    if vx % BRICK or vy % BRICK or vz % BRICK:
        raise ValueError(f"the table integrator needs a 16-aligned res, got {cfg.res}")
    packed = pack_frames(frames)
    if packed.shape[1] < WY or packed.shape[2] < WX:
        raise ValueError(f"sensor frames {tuple(packed.shape[1:3])} are smaller than "
                         f"one ({WY}, {WX}) window")
    idx, _, count = occupied_list(mask16, max_bricks)
    run = integrate_sparse_cuda if native.is_cuda(packed) else integrate_sparse_plain
    return run(packed, tables.pos_blocked, idx, count, win_off, cfg.res, float(cfg.limit))

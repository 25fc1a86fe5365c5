"""Brick-sparse TSDF + color integration emitting the dense volumes
(mirrors ``rgbd_recon_tpu/ops/tsdf_dense.py``).

``integrate_dense`` is the port of the TPU kernel ``integrate_dense_pallas``
at the pipeline's settings (``zmajor=True, vol_dtype=bf16``, per-sensor
classes from the depth-band cull): TSDF bf16[Vz, Vy, Vx] cleared to -limit
and color bf16[Vz, 4, Vy, Vx] (rgb + has-quality flag) cleared to 0. The
CUDA kernel (``csrc/integrate_dense.cu``) reads ``AffineTables.coeffs``
directly — the TPU's session-baked ``cmats_full`` layout is not ported —
and ``integrate_dense_plain`` is the same function in PyTorch. The kernel
fuses the bricks of the occupied list and clears the ones the per-brick
slot map marks idle (``tsdf_fast.occupied_bricks``), in one launch; it
reads the frame in the two planes of ``tsdf_fast.pack_planes``.

Per voxel and sensor (``tsdf_persist._fuse_update`` / ``fuse_chunk_v3``):
the quadratic warp gives window-relative pixel coordinates; a voxel outside
the image or the [0, 1] depth range takes the image's corner pixel values;
depth samples NEAREST and (1 - silhouette), quality and registered rgb
LINEAR, all clamped to the brick's window; then the reference's TSDF and
color-blend update (tsdf_integration.vs:23-59, tsdf_raymarch.fs:295-320)
with the ``SIL_PL`` silhouette gate. The kernel samples in float32 where
the TPU kernel sampled through bf16 windows and weights, so the two agree
to the bound of ``tests/test_tsdf_affine.py:109-116``, not bitwise.
"""
from __future__ import annotations

import torch

from .. import native
from ..utils.math import full_f32
from .tsdf import TsdfConfig
from .tsdf_affine import AffineTables, NBASIS, _brick_basis
from .tsdf_fast import (BRICK, block_major_bricks, occupied_bricks, pack_frames, pack_planes,
                        scatter_bricks)

B3 = BRICK ** 3
SIL_PL = 0.998       # bf16-tolerant silhouette gate (tsdf_pallas.py:57)
SIL_FULL = 0.9999    # the XLA table integrator's gate on the silhouette (tsdf_fast.py:52)
PLAIN_CHUNK = 64     # bricks per vectorized step of the plain version


def _fuse(state, d_vox, depth, qual, sil, rgb, limit, sil_direct=False):
    """One sensor's TSDF + color-blend update (``_fuse_update``). ``sil``:
    (1 - silhouette) under the SIL_PL gate, or with ``sil_direct`` the
    silhouette itself under SIL_FULL (``tsdf_fast.integrate_sparse``)."""
    wt, tw, tc, tcw, tc2, tcw2 = state
    sdist = d_vox - depth
    outside = sil < SIL_FULL if sil_direct else sil > 1.0 - SIL_PL
    skip = outside & (wt >= limit)
    in_front = sdist <= -limit
    in_band = (sdist > -limit) & (sdist < limit)
    new_tw = tw + qual
    accum = torch.where(
        new_tw > 0.0,
        (wt * tw + qual * sdist) / torch.where(new_tw > 0.0, new_tw, 1.0),
        wt,
    )
    wt_next = torch.where(in_front, -limit, torch.where(in_band, accum, wt))
    tw_next = torch.where(in_band & (new_tw > 0.0), new_tw, tw)
    wt = torch.where(skip, -limit, wt_next)
    tw = torch.where(skip, tw, tw_next)
    dist = (depth - d_vox).abs()
    q_c = torch.where(dist < limit, qual, 0.0)
    w_c = q_c / (dist + 0.01)
    w2 = 1.0 / torch.clamp(dist, min=1e-9)
    return (wt, tw, tc + rgb * w_c[:, None], tcw + w_c,
            tc2 + rgb * w2[:, None], tcw2 + w2)


def fuse_init(n: int, limit: float, device) -> tuple:
    """Fusion state of n bricks: (wt, tw, tc, tcw, tc2, tcw2)."""
    shape = (n, B3)
    return (torch.full(shape, limit, device=device), torch.zeros(shape, device=device),
            torch.zeros((n, 3, B3), device=device), torch.zeros(shape, device=device),
            torch.zeros((n, 3, B3), device=device), torch.zeros(shape, device=device))


def bilinear5(img, w, v0, v1, u0, u1, gu, gv, sil_direct=False):
    """LINEAR taps of (1 - silhouette), quality, rgb from the packed frame
    ``img`` f32[H*W, 6] at flat rows/columns: [..., 5]; with ``sil_direct``
    the silhouette itself in place of (1 - silhouette)."""
    chans = [2, 1, 3, 4, 5]

    def taps(v, u):
        t = img[v * w + u][..., chans]
        return t if sil_direct else torch.cat([1.0 - t[..., :1], t[..., 1:]], dim=-1)

    gu, gv = gu[..., None], gv[..., None]
    left = (1.0 - gv) * taps(v0, u0) + gv * taps(v1, u0)
    right = (1.0 - gv) * taps(v0, u1) + gv * taps(v1, u1)
    return (1.0 - gu) * left + gu * right


def fuse_sampled(state, d_vox, depth, lin, invalid, cv, limit, sil_direct=False):
    """Substitute the corner pixel ``cv`` f32[6] for invalid voxels, then
    fuse one sensor's samples (depth [n, B3], lin [n, B3, 5] from
    ``bilinear5`` with the same ``sil_direct``)."""
    corner = torch.stack([cv[2] if sil_direct else 1.0 - cv[2], cv[1], cv[3], cv[4], cv[5]])
    lin = torch.where(invalid[..., None], corner, lin)
    depth = torch.where(invalid, cv[0], depth)
    return _fuse(state, d_vox, depth, lin[..., 1], lin[..., 0],
                 lin[..., 2:].permute(0, 2, 1), limit, sil_direct)


def fuse_finish(state):
    """(wt [n, B3], rgb [n, 3, B3], flag [n, B3]) of a fusion state."""
    wt, _, tc, tcw, tc2, tcw2 = state
    hasq = tcw > 0.0
    rgb = torch.where(hasq[:, None], tc / torch.clamp(tcw, min=1e-20)[:, None],
                      tc2 / torch.clamp(tcw2, min=1e-20)[:, None])
    return wt, rgb, torch.where(hasq, 1.0, -1.0)


def _brick_chunk(packed, coeffs, win_off, cls, bricks, basis, h, w, wy, wx,
                 xstride, limit):
    """Fused (wt f32[n, B3], rgb f32[n, 3, B3], flag f32[n, B3]) of the
    bricks ``bricks`` i64[n] — the plain form of one kernel block each."""
    num_k = packed.shape[0]
    n = bricks.shape[0]
    dev = packed.device
    state = fuse_init(n, limit, dev)
    scale = torch.tensor([w, h, 1.0], device=dev)
    for k in range(num_k):
        y_lo = win_off[k, bricks, 0].to(torch.int64)
        x_lo = win_off[k, bricks, 1].to(torch.int64) * xstride
        cs = coeffs[k, bricks, :3, :] * scale[None, :, None]       # [n, 3, 10]
        off = torch.zeros_like(cs)
        off[:, 0, 0] = -(x_lo.to(torch.float32) + 0.5)
        off[:, 1, 0] = -(y_lo.to(torch.float32) + 0.5)
        with full_f32():
            pc = torch.einsum("nca,av->ncv", cs + off, basis)     # [n, 3, B3]
        pu, pv, pd = pc[:, 0], pc[:, 1], pc[:, 2]
        xl = x_lo.to(torch.float32)[:, None]
        yl = y_lo.to(torch.float32)[:, None]
        invalid = ((pu < -0.5 - xl) | (pu > w - 0.5 - xl)
                   | (pv < -0.5 - yl) | (pv > h - 0.5 - yl)
                   | (pd < 0.0) | (pd > 1.0))
        hu = torch.clamp(w - 1 - x_lo, max=wx - 1)[:, None]
        hv = torch.clamp(h - 1 - y_lo, max=wy - 1)[:, None]
        img = packed[k].reshape(h * w, 6)

        def clip_hi(x, hi):
            return torch.minimum(torch.clamp(x, min=0.0), hi.to(torch.float32))

        nu = clip_hi(torch.floor(pu + 0.5), hu).to(torch.int64)
        nv = clip_hi(torch.floor(pv + 0.5), hv).to(torch.int64)
        depth = img[(y_lo[:, None] + nv) * w + x_lo[:, None] + nu, 0]
        cu, cv_ = clip_hi(pu, hu), clip_hi(pv, hv)
        iu, iv = torch.floor(cu), torch.floor(cv_)
        gu, gv = cu - iu, cv_ - iv
        iu, iv = iu.to(torch.int64), iv.to(torch.int64)
        lin = bilinear5(img, w, y_lo[:, None] + iv, y_lo[:, None] + torch.minimum(iv + 1, hv),
                        x_lo[:, None] + iu, x_lo[:, None] + torch.minimum(iu + 1, hu),
                        gu, gv)                                   # [n, B3, 5]
        cv = packed[k, 0, 0]                                     # corner pixel
        full = fuse_sampled(state, pd, depth, lin, invalid, cv, limit)
        zero = torch.zeros_like(pd)
        inv = _fuse(state, zero, cv[0] + zero, cv[1] + zero, 1.0 - cv[2] + zero,
                    cv[3:6][None, :, None] + torch.zeros_like(state[2]), limit)
        kc = (cls[k, bricks] if cls is not None
              else torch.zeros(n, dtype=torch.int32, device=dev))
        front = (torch.full_like(state[0], -limit),) + state[1:]
        out = []
        for s_full, s_inv, s_front, s_none in zip(full, inv, front, state):
            c = kc.view((n,) + (1,) * (s_full.dim() - 1))
            out.append(torch.where(c == 0, s_full, torch.where(
                c == 3, s_inv, torch.where(c == 2, s_front, s_none))))
        state = tuple(out)
    return fuse_finish(state)


def integrate_quadratic_plain(packed, coeffs, idx, count, win_off, cls, res,
                              wy, wx, xstride, limit, raw: bool = False):
    """The fusion of kernels 1 and 6 in PyTorch, in float32: (TSDF
    [Vz, Vy, Vx], color [Vz, Vy, Vx, 4]) with the clear values where no
    brick is occupied; with ``raw``, the block-major (TSDF [NB, 32, 128],
    color [NB, 4, 32, 128], visited bool[NB]) of ``block_major_bricks``.
    Syncs with the device once to read the occupied count."""
    _, h, w, _ = packed.shape
    basis = torch.as_tensor(_brick_basis(), device=packed.device)

    def chunk(bricks):
        return _brick_chunk(packed, coeffs, win_off, cls, bricks, basis, h, w, wy, wx,
                            xstride, limit)

    if raw:
        vx, vy, vz = res
        nb = (vx // BRICK) * (vy // BRICK) * (vz // BRICK)
        return block_major_bricks(chunk, idx, count, nb, PLAIN_CHUNK)
    return scatter_bricks(chunk, idx, count, res, limit, PLAIN_CHUNK)


def integrate_dense_plain(packed, coeffs, idx, count, win_off, cls, res,
                          wy, wx, xstride, limit):
    """PyTorch form of kernel 1 (see integrate_dense); takes the kernel's
    arguments."""
    tsdf, color = integrate_quadratic_plain(packed, coeffs, idx, count, win_off, cls, res,
                                            wy, wx, xstride, limit)
    return tsdf.to(torch.bfloat16), color.permute(0, 3, 1, 2).contiguous().to(torch.bfloat16)


_INTEGRATE_DENSE = native.Kernel(
    "integrate_dense",
    [native.P] * 10 + [native.I] * 10 + [native.F],
)


def quadratic_args(planes, coeffs, idx, count, slots, win_off, res):
    """Validate the inputs the kernels of ``csrc/integrate_dense.cu`` share;
    returns their pointers and (K, H, W, NB, nbx, nby, max_bricks)."""
    vx, vy, vz = res
    plane_a, plane_b = planes
    num_k, h, w, _ = plane_a.shape
    nb = (vx // BRICK) * (vy // BRICK) * (vz // BRICK)
    dev = plane_a.device
    native.check(plane_a, "plane_a", torch.float32, (num_k, h, w, 4), dev)
    native.check(plane_b, "plane_b", torch.float32, (num_k, h, w, 2), dev)
    native.check(coeffs, "coeffs", torch.float32, (num_k, nb, 4, NBASIS), dev)
    native.check(idx, "idx", torch.int32, None, dev)
    native.check(count, "count", torch.int32, (1,), dev)
    native.check(slots, "slots", torch.int32, (nb,), dev)
    native.check(win_off, "win_off", torch.int32, (num_k, nb, 2), dev)
    ptrs = [t.data_ptr() for t in (plane_a, plane_b, coeffs, idx, count, slots, win_off)]
    return ptrs, (num_k, h, w, nb, vx // BRICK, vy // BRICK, idx.shape[0])


def integrate_dense_cuda(planes, coeffs, idx, count, slots, win_off, cls, res, wy, wx,
                         xstride, limit):
    """Kernel 1 on the card (``csrc/integrate_dense.cu``): the arguments of
    ``integrate_dense_plain`` with the frame as ``tsdf_fast.pack_planes``
    gives it and the per-brick slot map ``slots``
    (``tsdf_fast.occupied_bricks``). One launch writes every output byte once;
    no host sync: the kernel reads the count from device memory."""
    vx, vy, vz = res
    ptrs, dims = quadratic_args(planes, coeffs, idx, count, slots, win_off, res)
    dev = coeffs.device
    if cls is not None:
        native.check(cls, "cls", torch.int32, (dims[0], dims[3]), dev)
    tsdf = torch.empty((vz, vy, vx), dtype=torch.bfloat16, device=dev)
    color = torch.empty((vz, 4, vy, vx), dtype=torch.bfloat16, device=dev)
    _INTEGRATE_DENSE(*ptrs, cls.data_ptr() if cls is not None else None, tsdf.data_ptr(),
                     color.data_ptr(), *dims, wy, wx, xstride, limit)
    return tsdf, color


def integrate_dense(frames, affine: AffineTables, cfg: TsdfConfig,
                    mask16: torch.Tensor, max_bricks: int, win_off: torch.Tensor,
                    wy: int, wx: int, xstride: int, cls: torch.Tensor | None = None):
    """Fused TSDF bf16[Vz, Vy, Vx] + z-major color bf16[Vz, 4, Vy, Vx] of the
    occupied 16^3 bricks of ``mask16`` (the first ``max_bricks`` in
    ascending order). ``win_off`` i32[K, NB, 2] window origins
    (win_offsets_affine at (wy, wx, xstride)); ``cls`` i32[K, NB] classes
    of block_depth_cull_baked or None (all FULL)."""
    vx, vy, vz = cfg.res
    if vx % 128 or vy % BRICK or vz % BRICK:
        raise ValueError(f"dense emit needs Vx % 128 == 0 and 16-aligned res, got {cfg.res}")
    idx, count, slots = occupied_bricks(mask16, max_bricks)
    if native.is_cuda(frames.depth):
        return integrate_dense_cuda(pack_planes(frames), affine.coeffs, idx, count, slots,
                                    win_off, cls, cfg.res, wy, wx, xstride, float(cfg.limit))
    return integrate_dense_plain(pack_frames(frames), affine.coeffs, idx, count, win_off, cls,
                                 cfg.res, wy, wx, xstride, float(cfg.limit))

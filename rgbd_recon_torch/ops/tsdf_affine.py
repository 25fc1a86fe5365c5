"""Per-brick quadratic warp coefficients, sampling windows and the
depth-band block cull (mirrors ``rgbd_recon_tpu/ops/tsdf_affine.py``).

Per (sensor, 16^3 brick) the voxel -> (u, v, d_norm) warp is the
least-squares QUADRATIC fit

    (u, v, d)(voxel) = C @ [1, lz, ly, lx, lz2, ly2, lx2, lzly, lzlx, lylx]

over the brick's clean voxels of the trilinearly resampled inverse
calibration volume (``bake_affine``, one brick-z slab at a time in float32
with TF32 off). The windows (``win_offsets_affine``, ``auto_window_rows``,
``auto_window_cols``) are TPU layout choices but they decide which pixels a
brick with an oversized footprint reads, so the port keeps them and the
integration kernel clamps to them exactly as the TPU kernel does.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.math import full_f32
from .tsdf import TsdfConfig
from .tsdf_fast import BRICK, IntegrationTables
from .warp import _gl_resize_weights_np

B3 = BRICK ** 3
NBASIS = 10


class AffineTables(NamedTuple):
    """coeffs f32[K, NB, 4, NBASIS] ([..., chan, basis], chan = (u, v, d,
    pad)); an all-invalid (sensor, brick) stores the constant u = -1 row.
    max_err f32[3]: max residual vs the resampled table over clean interior
    voxels; edge_err f32[3] over the excluded (clamp-shell, cliff) voxels;
    n_cliff: count of excluded table-valid voxels."""

    coeffs: torch.Tensor
    max_err: torch.Tensor
    edge_err: torch.Tensor
    n_cliff: torch.Tensor


def _brick_basis() -> np.ndarray:
    """f32[10, B3] quadratic basis on centered in-brick coordinates, voxel
    order z-major within the brick."""
    idx = np.arange(B3)
    lz = (idx // (BRICK * BRICK)).astype(np.float32) - (BRICK - 1) / 2.0
    ly = ((idx // BRICK) % BRICK).astype(np.float32) - (BRICK - 1) / 2.0
    lx = (idx % BRICK).astype(np.float32) - (BRICK - 1) / 2.0
    one = np.ones(B3, np.float32)
    return np.stack([one, lz, ly, lx, lz * lz, ly * ly, lx * lx,
                     lz * ly, lz * lx, ly * lx])


# normalized basis for a well-conditioned float32 Gram
_BASIS_SCALE = np.array(
    [1.0, 8.0, 8.0, 8.0, 64.0, 64.0, 64.0, 64.0, 64.0, 64.0], np.float32
)


def _solve(a: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve the float32 normal equations ``a`` [..., 10, 10] x = ``rhs``
    [..., 10, 3] in float64 and round the solution to float32: frustum-edge
    bricks with few clean voxels give ill-conditioned systems, where a
    float32 factorization's rounding (which differs between the CPU and the
    card) is amplified into the coefficients."""
    sol, _ = torch.linalg.solve_ex(a.double(), rhs.double())
    return sol.float()


def _lsq(f, m, basis):
    """Masked per-brick LSQ. f [K, nb, B3, 3]; m [K, nb, B3] weights;
    basis [NBASIS, B3]. Returns coeffs [K, nb, NBASIS, 3]."""
    nvalid = m.sum(dim=-1)
    mb = m[..., None, :] * basis                             # [K, nb, 10, B3]
    gram = torch.einsum("knav,bv->knab", mb, basis)
    rhs = torch.einsum("knav,knvc->knac", mb, f)
    eye = torch.eye(NBASIS, device=f.device)
    ridge = (1e-6 * torch.clamp(nvalid, min=1.0))[..., None, None] * eye
    return _solve(gram + ridge, rhs)


def _interior(n_src: int, n_dst: int) -> np.ndarray:
    """bool[n_dst]: voxels whose GL sample coordinate is not edge-clamped."""
    t = (np.arange(n_dst, dtype=np.float64) + 0.5) / n_dst
    c = t * n_src - 0.5
    return (c >= 0.0) & (c <= n_src - 1)


def _fit_slab(src, wd_slab, wh, ww, basis, interior):
    """Fit one brick-z slab. src f32[K, D, H, W, 3]; wd_slab f32[16, D];
    wh f32[Vy, H]; ww f32[Vx, W]; interior bool[nb_slab, B3]. Returns
    (coeffs f32[K, nb_slab, 4, NBASIS], err f32[3], edge_err f32[3],
    n_cliff)."""
    # 4th channel: off-frustum indicator — a voxel whose trilinear stencil
    # touches a (-1,-1,-1) marker texel is excluded from the fit
    src4 = torch.cat([src, (src[..., :1] < 0.0).to(torch.float32)], dim=-1)
    pos = torch.einsum("Dd,kdhwc->kDhwc", wd_slab, src4)
    pos = torch.einsum("Hh,kDhwc->kDHwc", wh, pos)
    pos = torch.einsum("Ww,kDHwc->kDHWc", ww, pos)
    k, _, vy, vx, _ = pos.shape
    nby, nbx = vy // BRICK, vx // BRICK
    f4 = pos.reshape(k, BRICK, nby, BRICK, nbx, BRICK, 4)
    f4 = f4.permute(0, 2, 4, 1, 3, 5, 6).reshape(k, nby * nbx, B3, 4)
    f = f4[..., :3]
    valid = f[..., 0] >= 0.0
    clean = valid & (f4[..., 3] < 1e-6) & interior[None]
    has_clean = clean.sum(dim=-1) >= 32
    scale = torch.as_tensor(_BASIS_SCALE, device=src.device)
    c_n = _lsq(f, clean.to(torch.float32), basis / scale[:, None])
    c = c_n / scale[None, None, :, None]

    c_empty = torch.zeros((NBASIS, 3), device=src.device)
    c_empty[0, 0] = -1.0
    bad = ~has_clean | ~torch.isfinite(c).all(dim=-1).all(dim=-1)
    c = torch.where(bad[..., None, None], c_empty, c)

    pred = torch.einsum("knac,av->knvc", c, basis)
    dev = (pred - f).abs()
    err = torch.where((clean & ~bad[..., None])[..., None], dev, 0.0).amax(dim=(0, 1, 2))
    edge_err = torch.where((valid & ~clean & ~bad[..., None])[..., None], dev,
                           0.0).amax(dim=(0, 1, 2))
    n_cliff = (valid & ~clean).sum()
    cm = c.permute(0, 1, 3, 2)                                 # [K, nb, 3, 10]
    cm = torch.cat([cm, torch.zeros_like(cm[:, :, :1])], dim=2)
    return cm, err, edge_err, n_cliff


def bake_affine(rig, cfg: TsdfConfig, device: torch.device | str = "cuda") -> AffineTables:
    """Per-brick quadratic warp coefficients for every sensor at the volume
    res, slab by slab on ``device`` (the dense table is never built)."""
    vx, vy, vz = cfg.res
    if vx % BRICK or vy % BRICK or vz % BRICK:
        raise ValueError(f"volume res {cfg.res} is not 16-aligned")
    nbz, nby, nbx = vz // BRICK, vy // BRICK, vx // BRICK
    src_np = np.asarray(rig.cv_xyz_inv, np.float32)
    src = torch.tensor(src_np, device=device)

    def t(a):
        return torch.as_tensor(a, device=device)

    wd = t(_gl_resize_weights_np(src_np.shape[1], vz))
    wh = t(_gl_resize_weights_np(src_np.shape[2], vy))
    ww = t(_gl_resize_weights_np(src_np.shape[3], vx))
    basis = t(_brick_basis())
    iy = _interior(src_np.shape[2], vy)
    ix = _interior(src_np.shape[3], vx)
    iz = _interior(src_np.shape[1], vz)
    iyx = (iy[:, None] & ix[None, :]).reshape(nby, BRICK, nbx, BRICK)
    iyx = iyx.transpose(0, 2, 1, 3).reshape(nby * nbx, BRICK * BRICK)

    coeffs, errs, eerrs, cliffs = [], [], [], []
    with full_f32():
        for bz in range(nbz):
            izb = iz[bz * BRICK:(bz + 1) * BRICK]
            interior = (izb[None, :, None] & iyx[:, None, :]).reshape(nby * nbx, B3)
            cm, err, eerr, ncl = _fit_slab(
                src, wd[bz * BRICK:(bz + 1) * BRICK], wh, ww, basis, t(interior))
            coeffs.append(cm)
            errs.append(err)
            eerrs.append(eerr)
            cliffs.append(ncl)
    return AffineTables(
        coeffs=torch.cat(coeffs, dim=1).contiguous(),
        max_err=torch.stack(errs).amax(dim=0),
        edge_err=torch.stack(eerrs).amax(dim=0),
        n_cliff=torch.stack(cliffs).sum(),
    )


def expand_affine(tables: AffineTables) -> IntegrationTables:
    """The quadratic model evaluated at every voxel: the dense block-major
    table (float32, TF32 off; a test oracle)."""
    basis = torch.as_tensor(_brick_basis(), device=tables.coeffs.device)
    with full_f32():
        pos = torch.einsum("knab,bv->knva", tables.coeffs[..., :3, :], basis)
    return IntegrationTables(pos_blocked=pos)


def _hull_basis() -> np.ndarray:
    """f32[NBASIS, 27]: the quadratic basis at the 27 points {-7.5, 0, 7.5}^3
    of a brick (footprint hull for window placement and sizing)."""
    g = np.array([-(BRICK - 1) / 2.0, 0.0, (BRICK - 1) / 2.0], np.float32)
    lz, ly, lx = [a.ravel() for a in np.meshgrid(g, g, g, indexing="ij")]
    return np.stack([np.ones_like(lz), lz, ly, lx, lz * lz, ly * ly,
                     lx * lx, lz * ly, lz * lx, ly * lx])


def win_offsets_affine(tables: AffineTables, h: int, w: int, wy: int, wx: int,
                       xstride: int, yalign: int = 8) -> torch.Tensor:
    """Per-brick per-sensor window selectors i32[K, NB, 2] (y_origin px,
    x block index): the origin aligns down from the footprint-hull minimum
    - 1 (y to ``yalign`` rows, x to the ``xstride`` block grid)."""
    wp = max(-(-w // xstride) * xstride, wx)
    nxb = (wp - wx) // xstride + 1
    hp = h if yalign == 8 else -(-h // yalign) * yalign
    sb = torch.as_tensor(_hull_basis()[: tables.coeffs.shape[-1]],
                         device=tables.coeffs.device)
    with full_f32():
        pts = torch.einsum("knca,as->kncs", tables.coeffs[..., :2, :], sb)
    u_min = pts[..., 0, :].amin(dim=-1) * w - 0.5
    v_min = pts[..., 1, :].amin(dim=-1) * h - 0.5
    xb = torch.clamp(torch.div(torch.floor(u_min).to(torch.int32) - 1, xstride,
                               rounding_mode="floor"), 0, nxb - 1)
    y8 = torch.clamp(
        torch.div(torch.floor(v_min).to(torch.int32) - 1, yalign,
                  rounding_mode="floor") * yalign,
        0, (hp - wy) & ~(yalign - 1))
    return torch.stack([y8, xb], dim=-1).to(torch.int32).contiguous()


def _footprint_extents(tables: AffineTables, chan: int, scale: int) -> np.ndarray:
    """Per valid (sensor, brick) footprint extent in px along ``chan``
    (0 = u, 1 = v), from the 27-point hull (host numpy, as the original)."""
    coeffs = tables.coeffs.detach().cpu().numpy()
    pts = coeffs[..., chan, :] @ _hull_basis()
    ext = (pts.max(-1) - pts.min(-1)) * scale
    return ext[coeffs[..., 0, 0] >= 0.0]


def auto_window_rows(tables: AffineTables, h: int, wy_max: int = 48,
                     wy_min: int = 16, quantile: float = 99.0) -> tuple[int, float]:
    """Integration window height from the bake: the ``quantile`` v extent of
    valid bricks + 10 (alignment + bilinear reach), 8-aligned, clamped to
    [wy_min, wy_max]. Returns (wy, fraction of valid bricks that clip)."""
    ev = _footprint_extents(tables, 1, h)
    if ev.size == 0:
        return wy_max, 0.0
    need = float(np.percentile(ev, quantile)) + 10.0
    wy = int(min(max(-(-int(np.ceil(need)) // 8) * 8, wy_min), wy_max))
    return wy, float((ev > wy - 10.0).mean())


def auto_window_cols(tables: AffineTables, w: int,
                     quantile: float = 99.0) -> tuple[int, int, float]:
    """Integration x window (wx, xstride, clip fraction): 32 px at stride 8
    or 4 when the ``quantile`` u extent fits, else 64 px at stride 16."""
    ev = _footprint_extents(tables, 0, w)
    if ev.size == 0:
        return 64, 16, 0.0
    p = float(np.percentile(ev, quantile))
    if p + 8.0 + 2.0 <= 32.0:
        return 32, 8, float((ev > 32 - 10.0).mean())
    if p + 4.0 + 2.0 <= 32.0:
        return 32, 4, float((ev > 32 - 6.0).mean())
    return 64, 16, float((ev > 64 - 18.0).mean())


class CullBake(NamedTuple):
    """Frame-invariant half of the depth-band cull ([K, NB] each)."""

    d_lo: torch.Tensor    # f32 brick depth band (hull -/+ lim margin)
    d_hi: torch.Tensor
    cya: torch.Tensor     # i32 covered depth-mip cell ranges
    cyb: torch.Tensor
    cxa: torch.Tensor
    cxb: torch.Tensor
    wide: torch.Tensor    # bool footprint exceeds the cell budget
    edge: torch.Tensor    # bool footprint leaves the image
    valid: torch.Tensor   # bool bake-valid (sensor, brick)


def bake_cull(tables: AffineTables, h: int, w: int, limit: float = 0.01,
              cell: int = 8, shifts: int = 5, margin: float = 1.25) -> CullBake:
    """Session bake of the cull's frame-invariant quantities."""
    lim = limit * margin
    ch, cw = -(-h // cell), -(-w // cell)
    sb = torch.as_tensor(_hull_basis(), device=tables.coeffs.device)
    with full_f32():
        pts = torch.einsum("knca,as->kncs", tables.coeffs[..., :3, :], sb)
    u_lo = pts[:, :, 0].amin(-1) * w - 0.5
    u_hi = pts[:, :, 0].amax(-1) * w - 0.5
    v_lo = pts[:, :, 1].amin(-1) * h - 0.5
    v_hi = pts[:, :, 1].amax(-1) * h - 0.5
    d_lo = pts[:, :, 2].amin(-1) - lim
    d_hi = pts[:, :, 2].amax(-1) + lim

    def cell_of(v, n):
        return torch.clamp(torch.floor(v / cell).to(torch.int32), 0, n - 1)

    cya, cyb = cell_of(v_lo - 1.0, ch), cell_of(v_hi + 1.0, ch)
    cxa, cxb = cell_of(u_lo - 1.0, cw), cell_of(u_hi + 1.0, cw)
    wide = ((u_hi - u_lo) > shifts * cell - 2) | ((v_hi - v_lo) > shifts * cell - 2)
    edge = (u_lo < 0.0) | (u_hi > w - 1.0) | (v_lo < 0.0) | (v_hi > h - 1.0)
    valid = tables.coeffs[..., 0, 0] >= 0.0
    return CullBake(d_lo, d_hi, cya, cyb, cxa, cxb, wide, edge, valid)


def block_depth_cull(mask16: torch.Tensor, tables: AffineTables, depth_n: torch.Tensor,
                     quality: torch.Tensor, silhouette: torch.Tensor | None = None,
                     limit: float = 0.01, cell: int = 8, shifts: int = 5,
                     margin: float = 1.25):
    """The depth-band cull without a session bake: ``bake_cull`` at the
    depth maps' size, then ``block_depth_cull_baked`` (the JAX function is
    the same bake-then-apply wrapper). Returns (mask16 & keep, keep, cls)."""
    h, w = depth_n.shape[1:]
    bake = bake_cull(tables, h, w, limit, cell, shifts, margin)
    return block_depth_cull_baked(mask16, bake, depth_n, quality, silhouette, limit, cell,
                                  shifts, margin)


def block_depth_cull_baked(mask16: torch.Tensor, bake: CullBake,
                           depth_n: torch.Tensor, quality: torch.Tensor,
                           silhouette: torch.Tensor | None = None,
                           limit: float = 0.01, cell: int = 8, shifts: int = 5,
                           margin: float = 1.25):
    """Per-frame depth-band cull of occupied 16^3 blocks (the reference's
    brick depth peel, recon_integration.cpp:408-428, applied to
    integration) and the per-(sensor, block) classes 0 FULL / 1 NONE /
    2 FRONT / 3 INVALID. Returns (mask16 & keep, keep, cls i32[K, NB]).
    Same decisions as the JAX function; its one-hot row/column matmuls are
    exact selections, done here by indexing."""
    nbz, nby, nbx = mask16.shape
    k, nb = bake.d_lo.shape
    h, w = depth_n.shape[1:]
    lim = limit * margin
    big = 1e9
    ch, cw = -(-h // cell), -(-w // cell)
    live = quality > 0.0

    def mip(x, fill, op):
        p = torch.nn.functional.pad(x, (0, cw * cell - w, 0, ch * cell - h), value=fill)
        p = p.reshape(k, ch, cell, cw, cell)
        return op(op(p, dim=4), dim=2)

    dmin = mip(torch.where(live, depth_n, big), big, torch.amin)
    dmax = mip(torch.where(live, depth_n, -big), -big, torch.amax)

    def range_reduce(m, op, fill):
        """op of m[k, cy, cx] over each block's covered cell rectangle
        (at most shifts x shifts cells)."""
        kk = torch.arange(k, device=m.device)[:, None]
        rows = None
        for i in range(shifts):
            r = torch.clamp(bake.cya + i, max=ch - 1).to(torch.int64)
            s = m[kk, r]                                      # [K, NB, cw]
            s = torch.where((bake.cya + i <= bake.cyb)[..., None], s, fill)
            rows = s if rows is None else op(rows, s)
        out = None
        for i in range(shifts):
            c = torch.clamp(bake.cxa + i, max=cw - 1).to(torch.int64)
            s = torch.gather(rows, 2, c[..., None])[..., 0]
            s = torch.where(bake.cxa + i <= bake.cxb, s, fill)
            out = s if out is None else op(out, s)
        return out

    wmin = range_reduce(dmin, torch.minimum, big)
    wmax = range_reduce(dmax, torch.maximum, -big)
    if silhouette is not None:
        strict = (live & (silhouette >= 1.0)).to(torch.float32)
        lmin = mip(strict, 0.0, torch.amin)
        full_live = range_reduce(lmin, torch.minimum, big) > 0.5
    else:
        full_live = torch.zeros((k, nb), dtype=torch.bool, device=depth_n.device)

    cd = depth_n[:, 0, 0]
    c_live = quality[:, 0, 0] > 0.0
    big_t = torch.full_like(cd, big)
    wmin = torch.where(bake.edge, torch.minimum(
        wmin, torch.where(c_live, cd, big_t)[:, None]), wmin)
    wmax = torch.where(bake.edge, torch.maximum(
        wmax, torch.where(c_live, cd, -big_t)[:, None]), wmax)

    band = (bake.d_hi >= wmin) & (bake.d_lo <= wmax)
    inv_live = c_live & (cd.abs() < lim)
    touch = torch.where(bake.valid, band | bake.wide, inv_live[:, None])
    keep = touch.any(dim=0).reshape(nbz, nby, nbx)

    safe = ~bake.wide & ~bake.edge & full_live
    cls = torch.zeros((k, nb), dtype=torch.int32, device=depth_n.device)
    cls = torch.where(safe & (wmax < bake.d_lo), 1, cls)
    cls = torch.where(safe & (wmin > bake.d_hi), 2, cls)
    cls = torch.where(~bake.valid, 3, cls).to(torch.int32)
    return mask16 & keep, keep, cls

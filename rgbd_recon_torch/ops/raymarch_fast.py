"""Sweep-composited TSDF renderer (mirrors ``rgbd_recon_tpu/ops/raymarch_fast.py``).

The ray march as a plane sweep: pick the volume axis most aligned with the
view, resample each slice onto a fixed intermediate grid (a separable
scale + translate for a pinhole camera: two hat-weight matrix products),
carry the per-ray hit state front to back (zero crossing + the shader's
secant refinement, fs:92-110), then warp the intermediate hit buffers to
the screen with the windowed warp (kernel 2) and shade.

The JAX sweep with the slab skip: slices of 16-voxel brick layers holding
no occupied brick are skipped, by flags in physical slice order from the
frame's brick mask, on the host (``slab_occupancy``, one sync a frame:
the staged frame) or on the device (``slab_occupancy_device``: the fused
frame, one CUDA graph). On the card ``sweep`` is one launch of the
hand-written kernel ``csrc/sweep_march.cu`` (``sweep_cuda``): the carry
in registers, each ray resampled at its non-zero hat taps, empty slices
skipped by the device flags, the camera's values read from device tensors
(``sweep_params``). ``sweep_plain`` is the same function in PyTorch, slice
by slice, and the CPU path: its resample is two hat-weight matrix
products with the JAX version's bf16 rounding of weights, slices and the
row-stage intermediate and float32 accumulation (TF32 off); given device
flags it resamples every slice and the flag selects the skip's values (as
JAX's ``lax.cond``). The kernel equals it bit for bit (up to the sign of
a zero): each stage of the products sums at most two non-zero exact
products. Two volume layouts, as the JAX sweep reads them: the dense
emit's z-major color [Vz, 4, Vy, Vx] (``zmajor=True``) and channels-last
color [Vz, Vy, Vx, 4] (the block-major and table integrators), each beside
a TSDF [Vz, Vy, Vx] in bf16 or f32. The TPU's 16-slice slab branch is not
ported.

The multi-card decomposition (``parallel/fast_sharded.py``) sweeps one
slab of the sweep axis per rank as a logical k-window (``SweepWindow``):
the window's carry starts from a 2-slice halo of the logically previous
slab, and the windows' hit planes fold front to back with ``merge_sweep``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import native
from ..utils.math import Bbox, device_const, full_f32, pmat
from .raymarch import RenderCamera, RenderOutput, RenderParams, phong_shade, vol_to_world_tensor
from .warp import warp_screen


class SweepConfig(NamedTuple):
    res: tuple[int, int] = (512, 512)  # intermediate grid (rows, cols)


def pick_axis(modelview: np.ndarray, vol_to_world: np.ndarray) -> tuple[int, bool]:
    """Sweep axis (0=x, 1=y, 2=z in volume space) and whether the camera
    sits on the high side. Host-side, on concrete matrices."""
    mv = np.asarray(modelview) @ np.asarray(vol_to_world)
    inv = np.linalg.inv(mv)
    eye = inv[:3, 3]
    fwd = -inv[:3, 2]
    axis = int(np.argmax(np.abs(fwd)))
    return axis, bool(eye[axis] > 0.5)


def _permutation(axis: int):
    """(coord_perm, array_perm): volume coords (x, y, z) -> sweep coords
    (s, r, c); vol array [z, y, x] -> [sweep, row, col]."""
    others = [a for a in (0, 1, 2) if a != axis]
    coord_perm = (axis, others[1], others[0])
    return coord_perm, tuple(2 - a for a in coord_perm)


def _hat_rows(coords: torch.Tensor, n: int) -> torch.Tensor:
    """[m, n] linear-interp weights; outside-volume samples read as 0."""
    i = torch.arange(n, dtype=torch.float32, device=coords.device)
    return torch.clamp(1.0 - (coords[:, None] - i).abs(), 0.0, 1.0)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


class SweepResult(NamedTuple):
    hit: torch.Tensor        # f32[Ti, Si] 0/1
    hit_s: torch.Tensor      # f32[Ti, Si] sweep coordinate of the refined hit
    hit_color: torch.Tensor  # f32[Ti, Si, 4]
    hit_grad: torch.Tensor   # f32[Ti, Si, 3] (sweep-coordinate order)
    base_extent: tuple       # (r0, r1, c0, c1) intermediate window, volume units
    eye_p: torch.Tensor      # eye in permuted coords
    num_samples: torch.Tensor  # f32[Ti, Si]


class SweepWindow(NamedTuple):
    """A logical k-window of the sweep over a LOCAL slab of the sweep axis
    (JAX ``raymarch_fast.SweepWindow``). The only state the sweep carries
    from slice to slice is (prev_d, prev_c, prev_g), and prev_g's sweep
    component needs the density one slice further back, so the window's
    carry is rebuilt from the two slices before it.

    k0: logical start slice; ns_total: the global slice count;
    halo_d2 / halo_d1: density slices [R, C] at logical k0-2 / k0-1 (in
    the sweep's permuted frame); halo_c1: the color slice [4, R, C] at
    k0-1; halo_valid: False when k0 == 0 (the clear-value start). As in
    JAX, the start reads the halo slices whether or not their brick layer
    was skipped (ROADMAP queue 3)."""

    k0: int
    ns_total: int
    halo_d2: torch.Tensor
    halo_d1: torch.Tensor
    halo_c1: torch.Tensor
    halo_valid: bool


def merge_sweep(near: SweepResult, far: SweepResult) -> SweepResult:
    """Front-to-back composition of two adjacent sweep windows: the nearer
    window's hit wins, rays still active take the farther window's state.
    Associative; fold in logical k order."""
    h = near.hit > 0.5
    return SweepResult(
        hit=torch.maximum(near.hit, far.hit),
        hit_s=torch.where(h, near.hit_s, far.hit_s),
        hit_color=torch.where(h[..., None], near.hit_color, far.hit_color),
        hit_grad=torch.where(h[..., None], near.hit_grad, far.hit_grad),
        base_extent=near.base_extent,
        eye_p=near.eye_p,
        num_samples=near.num_samples + torch.where(h, 0.0, far.num_samples),
    )


def sweep_planes(tsdf: torch.Tensor, cvol: torch.Tensor, axis: int,
                 zmajor: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """The volumes in the sweep's frame, as views: density [S, R, C] and
    color [S, 4, R, C] (S the sweep axis); ``cvol`` z-major or, with
    ``zmajor=False``, channels-last."""
    array_perm = _permutation(axis)[1]
    if zmajor:
        m = {0: 0, 1: 2, 2: 3}
        col = cvol.permute((m[array_perm[0]], 1, m[array_perm[1]], m[array_perm[2]]))
    else:
        col = cvol.permute((array_perm[0], 3, array_perm[1], array_perm[2]))
    return tsdf.permute(array_perm), col


class SweepGrid(NamedTuple):
    """The camera's part of a sweep, on the camera's device: the eye in
    permuted coordinates, the base plane's divisor, the intermediate
    grid's extents (g_lo, g_hi: rows, cols) and sample positions, and the
    doubled grid steps of the in-plane gradient."""

    eye_p: torch.Tensor    # f32[3]
    denom: torch.Tensor    # f32[]
    g_lo: torch.Tensor     # f32[2]
    g_hi: torch.Tensor     # f32[2]
    r_grid: torch.Tensor   # f32[Ti]
    c_grid: torch.Tensor   # f32[Si]
    dr2: torch.Tensor      # f32[]
    dc2: torch.Tensor      # f32[]


def sweep_grid(cam: RenderCamera, bbox: Bbox, axis: int, flip: bool, ns: int,
               res: tuple[int, int]) -> SweepGrid:
    """The sweep's camera values for ``ns`` global slices on a ``res``
    grid, by tensor ops on the camera's device (no host copy: a captured
    frame replays them with each frame's modelview)."""
    dev = cam.modelview.device
    coord_perm, _ = _permutation(axis)
    v2w = vol_to_world_tensor(bbox, dev)
    with full_f32():     # inv_ex: inv's numbers without its host-side singularity check
        inv = torch.linalg.inv_ex(pmat(cam.modelview, v2w)).inverse
    eye = inv[:3, 3]
    eye_p = torch.stack([eye[coord_perm[0]], eye[coord_perm[1]], eye[coord_perm[2]]])
    if flip:
        eye_p = torch.stack([1.0 - eye_p[0], eye_p[1], eye_p[2]])

    s0 = 0.5 / ns
    es = eye_p[0]
    denom = torch.where((s0 - es).abs() < 1e-6, 1e-6, s0 - es)
    lo, hi = [], []
    for sk in (0.5 / ns, 1.0 - 0.5 / ns):
        sigma = (sk - es) / denom
        lo.append(eye_p[1:] + (0.0 - eye_p[1:]) / sigma)
        hi.append(eye_p[1:] + (1.0 - eye_p[1:]) / sigma)
    allpts = torch.stack(lo + hi)
    g_lo = torch.clamp(allpts.amin(dim=0), -1.0, 2.0)
    g_hi = torch.clamp(allpts.amax(dim=0), -1.0, 2.0)
    ti, si = res
    ar_t = (torch.arange(ti, dtype=torch.float32, device=dev) + 0.5) / ti
    ar_s = (torch.arange(si, dtype=torch.float32, device=dev) + 0.5) / si
    r_grid = g_lo[0] + ar_t * (g_hi[0] - g_lo[0])
    c_grid = g_lo[1] + ar_s * (g_hi[1] - g_lo[1])
    dr2 = 2.0 * (r_grid[1] - r_grid[0])
    dc2 = 2.0 * (c_grid[1] - c_grid[0])
    return SweepGrid(eye_p, denom, g_lo, g_hi, r_grid, c_grid, dr2, dc2)


def _sigma_of(grid: SweepGrid, k: int, ns: int):
    """Logical slice ``k``'s sweep coordinate s_k (a Python double) and its
    scale sigma = (s_k - e_s) / denom about the eye."""
    s_k = (k + 0.5) * (1.0 / ns)
    return s_k, (s_k - grid.eye_p[0]) / grid.denom


def _resample(grid: SweepGrid, sl_d, sl_c, sigma, res):
    """[5, Ti, Si] (density, rgba) of a slice pair ([R, C], [4, R, C]) at
    p = e + sigma (g - e)."""
    ti, si = res
    nr, nc = sl_d.shape
    pr = grid.eye_p[1] + sigma * (grid.r_grid - grid.eye_p[1])
    pc = grid.eye_p[2] + sigma * (grid.c_grid - grid.eye_p[2])
    wr = _bf16(_hat_rows(pr * nr - 0.5, nr))         # [Ti, R]
    wc = _bf16(_hat_rows(pc * nc - 0.5, nc))         # [Si, C]
    bf16 = torch.bfloat16
    both = torch.cat([sl_d[None].to(bf16), sl_c.to(bf16)], 0).to(torch.float32)
    with full_f32():
        t = wr @ both.permute(1, 0, 2).reshape(nr, 5 * nc)          # [Ti, 5C]
        out = _bf16(t).reshape(ti * 5, nc) @ wc.T                   # [5Ti, Si]
    return out.reshape(ti, 5, si).permute(1, 0, 2)


def _gradient(grid: SweepGrid, d, prev_d, sigma, ds: float):
    gr = (torch.roll(d, -1, 0) - torch.roll(d, 1, 0)) / (grid.dr2 * sigma + 1e-12)
    gc = (torch.roll(d, -1, 1) - torch.roll(d, 1, 1)) / (grid.dc2 * sigma + 1e-12)
    return torch.stack([(d - prev_d) / ds, gr, gc], dim=0)


def _window_carry(grid: SweepGrid, window: SweepWindow, res):
    """The windowed start: the carry (prev_d, prev_c, prev_g) as of logical
    k0, rebuilt from the halo slices at k0-1 and k0-2 by the resample's
    arithmetic."""
    _, sg1 = _sigma_of(grid, window.k0 - 1, window.ns_total)
    _, sg2 = _sigma_of(grid, window.k0 - 2, window.ns_total)
    smp1 = _resample(grid, window.halo_d1, window.halo_c1, sg1, res)
    d2 = _resample(grid, window.halo_d2, torch.zeros_like(window.halo_c1), sg2, res)[0]
    prev_d = smp1[0]
    prev_g = _gradient(grid, prev_d, d2, sg1, 1.0 / window.ns_total)
    return prev_d, smp1[1:5].to(torch.bfloat16), prev_g.to(torch.bfloat16)


def _extent(tsdf, cvol, axis: int, flip: bool, zmajor: bool, window: SweepWindow | None):
    """(vol, col, ns, k0, p0) of ``sweep``'s arguments: the sweep-frame
    views, the global slice count, the logical start and the physical index
    of the slab's first slice in the global volume (logical k -> global
    physical ns-1-k when flipped)."""
    vol, col = sweep_planes(tsdf, cvol, axis, zmajor)
    ns_local = vol.shape[0]
    ns = window.ns_total if window is not None else ns_local
    k0 = window.k0 if window is not None else 0
    p0 = (ns - k0 - ns_local) if flip else k0
    return vol, col, ns, k0, p0


def sweep_plain(tsdf: torch.Tensor, cvol: torch.Tensor, cam: RenderCamera, bbox: Bbox,
                limit: float, axis: int, flip: bool, cfg: SweepConfig = SweepConfig(),
                slab_occupied: np.ndarray | torch.Tensor | None = None,
                zmajor: bool = True, window: SweepWindow | None = None) -> SweepResult:
    """``sweep`` in PyTorch, slice by slice: each slice resampled by two
    hat-weight matrix products, the carry as [Ti, Si] tensors. A host
    ``slab_occupied`` skips the empty slices; a device tensor gates them
    (every slice resampled, the flag selecting the skip's values)."""
    dev = tsdf.device
    vol, col, ns, k0, p0 = _extent(tsdf, cvol, axis, flip, zmajor, window)
    ns_local = vol.shape[0]
    res = cfg.res
    grid = sweep_grid(cam, bbox, axis, flip, ns, res)
    ti, si = res
    ds = 1.0 / ns
    bf16 = torch.bfloat16

    hit_s = torch.full((ti, si), -1.0, device=dev)
    hit_c = torch.zeros((4, ti, si), dtype=bf16, device=dev)
    hit_g = torch.zeros((3, ti, si), dtype=bf16, device=dev)
    nsamp = torch.zeros((ti, si), device=dev)
    prev_clear = (torch.full((ti, si), -limit, device=dev),
                  torch.zeros((4, ti, si), dtype=bf16, device=dev),
                  torch.zeros((3, ti, si), dtype=bf16, device=dev))
    prev_d, prev_c, prev_g = prev_clear
    if window is not None and window.halo_valid:
        prev_d, prev_c, prev_g = _window_carry(grid, window, res)
    gated = isinstance(slab_occupied, torch.Tensor)
    for k in range(k0, k0 + ns_local):
        k_phys = ((ns - 1 - k) if flip else k) - p0
        active = hit_s < 0.0
        if slab_occupied is not None and not gated and not slab_occupied[k_phys]:
            # an empty slice: no crossing, the carry decays to the clear values
            nsamp = nsamp + active.to(torch.float32)
            prev_d, prev_c, prev_g = prev_clear
            continue
        s_k, sigma = _sigma_of(grid, k, ns)
        smp = _resample(grid, vol[k_phys], col[k_phys], sigma, res)
        d = smp[0]
        c = smp[1:5]
        g = _gradient(grid, d, prev_d, sigma, ds)
        crossed = active & (d > 0.0) & (k > 0)
        if gated:           # an empty slice crosses nothing
            on = slab_occupied[k_phys]
            crossed = crossed & on
        den = d - prev_d
        frac = prev_d / torch.where(den.abs() > 1e-20, den, 1e-20)
        s_hit = s_k - ds - ds * frac
        alpha = torch.clamp(-frac, 0.0, 1.0)
        c_hit = prev_c.to(torch.float32) + (c - prev_c.to(torch.float32)) * alpha[None]
        g_hit = prev_g.to(torch.float32) + (g - prev_g.to(torch.float32)) * alpha[None]
        hit_s = torch.where(crossed, s_hit, hit_s)
        hit_c = torch.where(crossed[None], c_hit.to(bf16), hit_c)
        hit_g = torch.where(crossed[None], g_hit.to(bf16), hit_g)
        nsamp = nsamp + active.to(torch.float32)
        prev_d, prev_c, prev_g = d, c.to(bf16), g.to(bf16)
        if gated:           # ... and decays the carry to the clear values
            prev_d, prev_c, prev_g = (torch.where(on, p, q) for p, q in
                                      zip((prev_d, prev_c, prev_g), prev_clear))

    hit = (hit_s >= 0.0).to(torch.float32)
    return SweepResult(
        hit, torch.clamp(hit_s, min=0.0),
        hit_c.to(torch.float32).permute(1, 2, 0),
        hit_g.to(torch.float32).permute(1, 2, 0),
        (grid.g_lo[0], grid.g_hi[0], grid.g_lo[1], grid.g_hi[1]), grid.eye_p, nsamp,
    )


class SweepParams(NamedTuple):
    """The kernel's per-slice inputs, f32[n] on the device for the logical
    slices k0..k0+n-1, each the twin's own value: sigma; s_back = s_k - ds
    (a double in the twin, rounded once); the gradient's divisors
    dr2 * sigma + 1e-12 and dc2 * sigma + 1e-12. ``ds`` is the twin's
    1 / ns as the float32 its products see."""

    grid: SweepGrid
    sigma: torch.Tensor
    s_back: torch.Tensor
    grad_r: torch.Tensor
    grad_c: torch.Tensor
    ds: float


def sweep_params(cam: RenderCamera, bbox: Bbox, axis: int, flip: bool, ns: int, k0: int,
                 n: int, res: tuple[int, int]) -> SweepParams:
    """What ``sweep_cuda`` packs for the kernel: the grid and the per-slice
    values, by tensor ops on the device from the camera (no host float of
    the camera reaches the kernel); the slices' s_k and s_k - ds are
    constants of (ns, k0, n), made once per device."""
    grid = sweep_grid(cam, bbox, axis, flip, ns, res)
    dev = grid.eye_p.device
    ds = 1.0 / ns
    s_k = device_const(tuple((k + 0.5) * ds for k in range(k0, k0 + n)), dev)
    s_back = device_const(tuple((k + 0.5) * ds - ds for k in range(k0, k0 + n)), dev)
    sigma = (s_k - grid.eye_p[0]) / grid.denom
    return SweepParams(grid, sigma, s_back, grid.dr2 * sigma + 1e-12,
                       grid.dc2 * sigma + 1e-12, float(np.float32(ds)))


_SWEEP_MARCH = native.Kernel(
    "sweep_march",
    [native.P] * 18 + [native.I64] * 7 + [native.I] * 11 + [native.F] * 2,
)


def sweep_cuda(tsdf: torch.Tensor, cvol: torch.Tensor, cam: RenderCamera, bbox: Bbox,
               limit: float, axis: int, flip: bool, cfg: SweepConfig = SweepConfig(),
               slab_occupied: np.ndarray | torch.Tensor | None = None,
               zmajor: bool = True, window: SweepWindow | None = None) -> SweepResult:
    """``sweep`` on the card: one launch of ``csrc/sweep_march.cu`` over
    the whole sweep, the carry in registers, empty slices skipped by the
    flags read on the device; the arguments of ``sweep_plain`` and its
    result bit for bit (up to the sign of a zero)."""
    dev = tsdf.device
    vol, col, ns, k0, p0 = _extent(tsdf, cvol, axis, flip, zmajor, window)
    ns_local, nr, nc = vol.shape
    ti, si = cfg.res
    for name, t in (("tsdf", vol), ("cvol", col)):
        if t.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"sweep kernel: {name} dtype {t.dtype}, takes bfloat16 or float32")
        if t.device != dev:
            raise ValueError(f"sweep kernel: {name} on {t.device}, expected {dev}")
    if tuple(col.shape) != (ns_local, 4, nr, nc):
        raise ValueError(f"sweep kernel: color {tuple(col.shape)} beside tsdf {tuple(vol.shape)}")
    prm = sweep_params(cam, bbox, axis, flip, ns, k0, ns_local, cfg.res)
    g = prm.grid
    flags = None
    if slab_occupied is not None:      # the kernel reads torch's one-byte bools
        flags = torch.as_tensor(slab_occupied, device=dev).contiguous()
        native.check(flags, "slab_occupied", torch.bool, (ns_local,), dev)
    init = (None, None, None)
    if window is not None and window.halo_valid:
        init = tuple(t.contiguous() for t in _window_carry(g, window, cfg.res))
    hit = torch.empty((ti, si), dtype=torch.float32, device=dev)
    hit_s = torch.empty_like(hit)
    nsamp = torch.empty_like(hit)
    hit_color = torch.empty((ti, si, 4), dtype=torch.float32, device=dev)
    hit_grad = torch.empty((ti, si, 3), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    consts = (g.r_grid, g.c_grid, g.eye_p, prm.sigma, prm.s_back, prm.grad_r, prm.grad_c)
    _SWEEP_MARCH(vol.data_ptr(), col.data_ptr(), ptr(flags), *(t.data_ptr() for t in consts),
                 *(ptr(t) for t in init), hit.data_ptr(), hit_s.data_ptr(),
                 hit_color.data_ptr(), hit_grad.data_ptr(), nsamp.data_ptr(),
                 *vol.stride(), *col.stride(), ns_local, nr, nc, ti, si, ns, k0, p0, int(flip),
                 int(vol.dtype == torch.float32), int(col.dtype == torch.float32),
                 prm.ds, float(np.float32(-limit)))
    return SweepResult(hit, hit_s, hit_color, hit_grad,
                       (g.g_lo[0], g.g_hi[0], g.g_lo[1], g.g_hi[1]), g.eye_p, nsamp)


def sweep(tsdf: torch.Tensor, cvol: torch.Tensor, cam: RenderCamera, bbox: Bbox,
          limit: float, axis: int, flip: bool, cfg: SweepConfig = SweepConfig(),
          slab_occupied: np.ndarray | torch.Tensor | None = None,
          zmajor: bool = True, window: SweepWindow | None = None) -> SweepResult:
    """Front-to-back sweep along ``axis``. ``tsdf`` [Vz, Vy, Vx] and the
    color volume ``cvol``: Z-MAJOR [Vz, 4, Vy, Vx] (the dense-emit layout)
    or, with ``zmajor=False``, channels-last [Vz, Vy, Vx, 4];
    ``slab_occupied`` bool[n_slices] in physical slice order, a host array
    or a device tensor (``slab_occupancy_device``, no host sync): an empty
    slice crosses nothing and decays the carry to the clear values.

    ``window``: sweep only a logical k-window over a local slab
    (``SweepWindow``): ``tsdf``/``cvol`` then hold the slab's slices
    (physically contiguous), ``slab_occupied`` the slab's flags, and the
    result folds with ``merge_sweep``. The grid extents and the step use
    the global slice count.

    A CUDA volume takes the kernel (``sweep_cuda``), a CPU one the plain
    version (``sweep_plain``)."""
    run = sweep_cuda if native.is_cuda(tsdf) else sweep_plain
    return run(tsdf, cvol, cam, bbox, limit, axis, flip, cfg, slab_occupied, zmajor, window)


def screen_tile(h: int, w: int, ti: int, si: int):
    """The screen-warp tile of ``raymarch_fast.py:538-545``: the largest
    dividing tile, taken when the TPU kernel accepts it (pixel count a
    multiple of 1024, source footprint within one 128-px window)."""
    th = next((t for t in (48, 24, 16, 8) if h % t == 0), None)
    tw = next((t for t in (128, 64, 32) if w % t == 0), None)
    if (th is not None and tw is not None and (th * tw) % 1024 == 0
            and math.ceil(tw * si / w * 1.5) + 16 <= 128):
        return th, tw
    return None


def _taps(packed: torch.Tensor, fr: torch.Tensor, fc: torch.Tensor) -> torch.Tensor:
    """Exact per-pixel bilinear taps (render sizes no tile fits)."""
    ti, si, ch = packed.shape
    i0f, j0f = torch.floor(fr), torch.floor(fc)
    ff = torch.clamp(fr - i0f, 0.0, 1.0)[..., None]
    gg = torch.clamp(fc - j0f, 0.0, 1.0)[..., None]
    i0, j0 = i0f.to(torch.int64), j0f.to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=ti - 1)
    j1 = torch.clamp(j0 + 1, max=si - 1)
    flat = packed.reshape(ti * si, ch)
    return (flat[i0 * si + j0] * (1 - ff) * (1 - gg) + flat[i0 * si + j1] * (1 - ff) * gg
            + flat[i1 * si + j0] * ff * (1 - gg) + flat[i1 * si + j1] * ff * gg)


def shade_sweep(res: SweepResult, cam: RenderCamera, bbox: Bbox, axis: int,
                flip: bool, ns_vox: int, params: RenderParams = RenderParams(),
                cfg: SweepConfig = SweepConfig()) -> RenderOutput:
    """Screen warp + shading of a SweepResult (the post-sweep half of
    render_fast)."""
    dev = res.hit.device
    coord_perm, _ = _permutation(axis)
    ti, si = cfg.res
    v2w = vol_to_world_tensor(bbox, dev)
    with full_f32():
        inv = torch.linalg.inv_ex(pmat(cam.proj, pmat(cam.modelview, v2w))).inverse
    w, h = cam.width, cam.height
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w * 2.0 - 1.0
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h * 2.0 - 1.0
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    one = torch.ones_like(xx)
    pn = pmat(torch.stack([xx, yy, -one, one], -1), inv.T)
    pf = pmat(torch.stack([xx, yy, one, one], -1), inv.T)
    d = pf[..., :3] / pf[..., 3:4] - pn[..., :3] / pn[..., 3:4]

    eye_p = res.eye_p
    d_p = torch.stack([d[..., coord_perm[0]], d[..., coord_perm[1]],
                       d[..., coord_perm[2]]], -1)
    if flip:
        d_p = torch.cat([-d_p[..., :1], d_p[..., 1:]], -1)
    d0 = torch.where(d_p[..., 0].abs() < 1e-9, 1e-9, d_p[..., 0])
    s0 = 0.5 / ns_vox
    t_base = (s0 - eye_p[0]) / d0
    g_r = eye_p[1] + t_base * d_p[..., 1]
    g_c = eye_p[2] + t_base * d_p[..., 2]
    r0, r1, c0, c1 = res.base_extent
    fr = (g_r - r0) / (r1 - r0) * ti - 0.5
    fc = (g_c - c0) / (c1 - c0) * si - 0.5

    hit = res.hit[..., None]
    # [Ti, Si, 12]: 9 channels and 3 of padding, the warp kernel's aligned taps
    packed = torch.cat([hit, res.hit_s[..., None] * hit, res.hit_color * hit,
                        res.hit_grad * hit, torch.zeros_like(res.hit_grad)], dim=-1)
    fr_cl = torch.clamp(fr, 0.0, ti - 1.0).contiguous()
    fc_cl = torch.clamp(fc, 0.0, si - 1.0).contiguous()
    tile = screen_tile(h, w, ti, si)
    if tile is not None:
        warped = warp_screen(packed, fr_cl, fc_cl, tile, channels=9)
    else:
        warped = _taps(packed[..., :9], fr_cl, fc_cl)
    wmask = warped[..., 0]
    hit = wmask > 0.5
    norm = torch.clamp(wmask, min=1e-6)[..., None]
    hit_s = warped[..., 1:2] / norm
    rgba = warped[..., 2:6] / norm
    grad_p = warped[..., 6:9] / norm

    t_hit = (hit_s[..., 0] - eye_p[0]) / d0
    pos_p = eye_p + d_p * t_hit[..., None]
    comps = [None, None, None]
    comps[coord_perm[0]] = (1.0 - pos_p[..., 0]) if flip else pos_p[..., 0]
    comps[coord_perm[1]] = pos_p[..., 1]
    comps[coord_perm[2]] = pos_p[..., 2]
    pos = torch.stack(comps, dim=-1)
    g = [None, None, None]
    g[coord_perm[0]] = -grad_p[..., 0] if flip else grad_p[..., 0]
    g[coord_perm[1]] = grad_p[..., 1]
    g[coord_perm[2]] = grad_p[..., 2]
    nvol = -torch.stack(g, dim=-1)
    nn = torch.linalg.vector_norm(nvol, dim=-1, keepdim=True)
    nvol = nvol / torch.where(nn < 1e-20, 1.0, nn)

    normal_view = pmat(nvol, cam.modelview[:3, :3].T)
    nn2 = torch.linalg.vector_norm(normal_view, dim=-1, keepdim=True)
    normal_view = normal_view / torch.where(nn2 < 1e-20, 1.0, nn2)
    mvw = pmat(cam.modelview, v2w)
    view_pos = pmat(pos, mvw[:3, :3].T) + mvw[:3, 3]
    if params.shade_mode == 1:
        rgba = torch.cat([phong_shade(view_pos, normal_view), rgba[..., 3:4]], -1)
    elif params.shade_mode == 2:
        rgba = torch.cat([nvol, rgba[..., 3:4]], -1)

    z = view_pos[..., 2]
    zs = torch.where(z.abs() < 1e-20, -1e-20, z)
    frag_depth = (cam.proj[2, 2] * z + cam.proj[2, 3]) / -zs * 0.5 + 0.5
    miss = ~hit
    rgba = torch.where(miss[..., None], 0.0, rgba)
    frag_depth = torch.where(miss, 1.0, frag_depth)
    nsamp = torch.zeros((h, w), dtype=torch.int32, device=dev)
    return RenderOutput(rgba, frag_depth, hit, nsamp)


def render_fast(tsdf: torch.Tensor, cvol: torch.Tensor, cam: RenderCamera,
                bbox: Bbox, limit: float, axis: int, flip: bool,
                params: RenderParams = RenderParams(), cfg: SweepConfig = SweepConfig(),
                slab_occupied: np.ndarray | torch.Tensor | None = None,
                zmajor: bool = True) -> RenderOutput:
    """Sweep + screen warp + shading (shade modes 0/1/2); ``slab_occupied``
    and ``zmajor`` as in ``sweep``."""
    res = sweep(tsdf, cvol, cam, bbox, limit, axis, flip, cfg, slab_occupied, zmajor)
    return shade_sweep(res, cam, bbox, axis, flip, tsdf.shape[2 - axis], params, cfg)


def slab_occupancy_device(mask16: torch.Tensor, axis: int, n_slices: int) -> torch.Tensor:
    """Per-slice occupancy flags along the sweep axis from the 16^3 brick
    mask: bool[n_slices] on the mask's device, no host sync (the fused
    frame's form)."""
    array_axis = 2 - axis
    other = tuple(a for a in range(3) if a != array_axis)
    per_block = mask16.any(dim=other[1]).any(dim=other[0])
    nb = per_block.shape[0]
    if n_slices % nb != 0:
        raise ValueError(
            f"slab_occupancy: {n_slices} slices not divisible by "
            f"{nb} brick layers along axis {axis}")
    return per_block[:, None].expand(nb, n_slices // nb).reshape(n_slices)


def slab_occupancy(mask16: torch.Tensor, axis: int, n_slices: int) -> np.ndarray:
    """``slab_occupancy_device`` read back: host bool[n_slices] (one device
    sync per frame; the staged frame skips the empty slices)."""
    return slab_occupancy_device(mask16, axis, n_slices).cpu().numpy()

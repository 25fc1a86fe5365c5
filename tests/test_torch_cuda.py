"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a GPU. The file
imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest`` because tests/conftest.py configures JAX).
"""
import types

import numpy as np
import pytest
import torch

from rgbd_recon_torch import native
from rgbd_recon_torch.calibration import synthetic
from rgbd_recon_torch.ops import assemble, bricks, inpaint, preprocess as pp
from rgbd_recon_torch.ops import tsdf_dense, tsdf_persist, tsdf_sparse
from rgbd_recon_torch.ops.tsdf_fast import occupied_bricks, occupied_list, pack_frames, pack_planes
from rgbd_recon_torch.ops.warp import (NEIGHBORHOOD, piecewise_eval_cuda, piecewise_eval_plain,
                                       warp_screen_cuda, warp_screen_plain, warp_windows)
from rgbd_recon_torch.runtime.pipeline import FramePipeline, PipelineConfig
from rgbd_recon_torch.utils.math import Bbox

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _small_pipeline(device, n=128, **over):
    bbox = Bbox.default()
    rig, cams = synthetic.synthetic_rig(num_sensors=3, bbox=bbox, fwd_res=(48, 64, 48),
                                        inv_res=(48, 48, 48), width=256, height=208)
    depth, color = synthetic.render_frames(cams, synthetic.SphereScene.default(bbox))
    cfg = PipelineConfig(render_width=320, render_height=240, tsdf_res=(n, n, n),
                         voxel_size=float(np.max(bbox.size) / n), sweep_res=(256, 256),
                         **over)
    pipe = FramePipeline(rig, cfg, device=device)
    mv, proj = pipe.default_camera()
    return pipe, depth, color, mv, proj


def test_bilateral_accum_cuda(dev):
    """Tolerance atol 2e-4, rtol 2e-5: the TPU kernel's bound against its
    plain form (tests/test_preprocess_pallas.py:41); sums in another order."""
    rng = np.random.default_rng(1)
    depth = (0.6 + 3.0 * rng.random((3, 61, 197))).astype(np.float32)   # ragged tiles
    depth[rng.random(depth.shape) < 0.1] = 0.0
    limits = np.array([[0.5, 4.5], [0.6, 4.0], [0.5, 3.0]], np.float32)
    d, lim = torch.from_numpy(depth).to(dev), torch.from_numpy(limits).to(dev)
    for g, p in zip(pp.bilateral_accum(d, lim), pp.bilateral_accum_plain(d, lim)):
        torch.testing.assert_close(g, p, atol=2e-4, rtol=2e-5)


def test_bilateral_accum_cuda_ragged_wide_range(dev):
    """The column-per-thread tiling: tiles ragged in both directions
    (213 = 13 * 16 + 5 rows, 301 = 9 * 32 + 13 columns),
    depths over 0.2-9 m with wide limits, so the range windows 0.35 d / 4.5
    span 16-700 mm. Tolerance as test_bilateral_accum_cuda."""
    rng = np.random.default_rng(5)
    depth = (0.2 + 8.8 * rng.random((2, 213, 301)) ** 2).astype(np.float32)
    depth[:, 100:140, 50:90] += np.linspace(0, 3, 40, dtype=np.float32)[None, :, None]
    depth[rng.random(depth.shape) < 0.05] = 0.0
    limits = np.array([[0.1, 12.0], [0.5, 6.0]], np.float32)
    d, lim = torch.from_numpy(depth).to(dev), torch.from_numpy(limits).to(dev)
    before = native.KERNELS["bilateral_accum"].launches
    got = pp.bilateral_accum(d, lim)
    assert native.KERNELS["bilateral_accum"].launches == before + 1
    for g, p in zip(got, pp.bilateral_accum_plain(d, lim)):
        torch.testing.assert_close(g, p, atol=2e-4, rtol=2e-5)


@pytest.mark.parametrize("brick_size", [0.1, 0.02])
def test_mark_bricks_cuda(dev, brick_size):
    """Integer-exact. brick_size 0.02 gives 1.1 M bins: the global-atomic
    variant of the kernel."""
    rng = np.random.default_rng(2)
    bbox = Bbox.default()
    world = (bbox.min + rng.random((200_000, 3)) * bbox.size * 1.2 - 0.1 * bbox.size)
    valid = rng.random(200_000) > 0.3
    grid = bricks.make_brick_grid(bbox, brick_size, 0.01)
    w = torch.from_numpy(world.astype(np.float32)).to(dev)
    v = torch.from_numpy(valid).to(dev)
    got = bricks.mark_bricks(w, v, grid).to(torch.int64)
    assert torch.equal(got, bricks.mark_bricks_plain(w, v, grid).to(torch.int64))
    assert int(got.sum()) > 0


def _smooth_points(n_rows, width, rng):
    """World points of a smooth depth image (a tilted, gently curved
    surface seen row by row), so neighbouring pixels share a brick as a
    sensor's rows do; 5% invalid."""
    bbox = Bbox.default()
    v, u = np.meshgrid(np.linspace(0, 1, n_rows), np.linspace(0, 1, width), indexing="ij")
    p = np.stack([u, v, 0.3 + 0.4 * u + 0.05 * np.sin(6 * v)], -1)
    world = (bbox.min + p * bbox.size).reshape(-1, 3)
    return world, rng.random(world.shape[0]) > 0.05


@pytest.mark.parametrize("case", ["smooth", "one_brick", "ragged"])
def test_mark_bricks_cuda_contention(dev, case):
    """Integer-exact where the warp aggregation and each block's 64-entry
    bin cache in shared memory matter: points of a smooth depth image
    (warps share bins), every point in one brick (the most contention on
    one cache entry and one global count; its neighbour bin too), and n
    not a multiple of the block size (a warp cut short)."""
    rng = np.random.default_rng(8)
    bbox = Bbox.default()
    grid = bricks.make_brick_grid(bbox, 0.1, 0.01)
    if case == "smooth":
        world, valid = _smooth_points(424, 512, rng)
    elif case == "one_brick":   # within 0.04 of one brick's center (half a brick: 0.05)
        center = grid.bbox_min + (np.array(grid.res) // 2 + 0.5) * grid.brick_size
        world = center + rng.uniform(-0.04, 0.04, (100_000, 3))
        valid = np.ones(100_000, bool)
    else:
        world, valid = _smooth_points(97, 1001, rng)
        world, valid = world[:97_003], valid[:97_003]
    w = torch.from_numpy(world.astype(np.float32)).to(dev)
    v = torch.from_numpy(valid).to(dev)
    before = native.KERNELS["mark_bricks"].launches
    got = bricks.mark_bricks(w, v, grid).to(torch.int64)
    assert native.KERNELS["mark_bricks"].launches == before + 1
    want = bricks.mark_bricks_plain(w, v, grid).to(torch.int64)
    assert torch.equal(got, want)
    assert int(got.sum()) >= int(valid.sum())
    if case == "one_brick":
        assert int((got > 0).sum()) <= 7 and int(got.max()) == 100_000


def test_warp_screen_cuda(dev):
    """atol 1e-5: the same four fp32 taps in the same order. Nine channels
    of a source padded to 12, as the renderer passes them."""
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.random((128, 128, 12)).astype(np.float32)).to(dev)
    ys, xs = np.meshgrid(np.arange(96), np.arange(128), indexing="ij")
    fy = torch.from_numpy(np.clip(ys * 1.3 * (1 + 0.1 * xs / 128) - 3, 0, 127)
                          .astype(np.float32)).to(dev)
    fx = torch.from_numpy(np.clip(xs * (1 + 0.08 * ys / 96) - 2, 0, 127)
                          .astype(np.float32)).to(dev)
    wh, y0, x0 = warp_windows(128, 128, fy, fx, (8, 128))
    before = native.KERNELS["warp_screen"].launches
    got = warp_screen_cuda(img, fy, fx, (8, 128), wh, y0, x0, 9)
    assert native.KERNELS["warp_screen"].launches == before + 1
    torch.testing.assert_close(got, warp_screen_plain(img, fy, fx, (8, 128), wh, y0, x0, 9),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("cp,c", [(3, 3), (12, 9)])
def test_warp_screen_cuda_layouts(dev, cp, c):
    """The two source layouts of the kernel: 3 channels (registration) and
    9 channels padded to 12 (the renderer), on a registration-like tile
    (8, 64) and a screen-like tile (48, 128). Tolerance as
    test_warp_screen_cuda."""
    rng = np.random.default_rng(7)
    img = torch.from_numpy(rng.random((200, 256, cp)).astype(np.float32)).to(dev)
    for (h, w), tile in (((96, 256), (8, 64)), ((144, 256), (48, 128))):
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        fy = torch.from_numpy(np.clip(ys * 1.3 + 4 * np.sin(xs / 17), 0, 199)
                              .astype(np.float32)).to(dev)
        fx = torch.from_numpy(np.clip(xs * 0.97 + 3 * np.cos(ys / 11), 0, 255)
                              .astype(np.float32)).to(dev)
        wh, y0, x0 = warp_windows(200, 256, fy, fx, tile)
        got = warp_screen_cuda(img, fy, fx, tile, wh, y0, x0, c)
        assert got.shape == (h, w, c)
        torch.testing.assert_close(got, warp_screen_plain(img, fy, fx, tile, wh, y0, x0, c),
                                   atol=1e-5, rtol=1e-5)


def test_integrate_dense_cuda(dev):
    """On a real small frame, at the repo's bound between formulations
    (tests/test_tsdf_affine.py:109-116)."""
    pipe, depth, color, mv, proj = _small_pipeline(dev)
    d, c, *_ = pipe._inputs(depth, color, mv, proj)
    pre = pipe._pre(d, c)
    frames, cls = pre.frames, pre.cls
    idx, count, slots = occupied_bricks(pre.mask16, pipe.max_bricks)
    integ = pipe.integrator
    rest = (integ.win_off, cls, pipe.tsdf_cfg.res, integ.wy, integ.wx, integ.xstride,
            pipe.tsdf_cfg.limit)
    vol, cvol = tsdf_dense.integrate_dense_cuda(pack_planes(frames), integ.affine.coeffs, idx,
                                                count, slots, *rest)
    pvol, pcvol = tsdf_dense.integrate_dense_plain(pack_frames(frames), integ.affine.coeffs,
                                                   idx, count, *rest)
    v, pv = vol.float(), pvol.float()
    assert ((v - pv).abs() > 1e-4).float().mean() < 1e-4
    assert ((cvol.float() - pcvol.float()).abs().amax(dim=1) > 1e-2).float().mean() < 1e-3
    occ, pocc = int((v > -0.01 + 1e-9).sum()), int((pv > -0.01 + 1e-9).sum())
    assert pocc > 1000 and abs(occ - pocc) <= max(100, 0.002 * pocc)


@pytest.mark.parametrize("m,c,h,w", [(5, 3, 61, 97), (1, 3, 61, 97), (5, 2, 37, 45),
                                     (1, 2, 424, 512)])
def test_piecewise_eval_cuda(dev, m, c, h, w):
    """Bit for bit: the same float32 operations in the same order, every
    one rounded on its own (no FMA contraction), the division included.
    M=5 with the normal stencil's five offsets, M=1 without; C = 2 and 3;
    ragged H and W (a warp's row cut short, a block's rows past the edge);
    depths outside [d_min, d_max]."""
    rng = np.random.default_rng(4)
    k, s = 2, 16
    d_min, d_max = 0.02, 0.98
    D = torch.from_numpy(rng.uniform(-0.1, 1.1, (m, k, h, w)).astype(np.float32)).to(dev)
    a, b = (torch.from_numpy(rng.standard_normal((k, h, w, c)).astype(np.float32)).to(dev)
            for _ in range(2))
    r = torch.from_numpy(rng.standard_normal((k, c, s, h, w)).astype(np.float32) * 1e-2
                         ).to(dev).to(torch.bfloat16)
    offs = NEIGHBORHOOD if m == 5 else None
    before = native.KERNELS["piecewise_eval"].launches
    got = piecewise_eval_cuda(D, a, b, r, d_min, d_max, offs)
    assert native.KERNELS["piecewise_eval"].launches == before + 1
    assert got.shape == (m, k, h, w, c)
    assert torch.equal(got, piecewise_eval_plain(D, a, b, r, d_min, d_max, offs))


def _integrator_args(pipe, depth, color, mv, proj):
    d, c, *_ = pipe._inputs(depth, color, mv, proj)
    pre = pipe._pre(d, c)
    idx, count, slots = occupied_bricks(pre.mask16, pipe.max_bricks)
    return pack_frames(pre.frames), idx, count, slots, pack_planes(pre.frames)


def _assert_integrator_bound(vol, cvol, pvol, pcvol):
    """tests/test_tsdf_affine.py:109-116 / tests/test_tsdf_pallas.py:40-47."""
    v, pv = vol.float(), pvol.float()
    assert ((v - pv).abs() > 1e-4).float().mean() < 1e-4
    assert ((cvol.float() - pcvol.float()).abs().amax(dim=-1) > 1e-2).float().mean() < 1e-3
    occ, pocc = int((v > -0.01 + 1e-9).sum()), int((pv > -0.01 + 1e-9).sum())
    assert pocc > 1000 and abs(occ - pocc) <= max(100, 0.002 * pocc)


def test_integrate_affine_cuda(dev):
    """Kernel 6 on a 96^3 volume (Vx % 128 != 0), at the bound between
    formulations."""
    pipe, depth, color, mv, proj = _small_pipeline(dev, n=96, use_pallas=True)
    packed, idx, count, slots, planes = _integrator_args(pipe, depth, color, mv, proj)
    integ = pipe.integrator
    rest = (integ.win_off, pipe.tsdf_cfg.res, integ.wy, pipe.tsdf_cfg.limit)
    win = {"wx": integ.wx, "xstride": integ.xstride}
    vol, cvol = tsdf_persist.integrate_affine_cuda(planes, integ.affine.coeffs, idx, count,
                                                   slots, *rest, **win)
    assert vol.dtype == torch.float32 and cvol.shape == (96, 96, 96, 4)
    _assert_integrator_bound(vol, cvol, *tsdf_persist.integrate_affine_plain(
        packed, integ.affine.coeffs, idx, count, *rest, **win))


def test_scatter_dense_cuda(dev):
    """Kernel 8 against its plain version, exactly (a copy), with garbage
    indices past the count and a non-cubic volume."""
    rng = np.random.default_rng(6)
    res = (80, 48, 64)
    nb = 5 * 3 * 4
    vbm = torch.from_numpy(rng.standard_normal((nb, 32, 128)).astype(np.float32)).to(dev)
    cbm = torch.from_numpy(rng.standard_normal((nb, 4, 32, 128)).astype(np.float32)
                           ).to(dev).to(torch.bfloat16)
    idx = np.full(40, nb + 77, np.int32)
    idx[:31] = np.sort(rng.permutation(nb)[:31])
    idx[35:] = -9
    idx, count = torch.from_numpy(idx).to(dev), torch.tensor([31], dtype=torch.int32).to(dev)
    before = native.KERNELS["scatter_dense"].launches
    v, c = assemble.scatter_dense(vbm, cbm, idx, count, res, 0.01)
    assert native.KERNELS["scatter_dense"].launches == before + 1
    pv, pc = assemble.scatter_dense_plain(vbm, cbm, idx, count, res, 0.01)
    assert torch.equal(v, pv) and torch.equal(c, pc)


def test_integrate_affine_raw_scatter_cuda(dev):
    """Kernel 6 in raw mode, assembled by kernel 8, is kernel 6's
    voxel-order output bit for bit (color after the channel permute)."""
    pipe, depth, color, mv, proj = _small_pipeline(dev, n=96, use_pallas=True)
    _, idx, count, slots, planes = _integrator_args(pipe, depth, color, mv, proj)
    integ = pipe.integrator
    args = (planes, integ.affine.coeffs, idx, count, slots, integ.win_off, pipe.tsdf_cfg.res,
            integ.wy, pipe.tsdf_cfg.limit)
    win = {"wx": integ.wx, "xstride": integ.xstride}
    vbm, cbm, visited = tsdf_persist.integrate_affine_cuda(*args, raw=True, **win)
    assert int(visited.sum()) == int(count) > 0
    v, c = assemble.scatter_dense_cuda(vbm, cbm, idx, count, pipe.tsdf_cfg.res,
                                       pipe.tsdf_cfg.limit)
    want_v, want_c = tsdf_persist.integrate_affine_cuda(*args, **win)
    assert torch.equal(v, want_v) and torch.equal(c.permute(1, 2, 3, 0), want_c)


def test_integrate_sparse_cuda(dev):
    """Kernel 7 (the table tier, use_affine=False), at the bound between
    formulations."""
    pipe, depth, color, mv, proj = _small_pipeline(dev, use_affine=False)
    packed, idx, count, _, _ = _integrator_args(pipe, depth, color, mv, proj)
    integ = pipe.integrator
    assert integ.tier == "warp table"
    args = (packed, integ.tables.pos_blocked, idx, count, integ.win_off, pipe.tsdf_cfg.res,
            pipe.tsdf_cfg.limit)
    vol, cvol = tsdf_sparse.integrate_sparse_cuda(*args)
    _assert_integrator_bound(vol, cvol, *tsdf_sparse.integrate_sparse_plain(*args))


@pytest.mark.parametrize("n, shift", [(64, 0), (96, 0), (96, 40)])
def test_integrate_sparse_window_cuda(dev, n, shift):
    """Kernel 7's window mode (the XLA table integrator that a volume under
    8 bricks an axis takes) against its plain form at the integrator
    bound: the pipeline's own tier and windows, then (shift) origins moved
    past the image, which both clamp into it as dynamic_slice does."""
    pipe, depth, color, mv, proj = _small_pipeline(dev, n=n)
    integ = pipe.integrator
    assert integ.tier == "table integrator" and integ.affine is None
    packed, idx, count, _, _ = _integrator_args(pipe, depth, color, mv, proj)
    win_off = (integ.win_off + shift).contiguous()
    args = (packed, integ.tables.pos_blocked, idx, count, win_off, pipe.tsdf_cfg.res,
            pipe.tsdf_cfg.limit)
    kern = native.KERNELS["integrate_sparse_window"]
    before = kern.launches
    vol, cvol = tsdf_sparse.integrate_sparse_cuda(*args, window=64)
    assert kern.launches == before + 1
    _assert_integrator_bound(vol, cvol, *tsdf_sparse.integrate_sparse_plain(*args, window=64))
    before = kern.launches
    pipe.step(depth, color, mv, proj)
    assert kern.launches == before + 1


def test_splat_deterministic_cuda(dev):
    """The forward splat repeats bit for bit on the card (pass 1 a min,
    pass 2 sorted sums, zbuffer_points' winner the last update), and agrees
    with the CPU where the projection's rounding (cuBLAS against the CPU's
    products) moves no point across a pixel or a depth order: all but
    1e-3 of the pixels within 1e-5."""
    from rgbd_recon_torch.ops import splat
    from rgbd_recon_torch.ops.raymarch import RenderCamera
    from rgbd_recon_torch.utils.math import look_at, perspective

    rng = np.random.default_rng(13)
    n = 200_000
    world = rng.uniform([-1.6, -1.2, -4.0], [1.6, 1.2, 1.0], (n, 3)).astype(np.float32)
    world[1::7] = world[0::7][:len(world[1::7])]     # exact ties
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    qual = rng.uniform(0.1, 1, n).astype(np.float32)
    size = rng.uniform(0.5, 7, n).astype(np.float32)
    valid = rng.uniform(0, 1, n) < 0.9
    mv = look_at(np.array([0.0, 0.0, 2.0], np.float32), np.zeros(3, np.float32), [0, 1, 0])
    proj = perspective(50.0, 320 / 240, 0.1, 50.0)
    runs = {}
    for d in (dev, dev, torch.device("cpu")):
        t = [torch.from_numpy(a).to(d) for a in (world, colors, qual, valid, size)]
        cam = RenderCamera(torch.from_numpy(mv).to(d), torch.from_numpy(proj).to(d), 320, 240)
        buf = splat.splat(*t[:4], cam, footprint=6, size=t[4])
        zp = splat.zbuffer_points(t[0], t[1], t[3], cam)
        runs.setdefault(d.type, []).append([x.cpu() for x in (*buf, *zp)])
    (a, b), (c,) = runs["cuda"], runs["cpu"]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for x, y in zip(a, c):
        dev_px = (x - y).abs().nan_to_num(0.0).reshape(240, 320, -1).amax(-1) > 1e-5
        assert float(dev_px.float().mean()) < 1e-3
    assert float((a[0][..., 3] > 0).float().mean()) > 0.1


MAXK = 8   # sensors a kernel of csrc/integrate_dense.cu takes (csrc/fuse.cuh)
LIMIT = 0.01


def _quadratic_case(device, res, k, occupied, max_bricks, classes, seed=0):
    """Synthetic inputs of kernels 1 and 6 on ``device``: each sensor sees
    the volume through a tilted, slightly curved warp that maps some voxels
    outside the image and the [0, 1] depth range, onto a wavy depth
    surface, so the band holds a shell of voxels; windows jittered so the
    window clamp bites; ``occupied`` of the bricks marked, the fused ones
    the first ``max_bricks``; classes FULL/NONE/FRONT/INVALID at random if
    ``classes``. Returns (packed, coeffs, idx, count, slots, mask16,
    win_off, cls) for 96 x 160 frames, 32 x 64 windows at x-stride 16."""
    h, w, wy, wx, xs = 96, 160, 32, 64, 16
    rng = np.random.default_rng(seed)
    vx, vy, vz = res
    nbx, nby, nbz = vx // 16, vy // 16, vz // 16
    nb = nbx * nby * nbz
    b = np.arange(nb)
    cz, cy, cx = (b // (nby * nbx)) * 16 + 8.0, ((b // nbx) % nby) * 16 + 8.0, (b % nbx) * 16 + 8.0
    coeffs = np.zeros((k, nb, 4, 10), np.float32)   # basis 1, z, y, x, zz, yy, xx, zy, zx, yx
    for s in range(k):
        su, sv, sd = rng.uniform(1.0, 1.15, 3) * (1.0, 1.0, 0.8)
        ou, ov, od = rng.uniform(-0.07, 0.0, 3) + (0.0, 0.0, 0.13)
        tz, tx, q = rng.uniform(-0.05, 0.05, 3)
        coeffs[s, :, 0, 0] = ou + su * cx / vx + tz * cz / vz
        coeffs[s, :, 0, 1], coeffs[s, :, 0, 3], coeffs[s, :, 0, 6] = tz / vz, su / vx, q * 1e-4
        coeffs[s, :, 1, 0] = ov + sv * cy / vy
        coeffs[s, :, 1, 2], coeffs[s, :, 1, 5] = sv / vy, q * 1e-4
        coeffs[s, :, 2, 0] = od + sd * cz / vz + tx * cx / vx
        coeffs[s, :, 2, 1], coeffs[s, :, 2, 3], coeffs[s, :, 2, 7] = sd / vz, tx / vx, q * 1e-5
    py, px = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    packed = np.empty((k, h, w, 6), np.float32)
    for s in range(k):
        wave = np.sin(2 * np.pi * px / w + s) * np.cos(2 * np.pi * py / h)
        packed[s, ..., 0] = 0.5 + 0.15 * wave + rng.uniform(0, 1e-3, (h, w))
        packed[s, ..., 1] = rng.uniform(0.3, 1.0, (h, w)) * (rng.random((h, w)) > 0.05)
        packed[s, ..., 2] = rng.random((h, w)) > 0.1     # silhouette: 10% background
        packed[s, ..., 3:] = rng.random((h, w, 3))
    u_c, v_c = coeffs[:, :, 0, 0] * w, coeffs[:, :, 1, 0] * h
    y0 = np.clip(np.round(v_c - wy / 2) + rng.integers(-4, 5, (k, nb)), 0, h - wy)
    xb = np.clip(np.floor((u_c - wx / 2) / xs) + rng.integers(-1, 2, (k, nb)), 0, (w - wx) // xs)
    win_off = np.stack([y0, xb], -1).astype(np.int32)
    cls = rng.choice(4, (k, nb), p=[0.55, 0.15, 0.15, 0.15]).astype(np.int32) if classes else None
    mask = np.zeros(nb, bool)
    mask[rng.permutation(nb)[:int(occupied * nb)]] = True
    m16 = torch.from_numpy(mask.reshape(nbz, nby, nbx)).to(device)
    idx, count, slots = occupied_bricks(m16, max_bricks)

    def put(a):
        return None if a is None else torch.from_numpy(a).to(device)

    return put(packed), put(coeffs), idx, count, slots, m16, put(win_off), put(cls)


def _bricks(vol, res):
    """[Vz, Vy, Vx, ...] -> [NB, 4096, ...] (z-major inside a brick)."""
    vx, vy, vz = res
    rest = vol.shape[3:]
    v = vol.reshape(vz // 16, 16, vy // 16, 16, vx // 16, 16, *rest)
    v = v.permute(0, 2, 4, 1, 3, 5, *range(6, 6 + len(rest)))
    return v.reshape((vx // 16) * (vy // 16) * (vz // 16), 4096, *rest)


QUADRATIC_CASES = {
    # case: (res dense, res block-major, K, occupied share, capacity share, classes)
    "empty": ((128, 128, 128), (96, 96, 96), 4, 0.0, 1.0, True),
    "dropped": ((128, 128, 128), (96, 96, 96), 4, 0.4, 0.5, True),
    "classes": ((128, 128, 128), None, 4, 0.4, 1.0, True),
    "k1": ((128, 128, 128), (96, 96, 96), 1, 0.4, 1.0, False),
    "kmax": ((128, 128, 128), (96, 96, 96), MAXK, 0.4, 1.0, False),
    "noncubic": ((128, 48, 80), (80, 48, 112), 4, 0.4, 1.0, False),
}


@pytest.mark.parametrize("mode,case", [(m, c) for c in QUADRATIC_CASES
                                       for m in ("dense", "affine", "raw")
                                       if m == "dense" or QUADRATIC_CASES[c][1]])
def test_integrate_quadratic_cases_cuda(dev, mode, case):
    """Kernel 1 (dense) and kernel 6 (voxel order, raw) against their plain
    versions at the integrator bound (tests/test_tsdf_affine.py:109-116) on
    synthetic frames: no brick occupied (the whole volume holds the clear
    values), more occupied bricks than the capacity (the dropped ones keep
    the clear values), all four classes, K = 1 and K = 8, a non-cubic
    volume."""
    res_dense, res_block, k, occ, cap, classes = QUADRATIC_CASES[case]
    res = res_dense if mode == "dense" else res_block
    nb = (res[0] // 16) * (res[1] // 16) * (res[2] // 16)
    max_bricks = max(1, int(cap * occ * nb)) if occ else nb
    packed, coeffs, idx, count, slots, m16, win_off, cls = _quadratic_case(
        dev, res, k, occ, max_bricks, classes and mode == "dense")
    planes = (packed[..., :4].contiguous(), packed[..., 4:].contiguous())   # pack_planes
    n_fused = int(count)
    dropped = m16.reshape(-1) & (slots < 0)
    assert n_fused == min(int(m16.sum()), max_bricks)
    assert (int(dropped.sum()) > 0) == (case == "dropped")
    kern = native.KERNELS["integrate_dense" if mode == "dense" else "integrate_affine"]
    before = kern.launches
    if mode == "dense":
        got = tsdf_dense.integrate_dense_cuda(planes, coeffs, idx, count, slots, win_off, cls,
                                              res, 32, 64, 16, LIMIT)
        want = tsdf_dense.integrate_dense_plain(packed, coeffs, idx, count, win_off, cls, res,
                                                32, 64, 16, LIMIT)
        cdim = 1
    else:
        got = tsdf_persist.integrate_affine_cuda(planes, coeffs, idx, count, slots, win_off,
                                                 res, 32, LIMIT, raw=mode == "raw")
        want = tsdf_persist.integrate_affine_plain(packed, coeffs, idx, count, win_off, res,
                                                   32, LIMIT, raw=mode == "raw")
        cdim = 1 if mode == "raw" else -1
    assert kern.launches == before + 1
    v, c = got[0].float(), got[1].float()
    pv, pc = want[0].float(), want[1].float()
    if mode == "raw":
        visited = got[2]
        assert torch.equal(visited, want[2]) and int(visited.sum()) == n_fused
        v, c, pv, pc = v[visited], c[visited], pv[visited], pc[visited]
    else:
        clear_v = torch.full_like(v, -LIMIT).to(got[0].dtype).float()
        vb, cb = _bricks(v, res), _bricks(c.movedim(cdim, -1), res)
        idle = slots < 0          # every brick the kernel does not fuse
        assert torch.equal(vb[idle], _bricks(clear_v, res)[idle])
        assert not cb[idle].any()
    if n_fused == 0:
        assert v.numel() == 0 or (torch.equal(v, pv) and torch.equal(c, pc))
        return
    assert ((v - pv).abs() > 1e-4).float().mean() < 1e-4
    assert ((c - pc).abs().amax(dim=cdim) > 1e-2).float().mean() < 1e-3
    occ_v, pocc = int((v > -LIMIT + 1e-9).sum()), int((pv > -LIMIT + 1e-9).sum())
    assert pocc > 1000 and abs(occ_v - pocc) <= max(100, 0.002 * pocc)


def test_slice_cuda_matches_cpu(dev):
    """The whole step on the card vs the plain versions on the CPU: hit
    agreement > 0.995, color PSNR > 30 dB, depth median < 2e-3 (the
    render-parity bounds of tests/test_golden.py:65-69), and every kernel
    of the pinhole path launched."""
    outs = {}
    for device in (dev, torch.device("cpu")):
        pipe, depth, color, mv, proj = _small_pipeline(device)
        before = {k: kern.launches for k, kern in native.KERNELS.items()}
        o = pipe.step(depth, color, mv, proj)
        if device.type == "cuda":   # the pinhole path's four kernels
            assert all(native.KERNELS[k].launches > before[k] for k in
                       ("bilateral_accum", "mark_bricks", "warp_screen", "integrate_dense"))
        outs[device.type] = [t.float().cpu().numpy() for t in (o.color, o.depth, o.hit)]
    (gc, gd, gh), (cc, cd, ch) = outs["cuda"], outs["cpu"]
    gh, ch = gh > 0.5, ch > 0.5
    assert (gh == ch).mean() > 0.995
    mse = ((gc[..., :3] - cc[..., :3]) ** 2).mean()
    assert mse == 0 or 10 * np.log10(1.0 / mse) > 30.0
    both = gh & ch
    assert both.mean() > 0.02 and np.median(np.abs(gd[both] - cd[both])) < 2e-3


def test_wire_decode_cuda_bitwise(dev):
    """The app's device-side wire decode on the card, bit for bit the host
    decode: DXT1 / DXT5 color (io/dxt.py) and u8 depth
    (FrameFormat.decode_depth); the normalisations divide by a 0-d device
    tensor, which CUDA does not turn into a reciprocal product."""
    from rgbd_recon_torch.io import dxt
    from rgbd_recon_torch.io.stream import FrameFormat
    from rgbd_recon_torch.ops import wire

    rng = np.random.default_rng(12)
    imgs = rng.integers(0, 256, (3, 424, 512, 3)).astype(np.uint8)
    fmt = FrameFormat(512, 424, 512, 424, compressed_rgb=1, compressed_depth=True)
    for enc, dec, fn in ((dxt.encode_dxt1, dxt.decode_dxt1, wire.decode_dxt1_device),
                         (dxt.encode_dxt5, dxt.decode_dxt5, wire.decode_dxt5_device)):
        pay = np.stack([enc(i) for i in imgs])
        got = fn(torch.from_numpy(pay).to(dev), 512, 424).cpu().numpy()
        want = np.stack([dec(p, 512, 424) for p in pay]).astype(np.float32) / 255.0
        np.testing.assert_array_equal(got, want)
    dpay = rng.integers(0, 256, (3, fmt.depth_size)).astype(np.uint8)
    dpay[0, :256] = np.arange(256)
    got = wire.decode_depth_u8_device(torch.from_numpy(dpay).to(dev), 512, 424).cpu().numpy()
    np.testing.assert_array_equal(got, np.stack([fmt.decode_depth(p) for p in dpay]))


def test_device_feed_cuda(dev):
    """Pinned double buffering on a side stream: every advanced frame holds
    what was staged, while the caller overwrites its arrays and the
    consumer stream computes on the previous frame."""
    from rgbd_recon_torch.io.ingest import DeviceFeed

    feed = DeviceFeed(dev)
    depth = np.zeros((4, 424, 512), np.float32)
    color = np.zeros((4, 424, 512, 3), np.uint8)
    prev = None
    for i in range(6):
        depth[:] = i
        color[:] = i
        feed.stage(depth, color, float(i))
        d, c = feed.advance()
        if prev is not None:   # work on the consumer stream while the next upload runs
            prev = prev * 2.0
        prev = d + c.float().mean()
        assert float(d.mean()) == i and int(c.max()) == i and feed.timestamp == i
    torch.cuda.synchronize()


def test_frame_monitor_cuda_fence(dev):
    """The watchdog reads a fence copied to pinned memory without blocking
    the loop; overflow of the capacity captured at submit surfaces."""
    from rgbd_recon_torch.app import FrameMonitor

    mon = FrameMonitor(dev)
    try:
        rgba = torch.zeros(8, 8, 4, device=dev)
        mon.submit(0, torch.tensor([1, 3], dtype=torch.int32, device=dev), rgba, 3)
        mon.drain()
        mon.submit(1, torch.tensor([1, 4], dtype=torch.int32, device=dev), rgba, 3)
        with pytest.raises(RuntimeError, match="exceed max_bricks=3"):
            mon.drain()
    finally:
        mon.close()


def test_reference_path_cuda(dev):
    """The reference path (fast_path=False: voxel mask, dense integrators,
    per-ray marcher with the brick skip) on a 96^3 frame on the card and on
    the CPU: kernels 2, 3 and 4 launch (kernel 4 under 8 bricks an axis
    too, where the integrator tier gate is off); the TSDF at the integrator
    bound (tests/test_tsdf_affine.py:109-116), the frame at the
    render-parity bounds (tests/test_golden.py:65-69)."""
    from rgbd_recon_torch.utils.metrics import render_parity, render_parity_passes

    outs = {}
    for d in (dev, torch.device("cpu")):
        pipe, depth, color, mv, proj = _small_pipeline(d, n=96, fast_path=False)
        assert not pipe.use_fast and pipe.integrator is None
        before = {k: native.KERNELS[k].launches
                  for k in ("warp_screen", "bilateral_accum", "mark_bricks")}
        outs[d.type] = pipe.step(depth, color, mv, proj)
        if d.type == "cuda":
            assert all(native.KERNELS[k].launches > n for k, n in before.items())
    g, c = outs["cuda"], outs["cpu"]
    v, pv = g.tsdf.cpu(), c.tsdf
    assert ((v - pv).abs() > 1e-4).float().mean() < 1e-4
    occ, pocc = int((v > -0.01 + 1e-9).sum()), int((pv > -0.01 + 1e-9).sum())
    assert pocc > 1000 and abs(occ - pocc) <= max(100, 0.002 * pocc)
    s = render_parity(*(types.SimpleNamespace(color=o.color.cpu().numpy(),
                                              depth=o.depth.cpu().numpy(),
                                              hit=o.hit.cpu().numpy()) for o in (c, g)))
    assert render_parity_passes(s) and s["hit_frac"] > 0.02, s


# -- fused mode: the frame as one CUDA graph per sweep variant ---------------

FIELDS = ("color", "depth", "hit", "tsdf", "occupied_ratio", "num_samples", "occupied_bricks")


def _assert_same(a, b, what):
    """Bit for bit on every FrameOutput field: the fused frame runs the
    staged frame's arithmetic; only the slab skip's selects differ."""
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), (what, f)


def _orbit_camera(pipe, axis, flip):
    """A view whose sweep is (axis, flip): the eye off the volume center
    along that axis (a little off-axis, so no tie), looking at the center."""
    from rgbd_recon_torch.ops import raymarch as rm, raymarch_fast as rmf
    from rgbd_recon_torch.utils.math import look_at

    center = (pipe.bbox.min + pipe.bbox.max) * 0.5
    d = np.array([0.25, 0.35, 0.3], np.float32)
    d[axis] = 3.0 if flip else -3.0
    up = [0, 0, 1] if axis == 1 else [0, 1, 0]
    mv = look_at(center + d, center, up)
    assert rmf.pick_axis(mv, rm.vol_to_world_matrix(pipe.bbox)) == (axis, flip)
    return mv


def test_fused_replay_matches_staged_cuda(dev):
    """A captured replay equals the staged frame bit for bit; kernels 2-4
    and the integrator count their per-frame launches on every replay."""
    pipe, depth, color, mv, proj = _small_pipeline(dev)
    staged = pipe.step(depth, color, mv, proj)
    for k in native.KERNELS.values():
        k.launches = 0
    pipe.step(depth, color, mv, proj)
    torch.cuda.synchronize()
    per_frame = {n: k.launches for n, k in native.KERNELS.items() if k.launches}
    assert {"bilateral_accum", "mark_bricks", "warp_screen", "integrate_dense"} <= set(per_frame)
    pipe.cfg = pipe.cfg._replace(fused=True)
    pipe.warmup(depth, color, mv, proj)         # the capture
    for k in native.KERNELS.values():
        k.launches = 0
    for i in range(3):
        out = pipe.step(depth, color, mv, proj)
        torch.cuda.synchronize()
        _assert_same(out, staged, f"replay {i}")
        assert {n: k.launches for n, k in native.KERNELS.items() if k.launches} == \
            {n: c * (i + 1) for n, c in per_frame.items()}
    assert len(pipe._graphs.keys()) == 1


def test_fused_retune_matches_fresh_cuda(dev):
    """After retune(tsdf_limit=...) the next fused frame (its graph dropped
    and captured anew) equals a fresh fused pipeline's."""
    pipe, depth, color, mv, proj = _small_pipeline(dev, fused=True)
    pipe.step(depth, color, mv, proj)
    assert len(pipe._graphs.keys()) == 1
    pipe.retune(tsdf_limit=0.02)
    assert pipe._graphs.keys() == []
    out = pipe.step(depth, color, mv, proj)
    fresh, *_ = _small_pipeline(dev, fused=True, tsdf_limit=0.02)
    _assert_same(out, fresh.step(depth, color, mv, proj), "retune")


def test_fused_variants_async_cuda(dev):
    """warm_variants_async captures the other five (axis, flip) variants on
    its thread; each replay equals the staged frame at its own camera."""
    pipe, depth, color, mv, proj = _small_pipeline(dev, fused=True)
    logs = []
    pipe._log = logs.append
    cams = {v: _orbit_camera(pipe, *v) for v in
            [(a, f) for a in (2, 0, 1) for f in (False, True)]}
    pipe.step(depth, color, cams[(2, False)], proj)
    pipe.warm_variants_async(depth, color, cams[(2, False)], proj)
    pipe._variants_thread.join(timeout=600)
    assert not pipe._variants_thread.is_alive()
    assert sorted(pipe._graphs.keys()) == sorted(cams), logs
    assert sum("captured fused variant" in s for s in logs) == 5, logs
    staged, *_ = _small_pipeline(dev)
    for v, cam in cams.items():
        _assert_same(pipe.step(depth, color, cam, proj), staged.step(depth, color, cam, proj),
                     v)


def _variant_camera(pipe, axis, flip):
    from rgbd_recon_torch.utils.math import look_at

    center = (pipe.bbox.min + pipe.bbox.max) * 0.5
    d = np.array([0.25, 0.35, 0.3], np.float32)
    d[axis] = 3.0 if flip else -3.0
    mv = look_at(center + d, center, [0, 0, 1] if axis == 1 else [0, 1, 0])
    assert pipe._axis(mv)[1] == (axis, flip)
    return mv


def _assert_frames_equal(a, b, fields=("color", "depth", "hit", "tsdf", "occupied_ratio",
                                       "num_samples", "occupied_bricks")):
    for f in fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_sharded_world_of_one_cuda(dev):
    """A world of one under NCCL at 128^3 (kernel 1): fast_sharded_step bit
    for bit FramePipeline.step with the cull off, kernels 1-4 launched;
    ReplayDriver (B = 2) bit for bit two steps; sharded_step bit for bit the
    reference path. The process group is destroyed after."""
    import torch.distributed as dist

    from rgbd_recon_torch.parallel import fast_sharded as fs
    from rgbd_recon_torch.parallel.replay import ReplayDriver
    from rgbd_recon_torch.parallel.sharding import make_mesh, sharded_step

    mesh = make_mesh(device="cuda")
    try:
        assert dist.get_backend() == "nccl" and mesh.size == 1
        pipe, depth, color, mv, proj = _small_pipeline(dev, brick_cull=False)
        step = fs.fast_sharded_step(pipe, mesh)
        want = pipe.step(depth, color, mv, proj)
        before = {k: native.KERNELS[k].launches for k in
                  ("bilateral_accum", "mark_bricks", "warp_screen", "integrate_dense")}
        got = step(depth, color, mv, proj)
        torch.cuda.synchronize()
        assert all(native.KERNELS[k].launches > c for k, c in before.items())
        _assert_frames_equal(got, want)
        out = ReplayDriver(pipe, mesh).step(np.stack([depth, depth * 1.001]),
                                            np.stack([color, color]), mv, proj)
        for i, s in enumerate((1.0, 1.001)):
            item = pipe.step(depth * s, color, mv, proj)
            for f in ("color", "depth", "hit", "tsdf"):
                assert torch.equal(getattr(out, f)[i], getattr(item, f)), (i, f)
        ref, depth, color, mv, proj = _small_pipeline(dev, n=64, fast_path=False)
        got = sharded_step(ref, mesh)(depth, color, mv, proj)
        _assert_frames_equal(got, ref.step(depth, color, mv, proj),
                             ("color", "depth", "hit", "tsdf", "num_samples"))
    finally:
        dist.destroy_process_group()


def test_four_slabs_cuda(dev):
    """4 z-slabs of 16 at 64^3, run rank by rank on the card, bit for bit the
    single step at every sweep variant."""
    from rgbd_recon_torch.parallel import fast_sharded as fs
    from rgbd_recon_torch.runtime.pipeline import VARIANTS

    pipe, depth, color, _, proj = _small_pipeline(dev, n=64, brick_cull=False)
    for v in VARIANTS:
        mv = _variant_camera(pipe, *v)
        _assert_frames_equal(fs.run_slabs(pipe, 4, depth, color, mv, proj),
                             pipe.step(depth, color, mv, proj))


# -- the sweep: csrc/sweep_march.cu against sweep_plain ------------------------

SWEEP_FIELDS = ("hit", "hit_s", "hit_color", "hit_grad", "num_samples")
SWEEP_RES = (48, 64, 80)       # (x, y, z): a non-cubic volume
SWEEP_CASES = {
    # case: (z-major color, TSDF dtype, color dtype, flags, grid (Ti, Si))
    "zmajor_bf16_bench_flags": (True, torch.bfloat16, torch.bfloat16, "bench", (56, 72)),
    "zmajor_bf16_no_flags": (True, torch.bfloat16, torch.bfloat16, None, (64, 64)),
    "channels_last_f32_all_on": (False, torch.float32, torch.bfloat16, "on", (50, 70)),
    "channels_last_f32_all_off": (False, torch.float32, torch.float32, "off", (72, 40)),
    "channels_last_f32_host_flags": (False, torch.float32, torch.float32, "host", (48, 96)),
}


def _sweep_volumes(zmajor, tsdf_dtype, color_dtype, device):
    """A sphere TSDF truncated at 0.02 and a random color volume (numpy,
    seed 3) at SWEEP_RES; the brick layers flagged empty by the bench-like
    mask16 of ``_sweep_mask`` hold the clear values."""
    vx, vy, vz = SWEEP_RES
    rng = np.random.default_rng(3)
    c = [(np.arange(v, dtype=np.float32) + 0.5) / v for v in (vz, vy, vx)]
    z, y, x = np.meshgrid(*c, indexing="ij")
    r = np.sqrt((x - 0.45) ** 2 + (y - 0.5) ** 2 + (z - 0.55) ** 2)
    tsdf = torch.from_numpy(np.clip(0.3 - r, -0.02, 0.02).astype(np.float32))
    color = torch.from_numpy(rng.random((vz, vy, vx, 4), dtype=np.float32))
    m = _sweep_mask().repeat_interleave(16, 0).repeat_interleave(16, 1).repeat_interleave(16, 2)
    tsdf = torch.where(m, tsdf, -0.02).to(tsdf_dtype)
    color = torch.where(m[..., None], color, 0.0).to(color_dtype)
    if zmajor:
        color = color.permute(0, 3, 1, 2).contiguous()
    return tsdf.to(device), color.to(device)


def _sweep_mask():
    """16^3 block mask at SWEEP_RES with empty brick layers along every
    axis (2 of 5 along z: near the bench's 37.5% of empty slices)."""
    vx, vy, vz = SWEEP_RES
    mask16 = torch.ones((vz // 16, vy // 16, vx // 16), dtype=torch.bool)
    mask16[0], mask16[3], mask16[:, 2], mask16[:, :, 1] = False, False, False, False
    return mask16


def _sweep_camera(axis, flip, turn=0.0):
    """A RenderCamera whose sweep is (axis, flip), turned by ``turn``
    radians about the volume's vertical."""
    from rgbd_recon_torch.ops import raymarch as rm, raymarch_fast as rmf
    from rgbd_recon_torch.utils.math import look_at, perspective

    bbox = Bbox.default()
    center = (bbox.min + bbox.max) * 0.5
    d = np.array([0.25, 0.35, 0.3], np.float32)
    d[axis] = 3.0 if flip else -3.0
    cs, sn = np.cos(turn), np.sin(turn)
    d = np.array([cs * d[0] + sn * d[2], d[1], -sn * d[0] + cs * d[2]], np.float32)
    mv = look_at(center + d, center, [0, 0, 1] if axis == 1 else [0, 1, 0])
    assert rmf.pick_axis(mv, rm.vol_to_world_matrix(bbox)) == (axis, flip)
    return mv, perspective(50.0, 1.5, 0.1, 200.0)


def _assert_sweeps_equal(got, want, what):
    """Bit for bit, up to the sign of a zero (torch.equal compares values)."""
    for f in SWEEP_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), (what, f)


@pytest.mark.parametrize("case", sorted(SWEEP_CASES))
@pytest.mark.parametrize("axis, flip", [(a, f) for a in (2, 0, 1) for f in (False, True)])
def test_sweep_march_cuda(dev, axis, flip, case):
    """The kernel equals sweep_plain on the card bit for bit, with one launch
    a sweep, at every (axis, flip): z-major and channels-last color, bf16
    and f32 volumes, flags absent, all on, all off, the bench's pattern (a
    device tensor, as the fused frame) and a host array (the staged frame),
    Ti != Si with ragged tiles, a non-cubic volume."""
    from rgbd_recon_torch.ops import raymarch as rm, raymarch_fast as rmf

    zmajor, td, cd, flags, grid = SWEEP_CASES[case]
    tsdf, cvol = _sweep_volumes(zmajor, td, cd, dev)
    mv, proj = _sweep_camera(axis, flip)
    cam = rm.RenderCamera(torch.from_numpy(mv).to(dev), torch.from_numpy(proj).to(dev), 96, 64)
    n = SWEEP_RES[axis]
    occ = {None: None, "on": torch.ones(n, dtype=torch.bool, device=dev),
           "off": torch.zeros(n, dtype=torch.bool, device=dev),
           "bench": rmf.slab_occupancy_device(_sweep_mask().to(dev), axis, n),
           "host": rmf.slab_occupancy(_sweep_mask(), axis, n)}[flags]
    cfg = rmf.SweepConfig(res=grid)
    before = native.KERNELS["sweep_march"].launches
    got = rmf.sweep(tsdf, cvol, cam, Bbox.default(), 0.02, axis, flip, cfg, occ, zmajor)
    assert native.KERNELS["sweep_march"].launches == before + 1
    want = rmf.sweep_plain(tsdf, cvol, cam, Bbox.default(), 0.02, axis, flip, cfg, occ, zmajor)
    _assert_sweeps_equal(got, want, (axis, flip, case))
    if flags == "off":
        assert float(got.hit.sum()) == 0.0 and float(got.num_samples.min()) == n
    else:
        assert float(got.hit.mean()) > 0.01


@pytest.mark.parametrize("axis, flip", [(a, f) for a in (2, 0, 1) for f in (False, True)])
def test_sweep_march_window_cuda(dev, axis, flip):
    """SweepWindow starts: each of 4 slabs (strided views of the volume)
    swept from its halo carry by the kernel equals sweep_plain's window bit
    for bit, with the bench-like flags."""
    from rgbd_recon_torch.ops import raymarch as rm, raymarch_fast as rmf
    from rgbd_recon_torch.parallel import fast_sharded as fs

    tsdf, cvol = _sweep_volumes(True, torch.bfloat16, torch.bfloat16, dev)
    mv, proj = _sweep_camera(axis, flip)
    cam = rm.RenderCamera(torch.from_numpy(mv).to(dev), torch.from_numpy(proj).to(dev), 96, 64)
    ns, arr = SWEEP_RES[axis], 2 - axis
    nl = ns // 4
    occ = rmf.slab_occupancy(_sweep_mask(), axis, ns)
    cdim = {0: 0, 1: 2, 2: 3}[arr]
    slabs = []
    for rank in range(4):
        s, cs = [slice(None)] * 3, [slice(None)] * 4
        s[arr] = cs[cdim] = slice(rank * nl, (rank + 1) * nl)
        slabs.append((tsdf[tuple(s)], cvol[tuple(cs)]))
    halos = [fs.halo_send(v, c, axis, flip, True) for v, c in slabs]
    cfg = rmf.SweepConfig(res=(56, 72))
    starts = 0
    for rank, (v, c) in enumerate(slabs):
        win = fs.window_of(halos, rank, 4, ns, flip)
        starts += win.halo_valid
        args = (v, c, cam, Bbox.default(), 0.02, axis, flip, cfg,
                occ[rank * nl:(rank + 1) * nl], True, win)
        _assert_sweeps_equal(rmf.sweep(*args), rmf.sweep_plain(*args), (axis, flip, rank))
    assert starts == 3


def test_sweep_march_fused_two_cameras_cuda(dev):
    """One fused graph captured once and replayed at two cameras of one
    (axis, flip): each frame equals, bit for bit, the staged frame whose
    sweep is sweep_plain at that camera (a kernel that kept the capture's
    camera would fail the second); one sweep launch a frame."""
    from rgbd_recon_torch.ops import raymarch_fast as rmf

    pipe, depth, color, mv, proj = _small_pipeline(dev, fused=True)
    mv2 = _orbit_camera(pipe, *pipe._axis(mv)[1])
    pipe.step(depth, color, mv, proj)                 # the capture
    got = []
    for cam in (mv, mv2, mv):
        before = native.KERNELS["sweep_march"].launches
        got.append(pipe.step(depth, color, cam, proj))
        torch.cuda.synchronize()
        assert native.KERNELS["sweep_march"].launches == before + 1
    assert len(pipe._graphs.keys()) == 1
    twin, *_ = _small_pipeline(dev)
    kernel = rmf.sweep
    rmf.sweep = rmf.sweep_plain
    try:
        want = [twin.step(depth, color, cam, proj) for cam in (mv, mv2)]
    finally:
        rmf.sweep = kernel
    _assert_same(got[0], want[0], "camera 1")
    _assert_same(got[1], want[1], "camera 2")
    _assert_same(got[2], want[0], "camera 1 again")
    assert not torch.equal(got[0].color, got[1].color)


# -- the benchmark's k5-208 cell: five sensors, 208 x 224 x 208, block-major ---

K5_SEED = 2**31 + 18


@pytest.fixture(scope="module")
def k5_208():
    """The rig, two frames (five sensors, depth 512x424, color 1280x1080 u8)
    and the camera of the benchmark cell ``k5-208.static``, from
    ``recon_bench``'s generator on the card."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    from recon_bench import discover, harness, schedule

    cell = discover.cell("k5-208.static")
    rig, depth, color = harness.make_inputs(cell.config, cell.traffic, K5_SEED, "cuda")
    mv, proj = schedule.make(cell.config, cell.traffic, K5_SEED).cameras[0]
    return cell, rig, depth[:2], color[:2], mv, proj


def _k5_pipeline(k5_208):
    from recon_bench import harness

    cell, rig, *_ = k5_208
    pipe = harness.pipeline(cell.config, rig, torch.device("cuda"))
    assert pipe.tsdf_cfg.res == (208, 224, 208)
    assert pipe.integrator.tier == "block-major"
    return pipe


def test_k5_208_fused_matches_staged_cuda(dev, k5_208, monkeypatch):
    """At the cell's size the fused frame equals the staged frame bit for
    bit, on two frames; the staged frame sweeps the channels-last color
    volume (``zmajor`` False); each replay launches kernel 6
    (``integrate_affine``) and the sweep once and kernel 1 never."""
    from rgbd_recon_torch.ops import raymarch_fast as rmf

    _, _, depth, color, mv, proj = k5_208
    assert depth.shape[1:] == (5, 424, 512) and color.shape[1:] == (5, 1080, 1280, 3)
    assert color.dtype == np.uint8
    pipe = _k5_pipeline(k5_208)
    pipe.cfg = pipe.cfg._replace(fused=False)
    layouts = []
    sweep = rmf.sweep

    def spy(*args):
        layouts.append(args[-1])
        return sweep(*args)

    monkeypatch.setattr(rmf, "sweep", spy)
    staged = [pipe.step(depth[i], color[i], mv, proj) for i in range(2)]
    monkeypatch.setattr(rmf, "sweep", sweep)
    assert layouts == [False, False]
    pipe.cfg = pipe.cfg._replace(fused=True)
    pipe.warmup(depth[0], color[0], mv, proj)          # the capture
    for k in native.KERNELS.values():
        k.launches = 0
    for i in (0, 1, 0):
        out = pipe.step(depth[i], color[i], mv, proj)
        torch.cuda.synchronize()
        _assert_same(out, staged[i], f"frame {i}")
    launches = {n: k.launches for n, k in native.KERNELS.items() if k.launches}
    assert launches["integrate_affine"] == 3 and launches["sweep_march"] == 3, launches
    assert "integrate_dense" not in launches, launches
    assert len(pipe._graphs.keys()) == 1


def test_k5_208_pair_counters_cuda(dev, k5_208):
    """With the recorder on, each replayed frame counts ``integrate.pairs``
    = 5 x its occupied blocks and ``integrate.pairs_culled`` between 0 and
    that, each from its own device scalar, beside the slice counter."""
    from rgbd_recon_torch.utils.timers import SPANS

    _, _, depth, color, mv, proj = k5_208
    SPANS.enable()
    try:
        pipe = _k5_pipeline(k5_208)
        occ = []
        for i in (0, 1, 0):
            occ.append(int(pipe.step(depth[i], color[i], mv, proj).occupied_bricks))
            torch.cuda.synchronize()
        with SPANS.frame():         # reads the last frame's device events
            pass
        rec = SPANS.collect()
    finally:
        SPANS.disable()
    assert rec["dropped"] == 0
    counts = {}
    for c in rec["counts"]:
        counts.setdefault(c["name"], {})[c["frame"]] = c["value"]
    pairs = [v for _, v in sorted(counts["integrate.pairs"].items())]
    culled = [v for _, v in sorted(counts["integrate.pairs_culled"].items())]
    assert pairs == [5 * n for n in occ] and min(occ) > 0
    assert all(0 <= c <= p for c, p in zip(culled, pairs)) and len(culled) == 3
    swept = counts["render.slices_swept"]
    assert all(0 < v <= swept[f] for f, v in counts["render.slices_occupied"].items())


# -- kernel 10: the quality pass (pre_quality.fs) ------------------------------

def _quality_case(case, rng):
    """(depth_b [K, H, W, 2], normals, world [K, H, W, 3], camera positions
    [K, 3]) on the CPU for one case; the depth channel is a smooth surface
    over (0, 1) with noise, steps the range window rejects and a quarter
    of the pixels outside (0 and 1 exactly, -1, 1.2)."""
    kk, h, w = {"bench": (4, 424, 512), "k5": (5, 424, 512), "ragged": (1, 37, 53),
                "all_outside": (2, 61, 97), "edges": (2, 37, 53)}[case]
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    dn = np.stack([0.25 + 0.3 * xx + 0.1 * np.sin(7 * yy + k) + 0.004 * rng.random((h, w))
                   for k in range(kk)])
    dn[:, h // 3:, w // 2:] += 0.2                  # a depth step
    dn[rng.random(dn.shape) < 0.25] = rng.choice([0.0, 1.0, -1.0, 1.2], 1)[0]
    dn = dn.astype(np.float32)
    if case == "all_outside":
        dn = rng.choice(np.array([0.0, 1.0, -1.0, 1.5, -0.1], np.float32), dn.shape)
    elif case == "edges":
        # every pixel of the four edges inside, each corner a different depth
        dn[:, [0, -1], :] = 0.41
        dn[:, :, [0, -1]] = 0.43
        dn[0, 0, 0], dn[0, 0, -1], dn[0, -1, 0], dn[0, -1, -1] = 0.2, 0.9, 0.55, 0.7
        # exact 0 and 1 among the taps of an inside pixel
        dn[1, 10, 9], dn[1, 10, 11], dn[1, 10, 10] = 0.0, 1.0, 0.6
        # a tap at exactly the range window, dist == 0.35 * d in float32
        c, s = _range_edge_pair(rng)
        dn[1, 20, 20], dn[1, 20, 23] = c, s
        # drm == 0: the smallest positive depth, one neighbour equal to it
        tiny = np.float32(np.finfo(np.float32).smallest_subnormal)
        assert np.float32(0.35) * tiny == 0
        dn[1, 30, 40], dn[1, 30, 41] = tiny, tiny
    depth_b = np.stack([dn, rng.random(dn.shape, dtype=np.float32)], -1)
    n = rng.standard_normal((kk, h, w, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    world = rng.uniform(-1, 2, (kk, h, w, 3))
    cam = rng.uniform(-3, 3, (kk, 3))
    if case == "edges":
        world[0, 5, 5] = cam[0]                     # to_cam 0: the norm's clamp
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32))
            for a in (depth_b, n, world, cam)]


def _range_edge_pair(rng):
    """(d, s) in (0, 1), float32, with |s - d| == float32(0.35) * d exactly."""
    for _ in range(100_000):
        c = np.float32(rng.uniform(0.1, 0.7))
        drm = np.float32(0.35) * c
        s = c + drm
        if abs(s - c) == drm and s < 1:
            return c, s
    raise AssertionError("no float32 pair at the range window's edge")


@pytest.mark.parametrize("case", ["bench", "k5", "ragged", "all_outside", "edges"])
def test_quality_cuda(dev, case):
    """Kernel 10 equals quality_plain on the card bit for bit, in one launch:
    at the bench shape (K = 4, 424 x 512), at K = 5, at K = 1 on a ragged
    37 x 53 frame smaller than two tiles, with every pixel outside, and on
    the edge cases (depths of exactly 0 and 1, a tap at exactly the range
    window, a zero window, the image's edges and corners, a zero distance
    to the camera)."""
    rng = np.random.default_rng(19)
    depth_b, n, world, cam = (t.to(dev) for t in _quality_case(case, rng))
    before = native.KERNELS["quality"].launches
    got = pp.quality_cuda(depth_b, n, world, cam)
    assert native.KERNELS["quality"].launches == before + 1
    want = pp.quality_plain(depth_b, n, world, cam)
    assert got.shape == want.shape == depth_b.shape[:3]
    bad = (got.view(torch.int32) != want.view(torch.int32))
    assert not bool(bad.any()), (int(bad.sum()), got[bad][:5], want[bad][:5])
    inside = (depth_b[..., 0] > 0) & (depth_b[..., 0] < 1)
    assert bool((got[~inside] == 0).all())
    if case == "all_outside":
        assert not bool(inside.any())
    else:
        assert bool((got[inside] > 0).any())


@pytest.fixture(scope="module")
def k4_256():
    """The rig, two frames (four sensors, depth 512x424, color 1280x1080 u8)
    and the camera of the benchmark cell ``k4-256.static``, from
    ``recon_bench``'s generator on the card."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    from recon_bench import discover, harness, schedule

    cell = discover.cell("k4-256.static")
    rig, depth, color = harness.make_inputs(cell.config, cell.traffic, K5_SEED, "cuda")
    mv, proj = schedule.make(cell.config, cell.traffic, K5_SEED).cameras[0]
    return cell, rig, depth[:2], color[:2], mv, proj


def test_k4_256_fused_quality_cuda(dev, k4_256, monkeypatch):
    """At ``k4-256.static``'s shape the fused frame equals the staged frame
    bit for bit on two frames, each replay launches kernel 10 once, and
    the staged frames' quality inputs give kernel 10 the twin's bits."""
    from recon_bench import harness

    cell, rig, depth, color, mv, proj = k4_256
    pipe = harness.pipeline(cell.config, rig, dev)
    pipe.cfg = pipe.cfg._replace(fused=False)
    calls = []
    kernel = pp.quality_cuda

    def spy(*args):
        calls.append(args)
        return kernel(*args)

    monkeypatch.setattr(pp, "quality_cuda", spy)
    staged = [pipe.step(depth[i], color[i], mv, proj) for i in range(2)]
    monkeypatch.setattr(pp, "quality_cuda", kernel)
    assert len(calls) == 2 and calls[0][0].shape == (4, 424, 512, 2)
    for args in calls:
        assert torch.equal(kernel(*args).view(torch.int32),
                           pp.quality_plain(*args).view(torch.int32))
    pipe.cfg = pipe.cfg._replace(fused=True)
    pipe.warmup(depth[0], color[0], mv, proj)          # the capture
    for k in native.KERNELS.values():
        k.launches = 0
    for i in (0, 1, 0):
        out = pipe.step(depth[i], color[i], mv, proj)
        torch.cuda.synchronize()
        _assert_same(out, staged[i], f"frame {i}")
    launches = {n: k.launches for n, k in native.KERNELS.items() if k.launches}
    assert launches["quality"] == 3 and launches["bilateral_accum"] == 3, launches
    assert len(pipe._graphs.keys()) == 1


# -- kernel 11: holefill, the inpaint pyramid and the colorfill resolve --------

HOLEFILL = ("holefill_level", "holefill_resolve")


def _holefill_case(case, rng):
    """(color [H, W, 4], depth [H, W], LODs) on the CPU for one case: a
    shaded image with scattered holes and hole blocks of alpha exactly 0 and
    negative, the holes in front of geometry (depth < 1) and background
    (depth >= 1, the LOD-0 holes the resolve leaves transparent)."""
    h, w, lods = {"bench": (720, 1280, 6), "odd": (45, 83, 8), "one_lod": (45, 83, 1),
                  "two_lods": (45, 83, 2), "all_hole": (64, 96, 6),
                  "no_holes": (64, 96, 6), "background": (120, 200, 6)}[case]
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    depth = 0.3 + 0.4 * xx + 0.1 * np.sin(9 * yy) + 0.01 * rng.random((h, w))
    color = np.stack([rng.random((h, w)), 0.5 * xx + 0.2 * rng.random((h, w)),
                      yy * rng.random((h, w)), 0.5 + 0.5 * rng.random((h, w))], -1)
    hole = rng.random((h, w)) < 0.3
    hole[h // 4:h // 2, w // 5:w // 2] = True          # a block several levels deep
    hole[-h // 5:, -w // 3:] = True
    far = np.zeros((h, w), bool)
    far[:h // 6, :] = True                               # background: holes at depth >= 1
    far[-h // 5:, -w // 3:] = True
    if case == "all_hole":
        hole[:] = True
        far = xx > 0.5                                   # front and back hole colors
    elif case == "no_holes":
        hole[:] = False
        far[:] = False
    elif case == "background":
        far = rng.random((h, w)) < 0.4
        hole |= far
    depth = np.where(far, 1.0 + rng.random((h, w)), depth)
    # hole alphas: exactly 0, -1 and other negatives
    color[..., 3] = np.where(hole, rng.choice([0.0, -1.0, -0.25], (h, w)), color[..., 3])
    return (torch.from_numpy(np.ascontiguousarray(color, np.float32)),
            torch.from_numpy(np.ascontiguousarray(depth, np.float32)), lods)


def _same_bits(a, b) -> bool:
    return a.shape == b.shape and bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


@pytest.mark.parametrize("case", ["bench", "odd", "one_lod", "two_lods", "all_hole",
                                  "no_holes", "background"])
def test_holefill_cuda(dev, case):
    """Kernel 11 equals the plain twins on the card bit for bit: every
    level's color and depth, the resolve on the twins' own pyramid, and the
    whole chain; one launch a level and one resolve. Cases: the bench's
    720 x 1280 with 6 LODs, an odd 45 x 83 image asking 8 LODs (odd levels,
    the stop at 1 x 2), 1 and 2 LODs, an all-hole image with front and back
    hole colors, no holes, and background pixels (LOD-0 holes at depth
    >= 1); hole alphas of exactly 0 and negative in every case."""
    rng = np.random.default_rng(21)
    color, depth, lods = _holefill_case(case, rng)
    color, depth = color.to(dev), depth.to(dev)
    before = {k: native.KERNELS[k].launches for k in HOLEFILL}
    kc, kd = inpaint.build_pyramid(color, depth, lods)
    got = inpaint.colorfill(kc, kd)
    n = len(kc)
    assert {k: native.KERNELS[k].launches - before[k] for k in HOLEFILL} == {
        "holefill_level": n - 1, "holefill_resolve": 1}
    pc, pd = inpaint.build_pyramid_plain(color, depth, lods)
    assert len(pc) == n and n == (6 if case == "odd" else lods)
    for lvl in range(1, n):
        assert _same_bits(kc[lvl], pc[lvl]), (lvl, "color")
        assert _same_bits(kd[lvl], pd[lvl]), (lvl, "depth")
    want = inpaint.colorfill_plain(pc, pd)
    assert _same_bits(inpaint.colorfill_cuda(pc, pd), want)
    bad = got.view(torch.int32) != want.view(torch.int32)
    assert not bool(bad.any()), (int(bad.sum()), got[bad][:8], want[bad][:8])
    alpha0 = color[..., 3]
    background = (alpha0 <= 0) & (depth >= 1)
    assert bool((got[background] == color[background]).all())
    if case in ("bench", "odd", "all_hole", "background"):
        assert bool(((alpha0 <= 0) & ~background).any())     # pixels the blend fills
    if case == "all_hole":
        assert bool((kc[1][..., 3] == -1).any()) and bool((kc[1][..., 1] == 1).any())


def test_holefill_cuda_refuses(dev):
    """The wrappers raise on what kernel 11 does not take (no fallback)."""
    color = torch.zeros((8, 10, 4), device=dev)
    depth = torch.zeros((8, 10), device=dev)
    with pytest.raises(TypeError):
        inpaint.inpaint_downsample_cuda(color.double(), depth)
    with pytest.raises(ValueError):
        inpaint.inpaint_downsample_cuda(color.transpose(0, 1), depth)
    with pytest.raises(ValueError):
        inpaint.inpaint_downsample_cuda(color[:1], depth[:1])
    with pytest.raises(ValueError):
        inpaint.colorfill_cuda([color] * (inpaint.MAX_LODS + 1), [depth])
    with pytest.raises(ValueError):
        inpaint.colorfill_cuda([torch.zeros((8, 5, 4), device=dev)], [depth])


def test_k4_256_fused_holefill_cuda(dev, k4_256, monkeypatch):
    """At ``k4-256.static``'s shape the fused frame equals the staged frame
    bit for bit on two frames, each replay's tally holds kernel 11's 5
    levels and one resolve, and the staged frames' holefill inputs give
    kernel 11 the twins' bits."""
    from recon_bench import harness

    cell, rig, depth, color, mv, proj = k4_256
    pipe = harness.pipeline(cell.config, rig, dev)
    pipe.cfg = pipe.cfg._replace(fused=False)
    calls = []
    pyramid = inpaint.build_pyramid

    def spy(*args):
        calls.append(args)
        return pyramid(*args)

    monkeypatch.setattr(inpaint, "build_pyramid", spy)
    staged = [pipe.step(depth[i], color[i], mv, proj) for i in range(2)]
    monkeypatch.setattr(inpaint, "build_pyramid", pyramid)
    assert len(calls) == 2 and calls[0][0].shape == (720, 1280, 4) and calls[0][2] == 6
    for args in calls:
        assert _same_bits(inpaint.colorfill(*pyramid(*args)),
                          inpaint.colorfill_plain(*inpaint.build_pyramid_plain(*args)))
    pipe.cfg = pipe.cfg._replace(fused=True)
    pipe.warmup(depth[0], color[0], mv, proj)          # the capture
    for k in native.KERNELS.values():
        k.launches = 0
    for i in (0, 1, 0):
        out = pipe.step(depth[i], color[i], mv, proj)
        torch.cuda.synchronize()
        _assert_same(out, staged[i], f"frame {i}")
    launches = {n: k.launches for n, k in native.KERNELS.items() if k.launches}
    assert launches["holefill_level"] == 3 * 5 and launches["holefill_resolve"] == 3, launches
    (key,) = pipe._graphs.keys()
    tally = pipe._graphs._graphs[key].launches
    assert tally["holefill_level"] == 5 and tally["holefill_resolve"] == 1, tally

"""Kernel 8 (``scatter_dense``) and the raw block-major mode of kernel 6
against the JAX package on the CPU.

``scatter_dense_plain`` is a pure copy, so it must equal the Pallas kernel
(interpret mode) exactly. The raw mode of ``integrate_affine`` is held
against ``integrate_affine_pallas(raw=True)`` (interpret) on the visited
blocks at the integrator bound of tests/test_tsdf_affine.py:109-116 (the
TPU kernel samples through bf16, the port in float32), with identical
``visited``; raw mode plus ``scatter_dense_plain`` must equal the
voxel-order plain output exactly. Inputs: numpy from a seed, and the
``small_rig`` fixture (3 pinhole sensors at 256x212) at 96^3.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rgbd_recon_tpu.ops import bricks as jbricks
from rgbd_recon_tpu.ops import preprocess as jpp
from rgbd_recon_tpu.ops import tsdf_affine as jaff
from rgbd_recon_tpu.ops.assemble_pallas import scatter_dense as jscatter_dense
from rgbd_recon_tpu.ops.tsdf import TsdfConfig as JTsdfConfig
from rgbd_recon_tpu.ops.tsdf_persist import integrate_affine_pallas
from rgbd_recon_tpu.ops.warp import bake_pixel_warp as jbake_pixel_warp

from rgbd_recon_torch.convert import from_jax
from rgbd_recon_torch.ops.assemble import scatter_dense, scatter_dense_plain
from rgbd_recon_torch.ops.tsdf import TsdfConfig
from rgbd_recon_torch.ops.tsdf_fast import occupied_list, pack_frames
from rgbd_recon_torch.ops.tsdf_persist import (WX2, XSTRIDE2, integrate_affine,
                                               integrate_affine_plain)

LIMIT = 0.01
N = 96            # the block-major configuration's volume (Vx % 128 != 0)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread: beside the other test workers on the same
    cores, a pool of 8 spins and a frame's small ops run 10-100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().to(torch.float32).cpu().numpy()


# (res, occupied count, list capacity): count 0; count < MB with garbage
# indices past it; every brick; a non-cubic volume
@pytest.mark.parametrize("res,count,mb", [
    ((32, 48, 32), 0, 5),
    ((32, 48, 32), 7, 12),
    ((32, 48, 32), 12, 12),
    ((64, 32, 48), 10, 16),
], ids=["count0", "garbage_past_count", "all_bricks", "non_cubic"])
def test_scatter_dense_matches_pallas(res, count, mb):
    rng = np.random.default_rng(8)
    vx, vy, vz = res
    nb = (vx // 16) * (vy // 16) * (vz // 16)
    vol_bm = rng.standard_normal((nb, 32, 128)).astype(np.float32)
    cvol_bm = rng.standard_normal((nb, 4, 32, 128)).astype(np.float32)
    idx = np.full(mb, -3, np.int32)
    idx[:count] = np.sort(rng.permutation(nb)[:count])
    idx[count::2] = nb + 1000        # out of range: never read
    cnt = np.array([count], np.int32)
    jv, jc = jscatter_dense(jnp.asarray(vol_bm), jnp.asarray(cvol_bm, jnp.bfloat16),
                            jnp.asarray(idx), jnp.asarray(cnt), res, LIMIT, interpret=True)
    tv, tc = scatter_dense(torch.from_numpy(vol_bm),
                           torch.from_numpy(cvol_bm).to(torch.bfloat16),
                           torch.from_numpy(idx), torch.from_numpy(cnt), res, LIMIT)
    assert tv.dtype == torch.float32 and tc.dtype == torch.bfloat16
    assert tuple(tv.shape) == (vz, vy, vx) and tuple(tc.shape) == (4, vz, vy, vx)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(_np(tc), np.asarray(jc, np.float32))
    assert int((tv.numpy() != -np.float32(LIMIT)).sum()) <= count * 4096


@pytest.fixture(scope="module")
def block(small_rig):
    """JAX frames, the 96^3 affine bake, windows and brick mask, and the
    JAX kernel's raw outputs on them."""
    rig, bbox = small_rig["rig"], small_rig["bbox"]
    warp = jbake_pixel_warp(rig, 212, 256)
    frames = jpp.preprocess(jnp.asarray(small_rig["depth"]), jnp.asarray(small_rig["color"]),
                            rig, warp=warp)
    grid = jbricks.make_brick_grid(bbox, 0.1, float(np.max(bbox.size) / N))
    counts = jbricks.mark_bricks(frames.world, frames.world_valid, grid)
    m16 = jbricks.block_occupancy(jbricks.occupancy_mask(counts, 10), grid, (N, N, N))
    cfg = JTsdfConfig((N,) * 3, LIMIT)
    aff = jaff.bake_affine(rig, cfg)
    wy, _ = jaff.auto_window_rows(aff, 212)
    win_off = jaff.win_offsets_affine(aff, 212, 256, wy, WX2, XSTRIDE2)
    n_occ = int(np.asarray(m16).sum())
    jraw = integrate_affine_pallas(frames, aff, cfg, m16, max_bricks=n_occ, win_off=win_off,
                                   wy=wy, interpret=True, raw=True)
    port = (from_jax(frames), from_jax(aff), TsdfConfig((N,) * 3, LIMIT), from_jax(m16),
            n_occ, from_jax(win_off), wy)
    return port, jraw


def test_integrate_affine_raw_matches_pallas(block):
    """Raw mode's plain form vs integrate_affine_pallas(raw=True): the same
    visited blocks, and on them the integrator bound."""
    port, (jv, jc, jvis) = block
    vol, cvol, visited = integrate_affine(*port, raw=True)
    nb = (N // 16) ** 3
    assert vol.shape == (nb, 32, 128) and vol.dtype == torch.float32
    assert cvol.shape == (nb, 4, 32, 128) and cvol.dtype == torch.bfloat16
    np.testing.assert_array_equal(visited.numpy(), np.asarray(jvis))
    vis = visited.numpy()
    assert vis.sum() > 20
    v, want = _np(vol)[vis], np.asarray(jv, np.float32)[vis]
    assert (np.abs(v - want) > 1e-4).mean() < 1e-4, (np.abs(v - want) > 1e-4).mean()
    occ, jocc = (v > -LIMIT + 1e-9).sum(), (want > -LIMIT + 1e-9).sum()
    assert jocc > 1000 and abs(int(occ) - int(jocc)) <= max(100, 0.002 * jocc)
    cd = np.abs(_np(cvol)[vis] - np.asarray(jc, np.float32)[vis]).max(axis=1)
    assert (cd > 1e-2).mean() < 1e-3, (cd > 1e-2).mean()


def test_raw_plus_scatter_equals_voxel_order(block):
    """Kernel 6's plain form in raw mode, assembled by kernel 8's plain
    form, is its voxel-order output bit for bit."""
    (frames, aff, cfg, m16, n_occ, win_off, wy), _ = block
    idx, _, count = occupied_list(m16, n_occ)
    args = (pack_frames(frames), aff.coeffs, idx, count, win_off, cfg.res, wy, LIMIT)
    vol_bm, cvol_bm, _ = integrate_affine_plain(*args, raw=True)
    tv, tc = scatter_dense_plain(vol_bm, cvol_bm, idx, count, cfg.res, LIMIT)
    want_v, want_c = integrate_affine_plain(*args)
    assert torch.equal(tv, want_v)
    assert torch.equal(tc.permute(1, 2, 3, 0), want_c)

"""Sensor counts other than the bench's 4 (bench.py's BENCH_SENSORS 2 and
5): the main path's stages at K = 2 and K = 5 sensors (128x104 each,
``entry._build_small``'s sizes: fwd_res (32, 48, 32), inv_res 32^3)
against the JAX functions on the same numpy inputs, at the bounds of
tests/test_torch_stages.py: stage 1, the brick counts, the affine bake
and the depth-band cull, and kernel 1's plain twin against
``integrate_dense_pallas`` (interpret mode) at 128^3. The bench-size rigs
of 2 and 5 sensors are held to the JAX package by tests/test_torch_ladder.py
and ``chip_smoke.py`` phase 15.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rgbd_recon_tpu.calibration.rig import RigCalibration as JRig
from rgbd_recon_tpu.ops import bricks as jbricks
from rgbd_recon_tpu.ops import preprocess as jpp
from rgbd_recon_tpu.ops import tsdf_affine as jaff
from rgbd_recon_tpu.ops.bricks_pallas import mark_bricks_pallas
from rgbd_recon_tpu.ops.tsdf import TsdfConfig as JTsdfConfig
from rgbd_recon_tpu.ops.tsdf_dense import integrate_dense_pallas
from rgbd_recon_tpu.ops.warp import bake_pixel_warp as jbake_pixel_warp

from rgbd_recon_torch.calibration import synthetic
from rgbd_recon_torch.calibration.rig import device_rig
from rgbd_recon_torch.convert import from_jax
from rgbd_recon_torch.ops import bricks, preprocess as pp, tsdf_affine
from rgbd_recon_torch.ops.tsdf import TsdfConfig
from rgbd_recon_torch.ops.tsdf_dense import integrate_dense
from rgbd_recon_torch.utils.math import Bbox

N = 128                      # volume res (dense emit needs Vx % 128 == 0)
LIMIT = 0.01
W, H = 128, 104              # entry._build_small's sensor size
INT_BRICKS = 16              # occupied bricks integrated (interpret mode: ~0.7 s a brick)


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


@pytest.mark.parametrize("k", [2, 5])
def test_sensor_count_matches_jax(k):
    """K sensors through stage 1, brick marking, the affine bake, the
    depth-band cull and kernel 1's twin, each against the JAX function on
    the same inputs (the JAX bakes fed to both sides where a stage is held
    alone), at tests/test_torch_stages.py's bounds."""
    bbox = Bbox.default()
    rig, cams = synthetic.synthetic_rig(num_sensors=k, bbox=bbox, fwd_res=(32, 48, 32),
                                        inv_res=(32, 32, 32), width=W, height=H)
    depth, color = synthetic.render_frames(cams, synthetic.SphereScene.default(bbox))
    jrig = JRig(*(np.asarray(getattr(rig, f)) for f in JRig._fields))

    # stage 1 on the same PixelWarp: floats atol 1e-4 on all but 5e-4 of
    # the values, world_valid on all but 1e-3 of the pixels. At 128x104 a
    # registration tile fits (at 256x212 none does): the color is
    # registered by kernel 2's twin in float32 where both JAX forms (the
    # TPU kernel, and the blocked XLA sampler it runs on the CPU) sample
    # through bf16, so it is held at kernel 2's bound, p99.5 < 2e-2
    # (tests/test_warp_pallas.py:33-34)
    warp = jbake_pixel_warp(jrig, H, W)
    jframes = jpp.preprocess(jnp.asarray(depth), jnp.asarray(color), jrig, warp=warp)
    got = pp.preprocess(torch.from_numpy(depth), torch.from_numpy(color),
                        device_rig(rig, "cpu"), pp.PreprocessConfig(), from_jax(warp))
    for f in ("depth", "silhouette", "normals", "quality", "world"):
        g, w = _np(getattr(got, f)), np.asarray(getattr(jframes, f))
        assert g.shape == w.shape and g.shape[0] == k, f
        frac = (np.abs(g - w) > 1e-4 * np.maximum(1.0, np.abs(w))).mean()
        assert frac < 5e-4, (f, frac)
    assert (got.world_valid.numpy() != np.asarray(jframes.world_valid)).mean() < 1e-3
    assert pp.registration_tile(H, W, H, W) is not None
    d = np.abs(_np(got.color_registered) - np.asarray(jframes.color_registered))
    assert np.percentile(d, 99.5) < 2e-2, np.percentile(d, 99.5)

    # brick counts and the 16^3 mask, exact, on JAX's frames
    frames = from_jax(jframes)
    voxel = float(np.max(bbox.size) / N)
    jgrid = jbricks.make_brick_grid(bbox, 0.1, voxel)
    jcounts = mark_bricks_pallas(jframes.world, jframes.world_valid, jgrid, interpret=True)
    jmask16 = jbricks.block_occupancy(jbricks.occupancy_mask(jcounts, 10), jgrid, (N, N, N))
    grid = bricks.make_brick_grid(bbox, 0.1, voxel)
    counts = bricks.mark_bricks(frames.world, frames.world_valid, grid)
    np.testing.assert_array_equal(counts.to(torch.int64).numpy(),
                                  np.asarray(jcounts).astype(np.int64))
    mask16 = bricks.block_occupancy(bricks.occupancy_mask(counts, 10), grid, (N, N, N))
    np.testing.assert_array_equal(mask16.numpy(), np.asarray(jmask16))

    # the affine bake: the warp it predicts over each valid (sensor, brick)
    # within 1e-5 at the median, under 2% of pairs above 1e-3; the window
    # sizes equal
    cfg = JTsdfConfig((N, N, N), LIMIT)
    jaf = jaff.bake_affine(jrig, cfg)
    aff = tsdf_affine.bake_affine(rig, TsdfConfig((N, N, N), LIMIT), "cpu")
    c, jc = aff.coeffs.numpy(), np.asarray(jaf.coeffs)
    assert c.shape[0] == k
    valid = jc[..., 0, 0] >= 0
    np.testing.assert_array_equal(c[..., 0, 0] >= 0, valid)
    dev = np.abs(np.einsum("knca,av->kncv", c[..., :3, :] - jc[..., :3, :],
                           tsdf_affine._brick_basis()))
    pair = dev.max(axis=(2, 3))[valid]
    assert np.median(pair) < 1e-5 and (pair > 1e-3).mean() < 0.02, (
        np.median(pair), (pair > 1e-3).mean())
    wy, _ = jaff.auto_window_rows(jaf, H)
    wx, xstride, _ = jaff.auto_window_cols(jaf, W)
    assert tsdf_affine.auto_window_rows(aff, H)[0] == wy
    assert tsdf_affine.auto_window_cols(aff, W)[:2] == (wx, xstride)

    # the depth-band cull on JAX's CullBake: mask, keep and classes exact
    jcull = jaff.bake_cull(jaf, H, W, LIMIT)
    jm2, jkeep, jcls = jaff.block_depth_cull_baked(
        jmask16, jcull, jframes.depth[..., 0], jframes.quality, jframes.silhouette, LIMIT)
    m2, keep, cls = tsdf_affine.block_depth_cull_baked(
        mask16, from_jax(jcull), frames.depth[..., 0], frames.quality, frames.silhouette, LIMIT)
    np.testing.assert_array_equal(m2.numpy(), np.asarray(jm2))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(cls.numpy(), np.asarray(jcls))
    assert cls.shape[0] == k and int(m2.sum()) > INT_BRICKS

    # kernel 1's twin against integrate_dense_pallas on the same frames,
    # bake, windows and classes, on the first INT_BRICKS bricks of the
    # culled mask: < 1e-4 of voxels off by more than 1e-4, occupied within
    # max(100, 0.2%), < 1e-3 of voxels with a color deviation above 1e-2
    # (tests/test_tsdf_affine.py:109-116)
    m = m2.numpy().copy()
    m.reshape(-1)[np.flatnonzero(m)[INT_BRICKS:]] = False
    jwin = jaff.win_offsets_affine(jaf, H, W, wy, wx, xstride)
    jv, jcv = integrate_dense_pallas(
        jframes, jaf, cfg, jnp.asarray(m), max_bricks=INT_BRICKS, win_off=jwin, wy=wy, wx=wx,
        xstride=xstride, cls=jcls, zmajor=True, vol_dtype=jnp.bfloat16, interpret=True)
    vol, cvol = integrate_dense(frames, from_jax(jaf), TsdfConfig((N, N, N), LIMIT),
                                torch.from_numpy(m), INT_BRICKS, from_jax(jwin), wy, wx,
                                xstride, from_jax(jcls))
    v, jv = _np(vol), np.asarray(jv, np.float32)
    assert (np.abs(v - jv) > 1e-4).mean() < 1e-4, (np.abs(v - jv) > 1e-4).mean()
    occ, jocc = (v > -LIMIT + 1e-9).sum(), (jv > -LIMIT + 1e-9).sum()
    assert jocc > 1000 and abs(int(occ) - int(jocc)) <= max(100, 0.002 * jocc)
    cd = np.abs(_np(cvol) - np.asarray(jcv, np.float32)).max(axis=1)
    assert (cd > 1e-2).mean() < 1e-3, (cd > 1e-2).mean()

"""The port on the adversarial scene (``ComplexScene``: a multi-blob
figure, a 2 cm free-standing panel and a concave open box): the
counterparts of tests/test_complex_scene.py's four tests, on the same
fixture (3 sensors at 128x104, fwd_res (32, 48, 32), inv_res 48^3), the
same sizes and the JAX tests' own bounds, and the port's CPU frame against
the JAX package's ``FramePipeline.step`` on it.
"""
import types

import numpy as np
import pytest
import torch

from rgbd_recon_tpu.calibration.rig import RigCalibration as JRig
from rgbd_recon_tpu.runtime.pipeline import FramePipeline as JPipe
from rgbd_recon_tpu.runtime.pipeline import PipelineConfig as JCfg

from rgbd_recon_torch.calibration import synthetic
from rgbd_recon_torch.calibration.rig import device_rig
from rgbd_recon_torch.ops import bricks as brick_ops
from rgbd_recon_torch.ops import preprocess as pp
from rgbd_recon_torch.ops import raymarch as rm
from rgbd_recon_torch.ops import raymarch_fast as rmf
from rgbd_recon_torch.ops import tsdf as tsdf_ops
from rgbd_recon_torch.ops import tsdf_affine
from rgbd_recon_torch.ops.tsdf_dense import integrate_quadratic_plain
from rgbd_recon_torch.ops.tsdf_fast import occupied_bricks, pack_frames
from rgbd_recon_torch.ops.tsdf_persist import WX2, XSTRIDE2
from rgbd_recon_torch.ops.tsdf_sparse import WY
from rgbd_recon_torch.ops.warp import bake_pixel_warp
from rgbd_recon_torch.runtime.pipeline import FramePipeline, PipelineConfig
from rgbd_recon_torch.utils.math import Bbox, look_at, perspective
from rgbd_recon_torch.utils.metrics import render_parity, render_parity_passes

# the end-to-end pipeline of tests/test_complex_scene.py:60-69
E2E = dict(render_width=128, render_height=96, tsdf_res=(64, 64, 64), brick_size=0.2,
           num_lods=5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread: beside the other test workers on the same
    cores, a pool of 8 spins and a frame's small ops run 10-100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def complex_rig():
    """tests/test_complex_scene.py's fixture, built by the port (its rig
    and frames are the JAX package's bits: tests/test_torch_calibration.py)."""
    bbox = Bbox.default()
    rig, cams = synthetic.synthetic_rig(num_sensors=3, bbox=bbox, fwd_res=(32, 48, 32),
                                        inv_res=(48, 48, 48), width=128, height=104)
    scene = synthetic.make_scene("complex", bbox)
    depth, color = synthetic.render_frames(cams, scene)
    return types.SimpleNamespace(rig=rig, cams=cams, scene=scene, depth=depth, color=color,
                                 bbox=bbox)


def _e2e_pipe(rig, bbox):
    return FramePipeline(rig, PipelineConfig(voxel_size=float(np.max(bbox.size / 64)), **E2E),
                         device="cpu")


@pytest.fixture(scope="module")
def port_e2e(complex_rig):
    pipe = _e2e_pipe(complex_rig.rig, complex_rig.bbox)
    mv, proj = pipe.default_camera()
    return pipe, pipe.step(complex_rig.depth, complex_rig.color, mv, proj)


@pytest.fixture(scope="module")
def jax_e2e(complex_rig):
    """The JAX package's FramePipeline.step on the same rig arrays and
    frames, once."""
    rig, bbox = complex_rig.rig, complex_rig.bbox
    jrig = JRig(*(np.asarray(getattr(rig, f)) for f in JRig._fields))
    jpipe = JPipe(jrig, JCfg(voxel_size=float(np.max(bbox.size / 64)), **E2E))
    mv, proj = jpipe.default_camera()
    out = jpipe.step(complex_rig.depth, complex_rig.color, mv, proj)
    return types.SimpleNamespace(**{f: np.asarray(getattr(out, f)) for f in
                                    ("color", "depth", "hit", "tsdf", "occupied_bricks")})


class _Unbounded:
    """The scene's SDF alone: the depth march evaluates it everywhere."""

    def __init__(self, scene):
        self.sdf = scene.sdf


def test_complex_scene_geometry(complex_rig):
    """The fixture exercises the adversarial features (the JAX test's
    checks: a ~2 cm panel, the concave box's cavity, coverage), and the
    depth march that skips samples far from every part gives the full
    march's depth map bit for bit (sensor 0)."""
    scene, depth = complex_rig.scene, complex_rig.depth
    assert (depth > 0).mean() > 0.05
    c = np.asarray(scene.box_c[0])
    assert scene.sdf(c[None]) < -0.005
    n = np.array([1.0, 0.0, 0.0])
    assert scene.sdf((c + 0.03 * n)[None]) > 0.015
    cavity = np.asarray(scene.box_c[1]) + np.array([0.0, 0.1, 0.0])
    d_cav = float(scene.sdf(cavity[None])[0])
    assert 0.02 < d_cav < 0.12
    full = synthetic._render_depth_general(complex_rig.cams[0], _Unbounded(scene))
    np.testing.assert_array_equal(depth[0], full)


def test_pipeline_complex_end_to_end(complex_rig, port_e2e):
    """The port's pipeline at 64^3 on the complex scene: finite output,
    plausible coverage, the capacity audit, the TSDF band on the true
    surfaces and positive voxels inside (tests/test_complex_scene.py:55-109
    bounds)."""
    pipe, out = port_e2e
    bbox, scene = complex_rig.bbox, complex_rig.scene
    assert bool(torch.isfinite(out.color).all())
    hit = out.hit.numpy()
    assert 0.02 < hit.mean() < 0.8
    n_occ = pipe.check_capacity(out)
    assert 0 < n_occ <= pipe.max_bricks
    tsdf = out.tsdf.float().numpy()
    res = tsdf.shape[::-1]
    zz, yy, xx = np.meshgrid(*[np.arange(r) for r in tsdf.shape], indexing="ij")
    size = bbox.size
    pts = np.stack([bbox.min[0] + (xx + 0.5) / res[0] * size[0],
                    bbox.min[1] + (yy + 0.5) / res[1] * size[1],
                    bbox.min[2] + (zz + 0.5) / res[2] * size[2]], axis=-1)
    sdf = scene.sdf(pts)
    voxel = float(np.max(size / 64))
    limit = float(pipe.tsdf_cfg.limit)
    band = np.abs(tsdf) < 0.99 * limit
    assert band.any()
    assert np.mean(np.abs(sdf[band]) < 3.5 * voxel) > 0.9
    pos = tsdf > 1e-4
    assert pos.any()
    assert np.mean(sdf[pos] < 3.5 * voxel) > 0.98


@pytest.fixture(scope="module")
def reference_volume(complex_rig):
    """The gather tier's frames and the reference integrators' 64^3 TSDF
    and color volume (tests/test_complex_scene.py:118-126)."""
    drig = device_rig(complex_rig.rig, "cpu", volumes=True)
    frames = pp.preprocess(torch.from_numpy(complex_rig.depth),
                           torch.from_numpy(complex_rig.color), drig, pp.PreprocessConfig(),
                           None)
    cfg = tsdf_ops.TsdfConfig(res=(64, 64, 64), limit=0.01)
    return (drig, frames, cfg, tsdf_ops.integrate(frames, drig, cfg),
            tsdf_ops.integrate_colors(frames, drig, cfg))


@pytest.mark.parametrize("eye_off", [(0.15, 0.25, 2.4), (2.3, 0.5, 0.4)])
def test_render_parity_golden_complex(complex_rig, reference_volume, eye_off):
    """The sweep against the per-ray oracle on the reference integrators'
    64^3 volume at 320x240 (tests/test_complex_scene.py:112-143 and its
    bounds: hit > 0.99, PSNR > 28 dB, depth median < 2e-3, p99 < 3e-2)."""
    bbox = complex_rig.bbox
    drig, frames, cfg, vol, cvol = reference_volume
    w, h = 320, 240
    center = (bbox.min + bbox.max) * 0.5
    proj = perspective(50.0, w / h, 0.1, 200.0)
    mv = look_at(center + np.asarray(eye_off, np.float32), center, [0, 1, 0]).astype(np.float32)
    cam = rm.RenderCamera(torch.from_numpy(mv), torch.from_numpy(proj), w, h)
    axis, flip = rmf.pick_axis(mv, rm.vol_to_world_matrix(bbox))
    slow = rm.render(vol, cvol, frames, drig, cam, bbox, cfg.limit)
    fast = rmf.render_fast(vol, cvol, cam, bbox, cfg.limit, axis, flip, zmajor=False)

    def host(o):
        return types.SimpleNamespace(color=o.color.numpy(), depth=o.depth.numpy(),
                                     hit=o.hit.numpy())

    s = render_parity(host(slow), host(fast))
    assert s["hit_agreement"] > 0.99, (eye_off, s)
    assert s["psnr_rgb"] > 28.0, (eye_off, s)
    assert s["depth_err_med"] < 2e-3, (eye_off, s)
    assert s["depth_err_p99"] < 3e-2, (eye_off, s)


def test_block_cull_safety_complex(complex_rig):
    """The depth-band cull on thin and concave geometry loses no band
    block, through kernel 1's plain twin (float32 TSDF) at 128^3 with the
    JAX test's default windows (tests/test_complex_scene.py:146-180):
    deviations only in dropped blocks, from +limit to the clear value."""
    rig, bbox = complex_rig.rig, complex_rig.bbox
    n = 128
    cfg = tsdf_ops.TsdfConfig((n, n, n), 0.01)
    lim = float(cfg.limit)
    aff = tsdf_affine.bake_affine(rig, cfg, "cpu")
    warp = bake_pixel_warp(rig, 104, 128, "cpu")
    frames = pp.preprocess(torch.from_numpy(complex_rig.depth),
                           torch.from_numpy(complex_rig.color), device_rig(rig, "cpu"),
                           pp.PreprocessConfig(), warp)
    grid = brick_ops.make_brick_grid(bbox, 0.1, float(np.max(bbox.size) / n))
    counts = brick_ops.mark_bricks(frames.world, frames.world_valid, grid)
    mask16 = brick_ops.block_occupancy(brick_ops.occupancy_mask(counts, 10), grid, cfg.res)
    m2, _, _ = tsdf_affine.block_depth_cull(mask16, aff, frames.depth[..., 0], frames.quality,
                                            frames.silhouette, lim)
    m0, m2 = mask16.numpy(), m2.numpy()
    assert (m2 <= m0).all()
    assert m0.sum() > 20, "scene too sparse to exercise the cull"
    win_off = tsdf_affine.win_offsets_affine(aff, 104, 128, WY, WX2, XSTRIDE2)
    packed = pack_frames(frames)

    def fuse(m):
        idx, count, _ = occupied_bricks(torch.from_numpy(m), 256)
        vol, _ = integrate_quadratic_plain(packed, aff.coeffs, idx, count, win_off, None,
                                           cfg.res, WY, WX2, XSTRIDE2, lim)
        return vol.numpy()

    v0, v1 = fuse(m0), fuse(m2)
    b = 16
    nb = n // b
    band_blocks = (np.abs(v0.reshape(nb, b, nb, b, nb, b)) < lim * 0.999).any((1, 3, 5)) & m0
    assert (band_blocks <= m2).all(), "cull dropped a band block"
    diff = v0 != v1
    db = diff.reshape(nb, b, nb, b, nb, b).any((1, 3, 5))
    assert (db <= (m0 & ~m2)).all()
    if diff.any():
        np.testing.assert_allclose(v0[diff], lim, rtol=0, atol=1e-6)
        np.testing.assert_allclose(v1[diff], -lim, rtol=0, atol=1e-6)


def test_step_matches_jax_complex(port_e2e, jax_e2e):
    """The port's CPU frame against the JAX package's ``FramePipeline.step``
    on the complex scene at 64^3: the render-parity bounds of
    tests/test_golden.py:65-69, the integrator bound of
    tests/test_tsdf_affine.py:109-116 and the occupied bricks equal (the
    bounds of tests/test_torch_parallel.py::test_single_step_matches_jax)."""
    _, got = port_e2e
    s = render_parity(jax_e2e, types.SimpleNamespace(color=got.color.numpy(),
                                                     depth=got.depth.numpy(),
                                                     hit=got.hit.numpy()))
    assert render_parity_passes(s) and s["hit_frac"] > 0.02, s
    v, w = got.tsdf.float().numpy(), jax_e2e.tsdf
    assert (np.abs(v - w) > 1e-4).mean() < 1e-4
    limit = 0.01
    occ, wocc = int((v > -limit + 1e-9).sum()), int((w > -limit + 1e-9).sum())
    assert abs(occ - wocc) <= max(100, 0.002 * wocc), (occ, wocc)
    assert int(got.occupied_bricks) == int(jax_e2e.occupied_bricks)

"""The realistic-calibration path of the port against the JAX package on
the CPU: the distorted camera and rig, the piecewise warp (bake,
evaluation, kernel 5's plain form against the Pallas kernel in interpret
mode), the three-tier pixel-warp gate, preprocessing per tier, and the
whole slice on the distorted rig.

The fixture is tests/test_distortion.py:23-35's: 2 sensors at 128x104,
fwd (32, 48, 32), inv (32, 32, 32), Kinect-magnitude lens distortion +
a 4 mm NNI-like world warp + offset rgb cameras. Both sides get the JAX
fixture's frames; the port's own frames are held against them in the
first test.
"""
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rgbd_recon_tpu.calibration import synthetic as jsyn
from rgbd_recon_tpu.ops import bricks as jbricks
from rgbd_recon_tpu.ops import inpaint as jinpaint
from rgbd_recon_tpu.ops import preprocess as jpp
from rgbd_recon_tpu.ops import raymarch as jrm
from rgbd_recon_tpu.ops import raymarch_fast as jrmf
from rgbd_recon_tpu.ops import tsdf_affine as jaff
from rgbd_recon_tpu.ops.piecewise_pallas import piecewise_eval_pallas
from rgbd_recon_tpu.ops.tsdf import TsdfConfig as JTsdfConfig
from rgbd_recon_tpu.ops.tsdf_dense import integrate_dense_pallas
from rgbd_recon_tpu.ops.warp import bake_piecewise_warp as jbake_piecewise_warp
from rgbd_recon_tpu.utils.math import Bbox as JBbox, look_at, perspective
from rgbd_recon_tpu.utils.metrics import render_parity

from rgbd_recon_torch.calibration import synthetic
from rgbd_recon_torch.calibration.rig import device_rig
from rgbd_recon_torch.convert import from_jax
from rgbd_recon_torch.ops import preprocess as pp
from rgbd_recon_torch.ops.warp import (PiecewiseWarp, PixelWarp, bake_piecewise_warp,
                                       piecewise_eval)
from rgbd_recon_torch.runtime.pipeline import FramePipeline, PipelineConfig
from rgbd_recon_torch.utils.math import Bbox

H, W = 104, 128
KW = dict(num_sensors=2, fwd_res=(32, 48, 32), inv_res=(32, 32, 32), width=W, height=H,
          distortion=0.004)
RES = (128, 64, 64)      # slice volume (dense emit: Vx % 128 == 0)
RW, RH = 320, 240
SWEEP = (256, 256)
LIMIT = 0.01


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


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side of these tests is ~10^5 small tensor ops (the SDF
    marcher alone unprojects 296 times per pixel). Split across threads
    they gain nothing, and beside other busy processes (parallel test
    workers) each split op can wait a scheduler slice for a descheduled
    thread: measured 573 s instead of 7 s for the rig test. One thread
    computes the same values."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    rig, cams, ccams = jsyn.synthetic_rig(bbox=JBbox.default(), **KW)
    scene = jsyn.SphereScene.default(JBbox.default())
    depth, color = jsyn.render_frames(cams, scene, color_cams=ccams)
    pw = jbake_piecewise_warp(rig, H, W, knots=48)
    frames = jpp.preprocess(jnp.asarray(depth), jnp.asarray(color), rig, warp=pw)
    return types.SimpleNamespace(rig=rig, cams=cams, depth=depth, color=color,
                                 bbox=JBbox.default(), pw=pw, frames=frames)


def test_distorted_rig_and_frames_match_jax(ref):
    """The port's distorted rig (float64 torch cameras) vs the numpy
    original: every rig field atol 1e-6 (measured: bit-identical); the
    depth frames of the SDF marcher: hit masks >= 99.9% equal, depth atol
    1e-5 on common hits."""
    rig, cams, ccams = synthetic.synthetic_rig(bbox=Bbox.default(), **KW)
    assert all(isinstance(c, synthetic.DistortedCamera) for c in cams + ccams)
    for f in rig._fields:
        np.testing.assert_allclose(getattr(rig, f), np.asarray(getattr(ref.rig, f)),
                                   atol=1e-6, rtol=0, err_msg=f)
    scene = synthetic.SphereScene.default(Bbox.default())
    depth = np.stack([synthetic.render_depth(c, scene) for c in cams])
    hit, jhit = depth > 0, ref.depth > 0
    assert (hit == jhit).mean() >= 0.999 and jhit.mean() > 0.05
    np.testing.assert_allclose(depth[hit & jhit], ref.depth[hit & jhit], atol=1e-5, rtol=0)


def _bf16_ulp(x):
    """The bf16 spacing at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def test_piecewise_bake_matches_jax(ref):
    """A and B atol 1e-6, the residual bounds within 1e-6, R equal as bf16
    except < 1e-3 of the entries, which differ by one bf16 ulp (the fit is
    summed in the numpy original's order; measured: all equal)."""
    pw = bake_piecewise_warp(from_jax(ref.rig), H, W, knots=48, device="cpu")
    assert isinstance(pw, PiecewiseWarp) and pw.knots == 48
    for f in ("xyz_a", "xyz_b", "uv_a", "uv_b"):
        np.testing.assert_allclose(getattr(pw, f).numpy(), np.asarray(getattr(ref.pw, f)),
                                   atol=1e-6, rtol=0, err_msg=f)
    for f in ("xyz_r", "uv_r"):
        got = getattr(pw, f)
        assert got.dtype == torch.bfloat16
        g = got.float().numpy()
        w = np.asarray(getattr(ref.pw, f)).astype(np.float32)
        assert g.shape == w.shape, f
        flip = g != w
        assert flip.mean() < 1e-3, (f, flip.mean())
        assert np.all(np.abs(g - w)[flip] <= _bf16_ulp(np.maximum(np.abs(g), np.abs(w)))[flip])
    assert (pw.d_min, pw.d_max) == (ref.pw.d_min, ref.pw.d_max)
    assert abs(pw.max_err_xyz - ref.pw.max_err_xyz) < 1e-6
    assert abs(pw.max_err_uv - ref.pw.max_err_uv) < 1e-6


def test_piecewise_eval_matches_jax(ref):
    """Same tables on both sides: xyz, uv, xyz_shifted in the four
    directions and the 5-tap neighborhood atol 1e-6; the plain kernel form
    vs piecewise_eval_pallas in interpret mode atol 2e-6
    (tests/test_distortion.py:172)."""
    pw = from_jax(ref.pw)
    rng = np.random.default_rng(0)
    d = rng.uniform(-0.05, 1.05, (2, H, W)).astype(np.float32)   # both clamps too
    dj, dt = jnp.asarray(d), torch.from_numpy(d)
    np.testing.assert_allclose(pw.xyz(dt).numpy(), np.asarray(ref.pw.xyz(dj)), atol=1e-6)
    np.testing.assert_allclose(pw.uv(dt).numpy(), np.asarray(ref.pw.uv(dj)), atol=1e-6)
    for dy, dx in ((1, 0), (-1, 0), (0, -1), (0, 1)):
        np.testing.assert_allclose(pw.xyz_shifted(dy, dx, dt).numpy(),
                                   np.asarray(ref.pw.xyz_shifted(dy, dx, dj)), atol=1e-6)
    scales = (1.0, 0.9, 1.1, 0.95, 1.05)
    got = pw.xyz_neighborhood(*(dt * s for s in scales))
    want = ref.pw.xyz_neighborhood(*(dj * s for s in scales))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)

    D = rng.uniform(0.0, 1.0, (5, 2, H, W)).astype(np.float32)
    want = piecewise_eval_pallas(jnp.asarray(D), ref.pw.xyz_a, ref.pw.xyz_b, ref.pw.xyz_r,
                                 ref.pw.d_min, ref.pw.d_max, interpret=True)
    got = piecewise_eval(torch.from_numpy(D), pw.xyz_a, pw.xyz_b, pw.xyz_r, pw.d_min, pw.d_max)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


def test_piecewise_eval_offsets_match_jax(ref):
    """The port's offset evaluation, one map a tap of the normal stencil,
    against piecewise_eval_pallas in interpret mode on tables shifted by
    numpy edge padding (out[y, x] = P[clamp(y+dy), clamp(x+dx)](d[y, x])),
    atol 2e-6 as the kernel form (tests/test_distortion.py:172); depths
    cross both clamps. The four shifted tables ride the sensor axis of one
    Pallas call."""
    pw = from_jax(ref.pw)
    taps = ((1, 0), (-1, 0), (0, -1), (0, 1))
    a, b, r = (np.asarray(t) for t in (ref.pw.xyz_a, ref.pw.xyz_b, ref.pw.xyz_r))
    k = a.shape[0]

    def shift(x, dy, dx, ay):   # edge-clamped shift of axes (ay, ay + 1)
        pad = [(0, 0)] * x.ndim
        pad[ay], pad[ay + 1] = (max(-dy, 0), max(dy, 0)), (max(-dx, 0), max(dx, 0))
        xp = np.pad(x, pad, mode="edge")
        sl = [slice(None)] * x.ndim
        sl[ay] = slice(max(-dy, 0) + dy, max(-dy, 0) + dy + x.shape[ay])
        sl[ay + 1] = slice(max(-dx, 0) + dx, max(-dx, 0) + dx + x.shape[ay + 1])
        return xp[tuple(sl)]

    rng = np.random.default_rng(3)
    D = rng.uniform(-0.05, 1.05, (len(taps), k, H, W)).astype(np.float32)
    want = piecewise_eval_pallas(
        jnp.asarray(D.reshape(1, len(taps) * k, H, W)),
        *(jnp.asarray(np.concatenate([shift(t, dy, dx, ay) for dy, dx in taps]))
          for t, ay in ((a, 1), (b, 1), (r, 3))),
        ref.pw.d_min, ref.pw.d_max, interpret=True)
    got = piecewise_eval(torch.from_numpy(D), pw.xyz_a, pw.xyz_b, pw.xyz_r, pw.d_min,
                         pw.d_max, offsets=taps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(got.shape), atol=2e-6)


def _pipeline(rig, **over):
    logs = []
    cfg = PipelineConfig(render_width=RW, render_height=RH, tsdf_res=(48, 48, 48),
                         voxel_size=float(np.max(Bbox.default().size) / 48),
                         brick_size=0.2, num_lods=5, **over)
    return FramePipeline(rig, cfg, log=logs.append, device="cpu"), logs


def test_warp_gate_tiers(ref, small_rig):
    """The distorted rig takes the piecewise tier (log and warp type); a
    pw_warp_tol below its residual, or use_warp=False, the gather tier
    (the device rig then carries the cv volumes); the pinhole rig stays
    affine. The log lines are the JAX pipeline's (runtime/pipeline.py:302-352)."""
    rig = from_jax(ref.rig)
    pipe, logs = _pipeline(rig)
    pipe._session(H, W)
    assert isinstance(pipe._warp, PiecewiseWarp), logs
    assert any("piecewise warp (48 knots) residual" in s and "gather" not in s
               for s in logs), logs
    assert pipe._drig.cv_xyz is None

    for over in (dict(pw_warp_tol=1e-6), dict(use_warp=False)):
        pipe, logs = _pipeline(rig, **over)
        pipe._session(H, W)
        assert pipe._warp is None and pipe._drig.cv_xyz is not None, (over, logs)
        if "pw_warp_tol" in over:
            assert any("using exact gather path" in s for s in logs), logs

    pipe, logs = _pipeline(from_jax(small_rig["rig"]))
    pipe._session(212, 256)
    assert isinstance(pipe._warp, PixelWarp), logs
    assert not any("piecewise" in s for s in logs), logs


@pytest.mark.parametrize("tier", ["piecewise", "gather"])
def test_preprocess_tier_matches_jax(ref, tier):
    """Same frames and warp; the bounds of test_preprocess_matches_jax
    (tests/test_torch_stages.py): float outputs atol 1e-4 on all but a
    5e-4 fraction of values, the validity mask on all but 1e-3 of the
    pixels. Off the TPU the JAX package registers color through its bf16
    blocked sampler when the sensor rows are a multiple of 8 (104 here,
    warp tiers only; the port's kernel 2 samples in float32), so there
    color_registered and color_lab are held at that sampler's bound
    instead: p99.5 of the deviation relative to max(1, |value|) under 2e-2
    (tests/test_warp_pallas.py:33)."""
    jwarp = ref.pw if tier == "piecewise" else None
    want = (ref.frames if jwarp is not None else
            jpp.preprocess(jnp.asarray(ref.depth), jnp.asarray(ref.color), ref.rig, warp=None))
    drig = device_rig(from_jax(ref.rig), "cpu", volumes=tier == "gather")
    got = pp.preprocess(torch.from_numpy(ref.depth), torch.from_numpy(ref.color), drig,
                        pp.PreprocessConfig(), from_jax(jwarp) if jwarp is not None else None)
    for f in ("depth", "silhouette", "normals", "quality", "color_registered",
              "color_lab", "world", "depth_morphed"):
        g, w = _np(getattr(got, f)), np.asarray(getattr(want, f))
        assert g.shape == w.shape, f
        rel = np.abs(g - w) / np.maximum(1.0, np.abs(w))
        if tier == "piecewise" and f in ("color_registered", "color_lab"):
            assert np.percentile(rel, 99.5) < 2e-2, (f, np.percentile(rel, 99.5))
            continue
        assert (rel > 1e-4).mean() < 5e-4, (f, (rel > 1e-4).mean())
    assert (got.world_valid.numpy() != np.asarray(want.world_valid)).mean() < 1e-3
    assert got.world_valid.numpy().mean() > 0.05


def test_distorted_slice_matches_jax(ref):
    """The whole slice on the distorted rig (piecewise tier, dense emit at
    128 x 64 x 64) with the port's own bakes vs the JAX stage chain (piecewise
    warp, Pallas dense integration in interpret mode), hole filling
    included, at the render-parity bounds of tests/test_golden.py:65-69.
    With 4 bricks on its shortest axis the volume takes the kernel tiers
    only with use_pallas=True (the gate's default is the XLA integrator)."""
    rig, bbox = ref.rig, ref.bbox
    cfg = JTsdfConfig(RES, LIMIT)
    voxel = float(np.max(bbox.size / np.array(RES)))
    frames = ref.frames
    grid = jbricks.make_brick_grid(bbox, 0.1, voxel)
    counts = jbricks.mark_bricks(frames.world, frames.world_valid, grid)
    mask16 = jbricks.block_occupancy(jbricks.occupancy_mask(counts, 10), grid, cfg.res)
    aff = jaff.bake_affine(rig, cfg)
    wy, _ = jaff.auto_window_rows(aff, H)
    wx, xstride, _ = jaff.auto_window_cols(aff, W)
    win_off = jaff.win_offsets_affine(aff, H, W, wy, wx, xstride)
    m2, _, cls = jaff.block_depth_cull_baked(
        mask16, jaff.bake_cull(aff, H, W, LIMIT), frames.depth[..., 0], frames.quality,
        frames.silhouette, LIMIT)
    vol, cvol = integrate_dense_pallas(
        frames, aff, cfg, m2, max_bricks=-(-int(np.asarray(m2).sum()) // 2) * 2, win_off=win_off,
        wy=wy, wx=wx, xstride=xstride, cls=cls, zmajor=True, vol_dtype=jnp.bfloat16,
        interpret=True)
    center = (bbox.min + bbox.max) * 0.5
    mv = look_at(center + np.array([1.5, 0.8, 2.2], np.float32), center, [0, 1, 0])
    proj = perspective(50.0, RW / RH, 0.1, 200.0)
    axis, flip = jrmf.pick_axis(mv, jrm.vol_to_world_matrix(bbox))
    out = jrmf.render_fast(
        vol, cvol, jrm.RenderCamera(jnp.asarray(mv), jnp.asarray(proj), RW, RH), bbox, LIMIT,
        axis, flip, jrm.RenderParams(), cfg=jrmf.SweepConfig(res=SWEEP),
        slab_occupied=jrmf.slab_occupancy(m2, axis, RES[axis]), zmajor=True)
    pc, pd = jinpaint.build_pyramid(out.color, out.depth, PipelineConfig().num_lods)
    filled = jinpaint.colorfill(pc, pd)

    logs = []
    pipe = FramePipeline(from_jax(rig), PipelineConfig(
        render_width=RW, render_height=RH, tsdf_res=RES, voxel_size=voxel,
        sweep_res=SWEEP, use_pallas=True), log=logs.append, device="cpu")
    got = pipe.step(ref.depth, ref.color, mv, proj)
    assert isinstance(pipe._warp, PiecewiseWarp) and pipe.integrator.zmajor, logs
    assert pipe.check_capacity(got) == int(np.asarray(m2).sum())
    s = render_parity(
        types.SimpleNamespace(color=np.asarray(filled), depth=np.asarray(out.depth),
                              hit=np.asarray(out.hit)),
        types.SimpleNamespace(color=_np(got.color), depth=_np(got.depth),
                              hit=got.hit.numpy()))
    # tests/test_golden.py:65-69
    assert s["hit_agreement"] > 0.995, s
    assert s["psnr_rgb"] > 30.0, s
    assert s["ssim_rgb"] > 0.95, s
    assert s["depth_err_med"] < 2e-3, s
    assert s["depth_err_p99"] < 2e-2, s
    assert s["hit_frac"] > 0.02, s

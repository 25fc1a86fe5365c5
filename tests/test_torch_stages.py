"""Stage-by-stage and end-to-end parity of the port's main frame path
against the JAX package, on the CPU at small size.

The JAX pipeline never runs the main-path kernels off the TPU (its gates
are ``jax.default_backend() == "tpu"``), so the reference here is its
stage functions chained by hand with the Pallas kernels in interpret mode
(brick marking, dense integration) or through the plain references the
JAX package runs on the CPU (bilateral scan, per-pixel registration taps,
blocked screen warp). The reference chain is computed once per module:
3 sensors at 256x212 (the ``small_rig`` fixture), a 128^3 volume, a
320x240 render with a 256x256 sweep grid.

Each stage is held alone by feeding both sides the same JAX bakes and
inputs through ``rgbd_recon_torch.convert.from_jax``; the port's own
bakes are held against the JAX bakes separately; the whole slice
(``FramePipeline.step`` with the port's own bakes) is held against the
JAX chain with the render-parity bounds of tests/test_golden.py:65-69.
"""
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rgbd_recon_tpu.ops import bricks as jbricks
from rgbd_recon_tpu.ops import inpaint as jinpaint
from rgbd_recon_tpu.ops import preprocess as jpp
from rgbd_recon_tpu.ops import raymarch as jrm
from rgbd_recon_tpu.ops import raymarch_fast as jrmf
from rgbd_recon_tpu.ops import tsdf_affine as jaff
from rgbd_recon_tpu.ops.bricks_pallas import mark_bricks_pallas
from rgbd_recon_tpu.ops.tsdf import TsdfConfig as JTsdfConfig
from rgbd_recon_tpu.ops.tsdf_dense import integrate_dense_pallas
from rgbd_recon_tpu.ops.warp import bake_pixel_warp as jbake_pixel_warp
from rgbd_recon_tpu.utils.metrics import render_parity

from rgbd_recon_torch.calibration.rig import device_rig
from rgbd_recon_torch.convert import from_jax
from rgbd_recon_torch.ops import bricks, preprocess as pp, raymarch as rm
from rgbd_recon_torch.ops import raymarch_fast as rmf, tsdf_affine
from rgbd_recon_torch.ops.tsdf import TsdfConfig
from rgbd_recon_torch.ops.tsdf_dense import integrate_dense
from rgbd_recon_torch.ops.warp import bake_pixel_warp
from rgbd_recon_torch.runtime.pipeline import FramePipeline, PipelineConfig

N = 128                      # volume res (dense emit needs Vx % 128 == 0)
RW, RH = 320, 240            # render size
SWEEP = (256, 256)           # sweep grid: the screen-warp tile (48, 64) fits
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
    return t.detach().to(torch.float32).cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.fixture(scope="module")
def ref(small_rig):
    """The JAX stage chain, once."""
    rig, bbox = small_rig["rig"], small_rig["bbox"]
    depth, color = small_rig["depth"], small_rig["color"]
    k, h, w = depth.shape
    warp = jbake_pixel_warp(rig, h, w)
    frames = jpp.preprocess(jnp.asarray(depth), jnp.asarray(color), rig, warp=warp)
    cfg = JTsdfConfig((N, N, N), LIMIT)
    voxel = float(np.max(bbox.size) / N)
    aff = jaff.bake_affine(rig, cfg)
    grid = jbricks.make_brick_grid(bbox, 0.1, voxel)
    counts = mark_bricks_pallas(frames.world, frames.world_valid, grid, interpret=True)
    mask16 = jbricks.block_occupancy(jbricks.occupancy_mask(counts, 10), grid, cfg.res)
    wy, _ = jaff.auto_window_rows(aff, h)
    wx, xstride, _ = jaff.auto_window_cols(aff, w)
    win_off = jaff.win_offsets_affine(aff, h, w, wy, wx, xstride)
    cull = jaff.bake_cull(aff, h, w, LIMIT)
    m2, keep, cls = jaff.block_depth_cull_baked(
        mask16, cull, frames.depth[..., 0], frames.quality, frames.silhouette, LIMIT)
    nb = (N // 16) ** 3
    max_bricks = min(nb, max(1024, nb // 4))
    vol, cvol = integrate_dense_pallas(
        frames, aff, cfg, m2, max_bricks=max_bricks, win_off=win_off, wy=wy,
        wx=wx, xstride=xstride, cls=cls, zmajor=True, vol_dtype=jnp.bfloat16,
        interpret=True)
    pipe_cfg = PipelineConfig(render_width=RW, render_height=RH,
                              tsdf_res=(N, N, N), voxel_size=voxel,
                              sweep_res=SWEEP)
    center = (bbox.min + bbox.max) * 0.5
    from rgbd_recon_tpu.utils.math import look_at, perspective
    mv = look_at(center + np.array([1.5, 0.8, 2.2], np.float32), center, [0, 1, 0])
    proj = perspective(50.0, RW / RH, 0.1, 200.0)
    axis, flip = jrmf.pick_axis(mv, jrm.vol_to_world_matrix(bbox))
    cam = jrm.RenderCamera(jnp.asarray(mv), jnp.asarray(proj), RW, RH)
    out = jrmf.render_fast(
        vol, cvol, cam, bbox, LIMIT, axis, flip, jrm.RenderParams(),
        cfg=jrmf.SweepConfig(res=SWEEP),
        slab_occupied=jrmf.slab_occupancy(m2, axis, N), zmajor=True)
    pc, pd = jinpaint.build_pyramid(out.color, out.depth, pipe_cfg.num_lods)
    filled = jinpaint.colorfill(pc, pd)
    return types.SimpleNamespace(
        rig=rig, bbox=bbox, depth=depth, color=color, warp=warp, frames=frames,
        aff=aff, grid=grid, counts=counts, mask16=mask16, wy=wy, wx=wx,
        xstride=xstride, win_off=win_off, cull=cull, m2=m2, keep=keep, cls=cls,
        max_bricks=max_bricks, vol=vol, cvol=cvol, mv=mv, proj=proj, axis=axis,
        flip=flip, out=out, filled=filled, pipe_cfg=pipe_cfg, voxel=voxel)


def test_pixel_warp_bake_matches_jax(ref):
    """The port's torch bake vs the JAX numpy bake: atol 1e-5 (meters for
    xyz, normalized texcoords for uv) — float32 sums in another order over
    the 48 depth slices."""
    warp = bake_pixel_warp(from_jax(ref.rig), 212, 256, device="cpu")
    for f in ("xyz_a", "xyz_b", "uv_a", "uv_b"):
        np.testing.assert_allclose(getattr(warp, f).numpy(),
                                   np.asarray(getattr(ref.warp, f)),
                                   atol=1e-5, rtol=0, err_msg=f)
    assert warp.d_min == ref.warp.d_min and warp.d_max == ref.warp.d_max
    assert abs(warp.max_err_xyz - ref.warp.max_err_xyz) < 1e-6
    assert abs(warp.max_err_uv - ref.warp.max_err_uv) < 1e-6


def test_session_bakes_match_jax(ref):
    """The port's bakes vs the JAX bakes. The affine fit is held by the
    warp it predicts over each valid (sensor, brick): a median deviation
    under 1e-5 (normalized units) and under 2% of pairs above 1e-3 — the
    normal equations of frustum-edge bricks with few clean voxels are
    ill-conditioned, so the JAX bake's float32 solve amplifies its rounding
    there in extrapolated voxels (measured: 20 of 1508 pairs above 1e-3
    against the port's float64 solve; see ROADMAP queue 3). Window sizes exact. Window origins, cull cells and
    cull depth bands (within 1e-4) are functions of the fit's footprint
    hull, so they follow the fit: each may differ on under 2% of entries."""
    aff = tsdf_affine.bake_affine(from_jax(ref.rig), TsdfConfig((N, N, N), LIMIT), "cpu")
    c, jc = aff.coeffs.numpy(), np.asarray(ref.aff.coeffs)
    valid = jc[..., 0, 0] >= 0
    np.testing.assert_array_equal(c[..., 0, 0] >= 0, valid)
    basis = tsdf_affine._brick_basis()
    dev = np.abs(np.einsum("knca,av->kncv", c[..., :3, :] - jc[..., :3, :], basis))
    pair = dev.max(axis=(2, 3))[valid]
    assert np.median(pair) < 1e-5 and (pair > 1e-3).mean() < 0.02, (
        np.median(pair), (pair > 1e-3).mean())
    assert float(aff.max_err.max()) < 0.02 and float(ref.aff.max_err.max()) < 0.02
    assert tsdf_affine.auto_window_rows(aff, 212)[0] == ref.wy
    assert tsdf_affine.auto_window_cols(aff, 256)[:2] == (ref.wx, ref.xstride)
    win_off = tsdf_affine.win_offsets_affine(aff, 212, 256, ref.wy, ref.wx, ref.xstride)
    assert (win_off.numpy() != np.asarray(ref.win_off)).mean() < 0.02
    cull = tsdf_affine.bake_cull(aff, 212, 256, LIMIT)
    for f in ("d_lo", "d_hi"):
        d = np.abs(getattr(cull, f).numpy() - np.asarray(getattr(ref.cull, f)))
        assert (d > 1e-4).mean() < 0.02, f
    for f in ("cya", "cyb", "cxa", "cxb", "wide", "edge", "valid"):
        assert (getattr(cull, f).numpy() != np.asarray(getattr(ref.cull, f))).mean() < 0.02, f


def test_preprocess_matches_jax(ref):
    """Same PixelWarp, same frames. Float outputs atol 1e-4 on all but a
    5e-4 fraction of values (the LAB/bilateral sums round differently, and
    a value sitting on one of the boundary/quality thresholds may flip);
    the validity mask may differ on at most 1e-3 of the pixels."""
    drig = device_rig(from_jax(ref.rig), "cpu")
    got = pp.preprocess(torch.from_numpy(ref.depth), torch.from_numpy(ref.color),
                        drig, pp.PreprocessConfig(), from_jax(ref.warp))
    for f in ("depth", "silhouette", "normals", "quality", "color_registered",
              "color_lab", "world", "depth_morphed"):
        g, w = _np(getattr(got, f)), np.asarray(getattr(ref.frames, f))
        assert g.shape == w.shape, f
        frac = (np.abs(g - w) > 1e-4 * np.maximum(1.0, np.abs(w))).mean()
        assert frac < 5e-4, (f, frac)
    assert (got.world_valid.numpy() != np.asarray(ref.frames.world_valid)).mean() < 1e-3


def test_occupancy_and_cull_exact(ref):
    """Brick counts (integer-exact) and the culled mask, keep and class
    arrays (exact: the golden form of tests/test_block_cull.py:193-204) on
    the same frames and the same CullBake."""
    frames = from_jax(ref.frames)
    grid = bricks.make_brick_grid(ref.bbox, 0.1, ref.voxel)
    counts = bricks.mark_bricks(frames.world, frames.world_valid, grid)
    np.testing.assert_array_equal(counts.to(torch.int64).numpy(),
                                  np.asarray(ref.counts).astype(np.int64))
    mask16 = bricks.block_occupancy(bricks.occupancy_mask(counts, 10), grid, (N, N, N))
    np.testing.assert_array_equal(mask16.numpy(), np.asarray(ref.mask16))
    m2, keep, cls = tsdf_affine.block_depth_cull_baked(
        mask16, from_jax(ref.cull), frames.depth[..., 0], frames.quality,
        frames.silhouette, LIMIT)
    np.testing.assert_array_equal(m2.numpy(), np.asarray(ref.m2))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(ref.keep))
    np.testing.assert_array_equal(cls.numpy(), np.asarray(ref.cls))
    assert int(m2.sum()) > 20


def test_integrate_dense_matches_pallas(ref):
    """integrate_dense (plain form) vs integrate_dense_pallas in interpret
    mode on the same frames, bake, windows, classes and mask, at the
    repo's bound between formulations (tests/test_tsdf_affine.py:109-116):
    < 1e-4 of voxels off by more than 1e-4, occupied count within
    max(100, 0.2%), < 1e-3 of voxels with a color deviation above 1e-2.
    The TPU kernel samples quality, silhouette and color through bf16
    windows and weights; the port samples in float32."""
    vol, cvol = integrate_dense(
        from_jax(ref.frames), from_jax(ref.aff), TsdfConfig((N, N, N), LIMIT),
        from_jax(ref.m2), ref.max_bricks, from_jax(ref.win_off), ref.wy,
        ref.wx, ref.xstride, from_jax(ref.cls))
    assert vol.dtype == torch.bfloat16 and cvol.shape == (N, 4, N, N)
    v, jv = _np(vol), np.asarray(ref.vol, np.float32)
    assert (np.abs(v - jv) > 1e-4).mean() < 1e-4, (np.abs(v - jv) > 1e-4).mean()
    occ, jocc = (v > -LIMIT + 1e-9).sum(), (jv > -LIMIT + 1e-9).sum()
    assert jocc > 1000 and abs(int(occ) - int(jocc)) <= max(100, 0.002 * jocc)
    cd = np.abs(_np(cvol) - np.asarray(ref.cvol, np.float32)).max(axis=1)
    assert (cd > 1e-2).mean() < 1e-3, (cd > 1e-2).mean()


def test_integrate_dense_classes_match_pallas(ref):
    """The four per-(sensor, brick) classes (FULL / NONE / FRONT /
    INVALID), drawn at random over 12 occupied bricks so each one runs,
    against the Pallas kernel at the same bound as above."""
    m = np.asarray(ref.m2).copy()
    occ = np.flatnonzero(m)
    m.reshape(-1)[occ[12:]] = False
    cls = np.random.default_rng(5).integers(0, 4, np.asarray(ref.cls).shape).astype(np.int32)
    cfg = JTsdfConfig((N, N, N), LIMIT)
    jv, jc = integrate_dense_pallas(
        ref.frames, ref.aff, cfg, jnp.asarray(m), max_bricks=ref.max_bricks,
        win_off=ref.win_off, wy=ref.wy, wx=ref.wx, xstride=ref.xstride,
        cls=jnp.asarray(cls), zmajor=True, vol_dtype=jnp.bfloat16, interpret=True)
    vol, cvol = integrate_dense(
        from_jax(ref.frames), from_jax(ref.aff), TsdfConfig((N, N, N), LIMIT),
        torch.from_numpy(m), ref.max_bricks, from_jax(ref.win_off), ref.wy,
        ref.wx, ref.xstride, torch.from_numpy(cls))
    v, jv = _np(vol), np.asarray(jv, np.float32)
    assert (np.abs(v - jv) > 1e-4).mean() < 1e-4
    cd = np.abs(_np(cvol) - np.asarray(jc, np.float32)).max(axis=1)
    assert (cd > 1e-2).mean() < 1e-3
    sel = cls[:, occ[:12]]
    assert all((sel == c).any() for c in range(4)), sel


def _parity(port_out, jax_color, jax_out):
    got = types.SimpleNamespace(color=_np(port_out.color), depth=_np(port_out.depth),
                                hit=port_out.hit.numpy())
    want = types.SimpleNamespace(color=np.asarray(jax_color), depth=np.asarray(jax_out.depth),
                                 hit=np.asarray(jax_out.hit))
    s = render_parity(want, got)
    # tests/test_golden.py:65-69
    assert s["hit_agreement"] > 0.995, s
    assert s["psnr_rgb"] > 30.0, s
    assert s["ssim_rgb"] > 0.95, s
    assert s["depth_err_med"] < 2e-3, s
    assert s["depth_err_p99"] < 2e-2, s
    assert s["hit_frac"] > 0.02, s
    return s


def test_render_matches_jax(ref):
    """The sweep renderer + screen warp alone, on the JAX volumes, at the
    render-parity bounds of tests/test_golden.py:65-69."""
    cam = rm.RenderCamera(torch.from_numpy(ref.mv), torch.from_numpy(ref.proj), RW, RH)
    vol = from_jax(ref.vol.astype(jnp.float32)).to(torch.bfloat16)
    cvol = from_jax(ref.cvol.astype(jnp.float32)).to(torch.bfloat16)
    occ = rmf.slab_occupancy(from_jax(ref.m2), ref.axis, N)
    out = rmf.render_fast(vol, cvol, cam, ref.bbox, LIMIT, ref.axis, ref.flip,
                          rm.RenderParams(), rmf.SweepConfig(res=SWEEP), occ)
    assert rmf.screen_tile(RH, RW, *SWEEP) is not None   # the kernel's path
    _parity(out, ref.out.color, ref.out)


def test_slice_matches_jax(ref):
    """The whole slice: the port's FramePipeline.step, with its own session
    bakes, vs the JAX stage chain, hole filling included, at the
    render-parity bounds of tests/test_golden.py:65-69."""
    pipe = FramePipeline(from_jax(ref.rig), ref.pipe_cfg, device="cpu")
    out = pipe.step(ref.depth, ref.color, ref.mv, ref.proj)
    assert pipe.check_capacity(out) == int(np.asarray(ref.m2).sum())
    assert out.tsdf.shape == (N, N, N) and out.color.shape == (RH, RW, 4)
    assert bool(torch.isfinite(out.color).all())
    _parity(out, ref.filled, ref.out)
    # step_timed: same frame, the four reference stage timers filled
    out2 = pipe.step_timed(ref.depth, ref.color, ref.mv, ref.proj)
    assert torch.equal(out2.color, out.color)
    assert all(pipe.timers.timers[t].count == 1 for t in
               ("1preprocess", "2integrate", "3recon", "holefill"))


def test_fused_slice_matches_jax(ref):
    """Fused mode (``cfg.fused``: the frame function with the slab flags on
    the device, run eagerly on the CPU) on the same chain, at the bounds of
    test_slice_matches_jax; ``step_timed`` records the whole frame under
    3recon alone, as the JAX pipeline's fused step does."""
    pipe = FramePipeline(from_jax(ref.rig), ref.pipe_cfg._replace(fused=True), device="cpu")
    out = pipe.step(ref.depth, ref.color, ref.mv, ref.proj)
    assert pipe.check_capacity(out) == int(np.asarray(ref.m2).sum())
    assert out.tsdf.shape == (N, N, N) and out.color.shape == (RH, RW, 4)
    _parity(out, ref.filled, ref.out)
    out2 = pipe.step_timed(ref.depth, ref.color, ref.mv, ref.proj)
    assert torch.equal(out2.color, out.color)
    assert [pipe.timers.timers[t].count for t in
            ("1preprocess", "2integrate", "3recon", "holefill")] == [0, 0, 1, 0]


@pytest.mark.parametrize("res, use_pallas, kernel_tiers", [
    ((48, 48, 48), None, False), ((128, 64, 64), None, False),
    ((48, 48, 48), True, True), ((128, 128, 128), False, False),
])
def test_pipeline_integrator_gate(small_rig, res, use_pallas, kernel_tiers):
    """The JAX pipeline's gate (rgbd_recon_tpu/runtime/pipeline.py:444-449):
    use_pallas=None takes the kernel tiers (here the affine bake) only with
    8 or more bricks on every axis, else the XLA table integrator with the
    dense tables and the square windows of tsdf_fast.win_offsets; an
    explicit use_pallas wins at any size."""
    from rgbd_recon_torch.calibration.rig import RigCalibration
    from rgbd_recon_torch.ops import tsdf_fast

    rig = RigCalibration(*(np.asarray(getattr(small_rig["rig"], f))
                           for f in RigCalibration._fields))
    cfg = PipelineConfig(render_width=64, render_height=48, tsdf_res=res,
                         voxel_size=float(np.max(small_rig["bbox"].size) / res[0]),
                         use_pallas=use_pallas)
    pipe = FramePipeline(rig, cfg, device="cpu")
    integ = pipe.integrator
    assert (integ.tier != "table integrator") is kernel_tiers
    assert (integ.affine is not None) is kernel_tiers and (integ.tables is None) is kernel_tiers
    pipe._session(212, 256)
    if not kernel_tiers:
        assert torch.equal(integ.win_off, tsdf_fast.win_offsets(integ.tables, 212, 256, 64))

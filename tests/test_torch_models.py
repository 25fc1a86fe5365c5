"""The reconstruction strategies (``rgbd_recon_torch.models``), the forward
splat (``ops/splat.py``) and the XLA table integrator
(``tsdf_fast.integrate_sparse``) against the JAX package, on the CPU.

One module fixture preprocesses the session ``small_rig`` frames with the
JAX package (the exact gather tier, as tests/test_models.py:14-30 does) and
carries them to the port with ``convert.from_jax``, so both strategies draw
from the same frames through the 128x96 camera of tests/test_models.py.
Images are held at the render-parity bounds of tests/test_golden.py:65-69;
the splat's z-buffer and winners exactly, its sums at float32 tolerance;
the integrator at the bound of tests/test_tsdf_affine.py:109-116.

The JAX mvt filter (169 unrolled taps a sensor) takes minutes to compile,
so it runs op by op under ``jax.disable_jit`` once per sensor (the
``jmvt`` fixture), and the jitted JAX ReconMVT reads those results through
a host callback keyed by its input: the same function on the same inputs.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_recon_tpu import models as jmodels
from rgbd_recon_tpu.models import integration as jintegration
from rgbd_recon_tpu.models import mvt as jmvt_module
from rgbd_recon_tpu.models.mvt import mvt_bilateral as jmvt_bilateral
from rgbd_recon_tpu.ops import bricks as jbricks
from rgbd_recon_tpu.ops import preprocess as jpp
from rgbd_recon_tpu.ops import splat as jsplat
from rgbd_recon_tpu.ops import tsdf_fast as jfast
from rgbd_recon_tpu.ops.raymarch import RenderCamera as JRenderCamera
from rgbd_recon_tpu.ops.tsdf import TsdfConfig as JTsdfConfig

from rgbd_recon_torch import models
from rgbd_recon_torch.convert import from_jax
from rgbd_recon_torch.models.mvt import mvt_bilateral
from rgbd_recon_torch.ops import splat, tsdf_fast
from rgbd_recon_torch.ops.raymarch import RenderCamera
from rgbd_recon_torch.ops.tsdf import TsdfConfig
from rgbd_recon_torch.utils.math import look_at, perspective
from rgbd_recon_torch.utils.metrics import render_parity

W, H = 128, 96
N = 48            # the voxel size of tests/test_models.py:82-89: bbox / 48
LIMIT = 0.01


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread: beside the other test workers on the same
    cores, a pool of 8 spins and a frame's small ops run 10-100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cams(mv, proj, w=W, h=H):
    return (JRenderCamera(jnp.asarray(mv), jnp.asarray(proj), w, h),
            RenderCamera(torch.from_numpy(mv), torch.from_numpy(proj), w, h))


@pytest.fixture(scope="module")
def jmvt(ref):
    """JAX mvt_bilateral of each sensor's raw depth, run op by op: input
    bytes -> (filtered, lateral^30) as numpy."""
    lim = np.asarray(ref.rig.depth_limits)
    out = {}
    with jax.disable_jit():
        for k in range(lim.shape[0]):
            raw = ref.frames.depth_raw[k:k + 1]
            f, lq = jmvt_bilateral(raw, lim[k, 0], lim[k, 1])
            out[np.asarray(raw).tobytes()] = (np.asarray(f), np.asarray(lq))
    return out


@pytest.fixture(scope="module")
def ref(small_rig):
    rig, bbox = small_rig["rig"], small_rig["bbox"]
    frames = jpp.preprocess(jnp.asarray(small_rig["depth"]), jnp.asarray(small_rig["color"]),
                            rig)
    center = (bbox.min + bbox.max) * 0.5
    mv = look_at(center + np.array([1.3, 0.8, 1.9], np.float32), center, [0, 1, 0])
    jcam, cam = _cams(mv, perspective(50.0, W / H, 0.1, 200.0))
    return types.SimpleNamespace(
        rig=rig, bbox=bbox, frames=frames, tframes=from_jax(frames), jcam=jcam, cam=cam,
        jctx=jmodels.ReconContext(rig=rig, bbox=bbox, width=W, height=H),
        ctx=models.ReconContext(rig=from_jax(rig), bbox=bbox, width=W, height=H,
                                device="cpu"))


def _parity(name, jrgba, jdepth, rgba, depth, hit_of):
    """Render parity (tests/test_golden.py:65-69) of two (rgba, depth)
    images; ``hit_of(rgba, depth)`` -> hit mask. Returns the stats, with
    the pixels whose hit or color (max channel > 1e-3) differ."""
    a = types.SimpleNamespace(color=np.asarray(jrgba), depth=np.asarray(jdepth))
    b = types.SimpleNamespace(color=rgba.numpy(), depth=depth.numpy())
    a.hit, b.hit = hit_of(a.color, a.depth), hit_of(b.color, b.depth)
    s = render_parity(a, b)
    s["pixels_differing"] = int(((a.hit != b.hit)
                                 | (np.abs(a.color - b.color).max(-1) > 1e-3)).sum())
    print(f"{name}: {s}")
    assert s["hit_agreement"] > 0.995, (name, s)
    assert s["psnr_rgb"] > 30.0, (name, s)
    assert s["ssim_rgb"] > 0.95, (name, s)
    assert s["depth_err_med"] < 2e-3, (name, s)
    assert s["depth_err_p99"] < 2e-2, (name, s)
    assert s["hit_frac"] > 0.02, (name, s)
    return s


def _alpha_hit(rgba, depth):
    return rgba[..., 3] > 0


# -- ops/splat.py ----------------------------------------------------------


def _points(seed, n=3000):
    """Seeded points around a camera's view: some past every image edge,
    some behind the camera, every tenth an exact copy of another with
    another color (ties), random validity and quality."""
    rng = np.random.default_rng(seed)
    world = rng.uniform([-1.6, -1.2, -4.0], [1.6, 1.2, 1.0], (n, 3)).astype(np.float32)
    world[1::10] = world[0::10][:len(world[1::10])]
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    quality = rng.uniform(0.1, 1.0, n).astype(np.float32)
    valid = rng.uniform(0, 1, n) < 0.9
    mv = look_at(np.array([0.0, 0.0, 2.0], np.float32), np.zeros(3, np.float32), [0, 1, 0])
    return world, colors, quality, valid, mv, perspective(50.0, 64 / 48, 0.1, 50.0)


def test_zbuffer_points_matches_jax():
    """Pass 1 exactly; the winners of tied pixels are the JAX function's
    last update (ties counted: each tie has two winners within 1e-7)."""
    world, colors, _, valid, mv, proj = _points(0)
    jcam, cam = _cams(mv, proj, 64, 48)
    jrgba, jdepth = jsplat.zbuffer_points(jnp.asarray(world), jnp.asarray(colors),
                                          jnp.asarray(valid), jcam, 4.0)
    rgba, depth = splat.zbuffer_points(torch.from_numpy(world), torch.from_numpy(colors),
                                       torch.from_numpy(valid), cam, 4.0)
    np.testing.assert_array_equal(depth.numpy(), np.asarray(jdepth))
    # the tied pixels: more than one covered point within 1e-7 of the min
    pxy, pos_es, _, inside = splat.project(torch.from_numpy(world), cam)
    zb = depth.reshape(-1)
    idx = torch.cat([splat._flat_indices(pxy, cam, dx, dy)
                     for dy in range(-1, 2) for dx in range(-1, 2)])
    ok = torch.from_numpy(valid) & inside & (-pos_es[..., 2] > 0)
    size = torch.clamp(4.0 / torch.clamp(torch.linalg.vector_norm(pos_es, dim=-1), min=1e-6),
                       1.0, 3.0)
    cov = torch.cat([ok & (size >= max(abs(dx), abs(dy)) * 2.0 - 1.0 + 1e-6)
                     for dy in range(-1, 2) for dx in range(-1, 2)])
    z = (-pos_es[..., 2]).repeat(9)
    win = cov & (z <= zb[idx] + 1e-7)
    ties = int((torch.bincount(idx[win], minlength=zb.numel()) > 1).sum())
    print(f"zbuffer_points: {ties} tied pixels of {int((zb < float('inf')).sum())} covered")
    assert ties > 20
    np.testing.assert_array_equal(rgba.numpy(), np.asarray(jrgba))
    # edge clamps: footprints past the image edge land on its border pixels
    alpha = rgba.numpy()[..., 3]
    assert (alpha[[0, -1]] > 0).any() and (alpha[:, [0, -1]] > 0).any()


@pytest.mark.parametrize("footprint, adaptive", [(2, False), (6, True)])
def test_splat_normalize_matches_jax(footprint, adaptive):
    """Pass 1 exactly, pass 2's sums (in another order) at rtol 1e-5, the
    resolve at atol 1e-5; the adaptive case with per-point
    sizes up to the cap."""
    world, colors, quality, valid, mv, proj = _points(1)
    jcam, cam = _cams(mv, proj, 64, 48)
    size = np.random.default_rng(2).uniform(0.5, 7.0, world.shape[0]).astype(np.float32)
    jbuf = jsplat.splat(jnp.asarray(world), jnp.asarray(colors), jnp.asarray(quality),
                        jnp.asarray(valid), jcam, footprint=footprint,
                        size=jnp.asarray(size) if adaptive else None)
    buf = splat.splat(torch.from_numpy(world), torch.from_numpy(colors),
                      torch.from_numpy(quality), torch.from_numpy(valid), cam,
                      footprint=footprint, size=torch.from_numpy(size) if adaptive else None)
    np.testing.assert_array_equal(buf.depth.numpy(), np.asarray(jbuf.depth))
    np.testing.assert_allclose(buf.color.numpy(), np.asarray(jbuf.color), rtol=1e-5, atol=1e-6)
    jrgba, jhit, _ = jsplat.normalize(jbuf)
    rgba, hit, _ = splat.normalize(buf)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    np.testing.assert_allclose(rgba.numpy(), np.asarray(jrgba), atol=1e-5)
    assert int(hit.sum()) > 100


# -- models ----------------------------------------------------------------


def test_mvt_bilateral_matches_jax(ref, jmvt):
    """The 169-tap filter of mvt_accum.vs, taps batched, atol 1e-5 (sums
    over the taps in another order)."""
    lim = np.asarray(ref.rig.depth_limits)
    for k in range(lim.shape[0]):
        jf, jl = jmvt[np.asarray(ref.frames.depth_raw[k:k + 1]).tobytes()]
        f, lq = mvt_bilateral(ref.tframes.depth_raw[k:k + 1], torch.tensor(lim[k, 0]),
                              torch.tensor(lim[k, 1]))
        np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=1e-5)
        np.testing.assert_allclose(lq.numpy(), np.asarray(jl), atol=1e-5)
        assert (f.numpy() > 0).mean() > 0.05


@pytest.mark.parametrize("shade_mode", [0, 1, 2, 3])
def test_points_matches_jax(ref, shade_mode):
    """ReconPoints in each shade mode (color, Phong, normals, camera
    colors) at the render-parity bounds."""
    jm = jmodels.ReconPoints(ref.jctx, shade_mode=shade_mode)
    jrgba, jdepth = jm._draw(ref.frames, (ref.jcam.modelview, ref.jcam.proj), W, H)
    rgba, depth = models.ReconPoints(ref.ctx, shade_mode).draw_with_depth(ref.tframes, ref.cam)
    _parity(f"points[{shade_mode}]", jrgba, jdepth, rgba, depth, _alpha_hit)


@pytest.mark.parametrize("cls, kw", [
    ("ReconTrigrid", dict(adaptive=True)),
    ("ReconTrigrid", dict(adaptive=False)),
    ("ReconMVT", dict()),
], ids=["trigrid-adaptive", "trigrid-fixed", "mvt"])
def test_grid_strategies_match_jax(ref, jmvt, monkeypatch, cls, kw):
    """ReconTrigrid (the adaptive footprint up to its cap of 6 px, and the
    fixed 2 px square) and ReconMVT at the render-parity bounds."""
    def filtered(raw, cv_min, cv_max):   # the jmvt fixture's results (module docstring)
        spec = jax.ShapeDtypeStruct(raw.shape, raw.dtype)
        return jax.pure_callback(lambda r: jmvt[np.asarray(r).tobytes()], (spec, spec), raw)

    monkeypatch.setattr(jmvt_module, "mvt_bilateral", filtered)
    jm = getattr(jmodels, cls)(ref.jctx, **kw)
    jrgba, jdepth = jm._draw(ref.frames, (ref.jcam.modelview, ref.jcam.proj), W, H)
    rgba, depth = getattr(models, cls)(ref.ctx, **kw).draw_with_depth(ref.tframes, ref.cam)
    _parity(cls + str(kw), jrgba, jdepth, rgba, depth, _alpha_hit)


def test_calibs_matches_jax(ref):
    """ReconCalibs for sensor 1 (its draw at the render-parity bounds, the
    slice mosaic exactly)."""
    jm = jmodels.ReconCalibs(ref.jctx)
    m = models.ReconCalibs(ref.ctx)
    jm.set_active_kinect(4)
    m.set_active_kinect(4)
    assert m.active == jm.active == 1
    jrgba = jm.draw(ref.frames, ref.jcam)
    rgba, depth = m.draw_with_depth(ref.tframes, ref.cam)
    # the JAX strategy returns no depth: the images alone are held
    s = _parity("calibs", jrgba, np.zeros(jrgba.shape[:2]), rgba, torch.zeros(depth.shape),
                _alpha_hit)
    assert s["hit_frac"] > 0.05
    np.testing.assert_array_equal(m.slice_mosaic(), jm.slice_mosaic())
    np.testing.assert_array_equal(m.slice_mosaic("cv_xyz", 4), jm.slice_mosaic("cv_xyz", 4))


@pytest.fixture(scope="module")
def jint(ref):
    """The JAX XLA integrator at 48^3 on the fixture's frames (brick_size
    0.2, 10 points a brick), once: its inputs and (vol, cvol) as numpy.
    ``max_bricks`` is the occupied count: entries past it are dropped
    either way, and the JAX strategy's default 1024 costs minutes and
    gigabytes of hat products on a CPU."""
    voxel = float(np.max(ref.bbox.size) / N)
    jcfg = JTsdfConfig((N, N, N), LIMIT)
    grid = jbricks.make_brick_grid(ref.bbox, 0.2, voxel)
    mask16 = jbricks.block_occupancy(jbricks.occupancy_mask(jbricks.mark_bricks(
        ref.frames.world, ref.frames.world_valid, grid), 10), grid, jcfg.res)
    tables = jfast.precompute_tables(ref.rig, jcfg)
    vol, cvol = jfast.integrate_sparse(ref.frames, tables, jcfg, mask16,
                                       max_bricks=int(np.asarray(mask16).sum()))
    return types.SimpleNamespace(voxel=voxel, mask16=np.asarray(mask16), tables=tables,
                                 vol=np.asarray(vol), cvol=np.asarray(cvol))


def test_integrate_sparse_matches_jax(ref, jint):
    """The XLA table integrator at 48^3 against the JAX function, at the
    bound between formulations (tests/test_tsdf_affine.py:109-116), with
    the clear values outside the occupied bricks."""
    vol, cvol = tsdf_fast.integrate_sparse(ref.tframes, from_jax(jint.tables),
                                           TsdfConfig((N, N, N), LIMIT),
                                           torch.tensor(jint.mask16))
    assert vol.dtype == cvol.dtype == torch.float32 and cvol.shape == (N, N, N, 4)
    v, jv = vol.numpy(), jint.vol
    assert (np.abs(v - jv) > 1e-4).mean() < 1e-4
    occ, jocc = int((v > -LIMIT + 1e-9).sum()), int((jv > -LIMIT + 1e-9).sum())
    assert jocc > 1000 and abs(occ - jocc) <= max(100, 0.002 * jocc)
    assert (np.abs(cvol.numpy() - jint.cvol).max(-1) > 1e-2).mean() < 1e-3
    empty = ~np.repeat(np.repeat(np.repeat(jint.mask16, 16, 0), 16, 1), 16, 2)
    assert (v[empty] == -LIMIT).all() and (cvol.numpy()[empty] == 0).all()


def test_integration_matches_jax(ref, jint, monkeypatch):
    """ReconIntegration at voxel_size bbox / 48 (tests/test_models.py:82-89)
    against the JAX strategy at the render-parity bounds; the occupied
    ratio read back the same. The jitted JAX strategy reads its integrator's
    volumes from the ``jint`` fixture through a host callback keyed by the
    brick mask it computed (a mask other than the fixture's fails)."""
    def integrate(frames, tables, cfg, mask16):
        specs = (jax.ShapeDtypeStruct(jint.vol.shape, jnp.float32),
                 jax.ShapeDtypeStruct(jint.cvol.shape, jnp.float32))

        def volumes(m):
            assert np.array_equal(m, jint.mask16), "another brick mask than the fixture's"
            return jint.vol, jint.cvol

        return jax.pure_callback(volumes, specs, mask16)

    monkeypatch.setattr(jintegration, "tsdf_fast", types.SimpleNamespace(
        BRICK=jfast.BRICK, precompute_tables=jfast.precompute_tables,
        integrate_sparse=integrate))
    voxel = jint.voxel
    jm = jmodels.ReconIntegration(ref.jctx, voxel_size=voxel, brick_size=0.2)
    axis, flip = jintegration.rmf.pick_axis(
        np.asarray(ref.jcam.modelview), jintegration.rm.vol_to_world_matrix(ref.bbox))
    jcolor, jdepth, jratio = jm._draw(ref.frames, (ref.jcam.modelview, ref.jcam.proj), W, H,
                                      axis, flip)
    m = models.ReconIntegration(ref.ctx, voxel_size=voxel, brick_size=0.2)
    assert m.volume_res == jm.volume_res == (N, N, N)
    color, depth = m.draw_with_depth(ref.tframes, ref.cam)
    _parity("integration", jcolor, jdepth, color, depth, lambda c, d: d < 1.0)
    assert m.occupied_ratio() == pytest.approx(float(jratio))
    assert 0.0 < m.occupied_ratio() < 0.6

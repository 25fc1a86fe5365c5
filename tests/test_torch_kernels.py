"""The port's kernel functions vs the JAX package's Pallas kernels.

On the CPU every wrapper runs its plain PyTorch version; the Pallas
kernels run in interpret mode, as their own tests run them. The CUDA
kernels themselves are held against the plain versions on the card by
tests/test_torch_cuda.py (marker ``cuda``) and by chip_smoke.py.
"""
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rgbd_recon_tpu.ops import bricks as jbricks
from rgbd_recon_tpu.ops.bricks_pallas import mark_bricks_pallas
from rgbd_recon_tpu.ops.preprocess_pallas import bilateral_accum_pallas
from rgbd_recon_tpu.ops.warp_pallas import warp_screen_pallas
from rgbd_recon_tpu.utils.math import Bbox as JBbox

from rgbd_recon_torch.ops import bricks, preprocess as pp
from rgbd_recon_torch.ops.raymarch_fast import _taps
from rgbd_recon_torch.ops.preprocess import bilateral_accum
from rgbd_recon_torch.ops.warp import PixelWarp, warp_screen
from rgbd_recon_torch.utils.math import Bbox


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread: beside the other test workers on the same
    cores, a pool of 8 spins and a frame's small ops run 10-100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bilateral_inputs(rng, kk=2, h=48, w=96):
    depth = (0.6 + 3.0 * rng.random((kk, h, w))).astype(np.float32)
    depth[rng.random((kk, h, w)) < 0.1] = 0.0      # invalid pixels
    limits = np.array([[0.5, 4.5], [0.6, 4.0]], np.float32)[:kk]
    return depth, limits


def test_bilateral_accum_matches_pallas(rng):
    """Tolerance atol 2e-4, rtol 2e-5: the Pallas kernel's own bound
    against its scan oracle (tests/test_preprocess_pallas.py:41) — the
    169-tap sums run in another order and the spatial weight is rounded
    once more on the TPU side."""
    depth, limits = _bilateral_inputs(rng)
    want = bilateral_accum_pallas(jnp.asarray(depth), jnp.asarray(limits),
                                  interpret=True)
    got = bilateral_accum(torch.from_numpy(depth), torch.from_numpy(limits))
    for g, wnt, name in zip(got, want, ("depth_bf", "w_acc", "w_range")):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=2e-4,
                                   rtol=2e-5, err_msg=name)


def _brick_inputs(rng, n=40_000):
    bbox = Bbox.default()
    world = (bbox.min + rng.random((2, n // 2, 3)).astype(np.float32) * bbox.size)
    # a few points outside the box exercise the index clamp
    world[0, :50] = bbox.min - 0.3
    world[1, :50] = bbox.max + 0.3
    valid = rng.random((2, n // 2)) > 0.3
    return bbox, world.astype(np.float32), valid


def test_mark_bricks_matches_pallas(rng):
    """Integer-exact (tests/test_bricks_pallas.py:30): a histogram."""
    bbox, world, valid = _brick_inputs(rng)
    jgrid = jbricks.make_brick_grid(JBbox(bbox.min, bbox.max), 0.1, 0.01)
    grid = bricks.make_brick_grid(bbox, 0.1, 0.01)
    assert tuple(grid.res) == tuple(jgrid.res)
    want = np.asarray(mark_bricks_pallas(jnp.asarray(world), jnp.asarray(valid),
                                         jgrid, interpret=True))
    got = bricks.mark_bricks(torch.from_numpy(world), torch.from_numpy(valid), grid)
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.to(torch.int64).numpy(), want.astype(np.int64))


def _screen_inputs(rng, ti=128, si=128, c=9, h=96, w=128):
    img = rng.random((ti, si, c)).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    fy = np.clip(ys * ti / h * (1.0 + 0.1 * xs / w) - 3.0, 0, ti - 1)
    fx = np.clip(xs * si / w * (1.0 + 0.08 * ys / h) - 2.0, 0, si - 1)
    return img, fy.astype(np.float32), fx.astype(np.float32)


def test_warp_screen_matches_pallas(rng):
    """p99.5 < 2e-2 and < 2e-3 on the precise channel
    (tests/test_warp_pallas.py:33-34): the TPU kernel samples through a
    bf16 matmul (a hi/lo split on channel 1); the port is float32."""
    img, fy, fx = _screen_inputs(rng)
    want = np.asarray(warp_screen_pallas(
        jnp.asarray(img), jnp.asarray(fy), jnp.asarray(fx), tile=(8, 128),
        precise_channels=(1,), interpret=True))
    got = warp_screen(torch.from_numpy(img), torch.from_numpy(fy),
                      torch.from_numpy(fx), (8, 128)).numpy()
    d = np.abs(got - want)
    assert np.percentile(d, 99.5) < 2e-2, np.percentile(d, 99.5)
    assert np.percentile(d[..., 1], 99.5) < 2e-3, np.percentile(d[..., 1], 99.5)


def test_warp_screen_window_clamp_matches_pallas(rng):
    """A tile whose source footprint is wider than its 128-px window: the
    port clamps to the same window as the TPU kernel (same bound as above),
    and the clamp really bites (exact bilinear sampling differs by far
    more)."""
    ti, si, c, h, w = 64, 512, 3, 8, 128
    img = rng.random((ti, si, c)).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    fy = np.clip(ys * 2.0 + 10.0, 0, ti - 1).astype(np.float32)
    fx = np.clip(xs * 3.5 + 5.0, 0, si - 1).astype(np.float32)   # 450-px span
    want = np.asarray(warp_screen_pallas(
        jnp.asarray(img), jnp.asarray(fy), jnp.asarray(fx), tile=(8, 128),
        interpret=True))
    got = warp_screen(torch.from_numpy(img), torch.from_numpy(fy),
                      torch.from_numpy(fx), (8, 128)).numpy()
    d = np.abs(got - want)
    assert np.percentile(d, 99.5) < 2e-2, np.percentile(d, 99.5)
    exact = _taps(torch.from_numpy(img), torch.from_numpy(fy),
                  torch.from_numpy(fx)).numpy()
    assert np.abs(exact - want).max() > 0.1


def test_wrappers_reject_other_devices():
    """The dispatch rule: CPU -> plain version, CUDA -> kernel, anything
    else raises (no silent fallback)."""
    d = torch.zeros((1, 8, 8), device="meta")
    with pytest.raises(ValueError):
        bilateral_accum(d, torch.zeros((1, 2), device="meta"))
    rig = types.SimpleNamespace(camera_positions=torch.zeros((1, 3), device="meta"))
    warp = types.SimpleNamespace(xyz=lambda dn: torch.zeros(dn.shape + (3,), device="meta"))
    with pytest.raises(ValueError):
        pp.quality(torch.zeros((1, 8, 8, 2), device="meta"),
                   torch.zeros((1, 8, 8, 3), device="meta"), rig, warp)


def _quality_inputs(rng, kk=2, h=37, w=53):
    """depth_b f32[K, H, W, 2] with a smooth depth over (0, 1), a quarter of
    the pixels outside (0 and 1 exactly, -1, 1.2) and a step the range
    window rejects; unit normals; camera positions f32[K, 3]."""
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    dn = np.stack([0.3 + 0.2 * xx + 0.1 * np.sin(5 * yy) + 0.01 * rng.random((h, w))
                   for _ in range(kk)])
    dn[:, :, w // 2:] += 0.3                      # a depth step
    dn[rng.random(dn.shape) < 0.25] = rng.choice([0.0, 1.0, -1.0, 1.2])
    depth_b = np.stack([dn, rng.random(dn.shape)], -1).astype(np.float32)
    n = rng.standard_normal((kk, h, w, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    cam = rng.uniform(-3, 3, (kk, 3)).astype(np.float32)
    return (torch.from_numpy(depth_b), torch.from_numpy(n.astype(np.float32)),
            torch.from_numpy(cam))


@pytest.mark.parametrize("tier", ["affine", "gather"])
def test_quality_cpu_is_plain_twin(rng, tier):
    """On CPU tensors ``quality`` is ``quality_plain`` (kernel 10's oracle)
    on the world position its warp tier gives, bit for bit: the affine
    PixelWarp's xyz(d), or the gather tier's exact taps of cv_xyz. Zero
    outside (0, 1), positive on some pixels inside."""
    depth_b, normals, cam = _quality_inputs(rng)
    kk, h, w, _ = depth_b.shape
    dn = depth_b[..., 0]
    if tier == "affine":
        f = lambda *s: torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32))  # noqa: E731
        warp = PixelWarp(f(kk, h, w, 3), f(kk, h, w, 3), f(kk, h, w, 2), f(kk, h, w, 2),
                         0.01, 0.99, 0.0, 0.0)
        rig = types.SimpleNamespace(camera_positions=cam, cv_xyz=None)
        world = warp.xyz(dn)
    else:
        warp = None
        cv = torch.from_numpy(rng.uniform(-1, 2, (kk, 8, 6, 5, 3)).astype(np.float32))
        rig = types.SimpleNamespace(camera_positions=cam, cv_xyz=cv)
        world = pp._sample_cv_per_pixel(cv, dn, pp.pixel_texcoords(h, w, dn.device))
    got = pp.quality(depth_b, normals, rig, warp)
    assert got.shape == (kk, h, w) and got.dtype == torch.float32
    assert torch.equal(got, pp.quality_plain(depth_b, normals, world, cam))
    outside = (dn <= 0) | (dn >= 1)
    assert bool((got[outside] == 0).all()) and bool((got[~outside] > 0).any())


@pytest.mark.parametrize("max_bricks", [0, 1, 37, 64, 90])
def test_brick_slots_match_occupied_list(max_bricks):
    """The per-brick slot map of the dense integration kernels
    (occupied_bricks) names the same fused bricks, in the same slots, as
    the port's occupied_list and the JAX package's: the first
    ``max_bricks`` occupied bricks in ascending order; -1 for unoccupied
    bricks and for occupied ones past the capacity (64 of 120 bricks
    occupied, so 37 and 1 drop some)."""
    from rgbd_recon_tpu.ops.tsdf_fast import occupied_list as joccupied_list
    from rgbd_recon_torch.ops.tsdf_fast import occupied_bricks, occupied_list

    rng = np.random.default_rng(11)
    mask = np.zeros(120, bool)
    mask[rng.permutation(120)[:64]] = True
    mask = mask.reshape(4, 5, 6)
    m16 = torch.from_numpy(mask)
    bidx, bcount, slots = occupied_bricks(m16, max_bricks)
    assert slots.dtype == torch.int32 and slots.shape == (120,)
    idx, valid, count = occupied_list(m16, max_bricks)
    assert torch.equal(bidx, idx) and torch.equal(bcount, count)
    n = int(count[0])
    assert int(valid.sum()) == n
    assert n == min(64, max_bricks)
    fused = np.flatnonzero(slots.numpy() >= 0)
    np.testing.assert_array_equal(fused, idx.numpy()[:n])
    np.testing.assert_array_equal(slots.numpy()[fused], np.arange(n))
    assert (slots.numpy()[~mask.ravel()] == -1).all()
    dropped = np.flatnonzero(mask.ravel())[n:]
    assert (slots.numpy()[dropped] == -1).all()
    if max_bricks:
        jidx, jvalid = joccupied_list(jnp.asarray(mask), max_bricks)
        np.testing.assert_array_equal(np.asarray(jidx)[np.asarray(jvalid)], fused)

"""The port's leaf ops and hole filling vs their JAX counterparts, on the CPU.

Each case feeds both sides the same numpy inputs from a seeded generator.
These ops run inside every stage; the stage tests hold them only through
the stages' outputs, so a fault here would show there as a stage-level
deviation with no pointer to its cause.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rgbd_recon_tpu.ops import colors as jcolors
from rgbd_recon_tpu.ops import inpaint as jinpaint
from rgbd_recon_tpu.ops import sample as jsample
from rgbd_recon_tpu.ops import warp as jwarp
from rgbd_recon_tpu.utils import math as jmath

from rgbd_recon_torch.ops import colors, inpaint, sample, warp
from rgbd_recon_torch.utils import math as tmath


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread: beside the other test workers on the same
    cores, a pool of 8 spins and a frame's small ops run 10-100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rgb_to_lab(rng):
    rgb = rng.random((64, 48, 3)).astype(np.float32)
    return (colors.rgb_to_lab(torch.from_numpy(rgb)).numpy(),
            np.asarray(jcolors.rgb_to_lab(jnp.asarray(rgb))))


def _sample2d(rng):
    img = rng.random((37, 53, 3)).astype(np.float32)
    # texcoords past both edges exercise the GL clamp
    uv = (rng.random((20, 30, 2)) * 1.2 - 0.1).astype(np.float32)
    return (sample.sample2d(torch.from_numpy(img), torch.from_numpy(uv)).numpy(),
            np.asarray(jsample.sample2d(jnp.asarray(img), jnp.asarray(uv))))


def _pixel_texcoords(rng):
    return (sample.pixel_texcoords(19, 33).numpy(),
            np.asarray(jsample.pixel_texcoords(19, 33)))


def _resize2d_gl(rng):
    img = rng.random((45, 80, 4)).astype(np.float32)
    return (warp.resize2d_gl(torch.from_numpy(img), (180, 320)).numpy(),
            np.asarray(jwarp.resize2d_gl(jnp.asarray(img), (180, 320))))


def _pmat(rng):
    a = rng.standard_normal((50, 4)).astype(np.float32)
    b = rng.standard_normal((4, 4)).astype(np.float32)
    return (tmath.pmat(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
            np.asarray(jmath.pmat(jnp.asarray(a), jnp.asarray(b))))


# (case, atol, rtol). rgb_to_lab: float32 pow/cbrt of two libraries, LAB
# values up to ~100. sample2d and pixel_texcoords: the same float32
# operations in the same order. resize2d_gl: both round weights, input and
# intermediate to bf16 and accumulate in float32, in another order. pmat:
# a 4-term float32 dot product, at full precision on both sides.
CASES = [
    (_rgb_to_lab, 1e-4, 1e-5),
    (_sample2d, 1e-6, 0.0),
    (_pixel_texcoords, 0.0, 0.0),
    (_resize2d_gl, 1e-5, 0.0),
    (_pmat, 1e-5, 1e-6),
]


@pytest.mark.parametrize("case, atol, rtol", CASES, ids=[c[0].__name__[1:] for c in CASES])
def test_leaf_op_matches_jax(case, atol, rtol):
    got, want = case(np.random.default_rng(11))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _holefill_inputs(rng, h=96, w=128, hole_frac=0.5):
    """A rendered image with holes, some of them over background (depth 1),
    as tests/test_inpaint_mm.py makes it."""
    c = rng.random((h, w, 4)).astype(np.float32)
    c[..., 3] = (rng.random((h, w)) > hole_frac).astype(np.float32)
    d = (0.2 + 0.7 * rng.random((h, w))).astype(np.float32)
    d[rng.random((h, w)) < 0.05] = 1.0
    return c, d


def _bf16_ulp(x):
    """The bf16 spacing at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _colorfill_bound(colors, h, w, atol):
    """Per-pixel, per-channel deviation bound between two colorfills of
    pyramids that agree to a few float32 ulps, and the blended-pixel mask.

    The pyramid levels are float32 sums of up to 16 taps; XLA sums them in
    an order that depends on the host CPU's vector width, so a level value
    may sit one float32 ulp off the port's. Pixels whose colour is taken
    from one LOD (``first == 0``) carry that over unchanged: atol. Blended
    pixels (``first > 0``) read the two next-coarser LODs through
    ``resize2d_gl``, which rounds every level value to bf16: a value within
    a float32 ulp of a bf16 rounding midpoint rounds to neighbouring bf16
    values on the two sides, one bf16 ulp apart, and the first resize
    stage rounds its intermediate to bf16 once more. So a blended pixel
    may deviate by the blend ``|w1| u1 + |w2| u2`` (tsdf_colorfill.fs
    weights) of two bf16 ulps at each blended level's largest magnitude."""
    n = len(colors)
    ys, xs = np.arange(h), np.arange(w)
    valid = np.stack([c[(ys * c.shape[0]) // h][:, (xs * c.shape[1]) // w][..., 3] > 0
                      for c in colors])
    first = np.where(valid.any(0), np.argmax(valid, 0), n - 1)
    ulp = np.stack([_bf16_ulp(np.abs(c).reshape(-1, 4).max(0)) for c in colors])  # [n, 4]
    s = ((np.arange(w, dtype=np.float32) + 0.5) / w)[None, :]
    t = ((np.arange(h, dtype=np.float32) + 0.5) / h)[:, None]
    w1 = np.sqrt(s * s + t * t)
    w2 = 1.0 - w1
    u1 = ulp[np.minimum(first + 1, n - 1)]
    u2 = ulp[np.minimum(first + 2, n - 1)]
    blend = 2.0 * (np.abs(w1)[..., None] * u1 + np.abs(w2)[..., None] * u2)
    blended = first > 0
    return np.where(blended[..., None], blend + atol, atol), blended


@pytest.mark.parametrize("ref", ["colorfill", "colorfill_mm"])
def test_holefill_matches_jax(ref):
    """The port's 16-tap pyramid and per-pixel colorfill vs the JAX package.
    Against ``colorfill`` (the same formulation): pyramids atol 1e-6; the
    filled image atol 1e-5 where a pixel takes one LOD, and within the
    bf16 bound of ``_colorfill_bound`` where it blends two upsampled LODs
    (the cause of this case's host-dependent failures at a single atol of
    1e-5). Against ``colorfill_mm`` (the TPU form, which resolves the blend
    on coarser grids; not ported): the bounds of
    tests/test_inpaint_mm.py:50-61 — non-hole and background pixels exact,
    filled pixels a median deviation < 0.06 and > 90% under 0.25."""
    c, d = _holefill_inputs(np.random.default_rng(12))
    pc, pd = inpaint.build_pyramid(torch.from_numpy(c), torch.from_numpy(d), 5)
    jpc, jpd = jinpaint.build_pyramid(jnp.asarray(c), jnp.asarray(d), 5, mm=False)
    got = inpaint.colorfill(pc, pd).numpy()
    if ref == "colorfill":
        for a, b in zip(pc + pd, jpc + jpd):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
        want = np.asarray(jinpaint.colorfill(jpc, jpd))
        bound, blended = _colorfill_bound([x.numpy() for x in pc], *c.shape[:2], atol=1e-5)
        dev = np.abs(got - want)
        over = dev.max(-1) > 1e-5
        report = (f"max deviation {dev.max():.3e}, {int(over.sum())} pixels above 1e-5, "
                  f"{int((over & ~blended).sum())} of them not blended")
        assert np.all(dev <= bound), report
        return
    want = np.asarray(jinpaint.colorfill_mm(jpc, jpd))
    hole = c[..., 3] <= 0.0
    bg = hole & (d >= 1.0)
    np.testing.assert_array_equal(got[~hole], want[~hole])
    np.testing.assert_array_equal(got[bg], want[bg])
    fill = hole & ~bg
    assert fill.any()
    dv = np.abs(got[fill][:, :3] - want[fill][:, :3])
    assert np.median(dv) < 0.06, np.median(dv)
    assert (dv < 0.25).mean() > 0.9, (dv < 0.25).mean()

"""What the sweep kernel reads of the camera and the grid
(``raymarch_fast.sweep_params``), against the values ``sweep_plain``
computes, on the CPU at small sizes.

The kernel (``csrc/sweep_march.cu``) runs only on the card
(tests/test_torch_cuda.py holds it to ``sweep_plain`` there). Its inputs
are packed here by tensor ops, once for all slices; the twin computes them
slice by slice from Python doubles. Held bit for bit (tolerance 0): the eye
and the grid extents, each slice's sigma, s_k - ds as the float32 the twin's
hit coordinate starts from, the gradient's divisors, and the float32 ds,
each in the kernel's formula against the twin's on the same tensors.
"""
import numpy as np
import pytest
import torch

from rgbd_recon_torch.ops import raymarch as rm, raymarch_fast as rmf
from rgbd_recon_torch.runtime.pipeline import VARIANTS
from rgbd_recon_torch.utils.math import Bbox, look_at, perspective

RES = (24, 32, 40)          # (x, y, z)
GRID = (36, 28)             # (Ti, Si)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread (as the other test_torch_* files)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _camera(axis, flip):
    bbox = Bbox.default()
    center = (bbox.min + bbox.max) * 0.5
    d = np.array([0.25, 0.35, 0.3], np.float32)
    d[axis] = 2.0 if flip else -2.0
    mv = look_at(center + d, center, [0, 0, 1] if axis == 1 else [0, 1, 0])
    assert rmf.pick_axis(mv, rm.vol_to_world_matrix(bbox)) == (axis, flip)
    return rm.RenderCamera(torch.from_numpy(mv),
                           torch.from_numpy(perspective(50.0, 1.5, 0.1, 200.0)), 96, 64)


@pytest.mark.parametrize("axis, flip", VARIANTS)
def test_sweep_params_match_plain(axis, flip):
    bbox = Bbox.default()
    cam = _camera(axis, flip)
    ns = RES[axis]
    vx, vy, vz = RES
    tsdf = torch.full((vz, vy, vx), -0.02, dtype=torch.bfloat16)
    cvol = torch.zeros((vz, 4, vy, vx), dtype=torch.bfloat16)
    plain = rmf.sweep_plain(tsdf, cvol, cam, bbox, 0.02, axis, flip, rmf.SweepConfig(GRID))
    rng = np.random.default_rng(axis * 2 + flip)
    frac = torch.from_numpy(rng.normal(0.0, 2.0, GRID).astype(np.float32))
    diff = torch.from_numpy(rng.normal(0.0, 0.01, GRID).astype(np.float32))
    for k0, n in ((0, ns), (8, 8)):          # the whole sweep and a window
        prm = rmf.sweep_params(cam, bbox, axis, flip, ns, k0, n, GRID)
        g = prm.grid
        assert torch.equal(g.eye_p, plain.eye_p)
        assert all(torch.equal(a, b) for a, b in
                   zip((g.g_lo[0], g.g_hi[0], g.g_lo[1], g.g_hi[1]), plain.base_extent))
        assert g.r_grid.shape == (GRID[0],) and g.c_grid.shape == (GRID[1],)
        ds = 1.0 / ns
        # the twin's g0 = (d - prev_d) / ds divides by the double ds
        assert torch.equal(diff / ds, diff / torch.tensor(prm.ds))
        for i, k in enumerate(range(k0, k0 + n)):
            s_k, sigma = rmf._sigma_of(g, k, ns)
            assert torch.equal(prm.sigma[i], sigma), k
            # the twin's hit coordinate, s_k - ds - ds * frac, against the
            # kernel's s_back - ds * frac in float32
            assert torch.equal(s_k - ds - ds * frac,
                               prm.s_back[i] - torch.tensor(prm.ds) * frac), k
            assert torch.equal(prm.grad_r[i], g.dr2 * sigma + 1e-12), k
            assert torch.equal(prm.grad_c[i], g.dc2 * sigma + 1e-12), k
            assert torch.equal(diff / (g.dr2 * sigma + 1e-12), diff / prm.grad_r[i]), k
        for t in (prm.sigma, prm.s_back, prm.grad_r, prm.grad_c):
            assert t.dtype == torch.float32 and t.shape == (n,)

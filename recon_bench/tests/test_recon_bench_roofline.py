"""Both roofline counts at 256^3 against hand-worked numbers."""
import json
import os

import pytest

from recon_bench import roofline

from .conftest import ROOT


@pytest.fixture
def k4_256():
    with open(os.path.join(ROOT, "recon_bench", "configs", "k4-256.json")) as f:
        return json.load(f)


def test_fuse_ops_count():
    # warp 30, sampling 4, taps 51, fusion 27 (chip_smoke.py's breakdown)
    assert roofline.FUSE_OPS == 112 and roofline.COLOR_OPS == 5


def test_integrate_work_at_256(k4_256):
    nbytes, ops = roofline.integrate_work(k4_256, 470)
    # 4 sensors x 512 x 424 px x 24 B + 470 bricks x 4096 voxels x 10 B
    assert nbytes == 20_840_448 + 19_251_200
    # 470 x 4096 voxels x (4 x 112 + 5) operations
    assert ops == 872_079_360
    t, by = roofline.bound(nbytes, ops)
    assert by == "operations" and t == pytest.approx(872_079_360 / 67e12)
    assert t * 1e6 == pytest.approx(13.016, abs=1e-3)


def test_sweep_work_at_256(k4_256):
    nbytes, ops = roofline.sweep_work(k4_256, 470)
    # 470 bricks x 4096 voxels x 10 B read + 512 x 512 rays x 36 B written
    assert (nbytes, ops) == (19_251_200 + 9_437_184, 0.0)
    t, by = roofline.bound(nbytes, ops)
    assert by == "bytes" and t * 1e6 == pytest.approx(8.5637, abs=1e-4)

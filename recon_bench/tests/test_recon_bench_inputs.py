"""The seeded generator: repeatable, the port's rig and frames at a small
size, and the orbit's sweep variants."""
import json
import os

import numpy as np
import pytest
import torch

from recon_bench import schedule
from recon_bench.frozen import inputs

from .conftest import DATA, ROOT


def _json(*p):
    with open(os.path.join(*p)) as f:
        return json.load(f)


@pytest.fixture
def tiny():
    return _json(DATA, "tiny.json")


@pytest.fixture
def static():
    return _json(ROOT, "recon_bench", "traffic", "static.json")


@pytest.fixture
def orbit():
    return _json(ROOT, "recon_bench", "traffic", "orbit.json")


def test_same_seed_same_frames(tiny, static):
    cams = inputs.cameras(tiny)
    big = 2**31 + 12345
    a = inputs.make_frames(tiny, static, big, cams, "cpu")
    b = inputs.make_frames(tiny, static, big, cams, "cpu")
    c = inputs.make_frames(tiny, static, big + 1, cams, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert a[0].shape == (16, 2, 104, 128) and a[1].shape == (16, 2, 264, 320, 3)


def test_subject_path(tiny, static):
    sc = inputs.scene_path(tiny, static, 7)
    step = np.linalg.norm(np.diff(sc.centers[:, 1], axis=0), axis=1)
    assert np.allclose(step, 0.01, atol=1e-6)
    assert np.linalg.norm(sc.centers[:, 1] - sc.centers[0, 1], axis=1).max() <= 0.15 + 1e-6
    assert np.array_equal(sc.centers[:, 0], np.repeat(sc.centers[:1, 0], 16, axis=0))


def test_rig_and_frame_match_the_port(tiny):
    from rgbd_recon_torch.calibration import synthetic
    from rgbd_recon_torch.utils.math import Bbox

    rig, cams = inputs.make_rig(tiny, "cpu")
    prig, pcams = synthetic.synthetic_rig(num_sensors=2, bbox=Bbox.default(), fwd_res=(32, 64, 32),
                                          inv_res=(32, 32, 32), width=128, height=104)
    for name in ("cv_xyz", "cv_uv", "cv_xyz_inv", "depth_limits", "camera_positions"):
        np.testing.assert_allclose(getattr(rig, name), getattr(prig, name), atol=2e-6,
                                   err_msg=name)
    still = {"frames": 1, "subject": {"sphere": 1, "step_m": 0.0, "max_m": 0.0}}
    depth, color = inputs.render(cams, inputs.scene_path(tiny, still, 0), "cpu")
    pd, pc = synthetic.render_frames(pcams, synthetic.SphereScene.default(Bbox.default()))
    np.testing.assert_allclose(depth[0].numpy(), pd, atol=1e-5)
    np.testing.assert_allclose(color[0].numpy(), pc, atol=1e-5)


def test_color_at_its_own_size_shoots_the_depth_cameras_view(tiny):
    """At three times the depth size the middle pixel of each 3x3 block
    lies on a depth pixel's ray: the same color there."""
    _, cams = inputs.make_rig(tiny, "cpu")
    still = {"frames": 1, "subject": {"sphere": 1, "step_m": 0.0, "max_m": 0.0}}
    scene = inputs.scene_path(tiny, still, 0)
    depth, color = inputs.render(cams, scene, "cpu")
    depth3, color3 = inputs.render(cams, scene, "cpu", (3 * 128, 3 * 104))
    assert torch.equal(depth3, depth) and color3.shape == (1, 2, 312, 384, 3)
    np.testing.assert_allclose(color3[:, :, 1::3, 1::3].numpy(), color.numpy(), atol=1e-5)


def test_static_schedule(tiny, static):
    s = schedule.make(tiny, static, 3)
    assert len(s.cameras) == 1 and s.variants == [(2, True)]
    assert [s.at(n)[0] for n in range(32)] == list(range(16)) + list(range(14, 0, -1)) + [0, 1]
    assert len(s.judged) == 2 and all(1 <= n < 24 for n in s.judged)


def test_orbit_schedule_visits_every_variant(tiny, orbit):
    from rgbd_recon_torch.ops import raymarch as rm, raymarch_fast as rmf
    from rgbd_recon_torch.utils.math import Bbox

    s = schedule.make(tiny, orbit, 3)
    assert len(s.cameras) == 72
    views = [s.variants[12 * v] for v in range(6)]
    assert sorted(views) == sorted(schedule.VARIANTS)
    assert views != list(schedule.VARIANTS) or schedule.make(tiny, orbit, 4).variants != s.variants
    assert all(s.variants[i] == views[i // 12] for i in range(72))
    v2w = rm.vol_to_world_matrix(Bbox.default())
    assert [rmf.pick_axis(mv, v2w) for mv, _ in s.cameras] == s.variants
    # three judged frames, each in its own view
    assert len({n // 12 for n in s.judged}) == 3


def test_frames_made_on_the_device_from_the_seed(tiny, static):
    g1 = inputs.add_noise(torch.zeros(2, 3), torch.zeros(2, 3, 3), static, 5)
    g2 = inputs.add_noise(torch.zeros(2, 3), torch.zeros(2, 3, 3), static, 5)
    assert torch.equal(g1[0], g2[0]) and float(g1[0].max()) < 0.002

"""The inputs and the 128^3 rung of the ladder golden.

The ladder golden (``tests/data/torch_bench_golden_ladder.npz``,
``rgbd_recon_torch/utils/bench_golden.py``) holds the JAX package's outputs
of each configuration of ``bench_golden.LADDER`` on the bench rig (512x424
sensors, 1280x720). The port's build of each configuration's inputs must
hash to the digests it stores. The card holds the port's frames to it
(``chip_smoke.py`` phase 15); these tests hold the 128^3 rung's CPU frame
(L1). The 256^3 configurations (C, S5, S2) are held on the card alone: the
CPU frame at 256^3 costs ~70 s a configuration here
(tests/test_torch_bench_golden.py).
"""
import numpy as np
import pytest
import torch

from rgbd_recon_torch.runtime.pipeline import FramePipeline
from rgbd_recon_torch.utils import bench_golden as bg


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread: beside the other test workers on the same
    cores, a pool of 8 spins and a frame's small ops run 10-100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ladder():
    return bg.load(bg.LADDER_PATH)


# the configurations by their inputs: L1 and L2 share the 4-sensor sphere rig
INPUTS = {"C": ("C",), "S5": ("S5",), "S2": ("S2",), "L1, L2": ("L1", "L2")}


@pytest.mark.parametrize("names", list(INPUTS.values()), ids=list(INPUTS))
def test_ladder_inputs_hash_to_the_golden(ladder, names):
    """Each configuration's bench inputs, built by the port on the host
    (rig and frame 0 of ``bench_golden.bench_frame``), hash to the digests
    the ladder file stores with the JAX package's outputs; the stored
    default camera is the port's."""
    cfg = bg.LADDER[names[0]]
    rig, bbox, depth, color = bg.bench_frame(cfg)
    assert depth.shape == (cfg.sensors, 424, 512)
    for name in names:
        g = bg.config(ladder, name)
        bg.check_digests(g, rig, depth, color)
        if bg.LADDER[name].stages:
            np.testing.assert_array_equal(g["A/default/mv"], bg.camera("default", bbox)[0])
            assert g["A/tsdf"].shape == (bg.LADDER[name].n,) * 3


@pytest.fixture(scope="module")
def port_l1(ladder):
    """The L1 rung's CPU frame (4 sensors, 128^3, 1280x720), stage by stage
    at the default camera, and its records of the ladder file."""
    g = bg.config(ladder, "L1")
    rig, bbox, depth, color = bg.bench_frame(bg.LADDER["L1"])
    pipe = FramePipeline(rig, bg.bench_config(bbox, 128), device="cpu")
    assert pipe.integrator.zmajor and pipe.max_bricks == 512
    return g, bg.port_stages(pipe, depth, color, g, views=("default",))


def _hold(rows):
    for r in rows:
        print(r.line("cpu L1"))
    bad = [r.line("cpu L1") for r in rows if not r.ok]
    assert not bad, bad


def test_l1_stages_match_jax(port_l1):
    """The 128^3 rung against JAX's TPU formulation (Pallas kernels in
    interpret mode): stage 1, brick counts and the 16^3 masks, the TSDF and
    the color draw at the bounds of ``bench_golden``."""
    g, got = port_l1
    _hold(bg.compare_pre(g, got) + bg.compare_bricks(g, got)
          + [bg.compare_tsdf(g["A/tsdf"], got["tsdf"]), bg.compare_color(g, got)])


def test_l1_render_matches_jax(port_l1):
    """The 128^3 rung's sweep planes (``SWEEP_BOUNDS``) and its screen
    before and after hole filling (render parity) at the default camera."""
    g, got = port_l1
    v = got["views"]["default"]
    ref = bg.screen(g, "A/default/")
    _hold([bg.compare_sweep(g, "default", v), bg.compare_screen("screen", ref, v["screen"]),
           bg.compare_screen("screen hole-filled", bg.filled(ref), bg.filled(v["screen"]))])

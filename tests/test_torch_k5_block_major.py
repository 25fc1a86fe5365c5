"""Five sensors through the block-major integrator, held to the benchmark's
plain reference on the CPU.

The benchmark cell ``k5-208.static`` runs five Kinect-v2 streams into a
208 x 224 x 208 volume, whose x size is no multiple of 128, so the fused
frame takes kernel 6 (block-major, voxel order) and the sweep's
channels-last color branch in place of the dense emit. Here the same
path runs at a CPU size: five sensors at 128x104 with color at 320x264,
a 144 x 128 x 128 volume (min(res) >= 128 keeps the kernel tiers; 144 %
128 != 0), one fused CPU frame of ``FramePipeline`` built as the harness
builds it, compared by ``recon_bench.compare`` with
``recon_bench.frozen.reference.frame`` on the same inputs. ``LIMITS`` come
from CPU readings at this size, as ``recon_bench/tests/data/tiny-limits.json``
came from its size; the frame with half the sensors left out fails them.
The file imports no JAX:

    python -m pytest --noconftest tests/test_torch_k5_block_major.py -q
"""
import pytest
import torch

from recon_bench import compare, discover, harness, schedule
from recon_bench.frozen import reference

SEED = 2**31 + 18
FRAME = 1           # the judged input frame
# CPU readings at this size over seeds 11-18 and SEED (input frame 1, the
# static view): the program's largest / the control's smallest (the
# reference in bfloat16 with float8 e4m3 volumes) / half the sensors'
# smallest:
#   tsdf_off      1.967e-3 / 0.01212 / 0.5156   bricks_out    0 / 0.02778 / 0.4507
#   hit_off       0 / 0 / 0.01781               hit_lost      0 / 0 / 0.01781
#   depth_med_mm  0.3758 / 26.01 / 0.3144       color_med     2.105e-3 / 0.01297 / 1.859e-3
#   color_off     0.01042 / 0.03226 / 0
# Each limit lies between the program's and the control's, with more room
# above the program's; hit_off and hit_lost, where the control adds and
# loses no surface, between the program's and half the sensors'.
LIMITS = {"tsdf_off": 0.005, "bricks_out": 0.01, "hit_off": 0.005, "hit_lost": 0.005,
          "depth_med_mm": 2.0, "color_med": 0.005, "color_off": 0.02}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread (as the other test_torch_* files)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cell_k5_208_resolves():
    """The benchmark's cell loads by name, five sensors at the client's
    default volume, and its limits file gives every number a limit."""
    cell = discover.cell("k5-208.static")
    compare.check_limits(cell.limits)
    cfg = cell.config
    assert (cfg["sensors"], cfg["tsdf_res"], cfg["reduced"]) == (5, [208, 224, 208], [])
    assert cfg["tsdf_res"][0] % 128 and cfg["capacity"] == 1024


def small_case(seed: int):
    """(configuration, rig, depth, color, camera) of ``k5-208`` at the CPU
    size (module docstring): the cell's configuration with the sizes
    changed, the static traffic cut to two frames."""
    cell = discover.cell("k5-208.static")
    cfg = dict(cell.config, sensor={"width": 128, "height": 104},
               color={"width": 320, "height": 264, "format": "rgb8"},
               cv_forward_res=[32, 64, 32], cv_inverse_res=[32, 32, 32],
               tsdf_res=[144, 128, 128], capacity=512, render={"width": 160, "height": 96},
               num_lods=4, sweep_res=[128, 256])
    traffic = dict(cell.traffic, frames=2)
    rig, depth, color = harness.make_inputs(cfg, traffic, seed, "cpu")
    cam = schedule.make(cfg, traffic, seed).cameras[0]
    return cfg, rig, depth[FRAME], color[FRAME], cam


def program(cfg, rig, depth, color, cam) -> dict:
    """One fused CPU frame of the harness's pipeline, as the host's outputs."""
    pipe = harness.pipeline(cfg, rig, "cpu")
    assert pipe.tsdf_cfg.res == (144, 128, 128) and pipe.cfg.fused
    assert pipe.integrator.tier == "block-major"
    return harness.host_outputs(pipe.step(depth, color, *cam))


def test_five_sensors_block_major_hold_the_reference():
    """The fused CPU frame of five sensors through the block-major path
    keeps within ``LIMITS`` of the plain reference; the same frame with
    the second half of the sensors left out does not."""
    cfg, rig, depth, color, cam = small_case(SEED)
    assert depth.shape == (5, 104, 128) and color.shape == (5, 264, 320, 3)
    sound = program(cfg, rig, depth, color, cam)
    half = program(cfg, rig, harness.half_sensors(depth), color, cam)
    with torch.no_grad():
        ref = reference.frame(rig, cfg, depth, color, *cam, "cpu")
    limit = float(cfg["tsdf_limit"])
    ok, checks = compare.verdict(compare.numbers(sound, ref, cam[1], limit), LIMITS)
    assert ok, checks
    ok, checks = compare.verdict(compare.numbers(half, ref, cam[1], limit), LIMITS)
    assert not ok, checks

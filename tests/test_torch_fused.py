"""Fused mode of the port's ``FramePipeline`` on the CPU, at small size.

On the card a fused frame is one CUDA graph replay (tests/
test_torch_cuda.py, ``chip_smoke.py`` phase 12), the sweep's slab flags
kept on the device (``raymarch_fast.slab_occupancy_device``); on the CPU
the same frame function runs eagerly, with the flags on the host. Held
here: the fused frame bit for bit against the staged frame (fast and
reference path), the gated sweep against the host-skip sweep, the session
API around the graphs, the
frame's freedom from host round trips (what a capture needs), and the JAX
package's own fused ``_step`` against the port's fused step at the
render-parity bounds of tests/test_golden.py:65-69.
"""
import collections
import traceback
import types

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from rgbd_recon_torch.calibration.rig import RigCalibration
from rgbd_recon_torch.ops import raymarch as rm, raymarch_fast as rmf
from rgbd_recon_torch.runtime.pipeline import FramePipeline, PipelineConfig
from rgbd_recon_torch.utils.math import look_at, perspective
from rgbd_recon_torch.utils.metrics import render_parity

N = 128                      # the test_torch_stages configuration
RW, RH = 320, 240
SWEEP = (256, 256)
FIELDS = ("color", "depth", "hit", "tsdf", "occupied_ratio", "num_samples", "occupied_bricks")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread (as the other test_torch_* files)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rig(small_rig):
    return RigCalibration(*(np.asarray(getattr(small_rig["rig"], f))
                            for f in RigCalibration._fields))


def _cfg(small_rig, n=N, **over):
    kw = dict(render_width=RW, render_height=RH, tsdf_res=(n, n, n), sweep_res=SWEEP,
              voxel_size=float(np.max(small_rig["bbox"].size) / n))
    kw.update(over)
    return PipelineConfig(**kw)


def _assert_same(a, b, what=""):
    """Bit for bit on every FrameOutput field (tolerance 0: the fused frame
    runs the staged frame's arithmetic, only the skip's selects differ)."""
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), (what, f)


@pytest.fixture(scope="module")
def staged(small_rig):
    """A staged pipeline at 128^3 and its frame."""
    pipe = FramePipeline(_rig(small_rig), _cfg(small_rig), device="cpu")
    mv, proj = pipe.default_camera()
    args = (small_rig["depth"], small_rig["color"], mv, proj)
    return types.SimpleNamespace(pipe=pipe, args=args, out=pipe.step(*args))


def test_fused_step_matches_staged(small_rig, staged):
    """(a) A fused pipeline's frame equals the staged frame bit for bit."""
    pipe = FramePipeline(_rig(small_rig), _cfg(small_rig, fused=True), device="cpu")
    assert pipe.use_fast and pipe.integrator.zmajor
    _assert_same(pipe.step(*staged.args), staged.out, "fused")
    assert staged.out.hit.float().mean() > 0.02


def test_fused_reference_path_matches_staged(small_rig):
    """(b) The same on the reference path (fast_path off, 48^3, 96x64)."""
    args = None
    outs = []
    for fused in (False, True):
        pipe = FramePipeline(_rig(small_rig), _cfg(small_rig, 48, fast_path=False, fused=fused,
                                                   render_width=96, render_height=64),
                             device="cpu")
        assert not pipe.use_fast
        if args is None:
            args = (small_rig["depth"], small_rig["color"], *pipe.default_camera())
        outs.append(pipe.step(*args))
    _assert_same(*outs, "reference")
    assert outs[0].hit.float().mean() > 0.02


def _sphere_volume(n: int, seed: int):
    """A TSDF of a sphere (bf16 [n, n, n], truncated at 0.02) and a random
    z-major color volume (bf16 [n, 4, n, n]), made with numpy."""
    rng = np.random.default_rng(seed)
    c = (np.arange(n, dtype=np.float32) + 0.5) / n
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    r = np.sqrt((x - 0.45) ** 2 + (y - 0.5) ** 2 + (z - 0.55) ** 2)
    tsdf = np.clip(0.3 - r, -0.02, 0.02).astype(np.float32)
    color = rng.random((n, 4, n, n), dtype=np.float32)
    return (torch.from_numpy(tsdf).to(torch.bfloat16),
            torch.from_numpy(color).to(torch.bfloat16))


@pytest.mark.parametrize("axis, flip", [(2, False), (0, True), (1, False)])
def test_sweep_device_flags_match_host_skip(small_rig, axis, flip):
    """(c) The sweep gated by device flags equals the host-skip sweep bit
    for bit (tolerance 0), on a mask with empty and occupied slabs along
    every axis."""
    n = 64
    bbox = small_rig["bbox"]
    vol, cvol = _sphere_volume(n, 3)
    mask16 = torch.ones((n // 16,) * 3, dtype=torch.bool)
    mask16[0], mask16[:, 3], mask16[:, :, 1] = False, False, False
    center = (bbox.min + bbox.max) * 0.5
    d = np.array([0.25, 0.35, 0.3], np.float32)
    d[axis] = 3.0 if flip else -3.0
    mv = look_at(center + d, center, [0, 0, 1] if axis == 1 else [0, 1, 0])
    assert rmf.pick_axis(mv, rm.vol_to_world_matrix(bbox)) == (axis, flip)
    cam = rm.RenderCamera(torch.from_numpy(mv),
                          torch.from_numpy(perspective(50.0, RW / RH, 0.1, 200.0)), RW, RH)
    host = rmf.slab_occupancy(mask16, axis, n)
    dev = rmf.slab_occupancy_device(mask16, axis, n)
    assert dev.dtype == torch.bool and np.array_equal(dev.numpy(), host)
    assert 0 < host.sum() < n
    cfg = rmf.SweepConfig(res=(128, 128))
    a = rmf.sweep(vol, cvol, cam, bbox, 0.02, axis, flip, cfg, host)
    b = rmf.sweep(vol, cvol, cam, bbox, 0.02, axis, flip, cfg, dev)
    for f in ("hit", "hit_s", "hit_color", "hit_grad", "num_samples"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.hit.mean() > 0.02


def test_fused_flag_read_at_every_step(staged):
    """(d) ``pipe.cfg = pipe.cfg._replace(fused=...)``, as bench.py
    switches modes, takes effect at the next step without _configure."""
    pipe = staged.pipe
    try:
        pipe.cfg = pipe.cfg._replace(fused=True)
        _assert_same(pipe.step_timed(*staged.args), staged.out, "fused")
        assert [pipe.timers.timers[t].count for t in
                ("1preprocess", "2integrate", "3recon", "holefill")] == [0, 0, 1, 0]
    finally:
        pipe.cfg = pipe.cfg._replace(fused=False)
    _assert_same(pipe.step(*staged.args), staged.out, "staged again")


def test_graphs_dropped_by_session_changes(small_rig):
    """(e) retune, reload, _configure and a new sensor size empty the graph
    runner (the graphs hold the addresses of the session bakes)."""
    pipe = FramePipeline(_rig(small_rig), _cfg(small_rig, 48, fused=True), device="cpu")
    pipe._session(212, 256)

    def fill():
        pipe._graphs._graphs.update({(2, False): None, (0, True): None})
        assert len(pipe._graphs.keys()) == 2

    for change in (lambda: pipe.retune(tsdf_limit=0.02), pipe.reload,
                   lambda: pipe._configure(pipe.cfg, keep_warp_bake=True),
                   lambda: pipe._session(106, 128)):
        fill()
        change()
        assert pipe._graphs.keys() == []
    frame = np.zeros((3, 106, 128), np.float32)
    mv = pipe.default_camera()[0]
    pipe._fused_key(frame, mv)
    fill()
    pipe._fused_key(frame, mv)      # the same size and config: the graphs are kept
    assert len(pipe._graphs.keys()) == 2
    pipe.cfg = pipe.cfg._replace(shade_mode=1)    # a reassigned config
    pipe._fused_key(frame, mv)
    assert pipe._graphs.keys() == []


class _HostRoundTrips(TorchFunctionMode):
    """Records torch calls that copy from or sync with the host, by the
    port's source line, outside the kernels' plain versions (on the CPU
    they stand in for the kernels, and some read a count back)."""

    CALLS = {"tensor", "as_tensor", "__bool__", "__int__", "__float__", "__index__",
             "item", "cpu", "numpy", "tolist", "nonzero"}

    def __init__(self):
        super().__init__()
        self.hits = collections.Counter()

    def __torch_function__(self, func, types_, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in self.CALLS:
            stack = [f for f in traceback.extract_stack()[:-1]
                     if "rgbd_recon_torch" in f.filename]
            if stack and not any(f.name.endswith("_plain") for f in stack):
                f = stack[-1]
                self.hits[f"{name} at {f.filename.split('rgbd_recon_torch')[1]}:"
                          f"{f.lineno} ({f.name})"] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("over", [dict(), dict(fast_path=False, shade_mode=3, render_width=96,
                                                render_height=64)],
                         ids=["fast", "reference"])
def test_fused_frame_has_no_host_round_trip(small_rig, staged, over, monkeypatch):
    """(h) The fused frame function, after a warm-up frame (the capture
    protocol's; the fixture's staged frame on the fast path), makes no copy
    from the host and no host sync: what a CUDA graph capture refuses. It
    runs the card's form of the slab flags: ``FramePipeline._render`` keeps
    them on a CUDA volume's device and reads them to the host for the CPU's
    plain sweep alone."""
    if over:
        pipe = FramePipeline(_rig(small_rig), _cfg(small_rig, 48, **over), device="cpu")
        args = (small_rig["depth"], small_rig["color"], *pipe.default_camera())
        pipe.step(*args)                        # the warm-up
    else:
        pipe, args = staged.pipe, staged.args
    pipe.cfg = pipe.cfg._replace(fused=True)
    monkeypatch.setattr(rmf, "slab_occupancy", rmf.slab_occupancy_device)
    try:
        inputs = pipe._inputs(*args)
        with _HostRoundTrips() as mode:
            pipe._frame(*inputs)
    finally:
        pipe.cfg = pipe.cfg._replace(fused=False)
    assert not mode.hits, dict(mode.hits)


def test_fused_step_matches_jax_fused(small_rig):
    """(f) The JAX package's own fused ``_step``
    (``FramePipeline(PipelineConfig(fused=True, use_pallas=False))`` on the
    CPU, jitted) against the port's fused step with the same config: both
    take the XLA table integrator; the render-parity bounds of
    tests/test_golden.py:65-69."""
    from rgbd_recon_tpu.runtime.pipeline import FramePipeline as JFramePipeline
    from rgbd_recon_tpu.runtime.pipeline import PipelineConfig as JPipelineConfig

    n = 64
    kw = dict(fused=True, use_pallas=False, render_width=160, render_height=120,
              tsdf_res=(n, n, n), voxel_size=float(np.max(small_rig["bbox"].size) / n))
    jpipe = JFramePipeline(small_rig["rig"], JPipelineConfig(**kw))
    pipe = FramePipeline(_rig(small_rig), PipelineConfig(**kw), device="cpu")
    assert jpipe.use_fast and pipe.use_fast and pipe.integrator.tier == "table integrator"
    mv, proj = pipe.default_camera()
    jout = jpipe.step(small_rig["depth"], small_rig["color"], mv, proj)
    out = pipe.step(small_rig["depth"], small_rig["color"], mv, proj)
    want = types.SimpleNamespace(color=np.asarray(jout.color), depth=np.asarray(jout.depth),
                                 hit=np.asarray(jout.hit))
    got = types.SimpleNamespace(color=out.color.numpy(), depth=out.depth.numpy(),
                                hit=out.hit.numpy())
    s = render_parity(want, got)
    assert s["hit_agreement"] > 0.995, s
    assert s["psnr_rgb"] > 30.0, s
    assert s["ssim_rgb"] > 0.95, s
    assert s["depth_err_med"] < 2e-3, s
    assert s["depth_err_p99"] < 2e-2, s
    assert s["hit_frac"] > 0.02, s
    assert int(out.occupied_bricks) == int(np.asarray(jout.occupied_bricks))


def test_footprints_script_runs():
    """(g) ``rgbd_recon_torch.scripts.footprints`` on the CPU at a small
    size: percentiles ordered, the occupied pairs inside the valid ones."""
    from rgbd_recon_torch.scripts.footprints import footprints

    lines = []
    stats = footprints(128, 2, "cpu", width=128, height=104, fwd_res=(32, 48, 32),
                       inv_res=(32, 32, 32), log=lines.append)
    assert any(s.startswith("occupied bricks:") and int(s.split()[-1]) > 0 for s in lines)
    for name in ("u(x)", "v(y)"):
        st = stats[name]
        for i in (0, 1):
            assert 0.0 < st["p50"][i] <= st["p99"][i] <= st["max"][i], (name, st)
        assert st["max"][1] <= st["max"][0]

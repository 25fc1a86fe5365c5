"""The port's app path (``rgbd_recon_torch.app``) against the JAX app, on
the CPU, on the scene fixture of tests/test_app.py:16-42 (2 sensors at
128x104, a 96x64 render, voxel_size 0.05 -> 48^3), written here by the
port's own ``write_reference_scene`` (byte-identical to the JAX writer's,
tests/test_torch_io.py).

Both apps integrate the 48^3 volume with the XLA table integrator (the
pipelines' use_pallas gate), which the port computes in float32 where JAX
contracts hat weights, so the frames are held at the render-parity bounds
of tests/test_golden.py:65-69, not bitwise. The JAX frame is computed once
for the module.
"""
import glob
import json
import os
import types
import urllib.request

import numpy as np
import pytest
import torch

from rgbd_recon_tpu.app import AppConfig as JAppConfig
from rgbd_recon_tpu.app import KinectClientApp as JKinectClientApp
from rgbd_recon_tpu.app import load_config as jload_config
from rgbd_recon_tpu.runtime.pipeline import FramePipeline as JFramePipeline
from rgbd_recon_tpu.runtime.pipeline import PipelineConfig as JPipelineConfig
from rgbd_recon_tpu.utils.metrics import render_parity

from rgbd_recon_torch.app import AppConfig, FrameMonitor, KinectClientApp, load_config, main
from rgbd_recon_torch.calibration import synthetic
from rgbd_recon_torch.calibration.files import load_scene
from rgbd_recon_torch.io.stream import FrameFormat, StreamWriter
from rgbd_recon_torch.runtime.integrator import TABLE
from rgbd_recon_torch.runtime.pipeline import FramePipeline, PipelineConfig
from rgbd_recon_torch.utils.math import Bbox
from rgbd_recon_torch.utils.png import read_png
from rgbd_recon_torch.utils.timers import TimerDatabase

CONF = ("recon_mode: 1\nscreenWidth: 96\nscreenHeight: 64\nplay: true\n"
        "voxel_size: 0.05\nbrick_size: 0.2\ntsdf_limit: 0.02\n"
        "zoom: 2.5\ntime_limit: 600\n")
ZOOM = 0.5   # the conf's 2.5 puts the camera 15 m out: 0.4% of the pixels hit


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread: beside the other test workers on the same
    cores, a pool of 8 spins and a frame's small ops run 10-100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """Reference-format scene + 3 recorded frames + a .conf, by the port."""
    d = tmp_path_factory.mktemp("torch_scene")
    bbox = Bbox.default()
    ks = synthetic.write_reference_scene(str(d), num_sensors=2, bbox=bbox,
                                         width=128, height=104)
    cams = synthetic.make_cameras(2, bbox, width=128, height=104)
    depth, color = synthetic.render_frames(cams, synthetic.SphereScene.default(bbox))
    fmt = FrameFormat(width=128, height=104, width_c=128, height_c=104)
    (d / "recordings").mkdir()
    w = StreamWriter([str(d / "recordings" / f"sensor{i}.stream") for i in range(2)], fmt)
    for _ in range(3):
        w.write(depth, color)
    w.close()
    (d / "run.conf").write_text(CONF)
    return dict(dir=d, ks=ks, conf=str(d / "run.conf"), depth=depth, color=color)


def _app(cls, cfg_cls, load, scene, stereo_mode=0, **kw):
    """An app on the fixture's conf that writes no timer CSVs on quit (only
    test_app_replay_run_cpu's run writes them)."""
    cfg = cfg_cls()
    load(cfg, scene["conf"])
    cfg.time_limit = 0
    cfg.loaded_conf = False
    cfg.stereo_mode = stereo_mode
    return cls(str(scene["dir"] / "scene.ks"), cfg,
               recordings_dir=str(scene["dir"] / "recordings"),
               out_dir=str(scene["dir"] / "frames_unused"), log=lambda *a: None, **kw)


def _first_frame(app):
    """One frame_step at ZOOM; the pipeline's FrameOutput of that frame."""
    outs = []
    pipe = app.pipeline
    for name in ("step", "step_timed"):
        fn = getattr(pipe, name)
        setattr(pipe, name, lambda *a, fn=fn: outs.append(fn(*a)) or outs[-1])
    app.apply_control({"zoom": ZOOM})
    try:
        rgba = app.frame_step()
    finally:
        app.quit()
    assert len(outs) == 1
    return rgba, outs[0]


@pytest.fixture(scope="module")
def jax_frame(scene):
    app = _app(JKinectClientApp, JAppConfig, jload_config, scene)
    rgba, out = _first_frame(app)
    jpipe = app.pipeline
    return types.SimpleNamespace(color=np.asarray(rgba), depth=np.asarray(out.depth),
                                 hit=np.asarray(out.hit), use_pallas=jpipe._use_pallas())


def test_app_frame_matches_jax(scene, jax_frame):
    """The slice as a whole: the port's app frame (replay, host decode,
    FramePipeline on the CPU) against the JAX app's, at the render-parity
    bounds of tests/test_golden.py:65-69. At 48^3 both pipelines take the
    XLA table integrator (the use_pallas gate: fewer than 8 bricks an
    axis), with the 64-px window origins of tsdf_fast.win_offsets."""
    app = _app(KinectClientApp, AppConfig, load_config, scene, device="cpu")
    pipe = app.pipeline
    assert pipe.tsdf_cfg.res == (48, 48, 48)
    integ = pipe.integrator
    assert integ.tier == TABLE and integ.affine is None and integ.tables is not None
    assert jax_frame.use_pallas is False
    rgba, out = _first_frame(app)
    assert rgba.shape == (64, 96, 4) and bool(torch.isfinite(rgba).all())
    got = types.SimpleNamespace(color=rgba.numpy(), depth=out.depth.numpy(),
                                hit=out.hit.numpy())
    s = render_parity(jax_frame, got)
    print(f"app frame vs the JAX app's: {s}")
    assert s["hit_agreement"] > 0.995, s
    assert s["psnr_rgb"] > 30.0, s
    assert s["ssim_rgb"] > 0.95, s
    assert s["depth_err_med"] < 2e-3, s
    assert s["depth_err_p99"] < 2e-2, s
    assert s["hit_frac"] > 0.02, s


def test_app_replay_run_cpu(scene, monkeypatch):
    """``main([... "-device", "cpu"])``: .ks + .conf + recordings -> frame
    and texture PNGs and the reference-named timer CSVs."""
    d = scene["dir"]
    monkeypatch.chdir(d)
    # a fresh process-wide timer database: the CSVs list every timer of
    # the process, and other test files of this worker register their own
    monkeypatch.setattr(TimerDatabase, "_instance", None)
    rc = main(["scene.ks", "run.conf", "-recordings", "recordings", "-outdir",
               str(d / "frames"), "-dump-every", "2", "-dump-textures", "-frames", "4",
               "-device", "cpu"])
    assert rc == 0
    pngs = sorted(glob.glob(str(d / "frames" / "frame_?????.png")))
    assert len(pngs) == 2
    assert read_png(pngs[0]).shape == (64, 96, 4)
    for tex in ("depth", "silhouette", "quality", "normals", "color"):
        assert glob.glob(str(d / "frames" / f"*_k1_{tex}.png")), tex
    csvs = glob.glob(str(d / "mean_run,*.csv"))
    assert len(csvs) == 1, os.listdir(d)
    header, values = open(csvs[0]).read().splitlines()
    # the stage timers and the strategies' draw_<name> timers, as the JAX app's
    assert header == ('timer,"1preprocess","2integrate","3recon","draw","draw_calibs",'
                      '"draw_mvt","draw_points","draw_trigrid","holefill"')
    assert values.startswith("run,")
    assert glob.glob(str(d / "min_run,*.csv")) and glob.glob(str(d / "max_run,*.csv"))


def test_app_control_channel(scene):
    """POST /control mid-run on the viewer (bound to 127.0.0.1): a
    tsdf_limit retune, a shade-mode rebuild and a switch to recon mode 2
    (trigrid) apply with a log line each, a bricking-off command applies
    with the res it derives logged, and the loop keeps streaming; GET
    /state reflects it. Bricking back on returns the integrator held over
    the reference path, its bake kept."""
    logs = []
    app = _app(KinectClientApp, AppConfig, load_config, scene, device="cpu",
               serve_port=0)
    app.log = logs.append
    try:
        assert app.viewer._server.server_address[0] == "127.0.0.1"
        assert app.frame_step() is not None
        integ, warp = app.pipeline.integrator, app.pipeline._warp
        tables = integ.tables
        body = json.dumps({"tsdf_limit": 0.04, "recon_mode": 2, "bricking": False,
                           "shade_mode": 1, "draw_grid": True}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{app.viewer.port}/control",
                                     data=body, method="POST")
        assert json.load(urllib.request.urlopen(req, timeout=10))["ok"]
        rgba = app.frame_step()
        assert isinstance(rgba, np.ndarray) and rgba.shape == (64, 96, 4)  # grid overlay
        assert app.pipeline.cfg.tsdf_limit == pytest.approx(0.04)
        assert app.pipeline.cfg.shade_mode == 1 and not app.pipeline.cfg.use_bricks
        assert app.cfg.recon_mode == 2
        assert app.pipeline.integrator is None and app.pipeline._warp is warp
        assert any(s == "control: recon_mode -> trigrid" for s in logs), logs
        assert not any("refused" in s and "recon_mode" in s for s in logs), logs
        assert "control: bricking off: volume res (40, 45, 40) (reference path)" in logs, logs
        assert not any("refused" in s for s in logs), logs
        assert TimerDatabase.instance().timers["draw_trigrid"].count >= 1
        state = json.load(urllib.request.urlopen(
            f"http://127.0.0.1:{app.viewer.port}/state", timeout=10))
        assert state["recon_mode"] == 2 and state["tsdf_limit"] == pytest.approx(0.04)
        assert app.frame_step() is not None
        app.apply_control({"bricking": True})
        assert app.pipeline.integrator is integ and integ.tables is tables
    finally:
        app.quit()


def test_app_anaglyph(scene):
    """Stereo mode 1: the left eye's red, the right eye's green and blue."""
    app = _app(KinectClientApp, AppConfig, load_config, scene, stereo_mode=1,
               device="cpu")
    app.apply_control({"zoom": ZOOM})
    try:
        rgba = app.frame_step()
    finally:
        app.quit()
    assert isinstance(rgba, np.ndarray) and rgba.shape == (64, 96, 4)
    assert np.isfinite(rgba).all() and (rgba[..., 3] == 0).all()
    assert rgba[..., 0].max() > 0 and rgba[..., 2].max() > 0


def test_app_live_zmq(scene):
    """Live mode: a localhost PUB feeds the app through ZMQIngest and the
    DeviceFeed; frames render and dump."""
    zmq = pytest.importorskip("zmq")
    import threading
    import time

    ctx = zmq.Context(1)
    pub = ctx.socket(zmq.PUB)
    port = pub.bind_to_random_port("tcp://127.0.0.1")
    stop = threading.Event()
    depth, color = scene["depth"], scene["color"]
    parts = [np.float64(1.0).tobytes()]
    for k in range(depth.shape[0]):
        parts.append(np.clip(np.rint(color[k] * 255), 0, 255).astype(np.uint8).tobytes())
        parts.append(depth[k].astype(np.float32).tobytes())
    msg = b"".join(parts)

    def feed():
        while not stop.is_set():
            pub.send(msg)
            time.sleep(0.05)

    t = threading.Thread(target=feed, daemon=True)
    t.start()
    try:
        cfg = AppConfig()
        load_config(cfg, scene["conf"])
        cfg.play, cfg.time_limit = False, 0
        out_dir = scene["dir"] / "frames_live"
        app = KinectClientApp(str(scene["dir"] / "scene.ks"), cfg,
                              server_socket=f"127.0.0.1:{port}", out_dir=str(out_dir),
                              dump_every=1, max_frames=2, device="cpu",
                              log=lambda *a: None)
        assert app.ingest is not None and not app.ingest.raw_wire
        assert app.run() == 0
        assert app._frames_done >= 2
        assert glob.glob(str(out_dir / "frame_*.png"))
    finally:
        stop.set()
        t.join(timeout=5)
        pub.close(0)
        ctx.term()


def test_frame_monitor_holds_each_fence_to_its_own_limit():
    """The capacity is captured at submit: a later change of the pipeline's
    limit does not move it; overflow and non-finite frames surface on
    drain."""
    mon = FrameMonitor(torch.device("cpu"))
    try:
        rgba = torch.zeros(2, 2, 4)
        mon.submit(0, torch.tensor([1, 5], dtype=torch.int32), rgba, max_bricks=5)
        mon.submit(1, torch.tensor([1, 9], dtype=torch.int32), rgba, max_bricks=None)
        mon.drain()
        mon.submit(2, torch.tensor([1, 6], dtype=torch.int32), rgba, max_bricks=5)
        with pytest.raises(RuntimeError, match="exceed max_bricks=5"):
            mon.drain()
        mon.submit(3, torch.tensor([0, 1], dtype=torch.int32), rgba, max_bricks=5)
        with pytest.raises(RuntimeError, match="non-finite"):
            mon.drain()
    finally:
        mon.close()


def _pipe(rig, **over):
    kw = dict(render_width=64, render_height=48, voxel_size=0.05, brick_size=0.2,
              tsdf_limit=0.02, num_lods=3)
    kw.update(over)
    return FramePipeline(rig, PipelineConfig(**kw), device="cpu")


def test_retune_tsdf_limit_keeps_bakes(scene):
    """A tsdf_limit retune keeps the affine bake, the pixel warp, the device
    rig and the windows (the same objects), re-derives the cull bake, and
    then renders what a fresh pipeline at the new limit renders, bit for
    bit (use_pallas=True: the 48^3 volume on the quadratic-warp tier,
    which has the cull bake)."""
    _, rig, _, _ = load_scene(scene["ks"])
    pipe = _pipe(rig, use_pallas=True)
    mv, proj = pipe.default_camera()
    pipe.step(scene["depth"], scene["color"], mv, proj)
    integ = pipe.integrator
    kept = (integ.affine, pipe._warp, pipe._drig, integ.win_off)
    cull = integ.cull_bake
    pipe.retune(tsdf_limit=0.04)
    out = pipe.step(scene["depth"], scene["color"], mv, proj)
    assert pipe.integrator is integ
    assert all(a is b for a, b in zip(kept, (integ.affine, pipe._warp, pipe._drig,
                                             integ.win_off)))
    assert integ.cull_bake is not cull
    fresh = _pipe(rig, tsdf_limit=0.04, use_pallas=True).step(scene["depth"], scene["color"],
                                                               mv, proj)
    for f in ("color", "depth", "hit", "tsdf", "occupied_bricks"):
        assert torch.equal(getattr(out, f), getattr(fresh, f)), f
    assert float(out.tsdf.min()) == pytest.approx(-0.04)


def test_retune_voxel_size_matches_jax_res(scene):
    """A voxel_size retune re-derives the res at align=16 as the JAX
    pipeline's retune does, and re-bakes; reload keeps every bake; warmup
    logs each stage; warm_variants_async is a logged no-op."""
    from rgbd_recon_tpu.calibration.files import load_scene as jload_scene

    _, rig, _, _ = load_scene(scene["ks"])
    logs = []
    pipe = _pipe(rig)
    pipe._log = logs.append
    _, jrig, _, _ = jload_scene(scene["ks"])
    jpipe = JFramePipeline(jrig, JPipelineConfig(render_width=64, render_height=48,
                                                 voxel_size=0.05, brick_size=0.2,
                                                 tsdf_limit=0.02))
    assert pipe.tsdf_cfg.res == jpipe.tsdf_cfg.res == (48, 48, 48)
    tables = pipe.integrator.tables
    pipe.retune(voxel_size=0.1)
    jpipe.retune(voxel_size=0.1)
    assert pipe.tsdf_cfg.res == jpipe.tsdf_cfg.res == (32, 32, 32)
    # both volumes are under 8 bricks an axis: the warp tables, re-baked
    integ = pipe.integrator
    assert integ.affine is None and jpipe.affine is None
    assert integ.tables is not tables and tuple(integ.tables.pos_blocked.shape[:2]) == (2, 8)
    mv, proj = pipe.default_camera()
    pipe.warmup(scene["depth"], scene["color"], mv, proj)
    for stage in ("session bakes", "1preprocess", "2integrate", "3recon", "holefill"):
        assert any(s.startswith(f"  {stage}") for s in logs), (stage, logs)
    kept = (integ.tables, pipe._warp, integ.win_off)
    pipe.reload()
    assert pipe.integrator is integ
    assert all(a is b for a, b in zip(kept, (integ.tables, pipe._warp, integ.win_off)))
    out = pipe.step(scene["depth"], scene["color"], mv, proj)
    assert tuple(out.tsdf.shape) == (32, 32, 32) and bool(torch.isfinite(out.color).all())
    n = len(logs)
    pipe.warm_variants_async(scene["depth"], scene["color"], mv, proj)
    pipe.warm_variants_async(scene["depth"], scene["color"], mv, proj)
    assert len(logs) == n + 1 and "nothing to warm" in logs[-1]

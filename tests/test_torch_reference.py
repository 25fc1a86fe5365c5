"""The reference path of the port against the JAX package, on the CPU at
small size: NEAREST sampling, the voxel mask, the dense integrators, the
per-ray oracle marcher, ``FramePipeline`` on its reference branch, the
bake kept across a bricking toggle, the app's bricking toggle and the
golden-parity script.

The JAX side is built from its module functions (no whole-frame jit): the
``small_rig`` fixture's frame (3 sensors at 256x212) preprocessed once
with the affine pixel warp, a 40x45x40 volume (voxel_size 0.05 at align
1), 160x120 renders. Render parity is held at the bounds of
tests/test_golden.py:65-69, the integrators at the bound of
tests/test_tsdf_affine.py:109-116 and bit for bit (the same float32
operations in the same order).
"""
import json
import types
import urllib.request

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rgbd_recon_tpu.ops import bricks as jbricks
from rgbd_recon_tpu.ops import inpaint as jinpaint
from rgbd_recon_tpu.ops import preprocess as jpp
from rgbd_recon_tpu.ops import raymarch as jrm
from rgbd_recon_tpu.ops import sample as jsample
from rgbd_recon_tpu.ops import tsdf as jtsdf
from rgbd_recon_tpu.ops import tsdf_fast as jtsdf_fast
from rgbd_recon_tpu.ops.warp import bake_pixel_warp as jbake_pixel_warp
from rgbd_recon_tpu.runtime.pipeline import FramePipeline as JFramePipeline
from rgbd_recon_tpu.runtime.pipeline import PipelineConfig as JPipelineConfig
from rgbd_recon_tpu.utils.math import look_at, perspective
from rgbd_recon_tpu.utils.metrics import render_parity

from rgbd_recon_torch.app import AppConfig, KinectClientApp, load_config
from rgbd_recon_torch.calibration import synthetic
from rgbd_recon_torch.calibration.files import load_scene
from rgbd_recon_torch.calibration.rig import device_rig
from rgbd_recon_torch.convert import from_jax
from rgbd_recon_torch.io.configurator import Configurator
from rgbd_recon_torch.io.stream import FrameFormat, StreamWriter
from rgbd_recon_torch.ops import bricks, raymarch as rm, sample, tsdf, tsdf_fast
from rgbd_recon_torch.runtime.pipeline import FrameOutput, FramePipeline, PipelineConfig
from rgbd_recon_torch.scripts import golden_parity
from rgbd_recon_torch.utils.math import Bbox
from rgbd_recon_torch.utils.metrics import render_parity_passes

VOXEL = 0.05
RES = (40, 45, 40)   # voxel_size 0.05 at align 1, the reference path's derivation
RW, RH = 160, 120
LIMIT = 0.01


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: the oracle runs thousands of
    small ops a frame (every trip of its march), where a parallel region
    per op costs more than it saves, most of all beside other test
    workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().to(torch.float32).cpu().numpy()


def _assert_render_parity(want, got):
    """tests/test_golden.py:65-69, on a frame with coverage."""
    s = render_parity(want, got)
    assert render_parity_passes(s) and s["hit_frac"] > 0.02, s
    return s


def _host(out):
    return types.SimpleNamespace(color=_np(out.color), depth=_np(out.depth),
                                 hit=out.hit.cpu().numpy())


def _skip_args(grid, bbox):
    """The brick skip's geometry as the JAX pipeline derives it
    (rgbd_recon_tpu/runtime/pipeline.py:688-690)."""
    return dict(brick_size_vol=grid.brick_size / float(np.max(bbox.size)),
                brick_extent=np.asarray(grid.res, np.float32) * grid.brick_size
                / bbox.size.astype(np.float32))


@pytest.fixture(scope="module")
def ref(small_rig):
    """The JAX frame, its brick mask, its volumes at RES without and with
    the voxel mask, and for each the JAX stage chain's frame (render, with
    the brick skip where bricks are on, then hole filling), once."""
    rig, bbox = small_rig["rig"], small_rig["bbox"]
    depth, color = small_rig["depth"], small_rig["color"]
    _, h, w = depth.shape
    # 1preprocess and holefill as the JAX pipeline runs them, jitted (op by
    # op they cost ~20 s more); integrate and render op by op
    warp = jbake_pixel_warp(rig, h, w)
    frames = jax.jit(lambda d, c: jpp.preprocess(d, c, rig, warp=warp))(
        jnp.asarray(depth), jnp.asarray(color))
    fill = jax.jit(lambda c, d: jinpaint.colorfill(*jinpaint.build_pyramid(c, d, 4)))
    cfg = jtsdf.TsdfConfig(RES, LIMIT)
    grid = jbricks.make_brick_grid(bbox, 0.1, VOXEL)
    mask = jbricks.occupancy_mask(
        jbricks.mark_bricks(frames.world, frames.world_valid, grid), 10)
    vmask = jbricks.voxel_occupancy(mask, grid, RES)
    vols = {on: (jtsdf.integrate(frames, rig, cfg, voxel_mask=vmask if on else None),
                 jtsdf.integrate_colors(frames, rig, cfg, voxel_mask=vmask if on else None))
            for on in (False, True)}
    center = (bbox.min + bbox.max) * 0.5
    mv = look_at(center + np.array([1.5, 0.8, 2.2], np.float32), center, [0, 1, 0])
    proj = perspective(50.0, RW / RH, 0.1, 200.0)
    jcam = jrm.RenderCamera(jnp.asarray(mv), jnp.asarray(proj), RW, RH)
    chain, raw = {}, {}
    for on, (v, c) in vols.items():
        out = jrm.render(v, c, frames, rig, jcam, bbox, LIMIT, brick_mask=mask if on else None,
                         **_skip_args(grid, bbox))
        chain[on] = types.SimpleNamespace(color=np.asarray(fill(out.color, out.depth)),
                                          depth=np.asarray(out.depth),
                                          hit=np.asarray(out.hit))
        if not on:      # shade mode 0 on the unmasked volume, with and without the skip
            raw[False] = out
            raw[True] = jrm.render(v, c, frames, rig, jcam, bbox, LIMIT, brick_mask=mask,
                                   **_skip_args(grid, bbox))
    return types.SimpleNamespace(
        rig=rig, bbox=bbox, depth=depth, color=color, frames=frames, grid=grid, mask=mask,
        vmask=vmask, vols=vols, vol=vols[False][0], cvol=vols[False][1], mv=mv, proj=proj,
        jcam=jcam, chain=chain, raw=raw, tframes=from_jax(frames),
        trig=device_rig(from_jax(rig), "cpu", volumes=True), marches={})


def _t(a):
    return torch.from_numpy(np.array(a))


def _cam(ref):
    return rm.RenderCamera(torch.from_numpy(ref.mv), torch.from_numpy(ref.proj), RW, RH)


def _port_march(ref, skip):
    """The port's march on the unmasked volume, once per skip setting."""
    if skip not in ref.marches:
        kw = _skip_args(ref.grid, ref.bbox) if skip else {}
        ref.marches[skip] = rm.march(_t(ref.vol), _cam(ref), ref.bbox, LIMIT,
                                     brick_mask=_t(ref.mask) if skip else None, **kw)
    return ref.marches[skip]


@pytest.mark.parametrize("dims", [2, 3])
def test_nearest_sampling_bit_exact(dims):
    """sample2d / sample3d with method="nearest": floor(t*N) clamped, the
    same texels as JAX's, coordinates outside [0, 1] and NaN included."""
    rng = np.random.default_rng(8)
    shape = (13, 17, 3) if dims == 2 else (7, 9, 11, 2)
    img = rng.standard_normal(shape).astype(np.float32)
    t = rng.uniform(-0.3, 1.3, (40, 50, dims)).astype(np.float32)
    t[0, :dims] = np.nan
    t[1, 0] = 1.0
    fn, jfn = ((sample.sample2d, jsample.sample2d) if dims == 2
               else (sample.sample3d, jsample.sample3d))
    got = fn(torch.from_numpy(img), torch.from_numpy(t), method="nearest")
    want = np.asarray(jfn(jnp.asarray(img), jnp.asarray(t), method="nearest"))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("res", [(60, 66, 60), (64, 80, 48)])
def test_voxel_occupancy_exact(ref, res):
    """voxel_occupancy against JAX's one-hot expansion, exactly, on an
    unaligned and a 16-aligned volume; on the aligned one
    block_occupancy == brick16_mask(voxel_occupancy)
    (rgbd_recon_tpu/ops/bricks.py:141-142)."""
    mask = _t(ref.mask)
    grid = bricks.make_brick_grid(ref.bbox, 0.1, VOXEL)
    got = bricks.voxel_occupancy(mask, grid, res)
    want = np.asarray(jbricks.voxel_occupancy(ref.mask, ref.grid, res))
    assert got.shape == res[::-1] and 0 < int(got.sum()) < got.numel()
    np.testing.assert_array_equal(got.numpy(), want)
    if all(r % 16 == 0 for r in res):
        m16 = tsdf_fast.brick16_mask(got).numpy()
        np.testing.assert_array_equal(m16, bricks.block_occupancy(mask, grid, res).numpy())
        np.testing.assert_array_equal(m16, np.asarray(jtsdf_fast.brick16_mask(jnp.asarray(want))))


@pytest.mark.parametrize("masked", [False, True])
def test_integrate_matches_jax(ref, masked):
    """integrate and integrate_colors on the same frames and rig, with and
    without the voxel mask: the integrator bound (< 1e-4 of voxels off by
    more than 1e-4, occupancy within max(100, 0.2%), < 1e-3 of voxels with
    a color deviation above 1e-2) and, both being the same float32
    operations in the same order, bit for bit (measured: 0)."""
    vmask = _t(ref.vmask) if masked else None
    cfg = tsdf.TsdfConfig(RES, LIMIT)
    v = _np(tsdf.integrate(ref.tframes, ref.trig, cfg, voxel_mask=vmask))
    c = _np(tsdf.integrate_colors(ref.tframes, ref.trig, cfg, voxel_mask=vmask))
    jv, jc = (np.asarray(a) for a in ref.vols[masked])
    assert v.shape == RES[::-1] and c.shape == RES[::-1] + (4,)
    dv, dc = np.abs(v - jv), np.abs(c - jc)
    occ, jocc = (v > -LIMIT + 1e-9).sum(), (jv > -LIMIT + 1e-9).sum()
    print(f"integrate max dev {dv.max():.3e}, integrate_colors {dc.max():.3e}, occupied "
          f"{occ} vs {jocc}")
    assert (dv > 1e-4).mean() < 1e-4
    assert jocc > 500 and abs(int(occ) - int(jocc)) <= max(100, 0.002 * jocc)
    assert (dc.max(axis=-1) > 1e-2).mean() < 1e-3
    assert dv.max() == 0.0 and dc.max() == 0.0
    if masked:
        out = ~vmask.numpy()
        assert out.any() and (v[out] == np.float32(-LIMIT)).all() and (c[out] == 0).all()


@pytest.mark.parametrize("skip", [False, True])
def test_march_matches_jax(ref, skip):
    """march on the same volume: hits, sample counts and refined hit
    positions (median and p99 deviation), with and without the coarse brick
    skip, which must shorten the march."""
    kw = _skip_args(ref.grid, ref.bbox) if skip else {}
    want = jrm.march(ref.vol, ref.jcam, ref.bbox, LIMIT,
                     brick_mask=ref.mask if skip else None, **kw)
    got = _port_march(ref, skip)
    hit, jhit = got.hit.numpy(), np.asarray(want.hit)
    both = hit & jhit
    pos_dev = np.abs(got.position.numpy() - np.asarray(want.position))[both].max(axis=-1)
    ns, jns = got.num_samples.numpy(), np.asarray(want.num_samples)
    print(f"march skip={skip}: hit agreement {(hit == jhit).mean():.5f}, hit position dev "
          f"median {np.median(pos_dev):.2e} p99 {np.percentile(pos_dev, 99):.2e} max "
          f"{pos_dev.max():.2e} (n {pos_dev.size}), samples equal {(ns == jns).mean():.5f}, "
          f"mean {ns.mean():.2f}")
    assert (hit == jhit).mean() > 0.995 and jhit.mean() > 0.02
    # volume units (a voxel is ~2.3e-2, a step 5e-3): the camera algebra's
    # last bits move a few secant refinements at grazing hits
    assert np.median(pos_dev) < 1e-5 and np.percentile(pos_dev, 99) < 1e-4
    assert (ns == jns).mean() > 0.99
    if skip:
        full = _port_march(ref, False).num_samples
        assert ns.mean() < 0.5 * full.float().mean()


@pytest.mark.parametrize("shade, exact, skip", [
    (0, False, False), (0, False, True), (1, False, True), (2, False, True),
    (3, False, True), (0, True, True),
])
def test_render_matches_jax(ref, shade, exact, skip):
    """render in shade modes 0-3 and with the exact per-hit color blend,
    with and without the brick skip, on the same volumes, frames and rig:
    the render-parity bounds. The JAX frames of shade mode 0 are the
    ``ref`` fixture's."""
    kw = _skip_args(ref.grid, ref.bbox) if skip else {}
    if shade == 0 and not exact:
        want = ref.raw[skip]
    else:
        want = jrm.render(ref.vol, ref.cvol, ref.frames, ref.rig, ref.jcam, ref.bbox, LIMIT,
                          jrm.RenderParams(shade_mode=shade),
                          brick_mask=ref.mask if skip else None, exact_colors=exact, **kw)
    got = rm.render(_t(ref.vol), _t(ref.cvol), ref.tframes, ref.trig, _cam(ref), ref.bbox,
                    LIMIT, rm.RenderParams(shade_mode=shade),
                    brick_mask=_t(ref.mask) if skip else None, exact_colors=exact, **kw)
    assert got.color.shape == (RH, RW, 4) and bool(torch.isfinite(got.color).all())
    s = _assert_render_parity(want, _host(got))
    print(f"render shade {shade} exact {exact} skip {skip}: {s}")


def test_render_takes_the_production_layout(ref):
    """A bf16 TSDF and a z-major bf16 color volume (the dense emit's) render
    as their float32 channels-last copies do."""
    vol, cvol = _t(ref.vol).to(torch.bfloat16), _t(ref.cvol).to(torch.bfloat16)
    cam = _cam(ref)._replace(width=RW // 2, height=RH // 2)
    a = rm.render(vol, cvol.permute(0, 3, 1, 2).contiguous(), None, None, cam, ref.bbox, LIMIT)
    b = rm.render(vol.float(), cvol.float(), None, None, cam, ref.bbox, LIMIT)
    assert a.hit.any()
    for f in ("color", "depth", "hit", "num_samples"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _pipe_kw(**over):
    kw = dict(render_width=RW, render_height=RH, brick_size=0.1, num_lods=4)
    kw.update(over)
    return kw


@pytest.mark.parametrize("over", [
    dict(use_bricks=False), dict(fast_path=False), dict(tsdf_res=RES),
], ids=["use_bricks=False", "fast_path=False", "unaligned"])
def test_pipeline_reference_matches_jax(ref, over):
    """FramePipeline on its reference branch, with its own bakes, against
    the JAX stage chain on the same frame: the JAX pipeline's res (align 1
    from voxel_size 0.05, or the unaligned tsdf_res), brick grid and
    capacity, then the render-parity bounds. The four stage timers are
    filled."""
    kw = _pipe_kw(voxel_size=VOXEL, **over)
    jpipe = JFramePipeline(ref.rig, JPipelineConfig(**kw))
    pipe = FramePipeline(from_jax(ref.rig), PipelineConfig(**kw), device="cpu")
    assert not jpipe.use_fast and not pipe.use_fast
    assert pipe.tsdf_cfg.res == jpipe.tsdf_cfg.res == RES
    assert pipe.brick_grid.res == jpipe.brick_grid.res == ref.grid.res
    assert pipe.integrator is None and pipe.max_bricks == jpipe.max_bricks
    mv, proj = pipe.default_camera()
    assert np.array_equal(mv, ref.mv) and np.array_equal(proj, ref.proj)
    out = pipe.step_timed(ref.depth, ref.color, mv, proj)
    assert out.tsdf.dtype == torch.float32 and out.tsdf.shape == RES[::-1]
    assert pipe.check_capacity(out) == 0
    assert all(pipe.timers.timers[t].count == 1 for t in
               ("1preprocess", "2integrate", "3recon", "holefill"))
    s = _assert_render_parity(ref.chain[jpipe.cfg.use_bricks], _host(out))
    print(f"{over}: {s}")


@pytest.mark.xfail(strict=True, raises=AttributeError,
                   reason="the JAX pipeline keeps its missing warp bake when bricking is "
                          "turned on with keep_warp_bake=True (runtime/pipeline.py:202-231), "
                          "so the next step reaches tsdf_fast.win_offsets(None, ...); the "
                          "port rebakes (test_bricking_toggle_rebakes)")
def test_jax_bricking_toggle_keeps_no_bake(ref):
    """The JAX app's toggle (app.py:415) on a pipeline started with
    bricking off."""
    cfg = JPipelineConfig(**_pipe_kw(use_bricks=False, voxel_size=VOXEL))
    jpipe = JFramePipeline(ref.rig, cfg)
    jpipe._configure(cfg._replace(use_bricks=True), keep_warp_bake=True)
    assert jpipe.use_fast
    mv, proj = jpipe.default_camera()
    jpipe.step(ref.depth, ref.color, mv, proj)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A reference-format scene (2 sensors at 128x104, 3 recorded frames)
    and a .conf with bricking off, voxel_size 0.05 and a 96x64 render."""
    d = tmp_path_factory.mktemp("torch_ref_scene")
    bbox = Bbox.default()
    ks = synthetic.write_reference_scene(str(d), num_sensors=2, bbox=bbox, width=128,
                                         height=104)
    cams = synthetic.make_cameras(2, bbox, width=128, height=104)
    depth, color = synthetic.render_frames(cams, synthetic.SphereScene.default(bbox))
    (d / "recordings").mkdir()
    w = StreamWriter([str(d / "recordings" / f"sensor{i}.stream") for i in range(2)],
                     FrameFormat(width=128, height=104, width_c=128, height_c=104))
    for _ in range(3):
        w.write(depth, color)
    w.close()
    (d / "run.conf").write_text(
        "recon_mode: 1\nscreenWidth: 96\nscreenHeight: 64\nplay: true\n"
        "voxel_size: 0.05\nbrick_size: 0.2\ntsdf_limit: 0.02\nbricking: false\nzoom: 0.5\n")
    _, rig, _, _ = load_scene(ks)
    return dict(dir=d, ks=ks, conf=str(d / "run.conf"), rig=rig, depth=depth, color=color)


@pytest.mark.parametrize("over", [dict(voxel_size=VOXEL),
                                  dict(tsdf_res=(48, 48, 48), voxel_size=2.2 / 48)],
                         ids=["res changes", "res kept"])
def test_bricking_toggle_rebakes(scene, over):
    """Bricking off -> on -> off through ``_configure(keep_warp_bake=True)``
    (the app's toggle): each frame equals a fresh pipeline's at that config,
    bit for bit. Toggling on bakes when the res moved to align 16 ("res
    changes") and when the res stayed but no bake was held ("res kept")."""
    rig, depth, color = scene["rig"], scene["depth"], scene["color"]
    cfg = PipelineConfig(**_pipe_kw(use_bricks=False, render_width=64, render_height=48,
                                    tsdf_limit=0.04, num_lods=3, **over))
    pipe = FramePipeline(rig, cfg, device="cpu")
    mv, proj = pipe.default_camera()
    res = []
    for on in (False, True, False):
        c = cfg._replace(use_bricks=on)
        if c != pipe.cfg:
            pipe._configure(c, keep_warp_bake=True)
        assert pipe.use_fast is on and (pipe.integrator is not None) is on
        assert pipe.integrator is None or pipe.integrator.tables is not None
        out = pipe.step(depth, color, mv, proj)
        res.append(pipe.tsdf_cfg.res)
        assert float(out.hit.float().mean()) > 0.02
        if len(res) > 1:
            fresh = FramePipeline(rig, c, device="cpu")
            assert fresh.tsdf_cfg.res == pipe.tsdf_cfg.res
            want = fresh.step(depth, color, mv, proj)
            for f in FrameOutput._fields:
                assert torch.equal(getattr(out, f), getattr(want, f)), (on, f)
    assert (res[0] != res[1]) is ("tsdf_res" not in over)


def test_app_toggles_bricking(scene, monkeypatch):
    """The app starts with ``bricking: false`` (the reference path at the
    align-1 res), then POSTs on its control channel turn bricking on and
    off again: each toggle is logged with the res it derives, and each
    frame equals a fresh pipeline's at that config, bit for bit."""
    # a fresh process-wide Configurator: it keeps every key it has read, so
    # this conf's bricking: false would reach later apps of this worker
    monkeypatch.setattr(Configurator, "_instance", None)
    cfg = AppConfig()
    load_config(cfg, scene["conf"])
    cfg.time_limit, cfg.loaded_conf = 0, False
    logs = []
    app = KinectClientApp(str(scene["dir"] / "scene.ks"), cfg,
                          recordings_dir=str(scene["dir"] / "recordings"),
                          out_dir=str(scene["dir"] / "frames"), log=logs.append,
                          device="cpu", serve_port=0)
    pipe = app.pipeline
    calls = []
    for name in ("step", "step_timed"):
        fn = getattr(pipe, name)
        setattr(pipe, name, lambda *a, fn=fn: calls.append((a, fn(*a))) or calls[-1][1])
    try:
        assert not pipe.use_fast and pipe.tsdf_cfg.res == (40, 45, 40)
        for cmd in (None, {"bricking": True}, {"bricking": "false"}):
            if cmd is not None:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{app.viewer.port}/control",
                    data=json.dumps(cmd).encode(), method="POST")
                assert json.load(urllib.request.urlopen(req, timeout=10))["ok"]
            assert app.frame_step() is not None
    finally:
        app.quit()
    assert [s for s in logs if s.startswith("control: bricking")] == [
        "control: bricking on: volume res (48, 48, 48) (brick-sparse path)",
        "control: bricking off: volume res (40, 45, 40) (reference path)"]
    assert not any("refused" in s for s in logs), logs
    rig = scene["rig"]
    assert len(calls) == 3
    for (args, out), on in zip(calls, (False, True, False)):
        want = FramePipeline(rig, pipe.cfg._replace(use_bricks=on), device="cpu").step(*args)
        for f in FrameOutput._fields:
            assert torch.equal(getattr(out, f), getattr(want, f)), (on, f)
        assert float(out.hit.float().mean()) > 0.02


def test_golden_parity_script_cpu(monkeypatch, tmp_path, capsys):
    """``python -m rgbd_recon_torch.scripts.golden_parity`` on the CPU at a
    small size (3 sensors at 256x212, 48^3, 128x96): the production volume
    through the oracle marcher and the sweep at the four views, the table
    printed, every view at the render-parity bounds (exit 0), the rig
    cached in the port's own file."""
    make = synthetic.synthetic_rig
    monkeypatch.setattr(synthetic, "synthetic_rig", lambda **kw: make(
        **{**kw, "fwd_res": (48, 64, 48), "inv_res": (48, 48, 48), "width": 256,
           "height": 212}))
    monkeypatch.setattr(golden_parity, "CACHE_DIR", str(tmp_path))
    rc = golden_parity.main(["--tsdf", "48", "--render", "128x96", "--sensors", "3",
                             "--device", "cpu", "--markdown"])
    out = capsys.readouterr().out.splitlines()
    print("\n".join(out))
    assert rc == 0
    rows = [ln for ln in out if ln.startswith("| ") and ln.split("|")[1].strip()
            in golden_parity.VIEWS]
    assert len(rows) == 4 and out[-1] == "cpu"
    assert (tmp_path / "torch_rig_k3_d0_sphere.npz").exists()

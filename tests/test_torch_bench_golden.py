"""The port's frame at the bench size against the JAX package's own
outputs, stage by stage (``rgbd_recon_torch/utils/bench_golden.py`` says
what ``tests/data/torch_bench_golden.npz`` holds).

The tier-1 tests here run the port alone on the CPU (its plain kernels,
one intra-op thread) on frame 0 of the bench inputs: 4 sensors at
512x424, 256^3, 1280x720. They read the stored JAX outputs with numpy.
The writer runs JAX on the CPU and takes about 6 minutes:

    JAX_PLATFORMS=cpu python tests/test_torch_bench_golden.py --write

The ``full``-marked test reruns it into a temporary file and holds the
stored file to it.
"""
import os
import sys
import time

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest
import torch

from rgbd_recon_torch.ops import raymarch as rm
from rgbd_recon_torch.ops import raymarch_fast as rmf
from rgbd_recon_torch.runtime.pipeline import FramePipeline
from rgbd_recon_torch.utils import bench_golden as bg

N = 256


def write_golden(path: str, log=print) -> None:
    """Compute the three references with the JAX package on the CPU and
    write them to ``path`` (``np.savez_compressed``)."""
    import jax
    import jax.numpy as jnp

    from rgbd_recon_tpu.calibration import synthetic as jsyn
    from rgbd_recon_tpu.calibration.rig import RigCalibration as JRig
    from rgbd_recon_tpu.ops import bricks as jbricks
    from rgbd_recon_tpu.ops import inpaint as jinpaint
    from rgbd_recon_tpu.ops import preprocess as jpp
    from rgbd_recon_tpu.ops import raymarch as jrm
    from rgbd_recon_tpu.ops import raymarch_fast as jrmf
    from rgbd_recon_tpu.ops import tsdf_affine as jaff
    from rgbd_recon_tpu.ops import warp as jwarp
    from rgbd_recon_tpu.ops.bricks_pallas import mark_bricks_pallas
    from rgbd_recon_tpu.ops.tsdf import TsdfConfig as JTsdfConfig
    from rgbd_recon_tpu.ops.tsdf_dense import integrate_dense_pallas
    from rgbd_recon_tpu.ops.tsdf_persist import integrate_affine_pallas
    from rgbd_recon_tpu.ops.warp_pallas import warp_screen_pallas
    from rgbd_recon_tpu.runtime.pipeline import FramePipeline as JPipe
    from rgbd_recon_tpu.runtime.pipeline import PipelineConfig as JCfg
    from rgbd_recon_tpu.utils.math import Bbox as JBbox

    if jax.default_backend() != "cpu":
        raise RuntimeError("write the golden with JAX on the CPU (JAX_PLATFORMS=cpu)")
    t_all = time.perf_counter()

    def step(what, t0):
        log(f"{what}: {time.perf_counter() - t0:.1f} s")
        return time.perf_counter()

    t0 = time.perf_counter()
    rig, bbox, depth, color = bg.bench_frame()
    k, w, h, fwd, inv = bg.BENCH
    jrig, jcams = jsyn.synthetic_rig(num_sensors=k, bbox=JBbox.default(), fwd_res=fwd,
                                     inv_res=inv, width=w, height=h)
    for f in JRig._fields:
        if not np.array_equal(np.asarray(getattr(jrig, f)), np.asarray(getattr(rig, f))):
            raise AssertionError(f"the JAX synthetic rig differs from the port's in {f}")
    jd, jc = jsyn.render_frames(jcams, jsyn.SphereScene.default(JBbox.default()))
    rng = np.random.default_rng(bg.SEED)
    if not (np.array_equal(jd + rng.uniform(0, 2e-3, jd.shape).astype(np.float32), depth)
            and np.array_equal(np.clip(jc + rng.uniform(0, 1e-2, jc.shape).astype(np.float32),
                                       0, 1), color)):
        raise AssertionError("the JAX frames differ from the port's")
    jrig = JRig(*(np.asarray(getattr(rig, f)) for f in JRig._fields))
    rec = {f"digest/{key}": np.str_(v) for key, v in bg.digests(rig, depth, color).items()}
    t0 = step("inputs (both packages, bit for bit)", t0)

    # the screen warp of JAX's TPU formulation: warp_screen_pallas in
    # interpret mode where shade_sweep takes the blocked XLA form on the CPU
    blocked = jwarp.sample2d_blocked_px

    def warp_tpu(img, fy, fx, tile, window, precise_channels=()):
        return warp_screen_pallas(img, fy, fx, tile=tile, precise_channels=precise_channels,
                                  interpret=True)

    def render_views(prefix, vol, cvol, mask16, n, zmajor):
        for view in bg.VIEWS:
            mv, proj = bg.camera(view, bbox)
            axis, flip = jrmf.pick_axis(mv, jrm.vol_to_world_matrix(bbox))
            cam = jrm.RenderCamera(jnp.asarray(mv), jnp.asarray(proj), *bg.RENDER)
            scfg = jrmf.SweepConfig(res=(512, 512))
            res = jrmf.sweep(vol, cvol, cam, bbox, bg.LIMIT, axis, flip, scfg,
                             jrmf.slab_occupancy(mask16, axis, n), zmajor=zmajor)
            jwarp.sample2d_blocked_px = warp_tpu
            try:
                out = jrmf.shade_sweep(res, cam, bbox, axis, flip, n, jrm.RenderParams(), scfg)
            finally:
                jwarp.sample2d_blocked_px = blocked
            pc, pd = jinpaint.build_pyramid(out.color, out.depth, 6)
            filled = jinpaint.colorfill(pc, pd)
            p = f"{prefix}{view}/"
            rec[f"{p}mv"] = mv
            rec[f"{p}axis"] = np.int32(axis)
            rec[f"{p}flip"] = np.bool_(flip)
            if prefix != "A/":      # reference C: the default view's frame output
                rec.update(bg.screen_record(p, None, out.depth, out.hit, filled))
                return
            rec.update(bg.sweep_record(p, res.hit, res.hit_s, res.hit_color, res.hit_grad))
            rec.update(bg.screen_record(p, out.color, out.depth, out.hit, filled))
            if view == "default":
                warp_formulations(res, cam, axis, flip, n, scfg, out)

    def warp_formulations(res, cam, axis, flip, n, scfg, tpu):
        """JAX's two screen warps and the port's on one sweep result: the
        hit pixels where the XLA blocked form (JAX on the CPU) and the
        port's plain warp each differ from warp_screen_pallas (JAX on a
        TPU), and the port's largest color deviation on the pixels both
        hit (``A/warp_differ``: XLA, port, port's color deviation)."""
        xla = jrmf.shade_sweep(res, cam, bbox, axis, flip, n, jrm.RenderParams(), scfg)
        t = {f: torch.from_numpy(np.array(getattr(res, f))) for f in
             ("hit", "hit_s", "hit_color", "hit_grad", "eye_p", "num_samples")}
        ext = tuple(torch.tensor(float(e)) for e in res.base_extent)
        port = rmf.shade_sweep(
            rmf.SweepResult(t["hit"], t["hit_s"], t["hit_color"], t["hit_grad"], ext,
                            t["eye_p"], t["num_samples"]),
            rm.RenderCamera(torch.from_numpy(np.array(cam.modelview)),
                            torch.from_numpy(np.array(cam.proj)), *bg.RENDER),
            bbox, axis, flip, n, rm.RenderParams(), rmf.SweepConfig(res=scfg.res))
        want = np.asarray(tpu.hit)
        both = want & port.hit.numpy()
        dc = np.abs(port.color.numpy()[both] - np.asarray(tpu.color)[both]).max()
        rec["A/warp_differ"] = np.array([(np.asarray(xla.hit) != want).sum(),
                                         (port.hit.numpy() != want).sum(), dc], np.float64)
        log(f"screen warp on one sweep result, hit pixels differing from warp_screen_pallas: "
            f"the XLA blocked form {int(rec['A/warp_differ'][0])}, the port's "
            f"{int(rec['A/warp_differ'][1])} (color {dc:.2e} at most)")

    warp = jwarp.bake_pixel_warp(jrig, h, w)
    frames = jpp.preprocess(jnp.asarray(depth), jnp.asarray(color), jrig, warp=warp)
    t0 = step("pixel-warp bake, preprocess", t0)

    def chain(prefix, n):
        """JAX's TPU formulation at n^3: kernels 4, 1 (n % 128 == 0) or 6,
        and 2 in interpret mode."""
        t0 = time.perf_counter()
        cfg = JTsdfConfig((n, n, n), bg.LIMIT)
        voxel = float(np.max(bbox.size) / n)
        aff = jaff.bake_affine(jrig, cfg)
        grid = jbricks.make_brick_grid(bbox, 0.1, voxel)
        counts = mark_bricks_pallas(frames.world, frames.world_valid, grid, interpret=True)
        mask16 = jbricks.block_occupancy(jbricks.occupancy_mask(counts, 10), grid, cfg.res)
        dense = n % 128 == 0
        wy, _ = jaff.auto_window_rows(aff, h)
        wx, xstride, _ = jaff.auto_window_cols(aff, w) if dense else (64, 16, 0.0)
        win_off = jaff.win_offsets_affine(aff, h, w, wy, wx, xstride)
        cull = jaff.bake_cull(aff, h, w, bg.LIMIT)
        m2, _, cls = jaff.block_depth_cull_baked(
            mask16, cull, frames.depth[..., 0], frames.quality, frames.silhouette, bg.LIMIT)
        nb = (n // 16) ** 3
        max_bricks = min(nb, max(1024, nb // 4))
        t0 = step(f"{prefix} affine bake, brick marking, cull", t0)
        if dense:
            vol, cvol = integrate_dense_pallas(
                frames, aff, cfg, m2, max_bricks=max_bricks, win_off=win_off, wy=wy, wx=wx,
                xstride=xstride, cls=cls, zmajor=True, vol_dtype=jnp.bfloat16,
                interpret=True)
        else:
            vol, cvol = integrate_affine_pallas(frames, aff, cfg, m2, max_bricks=max_bricks,
                                                win_off=win_off, wy=wy, interpret=True)
        vol = np.asarray(jnp.asarray(vol, jnp.float32))
        t0 = step(f"{prefix} integration (interpret mode)", t0)
        rec[f"{prefix}tsdf"] = vol
        if prefix == "C/":
            rec["C/n_occ"] = np.int32(np.asarray(m2).sum())
        else:
            pix, vox = bg.draws(frames.quality.shape, vol)
            rec["A/pix"] = bg.pack_mask(pix)
            rec["A/vox"] = bg.pack_mask(vox)
            for f in bg.PRE_FIELDS:
                rec[f"A/{f}"] = np.asarray(getattr(frames, f))[pix]
            rec["A/world_valid"] = bg.pack_mask(np.asarray(frames.world_valid)[pix])
            rec["A/counts"] = np.asarray(counts).astype(np.int32)
            rec["A/mask16"] = bg.pack_mask(m2)
            nonclear = bg.nonclear_voxels(vol)[vox]
            z, rest = np.divmod(nonclear, n * n)
            c = np.asarray(jnp.asarray(cvol, jnp.float32))
            rec["A/cvol"] = bg.bf16_bits(c[z, :, rest // n, rest % n])
            del c
        render_views(prefix, jnp.asarray(vol, jnp.bfloat16) if dense else jnp.asarray(vol),
                     cvol, m2, n, dense)
        step(f"{prefix} sweep, screen warp (interpret mode), hole filling", t0)

    chain("A/", N)
    # reference B: the JAX pipeline's own CPU frame (XLA table integrator)
    t0 = time.perf_counter()
    jpipe = JPipe(jrig, JCfg(render_width=bg.RENDER[0], render_height=bg.RENDER[1],
                             tsdf_res=(N, N, N), voxel_size=float(np.max(bbox.size) / N),
                             brick_size=0.1, num_lods=6))
    mv, proj = bg.camera("default", bbox)
    out = jpipe.step(depth, color, mv, proj)
    rec["B/tsdf"] = np.asarray(out.tsdf, np.float32)
    rec["B/n_occ"] = np.int32(out.occupied_bricks)
    # JAX's step returns the hole-filled color alone
    rec.update(bg.screen_record("B/default/", None, out.depth, out.hit, out.color))
    del jpipe, out
    step("B/ JAX FramePipeline.step on the CPU (bakes included)", t0)
    chain("C/", 240)
    np.savez_compressed(path, **rec)
    log(f"wrote {path}: {os.path.getsize(path) / 1e6:.2f} MB in "
        f"{time.perf_counter() - t_all:.0f} s")



@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread: beside the other test workers on the same
    cores, a pool of 8 spins and a frame's small ops run 10-100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gold():
    return bg.load()


@pytest.fixture(scope="module")
def inputs():
    return bg.bench_frame()


@pytest.fixture(scope="module")
def port_a(gold, inputs):
    """The default pipeline's frame, stage by stage, at the default camera."""
    rig, bbox, depth, color = inputs
    pipe = FramePipeline(rig, bg.bench_config(bbox, N), device="cpu")
    assert pipe._dense_emit and pipe.max_bricks == 1024
    return bg.port_stages(pipe, depth, color, gold, views=("default",))


@pytest.fixture(scope="module")
def port_b(inputs):
    """The ``use_pallas=False`` pipeline's frame: the XLA table integrator,
    reference B's formulation."""
    rig, bbox, depth, color = inputs
    pipe = FramePipeline(rig, bg.bench_config(bbox, N, use_pallas=False), device="cpu")
    return pipe.step(depth, color, *bg.camera("default", bbox))


def _hold(rows):
    for r in rows:
        print(r.line("cpu"))
    bad = [r.line("cpu") for r in rows if not r.ok]
    assert not bad, bad


def test_inputs_hash_to_the_golden(gold, inputs):
    """The port's bench inputs (numpy rig + seeded noise) are the bits JAX
    was given; the stored cameras are the port's."""
    rig, bbox, depth, color = inputs
    bg.check_digests(gold, rig, depth, color)
    for view in bg.VIEWS:
        np.testing.assert_array_equal(gold[f"A/{view}/mv"], bg.camera(view, bbox)[0])


def test_stage1_matches_jax(gold, port_a):
    """Preprocessing (bilateral filter, registration, quality, silhouette,
    world points) at the stored pixel draw."""
    _hold(bg.compare_pre(gold, port_a))


def test_bricks_match_jax(gold, port_a):
    """Brick counts exact (kernel 4's plain twin against
    mark_bricks_pallas) and the depth-band cull's 16^3 mask."""
    _hold(bg.compare_bricks(gold, port_a))


def test_integration_matches_jax(gold, port_a):
    """Kernel 1's plain twin with the port's own bakes against
    integrate_dense_pallas in interpret mode: TSDF and color volume."""
    _hold([bg.compare_tsdf(gold["A/tsdf"], port_a["tsdf"]),
           bg.compare_color(gold, port_a)])


def test_sweep_matches_jax(gold, port_a):
    """The sweep planes at the default camera on the 512x512 grid."""
    _hold([bg.compare_sweep(gold, "default", port_a["views"]["default"])])


@pytest.mark.parametrize("fill", [False, True])
def test_screen_matches_jax(gold, port_a, fill):
    """The screen planes at 1280x720 (kernel 2's plain twin against
    warp_screen_pallas in interpret mode), before and after hole filling."""
    ref, mine = bg.screen(gold, "A/default/"), port_a["views"]["default"]["screen"]
    if fill:
        ref, mine = bg.filled(ref), bg.filled(mine)
    _hold([bg.compare_screen("screen" + (" hole-filled" if fill else ""), ref, mine)])


def test_xla_integrator_matches_jax_frame(gold, port_b):
    """Reference B, one formulation on both sides: the TSDF within 1e-5
    everywhere with the non-clear count equal, the same occupied bricks."""
    _hold([bg.compare_tsdf(gold["B/tsdf"], port_b.tsdf.numpy(), exact_to=1e-5)])
    assert int(port_b.occupied_bricks) == int(gold["B/n_occ"])


def test_xla_frame_screen_matches_jax(gold, port_b):
    """Reference B's hole-filled screen against the port's frame (the
    blocked warp on JAX's side, the TPU kernel's window on the port's)."""
    mine = bg.Screen(port_b.color.numpy(), port_b.depth.numpy(), port_b.hit.numpy(), None)
    _hold([bg.compare_screen("screen hole-filled", bg.filled(bg.screen(gold, "B/default/")),
                             mine)])


@pytest.mark.full
def test_golden_rewrites_equal(tmp_path, request):
    """The writer, run again, writes the stored file's arrays. It runs only
    when the full tier is asked for (RGBD_FULL_TESTS=1 or ``-m full``): a
    ``-m`` expression that only leaves other markers out, such as
    ``'not slow'``, also turns off tests/conftest.py's skip of the full
    tier, and the writer takes ~4 minutes and ~41 GB of host memory."""
    if not (os.environ.get("RGBD_FULL_TESTS") or request.config.getoption("-m") == "full"):
        pytest.skip("full tier (set RGBD_FULL_TESTS=1 or -m full)")
    path = str(tmp_path / "golden.npz")
    write_golden(path)
    want, got = bg.load(), bg.load(path)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

if __name__ == "__main__":
    if "--write" not in sys.argv[1:]:
        sys.exit(f"usage: JAX_PLATFORMS=cpu python {sys.argv[0]} --write")
    os.makedirs(os.path.dirname(bg.PATH), exist_ok=True)
    write_golden(bg.PATH)

"""The port's frame at the bench size against the JAX package's own
outputs, stage by stage (``rgbd_recon_torch/utils/bench_golden.py`` says
what ``tests/data/torch_bench_golden.npz`` holds).

The tier-1 tests here run the port alone on the CPU (its plain kernels,
one intra-op thread) on frame 0 of the bench inputs: 4 sensors at
512x424, 256^3, 1280x720. They read the stored JAX outputs with numpy.
The writers run JAX on the CPU: ``--write`` the bench configuration's
file (about 4 minutes), ``--write-ladder`` the file of the configurations
of ``bg.LADDER`` (the complex scene, 5 and 2 sensors, the 128^3 and 512^3
rungs):

    JAX_PLATFORMS=cpu python tests/test_torch_bench_golden.py --write
    JAX_PLATFORMS=cpu python tests/test_torch_bench_golden.py --write-ladder

The ``full``-marked tests rerun each into a temporary file and hold the
stored file to it. ``--jax-formulations [C S5 S2 L1]`` measures how far the
JAX package's own other formulations (its TPU stage 1, another float32
solve of its bake) fall from the ladder's reference A.
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


def _jax_modules():
    """The JAX package's functions the writers call (imported by a writer
    only: the tier-1 tests here read the stored file with numpy)."""
    import types

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
    return types.SimpleNamespace(**{k: v for k, v in locals().items() if k != "types"})


def _step(log, what, t0):
    log(f"{what}: {time.perf_counter() - t0:.1f} s")
    return time.perf_counter()


def _jax_inputs(J, cfg: bg.Config, log):
    """Frame 0 of a configuration's bench inputs, built by the port and by
    the JAX package (raises unless JAX's rig and frames are the port's bits);
    returns (rig, bbox, depth, color, JAX's rig of the port's arrays, the
    digest records)."""
    t0 = time.perf_counter()
    rig, bbox, depth, color = bg.bench_frame(cfg)
    w, h, fwd, inv = bg.SIZE
    t0 = _step(log, f"port inputs ({cfg.sensors} sensors, {cfg.scene})", t0)
    jrig, jcams = J.jsyn.synthetic_rig(num_sensors=cfg.sensors, bbox=J.JBbox.default(),
                                       fwd_res=fwd, inv_res=inv, width=w, height=h)
    for f in J.JRig._fields:
        if not np.array_equal(np.asarray(getattr(jrig, f)), np.asarray(getattr(rig, f))):
            raise AssertionError(f"the JAX synthetic rig differs from the port's in {f}")
    jd, jc = J.jsyn.render_frames(jcams, J.jsyn.make_scene(cfg.scene, J.JBbox.default()))
    rng = np.random.default_rng(bg.SEED)
    if not (np.array_equal(jd + rng.uniform(0, 2e-3, jd.shape).astype(np.float32), depth)
            and np.array_equal(np.clip(jc + rng.uniform(0, 1e-2, jc.shape).astype(np.float32),
                                       0, 1), color)):
        raise AssertionError("the JAX frames differ from the port's")
    jrig = J.JRig(*(np.asarray(getattr(rig, f)) for f in J.JRig._fields))
    rec = {f"digest/{key}": np.str_(v) for key, v in bg.digests(rig, depth, color).items()}
    _step(log, "JAX inputs (bit for bit the port's)", t0)
    return rig, bbox, depth, color, jrig, rec


def _jax_frames(J, jrig, depth, color, log):
    """JAX's pixel-warp bake and preprocess of one frame."""
    t0 = time.perf_counter()
    _, h, w = depth.shape
    warp = J.jwarp.bake_pixel_warp(jrig, h, w)
    frames = J.jpp.preprocess(J.jnp.asarray(depth), J.jnp.asarray(color), jrig, warp=warp)
    _step(log, "pixel-warp bake, preprocess", t0)
    return frames


def _warp_formulations(J, rec, bbox, res, cam, axis, flip, n, scfg, tpu, log):
    """JAX's two screen warps and the port's on one sweep result: the hit
    pixels where the XLA blocked form (JAX on the CPU) and the port's plain
    warp each differ from warp_screen_pallas (JAX on a TPU), and the port's
    largest color deviation on the pixels both hit (``A/warp_differ``: XLA,
    port, port's color deviation)."""
    xla = J.jrmf.shade_sweep(res, cam, bbox, axis, flip, n, J.jrm.RenderParams(), scfg)
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


def _render_views(J, rec, prefix, bbox, vol, cvol, mask16, n, zmajor, views, record, log):
    """JAX's sweep, its screen warp through warp_screen_pallas (interpret
    mode, patched in for ``sample2d_blocked_px``, which shade_sweep takes on
    the CPU) and hole filling at each of ``views``. ``record``: "stages"
    stores the sweep planes and both screens of every view (and JAX's warp
    formulations at the default view when ``prefix`` is "A/"), "screen" the
    default view's frame output alone."""
    blocked = J.jwarp.sample2d_blocked_px

    def warp_tpu(img, fy, fx, tile, window, precise_channels=()):
        return J.warp_screen_pallas(img, fy, fx, tile=tile, precise_channels=precise_channels,
                                    interpret=True)

    for view in views:
        mv, proj = bg.camera(view, bbox)
        axis, flip = J.jrmf.pick_axis(mv, J.jrm.vol_to_world_matrix(bbox))
        cam = J.jrm.RenderCamera(J.jnp.asarray(mv), J.jnp.asarray(proj), *bg.RENDER)
        scfg = J.jrmf.SweepConfig(res=(512, 512))
        res = J.jrmf.sweep(vol, cvol, cam, bbox, bg.LIMIT, axis, flip, scfg,
                           J.jrmf.slab_occupancy(mask16, axis, n), zmajor=zmajor)
        J.jwarp.sample2d_blocked_px = warp_tpu
        try:
            out = J.jrmf.shade_sweep(res, cam, bbox, axis, flip, n, J.jrm.RenderParams(), scfg)
        finally:
            J.jwarp.sample2d_blocked_px = blocked
        pc, pd = J.jinpaint.build_pyramid(out.color, out.depth, 6)
        filled = J.jinpaint.colorfill(pc, pd)
        p = f"{prefix}{view}/"
        rec[f"{p}mv"] = mv
        rec[f"{p}axis"] = np.int32(axis)
        rec[f"{p}flip"] = np.bool_(flip)
        if record == "screen":      # the default view's frame output
            rec.update(bg.screen_record(p, None, out.depth, out.hit, filled))
            return
        rec.update(bg.sweep_record(p, res.hit, res.hit_s, res.hit_color, res.hit_grad))
        rec.update(bg.screen_record(p, out.color, out.depth, out.hit, filled))
        if view == "default" and prefix == "A/":
            _warp_formulations(J, rec, bbox, res, cam, axis, flip, n, scfg, out, log)


def _jax_chain(J, rec, prefix, bbox, jrig, frames, n, log, record="stages",
               views=tuple(bg.VIEWS), vox_draw=bg.VOX_DRAW, tsdf_bf16=False):
    """JAX's TPU formulation at n^3: kernels 4, 1 (n % 128 == 0) or 6, and
    2 in interpret mode, stored under ``prefix``. ``record``: "stages" (the
    preprocessed fields at the pixel draw, brick counts, the 16^3 masks,
    TSDF, the color volume at ``vox_draw`` voxels, ``views``), "screen"
    (TSDF, occupied bricks and the default view's frame output) or "masks"
    (the 16^3 masks before and after the depth-band cull alone: no
    integration). ``tsdf_bf16``: the TSDF as bf16 bits (``A/tsdf_bf16``)."""
    t0 = time.perf_counter()
    jnp = J.jnp
    _, h, w = frames.depth.shape[:3]
    cfg = J.JTsdfConfig((n, n, n), bg.LIMIT)
    voxel = float(np.max(bbox.size) / n)
    aff = J.jaff.bake_affine(jrig, cfg)
    grid = J.jbricks.make_brick_grid(bbox, 0.1, voxel)
    counts = J.mark_bricks_pallas(frames.world, frames.world_valid, grid, interpret=True)
    mask16 = J.jbricks.block_occupancy(J.jbricks.occupancy_mask(counts, 10), grid, cfg.res)
    dense = n % 128 == 0
    cull = J.jaff.bake_cull(aff, h, w, bg.LIMIT)
    m2, _, cls = J.jaff.block_depth_cull_baked(
        mask16, cull, frames.depth[..., 0], frames.quality, frames.silhouette, bg.LIMIT)
    if record == "masks":
        rec[f"{prefix}mask16_pre"] = bg.pack_mask(mask16)
        rec[f"{prefix}mask16"] = bg.pack_mask(m2)
        _step(log, f"{prefix} affine bake, brick marking, cull at {n}^3", t0)
        return
    wy, _ = J.jaff.auto_window_rows(aff, h)
    wx, xstride, _ = J.jaff.auto_window_cols(aff, w) if dense else (64, 16, 0.0)
    win_off = J.jaff.win_offsets_affine(aff, h, w, wy, wx, xstride)
    nb = (n // 16) ** 3
    max_bricks = min(nb, max(1024, nb // 4))
    t0 = _step(log, f"{prefix} affine bake, brick marking, cull", t0)
    if dense:
        vol, cvol = J.integrate_dense_pallas(
            frames, aff, cfg, m2, max_bricks=max_bricks, win_off=win_off, wy=wy, wx=wx,
            xstride=xstride, cls=cls, zmajor=True, vol_dtype=jnp.bfloat16, interpret=True)
    else:
        vol, cvol = J.integrate_affine_pallas(frames, aff, cfg, m2, max_bricks=max_bricks,
                                              win_off=win_off, wy=wy, interpret=True)
    vol = np.asarray(jnp.asarray(vol, jnp.float32))
    t0 = _step(log, f"{prefix} integration (interpret mode)", t0)
    if tsdf_bf16:
        rec[f"{prefix}tsdf_bf16"] = bg.bf16_bits(vol)
    else:
        rec[f"{prefix}tsdf"] = vol
    if record == "screen":
        rec[f"{prefix}n_occ"] = np.int32(np.asarray(m2).sum())
    else:
        pix, vox = bg.draws(frames.quality.shape, vol, vox_draw)
        rec[f"{prefix}pix"] = bg.pack_mask(pix)
        rec[f"{prefix}vox"] = bg.pack_mask(vox)
        for f in bg.PRE_FIELDS:
            rec[f"{prefix}{f}"] = np.asarray(getattr(frames, f))[pix]
        rec[f"{prefix}world_valid"] = bg.pack_mask(np.asarray(frames.world_valid)[pix])
        rec[f"{prefix}counts"] = np.asarray(counts).astype(np.int32)
        if prefix != "A/":
            rec[f"{prefix}mask16_pre"] = bg.pack_mask(mask16)
        rec[f"{prefix}mask16"] = bg.pack_mask(m2)
        nonclear = bg.nonclear_voxels(vol)[vox]
        z, rest = np.divmod(nonclear, n * n)
        c = np.asarray(jnp.asarray(cvol, jnp.float32))
        rec[f"{prefix}cvol"] = bg.bf16_bits(c[z, :, rest // n, rest % n])
        del c
    _render_views(J, rec, prefix, bbox, jnp.asarray(vol, jnp.bfloat16) if dense
                  else jnp.asarray(vol), cvol, m2, n, dense, views, record, log)
    _step(log, f"{prefix} sweep, screen warp (interpret mode), hole filling", t0)


def write_golden(path: str, log=print) -> None:
    """Compute the three references with the JAX package on the CPU and
    write them to ``path`` (``np.savez_compressed``)."""
    J = _jax_modules()
    t_all = time.perf_counter()
    rig, bbox, depth, color, jrig, rec = _jax_inputs(J, bg.BENCH, log)
    frames = _jax_frames(J, jrig, depth, color, log)
    _jax_chain(J, rec, "A/", bbox, jrig, frames, N, log)
    # reference B: the JAX pipeline's own CPU frame (XLA table integrator)
    t0 = time.perf_counter()
    jpipe = J.JPipe(jrig, J.JCfg(render_width=bg.RENDER[0], render_height=bg.RENDER[1],
                                 tsdf_res=(N, N, N), voxel_size=float(np.max(bbox.size) / N),
                                 brick_size=0.1, num_lods=6))
    mv, proj = bg.camera("default", bbox)
    out = jpipe.step(depth, color, mv, proj)
    rec["B/tsdf"] = np.asarray(out.tsdf, np.float32)
    rec["B/n_occ"] = np.int32(out.occupied_bricks)
    # JAX's step returns the hole-filled color alone
    rec.update(bg.screen_record("B/default/", None, out.depth, out.hit, out.color))
    del jpipe, out
    _step(log, "B/ JAX FramePipeline.step on the CPU (bakes included)", t0)
    _jax_chain(J, rec, "C/", bbox, jrig, frames, 240, log, record="screen")
    np.savez_compressed(path, **rec)
    log(f"wrote {path}: {os.path.getsize(path) / 1e6:.2f} MB in "
        f"{time.perf_counter() - t_all:.0f} s")


def write_ladder(path: str, log=print) -> None:
    """Reference A of each configuration of ``bg.LADDER`` (``write_golden``'s
    chain, at the default view, the color draw of ``bg.LADDER_VOX_DRAW``
    voxels and the TSDF as bf16 bits; the 512^3 rung's masks alone) under
    the configuration's name, with the digests of its inputs; written to
    ``path`` (``np.savez_compressed``)."""
    J = _jax_modules()
    t_all = time.perf_counter()
    rec = {}
    built = {}
    for name, cfg in bg.LADDER.items():
        key = (cfg.sensors, cfg.scene)
        if key not in built:
            rig, bbox, depth, color, jrig, digests = _jax_inputs(J, cfg, log)
            built = {key: (bbox, jrig, _jax_frames(J, jrig, depth, color, log), digests)}
        bbox, jrig, frames, digests = built[key]
        rec.update({f"{name}/{k}": v for k, v in digests.items()})
        _jax_chain(J, rec, f"{name}/A/", bbox, jrig, frames, cfg.n, log,
                   record="stages" if cfg.stages else "masks", views=("default",),
                   vox_draw=bg.LADDER_VOX_DRAW, tsdf_bf16=True)
    np.savez_compressed(path, **rec)
    log(f"wrote {path}: {os.path.getsize(path) / 1e6:.2f} MB in "
        f"{time.perf_counter() - t_all:.0f} s")


def _sweep_planes(rec: dict, prefix: str) -> dict:
    """A view's sweep record as ``bg.compare_sweep`` reads the port's."""
    shape = (512, 512)
    out = {"sweep_hit": bg.unpack_mask(rec[f"{prefix}sweep_hit"], shape),
           "axis": int(rec[f"{prefix}axis"])}
    for f, conv in (("sweep_s", np.asarray), ("sweep_color", bg.from_bf16_bits),
                    ("sweep_grad", bg.from_bf16_bits)):
        _, out[f] = bg._plane(rec[f"{prefix}sweep_hit"], conv(rec[f"{prefix}{f}"]), shape)
    return out


def jax_formulations(names, log=print) -> None:
    """How far the JAX package's own formulations fall from the ladder's
    reference A (its chain, JAX's XLA stage 1 and LU bake): (1) stage 1 in
    its TPU formulation (``bilateral_accum_pallas`` and ``warp_screen_pallas``
    in interpret mode, as on a TPU) through A's chain: brick counts, TSDF,
    sweep planes; (2) A's chain with the affine bake's float32 normal
    equations solved by Cholesky instead of LU: TSDF, sweep planes. Each
    configuration takes ~4 minutes."""
    import functools

    import rgbd_recon_tpu.ops.preprocess as jpp_mod
    import rgbd_recon_tpu.ops.preprocess_pallas as jppp
    import rgbd_recon_tpu.ops.tsdf_affine as jaff_mod
    import rgbd_recon_tpu.ops.warp_pallas as jwp

    J = _jax_modules()
    jax, jnp = J.jax, J.jnp

    class _OnTpu:
        """``jax`` as preprocess.py sees it, its backend the TPU."""

        def __getattr__(self, k):
            return (lambda: "tpu") if k == "default_backend" else getattr(jax, k)

    def lsq_cholesky(f, m, basis, prec):
        nvalid = jnp.sum(m, axis=-1)
        mb = m[..., None, :] * basis
        gram = jnp.einsum("knav,bv->knab", mb, basis, preferred_element_type=jnp.float32,
                          precision=prec)
        rhs = jnp.einsum("knav,knvc->knac", mb, f, preferred_element_type=jnp.float32,
                         precision=prec)
        ridge = (1e-6 * jnp.maximum(nvalid, 1.0))[..., None, None] * jnp.eye(jaff_mod.NBASIS)
        fac = jax.scipy.linalg.cho_factor(gram + ridge)
        return jax.scipy.linalg.cho_solve(fac, rhs), nvalid

    gold = bg.load(bg.LADDER_PATH)
    for name in names:
        cfg = bg.LADDER[name]
        g = bg.config(gold, name)
        rig, bbox, depth, color = bg.bench_frame(cfg)
        jrig = J.JRig(*(np.asarray(getattr(rig, f)) for f in J.JRig._fields))
        _, h, w = depth.shape
        warp = J.jwarp.bake_pixel_warp(jrig, h, w)
        saved = (jppp.bilateral_accum_pallas, jwp.warp_screen_pallas, jpp_mod.jax)
        jppp.bilateral_accum_pallas = functools.partial(saved[0], interpret=True)
        jwp.warp_screen_pallas = functools.partial(saved[1], interpret=True)
        jpp_mod.jax = _OnTpu()
        try:
            tpu_frames = J.jpp.preprocess(jnp.asarray(depth), jnp.asarray(color), jrig, warp=warp)
        finally:
            jppp.bilateral_accum_pallas, jwp.warp_screen_pallas, jpp_mod.jax = saved
        runs = [("stage 1 in JAX's TPU formulation", tpu_frames, None)]
        runs.append(("the bake solved by Cholesky", _jax_frames(J, jrig, depth, color, log),
                     lsq_cholesky))
        for what, frames, lsq in runs:
            saved = (jaff_mod._lsq, jaff_mod._fit_slab)
            if lsq is not None:
                # a new function object: jit traces the slab fit anew, reading
                # the patched solve (a trace of the original is cached)
                jaff_mod._lsq = lsq
                jaff_mod._fit_slab = lambda *a, fit=saved[1]: fit(*a)
            rec = {}
            try:
                _jax_chain(J, rec, "A/", bbox, jrig, frames, cfg.n, log, views=("default",),
                           vox_draw=bg.LADDER_VOX_DRAW)
            finally:
                jaff_mod._lsq, jaff_mod._fit_slab = saved
            mine = _sweep_planes(rec, "A/default/")
            mine["counts"] = rec["A/counts"].astype(np.int64)
            for r in ([bg.compare_tsdf(g["A/tsdf"], rec["A/tsdf"]),
                       bg.compare_sweep(g, "default", mine)]
                      + bg.compare_bricks({"A/counts": g["A/counts"]}, mine)):
                log(r.line(f"JAX {name}, {what}, against reference A"))


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


def _full_tier(request):
    """Skip unless the full tier is asked for (RGBD_FULL_TESTS=1 or ``-m
    full``): a ``-m`` expression that only leaves other markers out, such as
    ``'not slow'``, also turns off tests/conftest.py's skip of the full
    tier, and each writer takes minutes and tens of GB of host memory."""
    if not (os.environ.get("RGBD_FULL_TESTS") or request.config.getoption("-m") == "full"):
        pytest.skip("full tier (set RGBD_FULL_TESTS=1 or -m full)")


def _same_files(got_path, want_path):
    want, got = bg.load(want_path), bg.load(got_path)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.full
def test_golden_rewrites_equal(tmp_path, request):
    """The writer, run again, writes the stored file's arrays (~4 minutes,
    ~41 GB of host memory; only in the full tier)."""
    _full_tier(request)
    path = str(tmp_path / "golden.npz")
    write_golden(path)
    _same_files(path, bg.PATH)


@pytest.mark.full
def test_ladder_rewrites_equal(tmp_path, request):
    """The ladder's writer, run again, writes its stored file's arrays
    (only in the full tier)."""
    _full_tier(request)
    path = str(tmp_path / "ladder.npz")
    write_ladder(path)
    _same_files(path, bg.LADDER_PATH)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax-formulations"]:
        jax_formulations(sys.argv[2:] or list(bg.LADDER)[:4])
        sys.exit(0)
    writers = {"--write": (write_golden, bg.PATH), "--write-ladder": (write_ladder,
                                                                      bg.LADDER_PATH)}
    asked = [a for a in sys.argv[1:] if a in writers]
    if not asked:
        sys.exit(f"usage: JAX_PLATFORMS=cpu python {sys.argv[0]} --write | --write-ladder | "
                 f"--jax-formulations [C S5 S2 L1]")
    os.makedirs(bg.DATA, exist_ok=True)
    for a in asked:
        writers[a][0](writers[a][1])

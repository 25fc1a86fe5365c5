"""The port's sharded paths (``rgbd_recon_torch.parallel``) on the CPU, at
the small size of tests/test_multichip.py (2 sensors at 128x104,
32 x 32 x 64, 96x64).

Held here: ``fast_sharded_step`` (z- and x-axis camera), ``sharded_step``
and ``ReplayDriver`` (B = 4) in 2- and 4-rank ``gloo`` process groups,
each bit for bit the port's single-process step (the cull off for the fast
step, which has none, as in JAX); the per-rank functions run rank by rank
in one process (``run_slabs``) at every sweep variant and every integrator
tier, bit for bit the single-process step; the refusals; the multihost
replay script in two processes; ``dryrun_multichip(4)``;
``partition_sequences`` against JAX's; and the port's single-process step
against JAX's ``pipe.step`` at the render-parity bounds of
tests/test_golden.py:65-69 and the integrator bound.

The rank processes run this file as a script (``_rank_main``, a file
rendezvous), started in the background when the module starts so they
overlap the in-process tests; the multihost pair takes a free loopback
port, as its command line does.
"""
import os
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from rgbd_recon_torch.calibration import synthetic
from rgbd_recon_torch.entry import dryrun_multichip, entry, x_camera
from rgbd_recon_torch.parallel import fast_sharded as fs
from rgbd_recon_torch.parallel.replay import ReplayDriver, partition_sequences
from rgbd_recon_torch.runtime.pipeline import VARIANTS, FramePipeline, PipelineConfig
from rgbd_recon_torch.utils.math import Bbox, look_at
from rgbd_recon_torch.utils.metrics import render_parity, render_parity_passes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TSDF = (32, 32, 64)
FIELDS = ("color", "depth", "hit", "tsdf", "occupied_ratio", "num_samples", "occupied_bricks")
BATCH = 4
GROUPS = (2, 4)


def _scene():
    bbox = Bbox.default()
    rig, cams = synthetic.synthetic_rig(num_sensors=2, bbox=bbox, fwd_res=(32, 48, 32),
                                        inv_res=(32, 32, 32), width=128, height=104)
    depth, color = synthetic.render_frames(cams, synthetic.SphereScene.default(bbox))
    return rig, depth, color


def _pipe(rig, tsdf=TSDF, **over):
    kw = dict(render_width=96, render_height=64, tsdf_res=tsdf,
              voxel_size=float(np.max(rig.bbox.size) / tsdf[0]), brick_size=0.2,
              num_lods=4, brick_cull=False)
    kw.update(over)
    return FramePipeline(rig, PipelineConfig(**kw), device="cpu")


def _batch(depth, color):
    """BATCH distinct frames: the scene's with seeded depth noise."""
    rng = np.random.default_rng(5)
    d = np.stack([depth + rng.uniform(0, 2e-3, depth.shape).astype(np.float32) * (depth > 0)
                  for _ in range(BATCH)])
    return d, np.stack([color] * BATCH)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, n, out):
    """One rank of an n-rank gloo group (a file rendezvous beside ``out``):
    every sharded path on the scene; rank 0 saves the outputs (the z-slabs
    joined) to ``out``."""
    import torch.distributed as dist

    from rgbd_recon_torch.parallel.sharding import all_gather, make_mesh, sharded_step

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}.rendezvous", world_size=n,
                            rank=rank)
    mesh = make_mesh(n, device="cpu")

    def joined(o):
        d = o._asdict()
        d["tsdf"] = torch.cat(all_gather(mesh, o.tsdf))
        return d

    rig, depth, color = _scene()
    pipe = _pipe(rig)
    mv, proj = pipe.default_camera()
    step = fs.fast_sharded_step(pipe, mesh)
    res = {name: joined(step(depth, color, m, proj))
           for name, m in (("fast_z", mv), ("fast_x", x_camera(pipe)))}
    ref = _pipe(rig, (32, 32, 32), fast_path=False)
    res["dense"] = joined(sharded_step(ref, mesh)(depth, color, mv, proj))
    res["replay"] = ReplayDriver(pipe, mesh).step(*_batch(depth, color), mv, proj)._asdict()
    parts = [None] * n
    dist.all_gather_object(parts, partition_sequences([f"s{i}.stream" for i in range(10)]))
    res["partition"] = parts
    if rank == 0:
        torch.save(res, out)
    dist.destroy_process_group()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread (as the other test_torch_* files)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spawn(args):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, *args], cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


@pytest.fixture(scope="module", autouse=True)
def groups(tmp_path_factory):
    """Started first: the 2- and 4-rank groups and the multihost pair, in
    the background."""
    tmp = tmp_path_factory.mktemp("ranks")
    started = {}
    for n in GROUPS:
        out = str(tmp / f"world{n}.pt")
        started[n] = (out, [_spawn([__file__, str(r), str(n), out]) for r in range(n)])
    port = _free_port()
    started["multihost"] = (None, [_spawn(["-m", "rgbd_recon_torch.scripts.multihost_replay",
                                           str(port), str(r), "2", "--device", "cpu"])
                                   for r in range(2)])
    yield started
    for _, procs in started.values():
        for p in procs:
            if p.poll() is None:
                p.kill()


def _finish(procs):
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)
    return outs


@pytest.fixture(scope="module")
def scene():
    rig, depth, color = _scene()
    pipe = _pipe(rig)
    mv, proj = pipe.default_camera()
    return types.SimpleNamespace(rig=rig, depth=depth, color=color, pipe=pipe, mv=mv,
                                 proj=proj)


def _assert_same(a, b, what, fields=FIELDS):
    for f in fields:
        x, y = a[f] if isinstance(a, dict) else getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and torch.equal(x, y), (what, f)


def _variant_camera(pipe, axis, flip):
    """A modelview whose sweep is (axis, flip)."""
    center = (pipe.bbox.min + pipe.bbox.max) * 0.5
    d = np.array([0.25, 0.35, 0.3], np.float32)
    d[axis] = 3.0 if flip else -3.0
    mv = look_at(center + d, center, [0, 0, 1] if axis == 1 else [0, 1, 0])
    assert pipe._axis(mv)[1] == (axis, flip)
    return mv


@pytest.mark.parametrize("axis, flip", VARIANTS)
def test_slabs_match_single_step(scene, axis, flip):
    """4 slabs run rank by rank equal the single-process step bit for bit
    (tolerance 0) at every sweep variant, with the slab skip on."""
    mv = _variant_camera(scene.pipe, axis, flip)
    want = scene.pipe.step(scene.depth, scene.color, mv, scene.proj)
    got = fs.run_slabs(scene.pipe, 4, scene.depth, scene.color, mv, scene.proj)
    _assert_same(got, want, (axis, flip))
    assert want.hit.float().mean() > 0.02


@pytest.mark.parametrize("tier, tsdf, over", [
    ("dense emit (kernel 1)", (128, 32, 64), dict(use_pallas=True)),
    ("block-major (kernel 6)", TSDF, dict(use_pallas=True, use_affine=True)),
    ("warp table (kernel 7)", TSDF, dict(use_pallas=True, use_affine=False)),
    ("XLA table (kernel 7 window mode)", TSDF, dict(skip_space=False)),
])
def test_slabs_every_integrator(scene, tier, tsdf, over):
    """Each integrator tier integrates its slabs from the brick range of its
    bake: 2 slabs equal the single-process step bit for bit, x camera."""
    pipe = _pipe(scene.rig, tsdf, **over)
    mv = x_camera(pipe)
    want = pipe.step(scene.depth, scene.color, mv, scene.proj)
    assert (pipe.integrator.affine is not None) == ("kernel 7" not in tier)
    assert pipe.integrator.zmajor == ("kernel 1" in tier)
    assert pipe.integrator.tier in tier.replace("XLA table", "table integrator")
    got = fs.run_slabs(pipe, 2, scene.depth, scene.color, mv, scene.proj)
    _assert_same(got, want, tier)


def test_refusals(scene):
    """JAX's refusals: no whole brick layers per rank, a sweep axis the mesh
    does not divide, the reference path."""
    with pytest.raises(ValueError, match=r"\(64, 3\)"):
        fs.slab_plan(scene.pipe, 3)
    pipe = _pipe(scene.rig, (32, 32, 48))
    fs.slab_plan(pipe, 3)
    with pytest.raises(ValueError, match="sweep axis 0 res 32 not divisible by mesh size 3"):
        fs.run_slabs(pipe, 3, scene.depth, scene.color, x_camera(pipe), scene.proj)
    with pytest.raises(ValueError, match="brick-sparse"):
        fs.slab_plan(_pipe(scene.rig, fast_path=False), 2)


def test_single_step_matches_jax(scene):
    """The port's single-process step (default cull) against JAX's
    ``pipe.step`` on the same scene: the render-parity bounds of
    tests/test_golden.py:65-69 and the integrator bound of
    tests/test_tsdf_affine.py:109-116. (tests/test_multichip.py:120-130's
    bounds compare two runs of one arithmetic; the port's sharded steps
    meet them with tolerance 0 against its own single step, above.)"""
    from rgbd_recon_tpu.calibration import synthetic as jsyn
    from rgbd_recon_tpu.runtime.pipeline import FramePipeline as JPipe
    from rgbd_recon_tpu.runtime.pipeline import PipelineConfig as JCfg
    from rgbd_recon_tpu.utils.math import Bbox as JBbox

    bbox = JBbox.default()
    jrig, _ = jsyn.synthetic_rig(num_sensors=2, bbox=bbox, fwd_res=(32, 48, 32),
                                 inv_res=(32, 32, 32), width=128, height=104)
    jpipe = JPipe(jrig, JCfg(render_width=96, render_height=64, tsdf_res=TSDF,
                             voxel_size=float(np.max(bbox.size) / TSDF[0]), brick_size=0.2,
                             num_lods=4))
    want = jpipe.step(scene.depth, scene.color, scene.mv, scene.proj)
    got = _pipe(scene.rig, brick_cull=True).step(scene.depth, scene.color, scene.mv,
                                                 scene.proj)
    s = render_parity(want, types.SimpleNamespace(color=got.color.numpy(),
                                                  depth=got.depth.numpy(),
                                                  hit=got.hit.numpy()))
    assert render_parity_passes(s) and s["hit_frac"] > 0.02, s
    v, w = got.tsdf.numpy(), np.asarray(want.tsdf)
    assert (np.abs(v - w) > 1e-4).mean() < 1e-4
    limit = 0.01
    occ, wocc = int((v > -limit + 1e-9).sum()), int((w > -limit + 1e-9).sum())
    assert abs(occ - wocc) <= max(100, 0.002 * wocc), (occ, wocc)
    assert int(got.occupied_bricks) == int(want.occupied_bricks)


@pytest.mark.parametrize("n", GROUPS)
def test_process_group_matches_single_step(scene, groups, n):
    """An n-rank gloo group: fast_sharded_step (z- and x-axis camera),
    sharded_step (the dense path at 32^3) and ReplayDriver (B = 4 distinct
    frames) each bit for bit the single-process step; partition_sequences
    against JAX's."""
    from rgbd_recon_tpu.parallel.replay import partition_sequences as jpartition

    out, procs = groups[n]
    _finish(procs)
    res = torch.load(out, weights_only=False)
    pipe, d, c, proj = scene.pipe, scene.depth, scene.color, scene.proj
    for name, mv in (("fast_z", scene.mv), ("fast_x", x_camera(pipe))):
        _assert_same(res[name], pipe.step(d, c, mv, proj), (n, name))
    ref = _pipe(scene.rig, (32, 32, 32), fast_path=False)
    want = ref.step(d, c, scene.mv, proj)
    _assert_same(res["dense"], want, (n, "dense"), FIELDS[:-1])
    pre = ref._pre(*ref._sensor_inputs(d, c))
    assert int(res["dense"]["occupied_bricks"]) == int(pre.mask.sum()) > 0
    db, cb = _batch(d, c)
    for i in range(BATCH):
        item = pipe.step(db[i], cb[i], scene.mv, proj)
        for f in FIELDS:
            assert torch.equal(res["replay"][f][i], getattr(item, f)), (n, "replay", i, f)
    paths = [f"s{i}.stream" for i in range(10)]
    assert res["partition"] == [jpartition(paths, r, n) for r in range(n)]
    assert partition_sequences(paths) == paths       # no process group: rank 0 of 1


def test_multihost_replay_script(groups):
    """Two processes of ``rgbd_recon_torch.scripts.multihost_replay``: both
    print MULTIHOST OK with the same global coverage."""
    outs = _finish(groups["multihost"][1])
    lines = [next(ln for ln in o.splitlines() if ln.startswith("MULTIHOST OK")) for o in outs]
    covs = {ln.split("coverage=")[1] for ln in lines}
    assert len(covs) == 1 and float(covs.pop()) > 0.0, lines
    assert "pid=0 world=2" in lines[0] and "pid=1 world=2" in lines[1]


def test_dryrun_multichip():
    """The port's dry run over 4 spawned gloo ranks."""
    dryrun_multichip(4)


def test_entry_frame_function():
    """``entry(device="cpu")``: the frame function runs on its example
    arguments (device tensors, then the sweep variant) to a finite image."""
    fn, args = entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args[:4]) and args[4:] == (2, True)
    out = fn(*args)
    assert bool(torch.isfinite(out.color).all()) and out.hit.float().mean() > 0.02


def test_fast_step_follows_a_retune(scene):
    """A world of one on the CPU: ``fast_sharded_step`` remakes its slab
    plan and brick-range bakes when the pipeline re-bakes between two
    calls (a voxel-size retune, 32x32x64 -> 32^3); each call equals the
    single-process step bit for bit."""
    from rgbd_recon_torch.parallel.sharding import make_mesh
    import torch.distributed as dist

    pipe = _pipe(scene.rig)
    try:
        step = fs.fast_sharded_step(pipe, make_mesh(device="cpu"))
        for voxel_size in (None, 0.1):
            if voxel_size is not None:
                pipe.retune(voxel_size=voxel_size)
            got = step(scene.depth, scene.color, scene.mv, scene.proj)
            _assert_same(got, pipe.step(scene.depth, scene.color, scene.mv, scene.proj),
                         pipe.tsdf_cfg.res)
    finally:
        dist.destroy_process_group()
    assert pipe.tsdf_cfg.res == (32, 32, 32)


def test_replay_driver_runs_readers(scene, tmp_path):
    """``run`` replays StreamReaders in lockstep (a world of one on the
    CPU): each frame equals the single step on the decoded frame."""
    from rgbd_recon_torch.io.stream import FrameFormat, StreamReader, StreamWriter
    from rgbd_recon_torch.parallel.sharding import make_mesh
    import torch.distributed as dist

    fmt = FrameFormat(width=128, height=104, width_c=128, height_c=104)
    paths = [[str(tmp_path / f"b{b}_s{i}.stream") for i in range(2)] for b in range(2)]
    for b, ps in enumerate(paths):
        w = StreamWriter(ps, fmt)
        for _ in range(2):
            w.write(scene.depth + np.float32(b * 1e-3), scene.color)
        w.close()
    try:
        drv = ReplayDriver(scene.pipe, make_mesh(device="cpu"))
        outs = list(drv.run([StreamReader(ps, fmt) for ps in paths], scene.mv, scene.proj))
    finally:
        dist.destroy_process_group()
    assert len(outs) == 2 and outs[0].color.shape[0] == 2
    d, c = StreamReader(paths[1], fmt).read()
    want = scene.pipe.step(d, c, scene.mv, scene.proj)
    for f in FIELDS:
        assert torch.equal(outs[0]._asdict()[f][1], getattr(want, f)), f


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])

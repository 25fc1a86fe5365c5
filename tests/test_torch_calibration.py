"""The port's own rig / scene builder vs the JAX package's, and the port's
independence from JAX.

The card's machine has no JAX, and the JAX package's calibration modules
import it, so the port carries numpy copies of what the synthetic rig
builder reaches; they must reproduce the originals bit for bit.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from rgbd_recon_tpu.calibration import synthetic as jsyn
from rgbd_recon_tpu.utils.math import Bbox as JBbox

from rgbd_recon_torch.calibration import synthetic
from rgbd_recon_torch.utils.math import Bbox

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_synthetic_rig_bit_identical():
    """Every field of the rig and every camera, bit-identical (exact: the
    copies run the same numpy operations)."""
    kw = dict(num_sensors=3, fwd_res=(24, 32, 24), inv_res=(32, 32, 32),
              width=96, height=80)
    rig, cams = synthetic.synthetic_rig(bbox=Bbox.default(), **kw)
    jrig, jcams = jsyn.synthetic_rig(bbox=JBbox.default(), **kw)
    for f in rig._fields:
        np.testing.assert_array_equal(getattr(rig, f), np.asarray(getattr(jrig, f)),
                                      err_msg=f)
    for c, jc in zip(cams, jcams):
        for f in c._fields:
            np.testing.assert_array_equal(np.asarray(getattr(c, f)),
                                          np.asarray(getattr(jc, f)), err_msg=f)


@pytest.mark.parametrize("kind", ["sphere", "complex"])
def test_scene_frames_bit_identical(kind):
    """Depth and color frames of both scene kinds, bit-identical."""
    cams = synthetic.make_cameras(2, Bbox.default(), width=64, height=48)
    jcams = jsyn.make_cameras(2, JBbox.default(), width=64, height=48)
    d, c = synthetic.render_frames(cams, synthetic.make_scene(kind, Bbox.default()))
    jd, jc = jsyn.render_frames(jcams, jsyn.make_scene(kind, JBbox.default()))
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(c, jc)
    assert (d > 0).mean() > 0.05


@pytest.mark.parametrize("shape", [(3,), (64, 3), (12, 16, 3)])
def test_bbox_contains_matches_jax(shape):
    """``Bbox.contains`` bit for bit the JAX package's, on points inside,
    outside and on every face (min and max included), batched as [3],
    [N, 3] and [H, W, 3]."""
    bbox, jbbox = Bbox.default(), JBbox.default()
    rng = np.random.default_rng(3)
    lo, hi = bbox.min.astype(np.float64), bbox.max.astype(np.float64)
    p = rng.uniform(lo - 0.5 * (hi - lo), hi + 0.5 * (hi - lo), (4096, 3))
    face = rng.uniform(lo, hi, (12, 3))
    for i in range(6):      # on the faces: one coordinate at the min or the max
        face[2 * i:2 * i + 2, i % 3] = (lo if i < 3 else hi)[i % 3]
    p[:12] = face
    p = np.concatenate([p.astype(np.float32), face.astype(np.float32)])
    p = p[rng.permutation(len(p))][:int(np.prod(shape[:-1]))].reshape(shape)
    if shape == (3,):
        p = face[0].astype(np.float32)
    got, want = bbox.contains(p), jbbox.contains(p)
    assert got.dtype == want.dtype and got.shape == want.shape == shape[:-1]
    np.testing.assert_array_equal(got, want)
    assert bbox.contains(face.astype(np.float32)).all()
    if len(shape) > 1:
        assert got.any() and not got.all()


def test_port_runs_without_jax():
    """With ``import jax`` (and ``import zmq``) made to fail, every module of
    the port imports (``models/`` included), one CPU FramePipeline.step and
    two strategies' draws run on a tiny rig built by the port's own
    calibration code, and the port's app replays a scene the port wrote —
    what chip_smoke.py needs on the card's machine."""
    script = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["zmq"] = None
        import importlib, pkgutil
        import numpy as np
        import rgbd_recon_torch
        for m in pkgutil.walk_packages(rgbd_recon_torch.__path__, "rgbd_recon_torch."):
            importlib.import_module(m.name)
        assert not any(k == "rgbd_recon_tpu" or k.startswith("rgbd_recon_tpu.")
                       for k in sys.modules), "the port imported the JAX package"
        from rgbd_recon_torch.calibration import synthetic
        from rgbd_recon_torch.utils.math import Bbox
        from rgbd_recon_torch.runtime.pipeline import FramePipeline, PipelineConfig
        bbox = Bbox.default()
        rig, cams = synthetic.synthetic_rig(num_sensors=2, bbox=bbox,
            fwd_res=(16, 24, 16), inv_res=(16, 16, 16), width=96, height=80)
        d, c = synthetic.render_frames(cams, synthetic.SphereScene.default(bbox))
        pipe = FramePipeline(rig, PipelineConfig(render_width=64, render_height=48,
            tsdf_res=(128, 64, 64), voxel_size=0.05, brick_size=0.2, num_lods=3), device="cpu")
        mv, pr = pipe.default_camera()
        out = pipe.step(d, c, mv, pr)
        pipe.check_capacity(out)
        assert out.color.shape == (48, 64, 4)
        assert bool(out.color.isfinite().all())
        import torch
        from rgbd_recon_torch import models
        from rgbd_recon_torch.ops.raymarch import RenderCamera
        ctx = models.ReconContext(rig=rig, bbox=bbox, width=64, height=48, device="cpu")
        cam = RenderCamera(torch.from_numpy(mv), torch.from_numpy(pr), 64, 48)
        frames = pipe.preprocess(d, c)
        for m in (models.ReconPoints(ctx), models.ReconCalibs(ctx)):
            assert bool((m.draw(frames, cam)[..., 3] > 0).any()), m.name
        import contextlib, glob, io, os, tempfile
        from rgbd_recon_torch import app
        from rgbd_recon_torch.io.stream import FrameFormat, StreamWriter
        work = tempfile.mkdtemp()
        synthetic.write_reference_scene(work, num_sensors=2, bbox=bbox, width=96,
                                        height=80, compressed_rgb=1, compressed_depth=True)
        d, c = synthetic.render_frames(synthetic.make_cameras(2, bbox, width=96, height=80),
                                       synthetic.SphereScene.default(bbox))
        os.makedirs(work + "/rec")
        w = StreamWriter([f"{work}/rec/sensor{i}.stream" for i in range(2)],
                         FrameFormat(96, 80, 96, 80, compressed_rgb=1, compressed_depth=True))
        w.write(d, c)
        w.close()
        with open(work + "/run.conf", "w") as f:
            f.write("recon_mode: 1\\nscreenWidth: 64\\nscreenHeight: 48\\n"
                    "voxel_size: 0.05\\nbrick_size: 0.2\\ntsdf_limit: 0.02\\n")
        with contextlib.redirect_stdout(io.StringIO()):   # the app's log
            rc = app.main([work + "/scene.ks", work + "/run.conf", "-recordings",
                           work + "/rec", "-outdir", work + "/frames", "-dump-every", "2",
                           "-frames", "2", "-device", "cpu"])
        assert rc == 0 and glob.glob(work + "/frames/frame_00002.png")
        assert glob.glob(work + "/mean_run,*.csv")
        assert not any(k == "jax" or k.startswith("jax.") for k, v in sys.modules.items()
                       if v is not None)
        import shutil
        shutil.rmtree(work)
        print("OK", float(out.hit.float().mean()))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK"), proc.stdout


def test_entry_points_default_to_the_card():
    """The pipeline, the five public session bakes, the app and its device
    feed, and the strategies' context run on the card unless the caller
    passes ``device="cpu"``
    (signatures only: no GPU needed)."""
    import inspect

    from rgbd_recon_torch.app import KinectClientApp
    from rgbd_recon_torch.io.ingest import DeviceFeed
    from rgbd_recon_torch.models import ReconContext
    from rgbd_recon_torch.ops import tsdf_affine, tsdf_fast, warp
    from rgbd_recon_torch.runtime.pipeline import FramePipeline

    for fn in (FramePipeline.__init__, warp.bake_pixel_warp, warp.bake_piecewise_warp,
               tsdf_affine.bake_affine, tsdf_fast.precompute_tables,
               tsdf_fast.tables_cached, KinectClientApp.__init__, DeviceFeed.__init__,
               ReconContext):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__

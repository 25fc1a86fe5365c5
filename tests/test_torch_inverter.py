"""The port's offline tools and leftover functions on the CPU, against the
JAX package: ``calibration.inverter`` and the ``calib_inverter`` and
``make_fixture`` scripts, ``Frustum.inside``, ``tsdf_affine.{expand_affine,
block_depth_cull}``, ``tsdf_fast.resize3d_gl``, ``utils.math.transform_point``
and the native DXT decoder (``io/native.py``).
"""
import os
import sys

import numpy as np
import pytest
import torch

from rgbd_recon_torch.calibration import synthetic
from rgbd_recon_torch.calibration.frustum import Frustum, _plane
from rgbd_recon_torch.calibration.inverter import CalibrationInverter
from rgbd_recon_torch.calibration.volume import CalibrationVolume
from rgbd_recon_torch.io import dxt, native
from rgbd_recon_torch.ops import tsdf_affine, tsdf_fast
from rgbd_recon_torch.utils.math import Bbox, transform_point

VOXEL = 0.2                 # -> 10 x 12 x 10 over Bbox.default()
FWD = (16, 24, 16)
ATOL = 1e-5                 # inverse-volume values (normalized forward-index units)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread (as the other test_torch_* files)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A 2-sensor reference-format scene at fwd_res (16, 24, 16)."""
    d = tmp_path_factory.mktemp("scene")
    ks = synthetic.write_reference_scene(str(d), num_sensors=2, bbox=Bbox.default(),
                                         fwd_res=FWD)
    vols = [CalibrationVolume.read(str(d / f"sensor{i}.cv_xyz"), 3) for i in range(2)]
    return d, ks, vols


def _res():
    return tuple(int(np.ceil(float(s) / VOXEL)) for s in Bbox.default().size)


def _near_tie(fwd: np.ndarray, p: np.ndarray) -> bool:
    """The 8th and 9th nearest forward samples of ``p`` lie within a
    relative 1e-5 of one another (float64, every sample)."""
    d = np.sort(np.linalg.norm(fwd.reshape(-1, 3).astype(np.float64) - p, axis=1))
    return d[8] - d[7] <= 1e-5 * d[7]


def test_inverter_matches_jax(scene):
    """The port's inverter (torch, CPU) against JAX's at voxel size 0.2
    (10 x 12 x 10): the frustum mask exact, res and depth limits exact,
    values within ATOL, every voxel outside ATOL a near-tie of the 8th and
    9th distances (where the two 8-NN sets may differ)."""
    from rgbd_recon_tpu.calibration.inverter import CalibrationInverter as JInv
    from rgbd_recon_tpu.calibration.volume import CalibrationVolume as JVol
    from rgbd_recon_tpu.utils.math import Bbox as JBbox

    _, _, vols = scene
    res = _res()
    assert res == (10, 12, 10)
    jinv = JInv.from_volumes([JVol(v.res, v.depth_limits, v.volume) for v in vols],
                             JBbox.default())
    jinv.calculate_inverse_volumes(res)
    inv = CalibrationInverter.from_volumes(vols, Bbox.default(), device="cpu")
    inv.calculate_inverse_volumes(res)
    for v, got, want in zip(vols, inv.inverted, jinv.inverted):
        np.testing.assert_array_equal(got.res, want.res)
        np.testing.assert_array_equal(got.depth_limits, want.depth_limits)
        g, w = got.volume, want.volume
        assert g.shape == w.shape == (10, 12, 10, 4) and g.dtype == np.float32
        mask = w[..., 0] >= 0.0
        np.testing.assert_array_equal(g[..., 0] >= 0.0, mask)
        np.testing.assert_array_equal(g[~mask], w[~mask])
        assert 0.5 < mask.mean() < 1.0
        off = np.abs(g - w).max(-1) > ATOL
        size = Bbox.default().size.astype(np.float64) / np.array(res)
        for z, y, x in zip(*np.nonzero(off)):
            p = Bbox.default().min + size * (np.array([x, y, z]) + 0.5)
            assert _near_tie(v.volume, p), (z, y, x)


def test_calib_inverter_cli(scene, tmp_path, capsys):
    """``python -m rgbd_recon_torch.scripts.calib_inverter`` as
    tests/test_calibration.py:172-195 runs the JAX tool: the same log
    lines, file names, headers and resolution as JAX's script on a copy of
    the scene, values within ATOL."""
    import shutil

    import scripts.calib_inverter as jci
    from rgbd_recon_torch.scripts import calib_inverter as ci

    src, ks, _ = scene
    runs = {}
    for name, main, extra in (("port", ci.main, ["-device", "cpu"]), ("jax", jci.main, [])):
        d = tmp_path / name
        shutil.copytree(src, d)
        for i in range(2):
            (d / f"sensor{i}.cv_xyz_inv").unlink()
        capsys.readouterr()
        assert main([str(d / os.path.basename(ks)), "-s", str(VOXEL)] + extra) == 0
        runs[name] = (d, capsys.readouterr().out.replace(str(d), "<dir>"))
    assert runs["port"][1] == runs["jax"][1]
    assert "using resolution 10, 12, 10" in runs["port"][1]
    for i in range(2):
        f = f"sensor{i}.cv_xyz_inv"
        raw = [(runs[k][0] / f).read_bytes() for k in ("port", "jax")]
        assert len(raw[0]) == len(raw[1]) and raw[0][:20] == raw[1][:20]   # res + limits
        got, want = (CalibrationVolume.read(str(runs[k][0] / f), 4).volume
                     for k in ("port", "jax"))
        np.testing.assert_array_equal(got[..., 0] >= 0, want[..., 0] >= 0)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_make_fixture_matches_jax(tmp_path, monkeypatch, capsys):
    """``rgbd_recon_torch.scripts.make_fixture`` writes the same files,
    byte for byte, as the JAX script with the same options."""
    import scripts.make_fixture as jmf
    from rgbd_recon_torch.scripts import make_fixture as mf

    opts = ["--sensors", "2", "--frames", "2", "--width", "128", "--height", "104",
            "--fwd", "16,24,16", "--inv", "16,16,16", "--screen", "160x96"]
    assert mf.main([str(tmp_path / "port")] + opts) == 0
    monkeypatch.setattr(sys, "argv", ["make_fixture.py", str(tmp_path / "jax")] + opts)
    assert jmf.main() == 0
    files = {k: sorted(os.path.relpath(os.path.join(r, f), tmp_path / k)
                       for r, _, fs in os.walk(tmp_path / k) for f in fs)
             for k in ("port", "jax")}
    assert files["port"] == files["jax"] and "recordings/sensor1.stream" in files["port"]
    for f in files["port"]:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def test_frustum_matches_jax(scene):
    """``_plane``, the planes and ``Frustum.inside`` bit for bit the JAX
    package's numpy originals."""
    from rgbd_recon_tpu.calibration.frustum import Frustum as JFrustum, _plane as jplane

    _, _, vols = scene
    rng = np.random.default_rng(1)
    a, b, c = rng.normal(size=(3, 3))
    np.testing.assert_array_equal(_plane(a, b, c), jplane(a, b, c))
    pts = rng.uniform(-1.5, 2.5, (4000, 3)).astype(np.float32)
    for v in vols:
        got, want = Frustum(v.corner_points()), JFrustum(v.corner_points())
        np.testing.assert_array_equal(got.planes, want.planes)
        np.testing.assert_array_equal(got.inside(pts), want.inside(pts))
        np.testing.assert_array_equal(got.camera_position(), want.camera_position())
        assert 0.0 < got.inside(pts).mean() < 1.0


def _coeffs(rng, k=2, nb=8):
    """Affine coefficients in multiples of 2^-10 (every hull product and
    sum exact in float32), footprints inside a 64 x 80 image."""
    c = np.zeros((k, nb, 4, tsdf_affine.NBASIS), np.float32)
    c[..., :3, 0] = rng.integers(200, 800, (k, nb, 3)) / 1024.0
    c[..., :3, 1:4] = rng.integers(-8, 9, (k, nb, 3, 3)) / 1024.0
    c[..., :3, 4:] = rng.integers(-1, 2, (k, nb, 3, 6)) / 1024.0
    c[0, 3, 0, 0] = -1.0                        # one bake-invalid (sensor, brick)
    return c


def test_expand_affine_matches_jax():
    """The dense table of a quadratic bake against JAX's (atol 1e-6: float32
    sums in another order)."""
    from rgbd_recon_tpu.ops import tsdf_affine as jaff

    c = _coeffs(np.random.default_rng(2))
    z = np.zeros(3, np.float32)
    got = tsdf_affine.expand_affine(tsdf_affine.AffineTables(torch.from_numpy(c), *(
        torch.from_numpy(z) for _ in range(2)), torch.tensor(0)))
    want = jaff.expand_affine(jaff.AffineTables(c, z, z, np.int32(0)))
    assert got.pos_blocked.shape == (2, 8, 4096, 3)
    np.testing.assert_allclose(got.pos_blocked.numpy(), np.asarray(want.pos_blocked),
                               atol=1e-6, rtol=0)


def test_block_depth_cull_matches_baked_and_jax():
    """``block_depth_cull`` equals ``block_depth_cull_baked`` on a fresh
    bake, and JAX's ``block_depth_cull``, exactly (mask, keep and classes)."""
    from rgbd_recon_tpu.ops import tsdf_affine as jaff

    rng = np.random.default_rng(4)
    c = _coeffs(rng)
    k, h, w = 2, 64, 80
    depth = (0.5 + 0.01 * rng.random((k, h, w))).astype(np.float32)
    qual = (0.5 + 0.5 * rng.random((k, h, w))).astype(np.float32)
    qual[:, :8, :8] = 0.0                       # a dead corner
    sil = np.ones((k, h, w), np.float32)
    sil[1, 40:, 60:] = 0.0
    mask16 = rng.random((2, 2, 2)) > 0.2
    z = np.zeros(3, np.float32)
    tables = tsdf_affine.AffineTables(torch.from_numpy(c), torch.from_numpy(z),
                                      torch.from_numpy(z), torch.tensor(0))
    args = [torch.from_numpy(a) for a in (mask16, depth, qual, sil)]
    got = tsdf_affine.block_depth_cull(args[0], tables, *args[1:], limit=0.05)
    bake = tsdf_affine.bake_cull(tables, h, w, 0.05)
    baked = tsdf_affine.block_depth_cull_baked(args[0], bake, *args[1:], limit=0.05)
    want = jaff.block_depth_cull(mask16, jaff.AffineTables(c, z, z, np.int32(0)), depth, qual,
                                 sil, limit=0.05)
    for g, b, wnt in zip(got, baked, want):
        assert torch.equal(g, b)
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    assert 0 < int(got[1].sum()) < 8 and len(set(got[2].flatten().tolist())) > 1


def test_resize3d_gl_matches_jax():
    """The separable GL resize against JAX's (atol 1e-6)."""
    from rgbd_recon_tpu.ops.tsdf_fast import resize3d_gl as jresize

    vol = np.random.default_rng(6).random((6, 5, 7, 3), dtype=np.float32)
    got = tsdf_fast.resize3d_gl(torch.from_numpy(vol), (9, 4, 10))
    want = np.asarray(jresize(vol, (9, 4, 10)))
    assert got.shape == want.shape == (9, 4, 10, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_transform_point_matches_jax():
    from rgbd_recon_tpu.utils.math import transform_point as jtp

    rng = np.random.default_rng(7)
    m = rng.normal(size=(4, 4)).astype(np.float32)
    m[3] = [0.1, 0.2, 0.3, 2.0]
    for p in rng.normal(size=(5, 3)):
        got = transform_point(m, p)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jtp(m, p))


def test_native_decoder_bitwise():
    """The decoder built from native/dxt.cpp against io/dxt.py's numpy
    decode, bit for bit: DXT1 (encoded frames and random blocks, both color
    modes) and DXT5; ``best_decoder`` and the stream's host decode take it."""
    assert native.available()
    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, (104, 128, 3), dtype=np.uint8)
    enc = dxt.encode_dxt1(img)
    np.testing.assert_array_equal(native.decode_dxt1(enc, 128, 104),
                                  dxt.decode_dxt1(enc, 128, 104))
    raw1 = rng.integers(0, 256, 128 * 104 // 2, dtype=np.uint8)
    np.testing.assert_array_equal(native.decode_dxt1(raw1, 128, 104, num_threads=3),
                                  dxt.decode_dxt1(raw1, 128, 104))
    raw5 = rng.integers(0, 256, 640 * 480, dtype=np.uint8)
    np.testing.assert_array_equal(native.decode_dxt5(raw5.tobytes(), 640, 480),
                                  dxt.decode_dxt5(raw5, 640, 480))
    assert native.best_decoder("dxt1") is native.decode_dxt1
    assert native.best_decoder("dxt5") is native.decode_dxt5
    assert os.path.dirname(native.library_path()).endswith(os.path.join("rgbd_recon_torch",
                                                                        "_build"))
    with pytest.raises(ValueError, match="payload"):
        native.decode_dxt1(raw1[:10], 128, 104)

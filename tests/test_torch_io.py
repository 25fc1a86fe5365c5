"""The port's host-side copies (scene files, streams, codecs, control surface,
math utilities, timers, ingest) and its device-side wire decode against the
JAX package's originals, on the same seeded inputs: equal arrays, equal
bytes, bitwise decodes."""
import os
import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rgbd_recon_tpu.calibration import synthetic as jsyn
from rgbd_recon_tpu.calibration.files import CalibrationFiles as JCalibrationFiles
from rgbd_recon_tpu.calibration.files import file_value as jfile_value
from rgbd_recon_tpu.calibration.files import load_scene as jload_scene
from rgbd_recon_tpu.calibration.volume import CalibrationVolume as JCalibrationVolume
from rgbd_recon_tpu.io import dxt as jdxt
from rgbd_recon_tpu.io import ingest as jingest
from rgbd_recon_tpu.io import stream as jstream
from rgbd_recon_tpu.io.cmdparser import CMDParser as JCMDParser
from rgbd_recon_tpu.io.configurator import Configurator as JConfigurator
from rgbd_recon_tpu.io.ks import parse_ks as jparse_ks
from rgbd_recon_tpu.ops import wire as jwire
from rgbd_recon_tpu.utils import navigator as jnav
from rgbd_recon_tpu.utils import overlay as joverlay
from rgbd_recon_tpu.utils import png as jpng
from rgbd_recon_tpu.utils import stereo as jstereo
from rgbd_recon_tpu.utils.math import Bbox as JBbox
from rgbd_recon_tpu.utils.timers import TimerDatabase as JTimerDatabase

from rgbd_recon_torch.calibration import synthetic
from rgbd_recon_torch.calibration.files import CalibrationFiles, file_value, load_scene
from rgbd_recon_torch.calibration.volume import CalibrationVolume
from rgbd_recon_torch.io import dxt, ingest, stream
from rgbd_recon_torch.io.cmdparser import CMDParser
from rgbd_recon_torch.io.configurator import Configurator
from rgbd_recon_torch.io.ks import parse_ks
from rgbd_recon_torch.io.viewer import LiveViewer
from rgbd_recon_torch.ops import tsdf_fast, wire
from rgbd_recon_torch.ops.tsdf import TsdfConfig
from rgbd_recon_torch.utils import navigator, overlay, png, stereo
from rgbd_recon_torch.utils.math import Bbox
from rgbd_recon_torch.utils.timers import TimerDatabase

SCENE_KW = dict(num_sensors=2, width=64, height=48, fwd_res=(16, 24, 16),
                inv_res=(16, 16, 16), compressed_rgb=1, compressed_depth=True)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The same compressed scene written by the port and by the JAX package."""
    root = tmp_path_factory.mktemp("io_scenes")
    ks = synthetic.write_reference_scene(str(root / "port"), bbox=Bbox.default(), **SCENE_KW)
    jks = jsyn.write_reference_scene(str(root / "jax"), bbox=JBbox.default(), **SCENE_KW)
    return ks, jks


def _images(seed, k=2, h=48, w=64):
    return np.random.default_rng(seed).integers(0, 256, (k, h, w, 3)).astype(np.uint8)


def test_write_reference_scene_byte_identical(scenes):
    ks, jks = scenes
    d, jd = os.path.dirname(ks), os.path.dirname(jks)
    names = sorted(os.listdir(jd))
    assert sorted(os.listdir(d)) == names and len(names) == 1 + 2 * 7
    for n in names:
        with open(os.path.join(d, n), "rb") as f, open(os.path.join(jd, n), "rb") as g:
            assert f.read() == g.read(), n


def test_scene_parse_and_rig_equal(scenes):
    """parse_ks, CalibrationFiles (every parsed field), file_value and the
    rig of load_scene, equal to the JAX package's on the same files."""
    ks, _ = scenes
    files, bbox = parse_ks(ks)
    jfiles, jbbox = jparse_ks(ks)
    assert files == jfiles
    np.testing.assert_array_equal(bbox.min, jbbox.min)
    np.testing.assert_array_equal(bbox.max, jbbox.max)
    cfs, jcfs = CalibrationFiles(files), JCalibrationFiles(jfiles)
    for c, jc in zip(cfs.calibs, jcfs.calibs):
        for f in jc.__dataclass_fields__:
            np.testing.assert_array_equal(np.asarray(getattr(c, f)),
                                          np.asarray(getattr(jc, f)), err_msg=f)
        np.testing.assert_array_equal(c.intrinsic_d(), jc.intrinsic_d())
    assert cfs.frame_format().__dict__ == jcfs.frame_format().__dict__
    assert cfs.frame_format().compressed_rgb == 1 and cfs.frame_format().compressed_depth
    serial = files[0][:-3] + "serial"
    assert file_value(serial + "x", 2.5) == jfile_value(serial + "x", 2.5) == 2.5
    _, rig, fmt, _ = load_scene(ks)
    _, jrig, jfmt, _ = jload_scene(ks)
    for f in rig._fields:
        np.testing.assert_array_equal(getattr(rig, f), np.asarray(getattr(jrig, f)),
                                      err_msg=f)
    assert fmt.__dict__ == jfmt.__dict__


def test_calibration_volume_io(tmp_path):
    rng = np.random.default_rng(2)
    vol = CalibrationVolume(np.array([5, 4, 3], np.uint32), np.array([0.5, 4.5], np.float32),
                            rng.random((3, 4, 5, 2)).astype(np.float32))
    vol.write(str(tmp_path / "v.cv_uv"))
    jv = JCalibrationVolume.read(str(tmp_path / "v.cv_uv"), 2)
    v = CalibrationVolume.read(str(tmp_path / "v.cv_uv"), 2)
    for a, b, c in zip(v, jv, vol):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    with open(tmp_path / "short.cv_uv", "wb") as f:
        f.write(open(tmp_path / "v.cv_uv", "rb").read()[:-4])
    with pytest.raises(ValueError):
        CalibrationVolume.read(str(tmp_path / "short.cv_uv"), 2)


def test_dxt_codecs_bitwise():
    for img in _images(3):
        for enc, jenc, dec, jdec in ((dxt.encode_dxt1, jdxt.encode_dxt1, dxt.decode_dxt1,
                                      jdxt.decode_dxt1),
                                     (dxt.encode_dxt5, jdxt.encode_dxt5, dxt.decode_dxt5,
                                      jdxt.decode_dxt5)):
            pay = enc(img)
            np.testing.assert_array_equal(pay, jenc(img))
            np.testing.assert_array_equal(dec(pay, 64, 48), jdec(pay, 64, 48))


@pytest.mark.parametrize("rgb,cdepth", [(0, False), (1, True), (5, False), (1, False)])
def test_stream_files_byte_identical(tmp_path, rgb, cdepth):
    """StreamWriter bytes equal; StreamReader.read and read_raw equal, and
    looping, on every color and depth format."""
    rng = np.random.default_rng(4)
    w_c, h_c = (640, 480) if rgb == 5 else (64, 48)
    depth = (0.5 + 3.5 * rng.random((2, 48, 64))).astype(np.float32)
    depth[:, :4] = 0.0
    color = rng.random((2, h_c, w_c, 3)).astype(np.float32)
    kw = dict(width=64, height=48, width_c=w_c, height_c=h_c, compressed_rgb=rgb,
              compressed_depth=cdepth)
    fmt, jfmt = stream.FrameFormat(**kw), jstream.FrameFormat(**kw)
    paths = {}
    for tag, mod, f in (("p", stream, fmt), ("j", jstream, jfmt)):
        paths[tag] = [str(tmp_path / f"{tag}{i}.stream") for i in range(2)]
        w = mod.StreamWriter(paths[tag], f)
        w.write(depth, color)
        w.write(depth * 1.01, color[::-1].copy())
        w.close()
    for p, jp in zip(paths["p"], paths["j"]):
        assert open(p, "rb").read() == open(jp, "rb").read()
    r = stream.StreamReader(paths["p"], fmt)
    jr = jstream.StreamReader(paths["j"], jfmt)
    for _ in range(3):   # 2 frames, then the loop
        for a, b in zip(r.read(), jr.read()):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(r.read_raw(), jr.read_raw()):
            np.testing.assert_array_equal(a, b)
    r.close()
    jr.close()


@pytest.mark.parametrize("kind", ["dxt1", "dxt5", "rgb", "depth_u8", "depth_f32"])
def test_wire_decode_bitwise(kind):
    """The torch wire decode on the CPU against the host decode (io/dxt.py,
    FrameFormat) and the JAX one: bit for bit. JAX's composed decoder is
    jitted, and XLA turns its ``/ 255.0`` into a product with the
    reciprocal, so the raw-RGB case (which only it reaches) is held to it
    as tests/test_io.py:278 holds it: the same u8 after rint(x * 255)."""
    rng = np.random.default_rng(6)
    imgs = _images(6)
    if kind in ("dxt1", "dxt5"):
        enc = dxt.encode_dxt1 if kind == "dxt1" else dxt.encode_dxt5
        pay = np.stack([enc(i) for i in imgs])
        fn = "decode_dxt1_device" if kind == "dxt1" else "decode_dxt5_device"
        got = getattr(wire, fn)(torch.from_numpy(pay), 64, 48).numpy()
        jgot = np.asarray(getattr(jwire, fn)(jnp.asarray(pay), 64, 48))
        dec = dxt.decode_dxt1 if kind == "dxt1" else dxt.decode_dxt5
        want = np.stack([dec(p, 64, 48) for p in pay]).astype(np.float32) / 255.0
    elif kind == "rgb":
        fmt = stream.FrameFormat(width=64, height=48, width_c=64, height_c=48)
        pay = imgs.reshape(2, -1)
        dep = np.zeros((2, fmt.depth_size), np.uint8)
        got = wire.make_wire_decoder(fmt)(torch.from_numpy(pay), torch.from_numpy(dep))[1]
        got = got.numpy()
        jgot = np.asarray(jwire.make_wire_decoder(fmt)(jnp.asarray(pay), jnp.asarray(dep))[1])
        want = np.stack([fmt.decode_color(p) for p in pay])
    elif kind == "depth_u8":
        fmt = stream.FrameFormat(width=64, height=48, compressed_depth=True)
        pay = np.concatenate([np.arange(256, dtype=np.uint8).repeat(12),
                              rng.integers(0, 256, 2 * 3072 - 3072, np.uint8)]).reshape(2, -1)
        got = wire.decode_depth_u8_device(torch.from_numpy(pay), 64, 48).numpy()
        jgot = np.asarray(jwire.decode_depth_u8_device(jnp.asarray(pay), 64, 48))
        want = np.stack([fmt.decode_depth(p) for p in pay])
    else:
        fmt = stream.FrameFormat(width=64, height=48)
        d = rng.random((2, 48, 64)).astype(np.float32)
        pay = d.view(np.uint8).reshape(2, -1)
        got = wire.decode_depth_f32_device(torch.from_numpy(pay), 64, 48).numpy()
        jgot = np.asarray(jwire.decode_depth_f32_device(jnp.asarray(pay), 64, 48))
        want = np.stack([fmt.decode_depth(p) for p in pay])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if kind == "rgb":
        got, jgot = (np.rint(a * 255.0).astype(np.uint8) for a in (got, jgot))
    np.testing.assert_array_equal(got, jgot)


def test_navigator_matrices_equal():
    """Orbits, drags, pans and zooms: the same modelviews as the JAX copy."""
    nav, jn = navigator.CameraNavigator(zoom=1.7), jnav.CameraNavigator(zoom=1.7)
    for n in (nav, jn):
        n.resize(320, 200)
    np.testing.assert_array_equal(nav.modelview(), jn.modelview())
    for events in ([(0, True, 100, 80), (0, False, 180, 60)],
                   [(1, True, 10, 10), (1, False, 10, 40)],
                   [(2, True, 50, 50), (2, False, 70, 20)]):
        for n in (nav, jn):
            for b, pressed, x, y in events:
                n.motion(x, y)
                n.mouse(b, pressed, x, y)
        speed = (0.01 * nav.offset(0)[0], 0.01 * nav.offset(0)[1], 0.02 * nav.offset(1)[1])
        np.testing.assert_array_equal(nav.modelview(speed), jn.modelview(speed))
    for a, b in zip(nav.orbit_frames(5), jn.orbit_frames(5)):
        np.testing.assert_array_equal(a, b)


def test_stereo_composites_equal():
    cam, jcam = stereo.StereoCamera(screen_width=1.6), jstereo.StereoCamera(screen_width=1.6)
    m = stereo.translate(0.1, -0.2, 1.3)
    for c in (cam, jcam):
        c.set_cyclops_matrix(m)
    for side in ("left", "right", "cyclops"):
        for a, b in zip(cam.eye_view(side), jcam.eye_view(side)):
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(8)
    left, right = rng.random((2, 30, 40, 4)).astype(np.float32)
    np.testing.assert_array_equal(stereo.anaglyph_composite(left, right, 0.5),
                                  jstereo.anaglyph_composite(left, right, 0.5))
    np.testing.assert_array_equal(
        stereo.side_by_side_composite((50, 90), left, (0, 5), right, (45, -3)),
        jstereo.side_by_side_composite((50, 90), left, (0, 5), right, (45, -3)))


def test_overlay_images_equal():
    """Grid and frustum wireframes, depth-tested, onto the same image."""
    from rgbd_recon_torch.utils.math import look_at, perspective

    rng = np.random.default_rng(9)
    img = rng.random((60, 80, 4)).astype(np.float32)
    depth = rng.random((60, 80)).astype(np.float32)
    bbox = Bbox.default()
    mv = look_at(np.array([2.0, 1.5, 3.0], np.float32), np.array([0, 1.1, 0], np.float32),
                 [0, 1, 0])
    proj = perspective(50.0, 80 / 60, 0.1, 200.0)
    corners = rng.random((8, 3)).astype(np.float32) * 2 - 1
    for segs, jsegs in ((overlay.bbox_segments(bbox), joverlay.bbox_segments(JBbox.default())),
                        (overlay.frustum_segments(corners), joverlay.frustum_segments(corners))):
        np.testing.assert_array_equal(segs, jsegs)
        for d in (None, depth):
            np.testing.assert_array_equal(overlay.draw_segments(img, segs, mv, proj, depth=d),
                                          joverlay.draw_segments(img, jsegs, mv, proj, depth=d))


def test_png_bytes_equal(tmp_path):
    rng = np.random.default_rng(10)
    for img in (rng.integers(0, 255, (9, 13, 3), np.uint8), rng.random((7, 5, 4)),
                rng.random((6, 6)).astype(np.float32)):
        assert png.encode_png(img) == jpng.encode_png(img)
    png.write_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "a.png")),
                                  jpng.read_png(str(tmp_path / "a.png")))


def test_configurator_and_cmdparser_equal(tmp_path):
    conf = tmp_path / "x.conf"
    conf.write_text("# comment: 1\nrecon_mode: 1\nzoom : 2.5\nplay: true\nanimate: no\n"
                    "list: 1, 2,3\nbad: 1.2.3\nx: 4\n")
    c, jc = Configurator().read(str(conf)), JConfigurator().read(str(conf))
    for t in ("bools", "floats", "uints", "lists"):
        assert getattr(c, t) == getattr(jc, t), t
    assert Configurator.instance() is Configurator.instance()
    argv = ["scene.ks", "-d", "320", "200", "-m", "2", "run.conf", "-c", "0", "0", "0", "1",
            "-dump-textures", "-frames", "4"]
    parsers = []
    for cls in (CMDParser, JCMDParser):
        p = cls("<scene.ks> [run.conf]")
        for opt, n in (("d", 2), ("m", 1), ("c", 4), ("dump-textures", 0), ("frames", 1),
                       ("p", 1)):
            p.add_opt(opt, n, opt, "help")
        p.init(argv)
        parsers.append(p)
    p, jp = parsers
    assert p.args == jp.args == ["scene.ks", "run.conf"]
    assert p.show_help() == jp.show_help()
    assert p.get_opts_int("d") == jp.get_opts_int("d") == [320, 200]
    assert p.get_opts_float("c") == jp.get_opts_float("c")
    assert p.is_opt_set("dump-textures") and not p.is_opt_set("p")


def test_timer_csv_identical(tmp_path):
    """The same spans give the same three CSV files, byte for byte; begin /
    end(sync=) on a tensor and scope() fill the singleton."""
    db, jdb = TimerDatabase(), JTimerDatabase()
    for d in (db, jdb):
        for name in ("draw", "1preprocess", "3recon"):
            d.add_timer(name)
        for name, dts in (("draw", (0.0123, 0.02)), ("1preprocess", (0.004,))):
            for dt in dts:
                d.timers[name].total += dt
                d.timers[name].count += 1
                d.timers[name].vmin = min(d.timers[name].vmin, dt)
                d.timers[name].vmax = max(d.timers[name].vmax, dt)
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    for d, sub in ((db, "p"), (jdb, "j")):
        path = str(tmp_path / sub / "run,2026-1-2,3-4.csv")
        d.write_mean(path)
        d.write_min(path)
        d.write_max(path)
    for pre in ("mean_", "min_", "max_"):
        name = pre + "run,2026-1-2,3-4.csv"
        assert (tmp_path / "p" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    single = TimerDatabase.instance()
    assert single is TimerDatabase.instance()
    single.begin("t_unit")
    assert single.end("t_unit", sync=torch.ones(2)) >= 0.0
    with single.scope("t_unit"):
        pass
    assert single.timers["t_unit"].count == 2


def test_double_buffer_and_feedback_pack():
    db, jdb = ingest.DoubleBuffer((2, 3), (2, 3, 3)), jingest.DoubleBuffer((2, 3), (2, 3, 3))
    for b in (db, jdb):
        assert b.swap_if_dirty() is None
        b.back_depth[:] = 7.0
        b.back_color[:] = 0.5
        b.publish(1.5)
    for got, want in zip(db.swap_if_dirty(), jdb.swap_if_dirty()):
        np.testing.assert_array_equal(got, want)
    assert db.swap_if_dirty() is None
    m = np.arange(16, dtype=np.float32).reshape(4, 4)
    assert ingest.FeedbackSender.pack(m, m.T, m * 2, 2) == \
        jingest.FeedbackSender.pack(m, m.T, m * 2, 2)


def test_device_feed_cpu_staging():
    """Off the card the feed copies: the caller may reuse its arrays."""
    feed = ingest.DeviceFeed("cpu")
    assert feed.advance() is None
    d, c = np.ones((2, 3), np.float32), np.zeros((2, 3, 3), np.uint8)
    feed.stage(d, c, 4.0)
    d[:] = 5.0
    got = feed.advance()
    assert torch.equal(got[0], torch.ones(2, 3)) and got[1].dtype == torch.uint8
    assert feed.advance() is got and feed.current() is got and feed.timestamp == 4.0


@pytest.mark.parametrize("raw_wire", [False, True])
def test_zmq_ingest_live(raw_wire):
    """A localhost PUB message lands in the ingest's double buffer: raw
    payload bytes, or host-decoded as the JAX ingest decodes them."""
    zmq = pytest.importorskip("zmq")
    fmt = stream.FrameFormat(width=64, height=48, width_c=64, height_c=48,
                             compressed_rgb=1, compressed_depth=True)
    imgs = _images(11)
    pays = [(dxt.encode_dxt1(i), np.full(fmt.depth_size, 60 + k, np.uint8))
            for k, i in enumerate(imgs)]
    msg = np.float64(2.5).tobytes() + b"".join(c.tobytes() + d.tobytes() for c, d in pays)
    ctx = zmq.Context(1)
    pub = ctx.socket(zmq.PUB)
    port = pub.bind_to_random_port("tcp://127.0.0.1")
    ing = ingest.ZMQIngest(f"127.0.0.1:{port}", 2, fmt, color_u8=True, raw_wire=raw_wire)
    ing.start()
    try:
        swap = None
        for _ in range(100):
            pub.send(msg)
            time.sleep(0.02)
            swap = ing.buffer.swap_if_dirty()
            if swap is not None:
                break
        assert swap is not None, "no frame arrived"
        depth, color, ts = swap
        assert ts == 2.5
        for k, (c, d) in enumerate(pays):
            if raw_wire:
                np.testing.assert_array_equal(color[k], c)
                np.testing.assert_array_equal(depth[k], d)
            else:
                np.testing.assert_array_equal(color[k], jstream.FrameFormat(
                    **fmt.__dict__).decode_color(c, as_float=False))
                np.testing.assert_array_equal(depth[k], fmt.decode_depth(d))
    finally:
        ing.stop()
        pub.close(0)
        ctx.term()
    assert not ing._thread.is_alive()


def test_tables_cache_errors_recompute(tmp_path):
    """An unreadable or unwritable warp-table cache costs a recompute and a
    log line, never the run (the JAX tables_cached)."""
    rig, _ = synthetic.synthetic_rig(num_sensors=1, fwd_res=(8, 8, 8), inv_res=(8, 8, 8),
                                     width=32, height=24)
    cfg = TsdfConfig((16, 16, 16), 0.01)
    want = tsdf_fast.precompute_tables(rig, cfg, "cpu").pos_blocked
    logs = []
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")
    got = tsdf_fast.tables_cached(rig, cfg, "cpu", str(blocker), logs.append)
    assert torch.equal(got.pos_blocked, want) and "not written" in logs[-1]
    cache = tmp_path / "cache"
    tsdf_fast.tables_cached(rig, cfg, "cpu", str(cache), logs.append)
    (path,) = cache.iterdir()
    assert torch.equal(tsdf_fast.tables_cached(rig, cfg, "cpu", str(cache)).pos_blocked, want)
    path.write_bytes(path.read_bytes()[:100])
    got = tsdf_fast.tables_cached(rig, cfg, "cpu", str(cache), logs.append)
    assert torch.equal(got.pos_blocked, want) and "unreadable" in logs[-1]


def test_viewer_serves_localhost_frames():
    import json
    import urllib.request

    v = LiveViewer(0)
    try:
        assert v._server.server_address[0] == "127.0.0.1"
        base = f"http://127.0.0.1:{v.port}"
        img = np.zeros((4, 6, 4), np.float32)
        img[..., 0] = 1.0
        v.publish(img)
        body = urllib.request.urlopen(base + "/frame.png", timeout=10).read()
        assert body == png.encode_png(img, level=1)
        req = urllib.request.Request(base + "/control", data=b"zoom=1.5", method="POST")
        assert json.load(urllib.request.urlopen(req, timeout=10))["ok"]
        assert v.poll_controls() == [{"zoom": "1.5"}]
    finally:
        v.close()

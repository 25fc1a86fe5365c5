"""The port's span-and-counter recorder (``utils.timers.SPANS``) on the frame.

CPU cases at a small size: the recorder off makes nothing, on it leaves
every output as it was, each frame's spans nest under its ``frame`` span
with one frame id, a full buffer counts into ``dropped``, the slice
counter equals the slab flags' sum, the device events of a fused frame
are made once and read only once complete, and ``scripts.span_split``
takes its medians over the right frames. The ``cuda`` cases run on the card only: a
graph captured with the recorder on against one captured with it off,
the stage spans inside the graph, and ``graph.nodes``. The file imports
no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest tests/test_torch_spans.py -q
"""
import numpy as np
import pytest
import torch

from rgbd_recon_torch.calibration import synthetic
from rgbd_recon_torch.ops import raymarch_fast as rmf
from rgbd_recon_torch.runtime.pipeline import FramePipeline, PipelineConfig
from rgbd_recon_torch.utils import timers
from rgbd_recon_torch.utils.math import Bbox
from rgbd_recon_torch.utils.timers import SPANS

FIELDS = ("color", "depth", "hit", "tsdf", "occupied_ratio", "num_samples", "occupied_bricks")
STAGES = ("1preprocess", "2integrate", "3recon", "holefill")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread (as the other test_torch_* files)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _recorder_off():
    """Every case leaves the process-wide recorder off."""
    yield
    SPANS.disable()


@pytest.fixture(scope="module")
def scene():
    bbox = Bbox.default()
    rig, cams = synthetic.synthetic_rig(num_sensors=2, bbox=bbox, fwd_res=(24, 32, 24),
                                        inv_res=(24, 24, 24), width=128, height=104)
    depth, color = synthetic.render_frames(cams, synthetic.SphereScene.default(bbox))
    return rig, depth, color


def _pipeline(scene, device="cpu", n=64, **over):
    rig, depth, color = scene
    kw = dict(render_width=96, render_height=64, tsdf_res=(n, n, n), sweep_res=(64, 64),
              voxel_size=float(np.max(Bbox.default().size) / n))
    kw.update(over)
    pipe = FramePipeline(rig, PipelineConfig(**kw), device=device)
    mv, proj = pipe.default_camera()
    return pipe, (depth, color, mv, proj)


def _assert_same(a, b, what=""):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), (what, f)


def _by_frame(spans, clock="host"):
    out = {}
    for i, s in enumerate(spans):
        if s["clock"] == clock and s["frame"] >= 0:
            out.setdefault(s["frame"], []).append((i, s))
    return out


def test_recorder_off_records_nothing(scene):
    """Off, every span site returns the one shared null context, and a
    frame adds no record and no count."""
    SPANS.enable(64)
    SPANS.disable()
    assert SPANS.span("frame.load") is timers._NULL
    assert SPANS.span("3recon.sweep") is timers._NULL
    assert SPANS.frame() is timers._NULL
    SPANS.count("render.slices_occupied", torch.ones(4))
    for fused in (True, False):
        pipe, args = _pipeline(scene, fused=fused)
        pipe.step(*args)
    got = SPANS.collect()
    assert got["spans"] == [] and got["counts"] == [] and got["dropped"] == 0


def test_muted_records_nothing():
    """Inside ``muted`` (the eager run before a capture) the recorder on
    records no span and no count."""
    SPANS.enable(64)
    with SPANS.muted():
        assert SPANS.span("1preprocess") is timers._NULL
        SPANS.count("render.slices_swept", 64)
    with SPANS.span("frame.key"):
        pass
    got = SPANS.collect()
    assert [s["name"] for s in got["spans"]] == ["frame.key"] and got["counts"] == []


def test_outputs_bitwise_recorder_on_and_off(scene):
    """A fused and a staged CPU frame give the same outputs, bit for bit,
    with the recorder on and off (and each other's)."""
    outs = {}
    for on in (False, True):
        if on:
            SPANS.enable()
        for fused in (True, False):
            pipe, args = _pipeline(scene, fused=fused)
            outs[on, fused] = pipe.step(*args)
        SPANS.disable()
    ref = outs[False, False]
    assert ref.hit.float().mean() > 0.02
    for k, out in outs.items():
        _assert_same(out, ref, k)


def test_frame_spans_nest(scene):
    """On, each fused frame yields one ``frame`` span with its children
    (the four stages, through ``_frame``'s scope; the sweep and the shade
    under 3recon), each inside its parent, with the frame's id and
    start <= end. A staged frame, timed by its stage timers, yields a
    lone ``frame``."""
    SPANS.enable()
    for fused in (True, False):
        pipe, args = _pipeline(scene, fused=fused)
        pipe.step(*args)
        pipe.step(*args)
    got = SPANS.collect()
    spans = got["spans"]
    frames = _by_frame(spans)
    assert sorted(frames) == list(range(min(frames), min(frames) + 4))
    for n, (fid, recs) in enumerate(sorted(frames.items())):
        tops = [i for i, s in recs if s["name"] == "frame"]
        assert len(tops) == 1 and spans[tops[0]]["parent"] == -1
        top = tops[0]
        if n >= 2:      # staged
            assert len(recs) == 1, [s["name"] for _, s in recs]
            continue
        children = {s["name"] for _, s in recs if s["parent"] == top}
        assert children == set(STAGES), (fid, children)
        for i, s in recs:
            assert s["start"] <= s["end"]
            if i != top:
                p = spans[s["parent"]]
                assert p["frame"] == fid and p["start"] <= s["start"] <= s["end"] <= p["end"]
        sub = {s["name"]: spans[s["parent"]]["name"] for _, s in recs
               if s["name"].startswith("3recon.")}
        assert sub == {"3recon.sweep": "3recon", "3recon.shade": "3recon"}
    assert got["dropped"] == 0


def test_overflow_counts_dropped(scene):
    """A full buffer keeps what it holds and counts the rest in ``dropped``."""
    SPANS.enable(capacity=5)
    pipe, args = _pipeline(scene, fused=True)
    pipe.step(*args)
    got = SPANS.collect()
    assert len(got["spans"]) <= 5 and got["capacity"] == 5
    # 1 frame + 4 stages + sweep + shade = 7 spans; 2 counts fit
    assert got["dropped"] == 2
    SPANS.enable(capacity=1)
    pipe.step(*args)
    assert SPANS.collect()["dropped"] == 6 + 1      # the spans, then the second count


@pytest.mark.parametrize("fused", [True, False])
def test_slice_counter(scene, fused):
    """The frame's ``render.slices_occupied`` is the sum of the slab flags
    of its culled brick mask, beside the slices swept."""
    SPANS.enable()
    pipe, args = _pipeline(scene, fused=fused)
    pipe.step(*args)
    counts = {c["name"]: c["value"] for c in SPANS.collect()["counts"]}
    depth, col, _, _, axis, _ = pipe._inputs(*args)
    SPANS.disable()
    pre = pipe._pre(depth, col)
    n = pipe.tsdf_cfg.res[axis]
    want = int(rmf.slab_occupancy(pre.mask16, axis, n).sum())
    assert counts == {"render.slices_occupied": want, "render.slices_swept": n}
    assert 0 < want < n


class _Event:
    """A stand-in timing event at ``t`` ms."""

    def __init__(self, t, done=True):
        self.t, self.done = t, done

    def query(self):
        return self.done

    def elapsed_time(self, other):
        return other.t - self.t


class _Probe:
    def __init__(self, pairs, counts, host):
        self.pairs, self.counts, self.host, self.summed = pairs, counts, host, True


def test_device_events_read_once_complete():
    """A fused frame's device events are read at the next frame: spans in
    ns from its start event (the frame, its copies, the graph's pairs
    nested as captured), its counts, and ``device.idle`` from the frame
    before's end; a frame not complete is skipped and counted in
    ``dropped``."""
    SPANS.enable()
    name = SPANS._name
    pairs = [[name("3recon"), -1, _Event(11.0), _Event(17.0)],
             [name("3recon.sweep"), 0, _Event(11.5), _Event(16.0)]]
    probe = _Probe(pairs, [(name("render.slices_occupied"), None),
                           (name("render.slices_swept"), 64)], torch.tensor(40))
    load, out = name("frame.io.load"), name("frame.io.outputs")
    SPANS._pending = (0, _Event(10.0), _Event(19.0),
                      [(load, _Event(10.25), _Event(10.5)), (load, _Event(10.75), _Event(11.0)),
                       (out, _Event(18.0), _Event(18.5))], probe)
    SPANS._poll()
    SPANS._pending = (1, _Event(19.25), _Event(28.0), [(load, _Event(19.5), _Event(19.75))],
                      None)
    SPANS._poll()
    SPANS._pending = (2, _Event(30.0), _Event(33.0, False), [], None)
    SPANS._poll()
    got = SPANS.collect()
    rec = [(s["name"], s["frame"], s["start"], s["end"], s["clock"]) for s in got["spans"]]
    assert rec == [
        ("frame", 0, 0, 9_000_000, "device"),
        ("frame.io.load", 0, 250_000, 500_000, "device"),
        ("frame.io.load", 0, 750_000, 1_000_000, "device"),
        ("frame.io.outputs", 0, 8_000_000, 8_500_000, "device"),
        ("3recon", 0, 1_000_000, 7_000_000, "device"),
        ("3recon.sweep", 0, 1_500_000, 6_000_000, "device"),
        ("frame", 1, 0, 8_750_000, "device"),
        ("device.idle", 1, -250_000, 0, "device"),
        ("frame.io.load", 1, 250_000, 500_000, "device"),
    ]
    parents = [got["spans"][s["parent"]]["name"] if s["parent"] >= 0 else None
               for s in got["spans"]]
    assert parents == [None, "frame", "frame", "frame", "frame", "3recon", None, "frame", "frame"]
    assert got["counts"] == [{"name": "render.slices_occupied", "frame": 0, "value": 40},
                             {"name": "render.slices_swept", "frame": 0, "value": 64}]
    assert got["dropped"] == 1


def test_frame_events_made_once(monkeypatch):
    """The plain events of a fused frame (its start, its end and a pair for
    each copy) are made in the first two frames and then recorded again
    every other frame; each frame reads its own times, and the idle time
    from the frame before's end."""
    made, ticks = [], iter(range(1000))

    class Event:
        def __init__(self):
            made.append(self)

        def record(self):
            self.t = float(next(ticks))

        def query(self):
            return True

        def elapsed_time(self, other):
            return other.t - self.t

    monkeypatch.setattr(timers, "_event", Event)
    SPANS.enable()
    for _ in range(4):
        with SPANS.frame():
            SPANS.mark_start()
            for name in ("frame.io.load", "frame.io.load", "frame.io.outputs"):
                with SPANS.copies(name):
                    pass
            SPANS.mark_end()
    with SPANS.frame():         # reads the last frame's events
        pass
    assert len(made) == 2 * (2 + 2 * 3)
    got = SPANS.collect()
    assert got["dropped"] == 0
    ms = 1_000_000
    frames = sorted(_by_frame(got["spans"], "device").items())
    assert len(frames) == 4
    for k, (_, recs) in enumerate(frames):
        want = [("frame", 0, 7 * ms)] + [("device.idle", -ms, 0)] * (k > 0) + [
            ("frame.io.load", ms, 2 * ms), ("frame.io.load", 3 * ms, 4 * ms),
            ("frame.io.outputs", 5 * ms, 6 * ms)]
        assert [(s["name"], s["start"], s["end"]) for _, s in recs] == want, k


def _split_record():
    """A hand-made ``SPANS.collect()`` record of frames 0-5: host ``frame``
    and ``frame.load`` (1 + f / 10 ms), device ``frame`` (10 + f ms) with
    ``1preprocess`` (3 ms), ``3recon.sweep`` under 3recon and two
    ``frame.io.load`` copies (0.25 ms each) under it, ``device.idle`` (1 ms)
    before frames 1-5, 40 of 64 slices occupied, two captures' nodes."""
    ms = 1_000_000
    spans, counts = [], [{"name": "graph.nodes", "frame": -1, "value": 100}]

    def add(name, frame, start, end, clock="device", parent=-1):
        spans.append({"name": name, "parent": parent, "frame": frame, "start": start,
                      "end": end, "clock": clock})
        return len(spans) - 1

    for f in range(6):
        top = add("frame", f, 0, 10 * ms, "host")
        add("frame.load", f, 0, ms + f * ms // 10, "host", top)
        top = add("frame", f, 0, (10 + f) * ms)
        if f:
            add("device.idle", f, -ms, 0, parent=top)
        add("frame.io.load", f, 0, ms // 4, parent=top)
        add("frame.io.load", f, ms // 4, ms // 2, parent=top)
        add("1preprocess", f, ms, 4 * ms, parent=top)
        recon = add("3recon", f, 4 * ms, 4 * ms + ms // 2, parent=top)
        add("3recon.sweep", f, 4 * ms, 4 * ms + ms // 4, parent=recon)
        counts += [{"name": "render.slices_occupied", "frame": f, "value": 40},
                   {"name": "render.slices_swept", "frame": f, "value": 64}]
    counts.append({"name": "graph.nodes", "frame": 0, "value": 110})
    return {"spans": spans, "counts": counts, "dropped": 0, "capacity": 64}


def test_span_split_summarise():
    """``scripts.span_split.summarise``: medians over the frames outside
    the profiled chunks and the frame before each, or before the first
    chunk; None where every frame fell inside a chunk."""
    from rgbd_recon_torch.scripts.span_split import summarise

    rec = _split_record()
    got = summarise(rec, {3})           # frames 0, 1, 4, 5
    assert got["host.frame.load"] == pytest.approx(1.25)
    assert got["dev.frame"] == pytest.approx(12.5)
    assert got["dev.frame.io.load"] == pytest.approx(0.5)
    assert got["dev.3recon.sweep"] == pytest.approx(0.25)
    assert got["dev.device.idle"] == pytest.approx(1.0)
    # frames 0, 1, 4 have a next frame: 4 ms of spans over 11, 12, 15 ms
    assert got["device.span_idle_pct"] == pytest.approx(100 * (1 - 4 / 12))
    assert got["render.slices_occupied_pct"] == pytest.approx(62.5)
    assert got["graph.nodes"] == 105 and got["frames_read"] == 4 and got["dropped"] == 0
    early = summarise(rec, {3}, before=True)    # frames 0, 1
    assert early["host.frame.load"] == pytest.approx(1.05)
    assert early["device.span_idle_pct"] == pytest.approx(100 * (1 - (4 / 11 + 4 / 12) / 2))
    none = summarise(rec, set(range(6)))
    assert none["frames_read"] == 0 and none["graph.nodes"] == 105
    assert all(none[k] is None for k in ("host.frame.load", "dev.frame", "dev.device.idle",
                                         "device.span_idle_pct", "render.slices_occupied_pct"))


# -- on the card -------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA graphs run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graph_with_recorder_matches_off_cuda(scene, dev):
    """A graph captured with the recorder on replays the outputs of one
    captured with it off, bit for bit, and both the staged frame's."""
    staged, args = _pipeline(scene, dev, n=128)
    want = staged.step(*args)
    off, _ = _pipeline(scene, dev, n=128, fused=True)
    a = off.step(*args)
    SPANS.enable()
    on, _ = _pipeline(scene, dev, n=128, fused=True)
    b = [on.step(*args) for _ in range(3)]
    torch.cuda.synchronize()
    _assert_same(a, want, "off")
    for i, out in enumerate(b):
        _assert_same(out, a, f"on {i}")
    assert on._graphs._graphs[on._graphs.keys()[0]].probe is not None
    assert off._graphs._graphs[off._graphs.keys()[0]].probe is None


@pytest.mark.cuda
def test_stage_spans_inside_graph_cuda(scene, dev):
    """The stage spans timed inside the graph are > 0 and the top-level
    ones sum to no more than the frame's device span; each frame but the
    first has the device's idle time before it; nothing is dropped."""
    SPANS.enable()
    pipe, args = _pipeline(scene, dev, n=128, fused=True)
    for _ in range(4):
        pipe.step(*args)
        torch.cuda.synchronize()
    with SPANS.frame():         # reads the last frame's device events
        pass
    got = SPANS.collect()
    assert got["dropped"] == 0
    spans = got["spans"]
    dev_frames = _by_frame(spans, "device")
    assert len(dev_frames) == 4
    for n, (fid, recs) in enumerate(sorted(dev_frames.items())):
        top = next(i for i, s in recs if s["name"] == "frame")
        d = {s["name"]: s["end"] - s["start"] for _, s in recs}
        kids = [s for _, s in recs if s["parent"] == top]
        assert {s["name"] for s in kids} >= {*STAGES, "frame.io.load", "frame.io.outputs"}
        assert ("device.idle" in d) == (n > 0)
        assert all(d[s] > 0 for s in (*STAGES, "3recon.sweep", "3recon.shade"))
        assert sum(s["end"] - s["start"] for s in kids if s["name"] != "device.idle") <= d["frame"]
        assert sum(s["name"] == "frame.io.load" for s in kids) == 4    # depth, color, mv, proj
        assert d["3recon.sweep"] + d["3recon.shade"] <= d["3recon"]
    counts = {}
    for c in got["counts"]:
        counts.setdefault(c["name"], []).append(c["value"])
    assert len(counts["render.slices_occupied"]) == 4
    assert all(0 < v <= 128 for v in counts["render.slices_occupied"])
    assert counts["render.slices_swept"] == [128] * 4


@pytest.mark.cuda
def test_graph_nodes_cuda(scene, dev):
    """``graph.nodes`` is > 0 and the same for two captures of one key."""
    SPANS.enable()
    pipe, args = _pipeline(scene, dev, n=128, fused=True)
    pipe.step(*args)
    pipe._graphs.drop()
    pipe.step(*args)
    nodes = [c["value"] for c in SPANS.collect()["counts"] if c["name"] == "graph.nodes"]
    assert len(nodes) == 2 and nodes[0] == nodes[1] > 0

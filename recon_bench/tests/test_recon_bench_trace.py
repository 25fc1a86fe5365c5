"""The trace arithmetic on a hand-made event list."""
from recon_bench import discover, trace


def _gpu(name, ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _host(name, ts, dur, cat="cpu_op", **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def _eager():
    """An eager frame: kernels a, b, c in stages 1preprocess, 2integrate, 3recon."""
    ev = [_host(s, 100 * i, 90, "user_annotation")
          for i, s in enumerate(("1preprocess", "2integrate", "3recon"))]
    for i, (k, dims) in enumerate((("a", ""), ("b", ""), ("c", "[[512, 512]]"))):
        ev.append(_host("cudaLaunchKernel", 100 * i + 10, 5, "cuda_runtime",
                        correlation=50 + i, **{"External id": 7 + i}))
        ev.append(_host(f"aten::op{i}", 100 * i + 5, 20, **{"External id": 7 + i,
                                                            "Input Dims": dims}))
        ev.append(_gpu(k, 1000 + 100 * i, 10, 50 + i))
    return ev


def _replay():
    """One traced frame: a replay of a (0..10), b nested in a (5..8), c
    (20..25), then a copy outside the graph (50..52), in a frame range
    -10..60 with a clone on the host at 30..38."""
    return [
        _host(trace.FRAME_RANGE, -10, 70, "user_annotation"),
        _host("cudaGraphLaunch", -5, 2, "cuda_runtime", correlation=1),
        _host("cudaMemcpyAsync", 45, 1, "cuda_runtime", correlation=9),
        _host("aten::clone", 30, 8),
        _gpu("a", 0, 10, 1), _gpu("b", 5, 3, 1), _gpu("c", 20, 5, 1),
        _gpu("Memcpy DtoD", 50, 2, 9, "gpu_memcpy"),
    ]


def test_self_times_and_busy_union():
    gpu = trace.gpu_events(_replay())
    self_t, busy, spans = trace.self_times(gpu)
    assert [self_t[i] for i in range(4)] == [7, 3, 5, 2]
    assert busy == 17
    assert spans == [(0, 10), (20, 25), (50, 52)]


def test_eager_labels_take_stage_and_dims():
    labels = trace.eager_labels(_eager())
    assert [lab[:2] for lab in labels] == [("a", "1preprocess"), ("b", "2integrate"),
                                           ("c", "3recon")]
    assert labels[2][2] == "[[512, 512]]"


def test_buckets_gaps_and_window():
    r = trace.parse_chunk(_replay(), [(2, False)], {(2, False): trace.eager_labels(_eager())},
                          screen=(720, 1280))
    assert r["buckets"] == {"1preprocess": 7, "2integrate": 3, "3recon: sweep": 5, "io": 2}
    assert r["busy_us"] == 17 and r["window_us"] == 70
    assert r["launch_idle_us"] == 2     # the device idle under the launch at -5..-3
    assert (r["matched"], r["events"], r["replays"]) == (3, 3, 1)
    # before the replay the host was launching it; 10..20 is a launch gap
    # inside the graph; the 25 us gap at 25..50 lies under the clone; after
    # the copy the frame's range was closing
    assert r["gaps"] == [("cudaGraphLaunch", 10), ("device: between ops (< 20 us)", 10),
                         ("aten::clone", 25), (trace.FRAME_RANGE, 8)]


def test_screen_bucket_by_render_dims_or_warp_kernel():
    assert trace.bucket("x", "3recon", "[[720, 1280, 3]]", (720, 1280)) == "3recon: screen"
    assert trace.bucket("warp_screen_kernel", "3recon", "", (720, 1280)) == "3recon: screen"
    assert trace.bucket("x", "3recon", "[[512, 512]]", (720, 1280)) == "3recon: sweep"
    assert trace.bucket("x", "holefill", "", (720, 1280)) == "holefill"


def test_align_skips_an_extra_event():
    assert trace.align(["a", "m", "b"], ["a", "b"]) == [0, None, 1]
    assert trace.align(["a", "b"], ["a", "x", "b"]) == [0, 2]


def test_the_first_frame_of_a_chunk_is_not_read():
    """Two frames: the first (its launch pays the tracer's start-up) is
    traced but left out of buckets, busy time and window."""
    first = [_host(trace.FRAME_RANGE, -200, 150, "user_annotation"),
             _host("cudaGraphLaunch", -195, 100, "cuda_runtime", correlation=2),
             _gpu("a", -90, 10, 2), _gpu("b", -85, 3, 2), _gpu("c", -70, 5, 2)]
    r = trace.parse_chunk(first + _replay(), [(2, False), (2, False)],
                          {(2, False): trace.eager_labels(_eager())}, screen=(720, 1280))
    assert r["frames"] == 1 and r["replays"] == 2
    assert r["buckets"] == {"1preprocess": 7, "2integrate": 3, "3recon: sweep": 5, "io": 2}
    assert r["busy_us"] == 17 and r["window_us"] == 70


def test_idle_share_leaves_out_the_idle_under_graph_launches():
    r = trace.parse_chunk(_replay(), [(2, False)], {(2, False): trace.eager_labels(_eager())},
                          screen=(720, 1280))
    record = {"frames": r["frames"], "busy_s": r["busy_us"] / 1e6,
              "window_s": r["window_us"] / 1e6, "launch_idle_s": r["launch_idle_us"] / 1e6}
    idle = discover.reader("device.idle_pct")(record)
    assert abs(idle - 100.0 * (1.0 - 17.0 / 68.0)) < 1e-9
    assert discover.reader("device.idle_pct")(dict(record, frames=0)) is None

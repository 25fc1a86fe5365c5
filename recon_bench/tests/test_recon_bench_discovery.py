"""Cells, configurations, traffic mixes, limits and metrics are found by
name; a new cell is added as files and a BENCHMARK.json entry alone."""
import json
import os

import pytest

from recon_bench import compare, discover

from .conftest import ROOT


def test_every_cell_of_the_benchmark_resolves():
    bench = discover.benchmark(ROOT)
    for w in bench["workloads"]:
        c = discover.cell(w["name"], root=ROOT)
        assert c.config["name"] == w["config"] and c.chips == w["chips"]
        assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
        assert c.per_layer and c.limits
        for m in c.per_layer:
            assert callable(discover.reader(m["name"], ROOT))


def test_configuration_files_hold_their_source():
    bench = discover.benchmark(ROOT)
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


def test_a_throwaway_cell_added_as_files_alone(tiny_root):
    bench = os.path.join(tiny_root, "recon_bench")
    with open(os.path.join(bench, "traffic", "fast.json"), "w") as f:
        json.dump({"frames": 4, "subject": {"sphere": 1, "step_m": 0.02, "max_m": 0.05},
                   "noise": {"depth_m": 0.0, "color": 0.0},
                   "camera": {"kind": "static", "eye_offset": [0.0, 0.5, 2.5]},
                   "judge": {"count": 1, "within": 4}}, f)
    with open(os.path.join(bench, "limits", "tiny.fast.json"), "w") as f:
        json.dump({k: 0.5 for k in compare.NAMES}, f)
    with open(os.path.join(bench, "metrics", "frames_traced.py"), "w") as f:
        f.write("def read(record):\n    return float(record['frames']) or None\n")
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as f:
        b = json.load(f)
    b["workloads"].append({"name": "tiny.fast", "config": "tiny", "traffic": "fast",
                           "chips": 1, "why": "a throwaway cell"})
    b["per_layer"].append({"name": "frames_traced", "unit": "frames", "better": "higher",
                           "source": "device_trace", "layer": "device", "moves": "fps"})
    with open(path, "w") as f:
        json.dump(b, f)
    c = discover.cell("tiny.fast", root=tiny_root)
    assert c.traffic["frames"] == 4 and c.limits == {k: 0.5 for k in compare.NAMES}
    assert "frames_traced" in {m["name"] for m in c.per_layer}
    assert discover.reader("frames_traced", tiny_root)({"frames": 3}) == 3.0


@pytest.mark.parametrize("limits", [
    {"tsdf_med": 0.5},                                              # a number not compared
    {k: 0.5 for k in compare.NAMES if k != "hit_off"},              # a number left out
    dict({k: 0.5 for k in compare.NAMES}, not_held={"hit_off": "readings"}),   # both
    dict({k: 0.5 for k in compare.NAMES if k != "hit_off"}, not_held={"hit_off": ""}),
])
def test_a_limits_file_that_leaves_a_number_unheld_is_refused(tiny_root, limits):
    with open(os.path.join(tiny_root, "recon_bench", "limits", "tiny.static.json"), "w") as f:
        json.dump(limits, f)
    with pytest.raises(ValueError):
        discover.cell("tiny.static", root=tiny_root)


def test_a_number_not_held_is_named_with_its_readings(tiny_root):
    limits = dict({k: 0.5 for k in compare.NAMES if k != "hit_off"},
                  not_held={"hit_off": "program up to 3e-3, control 3e-3: no upper reading"})
    ok, checks = compare.verdict({k: 0.1 for k in compare.NAMES}, limits)
    assert ok and "hit_off" not in checks and len(checks) == len(compare.NAMES) - 1
    assert not compare.verdict({}, limits)[0]


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        discover.cell("no-such.cell", root=ROOT)

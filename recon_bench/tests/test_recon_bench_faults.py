"""``correct`` comes out false for a broken program and for the control.

The faults drive a whole run but its look for a card, on the CPU at the
tiny test size (``data/tiny.json``, limits ``data/tiny-limits.json`` set
from CPU readings at that size), with the timed path broken underneath:
a frame that returns the one before it (the state unchanged), half of the
sensors left out, the image's colors altered where they are produced. The
control (the reference computed in bfloat16 with float8 volumes, in the
program's place) runs here at the tiny size and, marked ``cuda``, on the
card at each cell's own size against the cell's own limits.
"""
import json
import os
import time

import pytest
import torch

from recon_bench import compare, discover, harness, schedule
from recon_bench.frozen import reference

from .conftest import ROOT


@pytest.fixture
def tiny_cell(tiny_root):
    bench = os.path.join(tiny_root, "recon_bench")
    with open(os.path.join(bench, "traffic", "static.json")) as f:
        tr = json.load(f)
    tr["judge"] = {"count": 1, "within": 4}      # reached in a short CPU window
    with open(os.path.join(bench, "traffic", "static.json"), "w") as f:
        json.dump(tr, f)
    torch.set_num_threads(4)
    return discover.cell("tiny.static", root=tiny_root)


def _run(cell, fault):
    return harness.run_cell(cell, 2**31 + 77, 8.0, False, "cpu", time.perf_counter(),
                            fault=fault)


def test_sound_run_is_correct(tiny_cell):
    r = _run(tiny_cell, None)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == set(tiny_cell.limits) - {compare.NOT_HELD}


@pytest.mark.parametrize("fault", ["stale", "half", "alter"])
def test_broken_program_is_not_correct(tiny_cell, fault):
    r = _run(tiny_cell, fault)
    assert not r["correct"], r["checks"]
    assert r["failed"] >= 1


def _control_fails(cell, seed, device):
    cfg = cell.config
    rig, depth, color = harness.make_inputs(cfg, cell.traffic, seed, device)
    sched = schedule.make(cfg, cell.traffic, seed)
    n = sched.judged[0]
    i, c = sched.at(n)
    mv, proj = sched.cameras[c]
    with torch.no_grad():
        ref = reference.frame(rig, cfg, depth[i], color[i], mv, proj, device)
        with reference.computing(torch.bfloat16, torch.float8_e4m3fn):
            low = reference.frame(rig, cfg, depth[i], color[i], mv, proj, device)
    got = compare.numbers({"color": low.color, "depth": low.depth, "hit": low.hit,
                           "tsdf": low.tsdf, "occupied_bricks": low.n_blocks},
                          ref, proj, float(cfg["tsdf_limit"]))
    ok, checks = compare.verdict(got, cell.limits)
    return not ok, checks


def test_control_is_not_correct_at_the_test_size(tiny_cell):
    failed, checks = _control_fails(tiny_cell, 5, torch.device("cpu"))
    assert failed, checks


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in discover.benchmark(ROOT)["workloads"]])
@pytest.mark.parametrize("seed", [101, 2**31 + 202, 303])
def test_control_is_not_correct_on_the_card(card, workload, seed):
    failed, checks = _control_fails(discover.cell(workload, root=ROOT), seed, card)
    assert failed, checks

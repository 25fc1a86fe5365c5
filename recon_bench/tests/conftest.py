"""Fixtures of the benchmark's own tests (run from the checkout's root:
``python -m pytest recon_bench/tests -q``)."""
import json
import os
import shutil
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture
def card():
    """The card, or a skip: the kernels and the measured window run only there."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this check runs on the card")
    return torch.device("cuda")


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout holding the benchmark's data files and one tiny cell
    (``tiny.static``: 2 sensors at 128x104, 128^3, 160x96) for CPU runs."""
    bench = os.path.join(tmp_path, "recon_bench")
    for d in ("traffic", "metrics", "limits", "configs"):
        shutil.copytree(os.path.join(ROOT, "recon_bench", d), os.path.join(bench, d))
    shutil.copy(os.path.join(DATA, "tiny.json"), os.path.join(bench, "configs", "tiny.json"))
    shutil.copy(os.path.join(DATA, "tiny-limits.json"),
                os.path.join(bench, "limits", "tiny.static.json"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append({"name": "tiny", "source": "a CPU test size",
                         "file": "recon_bench/configs/tiny.json", "reduced": [], "why": "tests"})
    b["workloads"].append({"name": "tiny.static", "config": "tiny", "traffic": "static",
                           "chips": 1, "why": "tests"})
    with open(os.path.join(tmp_path, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    return str(tmp_path)

"""The import checks: no run loads JAX or the JAX package, and the frozen
reference and generator load nothing of the program."""
import os
import subprocess
import sys

import pytest

from recon_bench import guard

from .conftest import ROOT


def test_names_compare_whole():
    assert guard.loaded(modules=["rgbd_recon_torch.ops", "numpy"]) == []
    assert guard.loaded(modules=["rgbd_recon_tpu.ops.x", "jax", "jaxlib.xla", "flax"]) == \
        ["flax", "jax", "jaxlib", "rgbd_recon_tpu"]


def test_frozen_sources_import_no_program():
    for f in ("reference.py", "inputs.py"):
        names = guard.imported_by(os.path.join(ROOT, "recon_bench", "frozen", f))
        assert not names & (guard.JAX_NAMES | {guard.PROGRAM}), f


def test_check_source_refuses(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import numpy\nfrom rgbd_recon_torch.ops import bricks\n")
    with pytest.raises(ImportError, match="rgbd_recon_torch"):
        guard.check_source(str(bad), {guard.PROGRAM})


def test_reference_loads_no_program_module():
    code = ("import sys; sys.path.insert(0, %r); import recon_bench.frozen.reference, "
            "recon_bench.frozen.inputs, recon_bench.schedule, recon_bench.compare; "
            "bad = sorted({m.partition('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'rgbd_recon_tpu', 'rgbd_recon_torch'}); "
            "print(bad); sys.exit(1 if bad else 0)" % ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); from recon_bench import harness, guard; "
            "import rgbd_recon_torch.runtime.pipeline; print(guard.loaded()); "
            "sys.exit(1 if guard.loaded() else 0)" % ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


def test_run_without_a_card_exits_nonzero_without_a_result():
    r = subprocess.run([sys.executable, os.path.join(ROOT, "recon_bench", "run.py"),
                        "--workload", "k4-256.static", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and r.stdout.strip() == ""

"""The integrator tier's choice (``rgbd_recon_torch.runtime.integrator``)
alone, on the CPU: one small volume per outcome, each against the choice
the JAX pipeline makes on the same rig and config (its gate on the CPU:
``use_pallas`` when given, else the XLA table integrator)."""
import numpy as np
import pytest
import torch

from rgbd_recon_tpu.runtime.pipeline import FramePipeline as JFramePipeline
from rgbd_recon_tpu.runtime.pipeline import PipelineConfig as JPipelineConfig

from rgbd_recon_torch.calibration.rig import RigCalibration
from rgbd_recon_torch.ops.tsdf import TsdfConfig
from rgbd_recon_torch.runtime import integrator
from rgbd_recon_torch.runtime.pipeline import PipelineConfig


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread (as the other test_torch_* files)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("res, over, tier, line", [
    ((128, 32, 32), dict(use_pallas=True), integrator.DENSE, "dense emit (kernel 1)"),
    ((64, 32, 32), dict(use_pallas=True, use_affine=True), integrator.BLOCK_MAJOR,
     "block-major (kernel 6; Vx % 128 = 64)"),
    ((64, 32, 32), dict(use_pallas=True, use_affine=False), integrator.WARP_TABLE,
     "warp table (kernel 7)"),
    ((48, 48, 32), dict(), integrator.TABLE, "table integrator (tsdf_fast)"),
    ((40, 40, 40), dict(), None, None),
], ids=["dense-emit", "block-major", "warp-table", "table-integrator", "reference"])
def test_choose_integrator(small_rig, res, over, tier, line):
    """``choose`` returns the tier (None on the reference path: a res that
    is not 16-aligned), its color layout (z-major for dense emit alone) and
    the log line naming it, and the JAX pipeline takes the same tier."""
    rig = RigCalibration(*(np.asarray(getattr(small_rig["rig"], f))
                           for f in RigCalibration._fields))
    kw = dict(render_width=64, render_height=48, tsdf_res=res,
              voxel_size=float(np.max(small_rig["bbox"].size) / res[0]), **over)
    logs = []
    integ = integrator.choose(rig, TsdfConfig(res, 0.01), PipelineConfig(**kw), "cpu",
                              logs.append)
    jpipe = JFramePipeline(small_rig["rig"], JPipelineConfig(**kw))
    if tier is None:
        assert integ is None and not logs and not jpipe.use_fast
        return
    assert integ.tier == tier and integ.zmajor == (tier == integrator.DENSE)
    assert logs[-1] == f"integrator at {res}: {line}", logs
    assert jpipe.use_fast and jpipe._use_pallas() == (tier != integrator.TABLE)
    assert jpipe._use_affine == (integ.affine is not None)
    assert jpipe._dense_emit == integ.zmajor

"""Reconstruction strategy base (mirrors ``rgbd_recon_tpu/models/base.py``).

≙ the reference's abstract ``Reconstruction``
(framework/reconstruction/reconstruction.hpp:11-36): virtual draw(), a timed
``drawF`` wrapper (reconstruction.cpp:35-39), resize and color-mask plumbing.
A strategy draws an image from preprocessed frames (``FramePipeline.
preprocess``) and a camera whose matrices lie on the context's device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import torch

from ..calibration.rig import DeviceRig, RigCalibration, device_rig
from ..ops.preprocess import ProcessedFrames
from ..ops.raymarch import RenderCamera
from ..utils.math import Bbox
from ..utils.timers import TimerDatabase


@dataclass
class ReconContext:
    """Shared state every strategy receives (≙ the CalibrationFiles +
    CalibVolumes + NetKinectArray trio passed to every reference ctor).
    ``device``: where the strategies compute, the card unless the caller
    asks for another; ``log``: optional callable(str)."""

    rig: RigCalibration
    bbox: Bbox
    width: int = 1280
    height: int = 720
    device: torch.device | str = "cuda"
    log: Callable[[str], None] | None = None
    _drig: DeviceRig | None = field(default=None, init=False, repr=False)

    def __post_init__(self):
        self.device = torch.device(self.device)

    def device_rig(self) -> DeviceRig:
        """The rig on the device with its forward cv volumes (the
        strategies sample cv_xyz / cv_uv per pixel); built once."""
        if self._drig is None:
            self._drig = device_rig(self.rig, self.device, volumes=True)
        return self._drig


class Reconstruction:
    name = "base"

    def __init__(self, ctx: ReconContext):
        self.ctx = ctx
        self.color_mask_mode = False
        self.viewport_offset = (0.0, 0.0)
        TimerDatabase.instance().add_timer(self.timer_name)

    @property
    def timer_name(self) -> str:
        return f"draw_{self.name}"

    def draw_with_depth(self, frames: ProcessedFrames, cam: RenderCamera):
        """(rgba f32[H, W, 4], depth f32[H, W]): the image and its depth
        buffer (view depth for the splatting strategies, +inf where empty;
        window depth for integration, 1 where a ray missed)."""
        raise NotImplementedError

    def draw(self, frames: ProcessedFrames, cam: RenderCamera) -> torch.Tensor:
        """The image, rgba f32[H, W, 4]."""
        return self.draw_with_depth(frames, cam)[0]

    def draw_f(self, frames: ProcessedFrames, cam: RenderCamera) -> torch.Tensor:
        """Timed draw (≙ Reconstruction::drawF, reconstruction.cpp:35-39):
        host clock to the synchronised image."""
        db = TimerDatabase.instance()
        db.begin(self.timer_name)
        out = self.draw(frames, cam)
        db.end(self.timer_name, sync=out)
        return out

    def resize(self, width: int, height: int) -> None:
        self.ctx.width = width
        self.ctx.height = height

    def set_color_mask_mode(self, mode: bool) -> None:
        self.color_mask_mode = mode

    def set_viewport_offset(self, x: float, y: float) -> None:
        self.viewport_offset = (x, y)

    def reload(self) -> None:
        """≙ shader reload. The JAX strategy clears its jit caches; eager
        PyTorch has nothing to recompile, so this logs that and returns."""
        if self.ctx.log is not None:
            self.ctx.log(f"{self.name}: reload: nothing to recompile (eager PyTorch)")

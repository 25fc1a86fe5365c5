"""Scripted novel-view orbit in fused mode (mirrors ``scripts/orbit_demo.py``):
reconstruct one frame and render N views on an arcball orbit (the
reference's interactive navigation, CameraNavigator.cpp), writing PNGs.

    python -m rgbd_recon_torch.scripts.orbit_demo [N_FRAMES] [OUT_DIR]
    ORBIT_WARM=block|bg|off   # default block

Each frame is one CUDA graph replay (``PipelineConfig(fused=True)``). An
orbit crosses the volume's diagonals, so its frames need several sweep
variants ``(axis, flip)``; ``ORBIT_WARM=block`` captures the other five
with ``warm_variants_async`` and waits before orbiting, ``bg`` orbits
while they are captured, ``off`` captures each at its first frame. Prints
each frame's coverage and time (host clock, synced), the frame-time max
and median, and the number of variants captured (at most 6). Runs on the
card unless ``ORBIT_DEVICE=cpu`` (the fused frame eagerly, no graphs).
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ..calibration import synthetic
from ..runtime.pipeline import FramePipeline, PipelineConfig
from ..utils.math import Bbox
from ..utils.navigator import CameraNavigator
from ..utils.png import write_png


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 12
    out_dir = argv[1] if len(argv) > 1 else "orbit_frames"
    device = torch.device(os.environ.get("ORBIT_DEVICE", "cuda"))
    warm = os.environ.get("ORBIT_WARM", "block")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (ORBIT_DEVICE=cpu runs on the CPU)")

    bbox = Bbox.default()
    rig, cams = synthetic.synthetic_rig(num_sensors=4, bbox=bbox, fwd_res=(64, 128, 64),
                                        inv_res=(96, 96, 96), width=512, height=424)
    depth, color = synthetic.render_frames(cams, synthetic.SphereScene.default(bbox))
    pipe = FramePipeline(rig, PipelineConfig(
        render_width=640, render_height=480, tsdf_res=(128, 128, 128),
        voxel_size=float(np.max(bbox.size) / 128), brick_size=0.1, fused=True),
        log=print, device=device)
    # zoom 0.45 puts the eye ~2.7 m from the subject (the navigator's
    # reference-faithful z basis is (0, 0, 6); the reference's default 2.5
    # starts 15 m out and expects the user to scroll in)
    nav = CameraNavigator(zoom=0.45)
    proj = pipe.default_camera()[1]
    os.makedirs(out_dir, exist_ok=True)

    mv0 = next(iter(nav.orbit_frames(1)))
    if warm in ("block", "bg"):
        pipe.step(depth, color, mv0, proj)      # the current variant's capture
        pipe.warm_variants_async(depth, color, mv0, proj)
        if warm == "block" and pipe._variants_thread is not None:
            pipe._variants_thread.join()

    times = []
    for f, mv in enumerate(nav.orbit_frames(n)):
        t0 = time.perf_counter()
        out = pipe.step(depth, color, mv, proj)
        cov = float(out.hit.float().mean())     # host read: the frame is done
        times.append(time.perf_counter() - t0)
        write_png(os.path.join(out_dir, f"orbit_{f:03d}.png"), out.color.cpu().numpy())
        print(f"frame {f}: coverage {cov:.3f}  {times[-1] * 1e3:.1f} ms")
    print(f"wrote {n} frames to {out_dir}; fused variants captured: "
          f"{len(pipe._graphs.keys())}")
    if times:
        print(f"frame-time trace: max {max(times) * 1e3:.1f} ms, "
              f"median {sorted(times)[len(times) // 2] * 1e3:.1f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

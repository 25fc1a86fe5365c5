"""Per-brick projected footprint statistics from the port's affine bake
(mirrors ``scripts/footprints.py``): what sizes the integration kernels'
sampling windows (``tsdf_affine.auto_window_rows`` / ``auto_window_cols``).

    python -m rgbd_recon_torch.scripts.footprints
    FP_TSDF=256 FP_SENSORS=4 FP_DEVICE=cuda    # the defaults

The bench rig (``FP_SENSORS`` Kinect-v2 sensors at 512x424, the two-sphere
scene) is built with the port's ``calibration.synthetic``; the frame's
occupied bricks come from the pipeline's own 1preprocess. It runs on the
card unless ``FP_DEVICE=cpu``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..calibration import synthetic
from ..runtime.pipeline import FramePipeline, PipelineConfig
from ..utils.math import Bbox


def half_extents(coeffs: np.ndarray, w_img: int, h_img: int):
    """(u half-extent px, v half-extent px, bake-valid) per (sensor,
    brick) from coeffs f32[K, NB, 4, NBASIS]: a conservative bound, the
    linear terms' |slope| times 7.5 plus the quadratic terms' times 7.5^2
    (basis 1, lz, ly, lx, then the six quadratics)."""
    lin = np.abs(coeffs[..., 1:4]).sum(-1) * 7.5
    quad = np.abs(coeffs[..., 4:]).sum(-1) * 7.5 ** 2
    return ((lin[..., 0] + quad[..., 0]) * w_img, (lin[..., 1] + quad[..., 1]) * h_img,
            coeffs[..., 0, 0] >= 0.0)       # an invalid pair stores u = -1


def footprints(tsdf_n: int = 256, sensors: int = 4, device: str = "cuda",
               width: int = 512, height: int = 424, fwd_res=(128, 256, 128),
               inv_res=(128, 128, 128), log=print) -> dict:
    """Print and return the u and v half-extent percentiles (p50, p99,
    max) over the bake-valid and over the occupied (sensor, brick)
    pairs."""
    bbox = Bbox.default()
    rig, cams = synthetic.synthetic_rig(num_sensors=sensors, bbox=bbox, fwd_res=fwd_res,
                                        inv_res=inv_res, width=width, height=height)
    depth, color = synthetic.render_frames(cams, synthetic.SphereScene.default(bbox))
    pipe = FramePipeline(
        rig, PipelineConfig(render_width=1280, render_height=720, tsdf_res=(tsdf_n,) * 3,
                            voxel_size=float(np.max(bbox.size) / tsdf_n), brick_size=0.1,
                            use_pallas=True, use_affine=True),
        log=lambda s: log(f"# {s}"), device=device)
    pre = pipe._pre(*pipe._sensor_inputs(depth, color))
    mask16 = pre.mask16.cpu().numpy()
    log(f"occupied bricks: {int(pre.n_occ)}")
    ext_u, ext_v, valid = half_extents(pipe.integrator.affine.coeffs.cpu().numpy(), width,
                                       height)
    occ = mask16.reshape(-1)[None, :] & valid
    stats = {}
    for name, e in (("u(x)", ext_u), ("v(y)", ext_v)):
        ev, eo = e[valid], e[occ]
        stats[name] = {k: tuple(float(f(x)) for x in (ev, eo)) for k, f in
                       (("p50", lambda x: np.percentile(x, 50)),
                        ("p99", lambda x: np.percentile(x, 99)), ("max", np.max))}
        log(f"{name} half-extent px: valid bricks p50={stats[name]['p50'][0]:.1f} "
            f"p99={stats[name]['p99'][0]:.1f} max={stats[name]['max'][0]:.1f} | "
            f"occupied p50={stats[name]['p50'][1]:.1f} p99={stats[name]['p99'][1]:.1f} "
            f"max={stats[name]['max'][1]:.1f}")
    return stats


def main() -> int:
    device = os.environ.get("FP_DEVICE", "cuda")
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (FP_DEVICE=cpu runs on the CPU)")
    footprints(int(os.environ.get("FP_TSDF", "256")), int(os.environ.get("FP_SENSORS", "4")),
               device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Generate a self-contained reference-format scene bundle (mirrors
``scripts/make_fixture.py``): ``.ks`` + RGBDemo ``.yml`` +
``.ext``/``.bbx``/``.serial`` side files + binary ``cv_xyz``/``cv_uv``/
``cv_xyz_inv`` volumes + DXT1 (or raw) ``.stream`` recordings + a benchmark
``run.conf`` — everything the reference binary reads from disk
(source/README_kinect_client.txt:2-17, calibration_volume.hpp:63-82,
NetKinectArray.cpp:510-523), written with the port's synthetic rig and
stream writer so the app can be driven end to end from these files alone.

Usage:
  python -m rgbd_recon_torch.scripts.make_fixture OUT_DIR [--sensors 4] [--frames 8]
      [--width 512 --height 424] [--fwd 128,256,128] [--inv 128,128,128]
      [--scene sphere|complex] [--raw-color] [--raw-depth] [--screen 1280x720]
      [--voxel-size 0.00859] [--time-limit 60]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--sensors", type=int, default=4)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=424)
    ap.add_argument("--fwd", default="128,256,128")
    ap.add_argument("--inv", default="128,128,128")
    ap.add_argument("--scene", default="sphere", choices=["sphere", "complex"])
    ap.add_argument("--raw-color", action="store_true",
                    help="raw RGB888 streams instead of DXT1")
    ap.add_argument("--raw-depth", action="store_true",
                    help="f32 depth instead of the sqrt-mapped u8 "
                         "compression (pre_depth.fs:51-61)")
    ap.add_argument("--screen", default="1280x720")
    ap.add_argument("--voxel-size", type=float, default=None,
                    help="default: bbox_x/256 = 0.0078125 (derived res "
                         "256x288x256 — x a whole number of 128-voxel "
                         "rows, so the dense-emit kernel engages)")
    ap.add_argument("--time-limit", type=int, default=60)
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    from ..calibration import synthetic
    from ..io.stream import FrameFormat, StreamWriter
    from ..utils.math import Bbox

    bbox = Bbox.default()
    fwd = tuple(int(v) for v in args.fwd.split(","))
    inv = tuple(int(v) for v in args.inv.split(","))
    compressed_rgb = 0 if args.raw_color else 1
    compressed_depth = not args.raw_depth

    t0 = time.time()
    print(f"writing reference-format scene to {args.out_dir} "
          f"({args.sensors} sensors, fwd {fwd}, inv {inv}) ...")
    ks = synthetic.write_reference_scene(
        args.out_dir, num_sensors=args.sensors, bbox=bbox,
        fwd_res=fwd, inv_res=inv, width=args.width, height=args.height,
        compressed_rgb=compressed_rgb, compressed_depth=compressed_depth,
    )
    print(f"  scene files: {time.time()-t0:.0f}s")

    t0 = time.time()
    cams = synthetic.make_cameras(args.sensors, bbox, width=args.width,
                                  height=args.height)
    scene = synthetic.make_scene(args.scene, bbox)
    depth, color = synthetic.render_frames(cams, scene)
    rec = os.path.join(args.out_dir, "recordings")
    os.makedirs(rec, exist_ok=True)
    fmt = FrameFormat(
        width=args.width, height=args.height,
        width_c=args.width, height_c=args.height,
        compressed_rgb=compressed_rgb, compressed_depth=compressed_depth,
    )
    paths = [os.path.join(rec, f"sensor{i}.stream")
             for i in range(args.sensors)]
    w = StreamWriter(paths, fmt)
    rng = np.random.default_rng(11)
    for i in range(args.frames):
        # per-frame depth jitter: distinct stream content like a live rig
        d_i = depth + rng.uniform(0, 2e-3, depth.shape).astype(np.float32) \
            * (depth > 0)
        w.write(d_i, color)
    w.close()
    print(f"  {args.frames} frames x {args.sensors} streams "
          f"({'DXT1' if compressed_rgb else 'raw'}): {time.time()-t0:.0f}s")

    sw, sh = (int(v) for v in args.screen.split("x"))
    voxel = args.voxel_size or float(bbox.size[0] / 256.0)
    conf = os.path.join(args.out_dir, "run.conf")
    with open(conf, "w") as f:
        f.write(
            "recon_mode: 1\n"
            f"screenWidth: {sw}\nscreenHeight: {sh}\n"
            "play: true\n"
            f"voxel_size: {voxel}\nbrick_size: 0.1\ntsdf_limit: 0.01\n"
            "zoom: 0.45\n"
            f"time_limit: {args.time_limit}\n"
        )
    print(f"wrote {ks} + {conf}")
    print("drive with:\n  python -m rgbd_recon_torch.app "
          f"{ks} {conf} -recordings {rec}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Offline inverse-calibration bake tool (mirrors ``scripts/calib_inverter.py``;
≙ the reference's second binary, source/calib_inverter.cpp:12-73).

    python -m rgbd_recon_torch.scripts.calib_inverter <scene.ks> [-s voxel_size] [-device cpu]

Parses the .ks scene (kinect lines + bbx), derives the inverse-volume
resolution as ceil(bbox_dims / voxel_size) (default 0.007 m,
calib_inverter.cpp:10,66-68), inverts each sensor's forward cv_xyz volume
(``calibration.inverter``: blocked 8-NN + inverse-distance weights on the
card unless ``-device cpu``) and writes ``<name>cv_xyz_inv`` next to the
calibration files.
"""
from __future__ import annotations

import os
import sys

import numpy as np


def main(argv=None) -> int:
    from ..calibration.inverter import CalibrationInverter
    from ..io.cmdparser import CMDParser
    from ..io.ks import parse_ks

    p = CMDParser("ks_file")
    p.add_opt("s", 1, "voxel_size", "set size of voxel in m (default 0.007)")
    p.add_opt("device", 1, "device", "cuda (default) or cpu")
    p.init(list(sys.argv[1:] if argv is None else argv))

    voxel_size = p.get_opts_float("s")[0] if p.is_opt_set("s") else 0.007
    device = p.get_opts_string("device")[0] if p.is_opt_set("device") else "cuda"
    if not p.args or not p.args[0].endswith(".ks"):
        raise SystemExit("No .ks file specified")
    ks_path = p.args[0]

    calib_files, bbox = parse_ks(ks_path)
    dims = bbox.size
    volume_res = tuple(int(np.ceil(float(d) / voxel_size)) for d in dims)
    print(f"using resolution {volume_res[0]}, {volume_res[1]}, {volume_res[2]}")

    inv = CalibrationInverter(calib_files, bbox, device=device)
    inv.calculate_inverse_volumes(volume_res)
    resource_path = os.path.dirname(ks_path) or "."
    inv.write_inverse_volumes(resource_path + os.sep)
    print(f"wrote {len(calib_files)} inverse volumes to {resource_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

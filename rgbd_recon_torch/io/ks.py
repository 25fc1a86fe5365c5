""".ks scene file parser (mirrors ``rgbd_recon_tpu/io/ks.py``).

Format (kinect_client.cpp:204-236): whitespace-separated tokens; ``kinect
<calib.yml>`` lines add sensors (relative paths resolve against the .ks
file's directory), ``bbx x0 y0 z0 x1 y1 z1`` overrides the default bbox.
"""
from __future__ import annotations

import os

import numpy as np

from ..utils.math import Bbox


def parse_ks(path: str) -> tuple[list[str], Bbox]:
    calib_files: list[str] = []
    bbox_min = np.array([-1.0, 0.0, -1.0], np.float32)
    bbox_max = np.array([1.0, 2.2, 1.0], np.float32)
    resource_path = os.path.dirname(path)
    with open(path) as f:
        tokens = f.read().split()
    i = 0
    while i < len(tokens):
        tok = tokens[i]
        if tok == "kinect":
            i += 1
            name = tokens[i]
            if name.startswith("/") or (len(name) > 1 and name[1] == ":"):
                calib_files.append(name)
            else:
                calib_files.append(os.path.join(resource_path, name))
        elif tok == "bbx":
            vals = [float(tokens[i + 1 + j]) for j in range(6)]
            bbox_min = np.array(vals[:3], np.float32)
            bbox_max = np.array(vals[3:], np.float32)
            i += 6
        i += 1
    return calib_files, Bbox(bbox_min, bbox_max)

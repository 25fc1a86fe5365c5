"""Reference calibration-file parsing: RGBDemo-0.5.0 ``.yml`` + side files (mirrors
``rgbd_recon_tpu/calibration/files.py``).

≙ KinectCalibrationFile (framework/calibration/KinectCalibrationFile.cpp:
148-580 ``parse``, :727-769 ``loadLocalTransform``) and CalibrationFiles
(calibration_files.cpp:8-100): the per-sensor metadata layer that turns a
``.ks`` scene into frame formats + rig geometry. Faithful quirks:

* the yml is parsed as a whitespace token stream, not structured YAML; keys
  are literal tokens like ``rgb_intrinsics:``; values follow after a ``[``
  token (``advanceToNextToken``, :585-597)
* list entries are read by chopping the LAST character off the token before
  atof — the trailing comma (``kommaStringToFloat``, :605-609); the closing
  entry uses plain atof (``getNextFloat``) so a trailing ``]`` parses as 0
  after the number (atof stops at the bracket)
* intrinsics read only (fu, cu, fv, cv) from the 3x3, skipping the
  structural zeros (:170-182)
* missing ``.ext{,2,3}`` files default to identity rotation / zero
  translation (:407-412,461-466,514-519); a missing ``.bbx`` defaults to
  pos [-100,100]^3 and NEGATIVE box min=max=-100 (:567-574 — "this is
  correct!")
* defaults: near 0.3, far 7.0, compressed rgb 1, compressed depth False,
  min_length 0.0125 (:89-97)
"""
from __future__ import annotations

import math
import os
import re
from dataclasses import dataclass, field

import numpy as np

_FLOAT_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?")


def _atof(token: str) -> float:
    """C atof: parse the longest valid leading float, else 0.0."""
    m = _FLOAT_RE.match(token.strip())
    return float(m.group(0)) if m else 0.0


def _komma_float(token: str) -> float:
    """kommaStringToFloat: drop the last char (the comma), then atof."""
    return _atof(token[:-1])


class _TokenStream:
    def __init__(self, text: str):
        self.tokens = text.split()
        self.i = 0

    def next(self) -> str | None:
        if self.i >= len(self.tokens):
            return None
        t = self.tokens[self.i]
        self.i += 1
        return t

    def advance_to(self, search: str) -> None:
        while True:
            t = self.next()
            if t is None or t == search:
                return

    def next_komma_float(self) -> float:
        return _komma_float(self.next() or "")

    def next_float(self) -> float:
        return _atof(self.next() or "")


def _read_floats(path: str, n: int) -> list[float] | None:
    """First n whitespace floats of a side file, or None if absent."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        toks = f.read().split()
    if len(toks) < n:
        return None
    return [float(t) for t in toks[:n]]


def _rot3_from9(vals: list[float]) -> np.ndarray:
    """9 file-order floats -> 3x3 (stored in file order; gloost fills
    columns 0/1/2 of its 4x4 the same way)."""
    return np.array(vals, np.float64).reshape(3, 3)


@dataclass
class KinectCalibrationFile:
    """Parsed per-sensor calibration (the metadata subset the runtime needs;
    the heavy lookup geometry lives in the binary cv volumes)."""

    path: str
    # color camera
    color_focal: tuple[float, float] = (0.0, 0.0)
    color_principal: tuple[float, float] = (0.0, 0.0)
    distortion_rgb: np.ndarray = field(default_factory=lambda: np.zeros(5))
    # depth camera
    depth_focal: tuple[float, float] = (0.0, 0.0)
    depth_principal: tuple[float, float] = (0.0, 0.0)
    distortion_d: np.ndarray = field(default_factory=lambda: np.zeros(5))
    # relative depth->color transform (yml R:/T:)
    rel_rotation: np.ndarray = field(default_factory=lambda: np.eye(3))
    rel_translation: np.ndarray = field(default_factory=lambda: np.zeros(3))
    # world transforms (.ext/.ext2/.ext3)
    world_rotation: np.ndarray = field(default_factory=lambda: np.eye(3))
    world_translation: np.ndarray = field(default_factory=lambda: np.zeros(3))
    world_rotation2: np.ndarray = field(default_factory=lambda: np.eye(3))
    world_translation2: np.ndarray = field(default_factory=lambda: np.zeros(3))
    world_rotation3: np.ndarray = field(default_factory=lambda: np.eye(3))
    world_translation3: np.ndarray = field(default_factory=lambda: np.zeros(3))
    # sizes / ranges / flags
    width: int = 0
    height: int = 0
    width_c: int = 0
    height_c: int = 0
    near: float = 0.3
    far: float = 7.0
    compressed_rgb: int = 1
    compressed_depth: bool = False
    min_length: float = 0.0125
    # .bbx clipping boxes
    pos_min: np.ndarray = field(default_factory=lambda: np.full(3, -100.0))
    pos_max: np.ndarray = field(default_factory=lambda: np.full(3, 100.0))
    neg_min: np.ndarray = field(default_factory=lambda: np.full(3, -100.0))
    neg_max: np.ndarray = field(default_factory=lambda: np.full(3, -100.0))
    # .local / .serial
    local_translation: np.ndarray = field(default_factory=lambda: np.zeros(3))
    local_rotation_deg: np.ndarray = field(default_factory=lambda: np.zeros(3))
    serial: str = ""

    def parse(self) -> "KinectCalibrationFile":
        with open(self.path) as f:
            ts = _TokenStream(f.read())
        while True:
            token = ts.next()
            if token is None:
                break
            if token == "rgb_intrinsics:":
                ts.advance_to("[")
                fu = ts.next_komma_float()
                ts.next()          # structural 0 (row 0, col 1)
                cu = ts.next_komma_float()
                ts.next()          # structural 0 (row 1, col 0)
                fv = ts.next_komma_float()
                cv = ts.next_komma_float()
                self.color_focal = (fu, fv)
                self.color_principal = (cu, cv)
            elif token == "rgb_distortion:":
                ts.advance_to("[")
                vals = [ts.next_komma_float() for _ in range(4)] + [ts.next_float()]
                self.distortion_rgb = np.array(vals)
            elif token == "depth_intrinsics:":
                ts.advance_to("[")
                fu = ts.next_komma_float()
                ts.next()
                cu = ts.next_komma_float()
                ts.next()
                fv = ts.next_komma_float()
                cv = ts.next_komma_float()
                self.depth_focal = (fu, fv)
                self.depth_principal = (cu, cv)
            elif token == "depth_distortion:":
                ts.advance_to("[")
                vals = [ts.next_komma_float() for _ in range(4)] + [ts.next_float()]
                self.distortion_d = np.array(vals)
            elif token == "R:":
                ts.advance_to("[")
                vals = [ts.next_komma_float() for _ in range(8)] + [ts.next_float()]
                self.rel_rotation = _rot3_from9(vals)
            elif token == "T:":
                ts.advance_to("[")
                vals = [ts.next_komma_float() for _ in range(2)] + [ts.next_float()]
                self.rel_translation = np.array(vals)
            elif token == "rgb_size:":
                ts.advance_to("[")
                self.width_c = int(ts.next_komma_float())
                self.height_c = int(ts.next_float())
            elif token == "depth_size:":
                ts.advance_to("[")
                self.width = int(ts.next_komma_float())
                self.height = int(ts.next_float())
            elif token == "near_far:":
                ts.advance_to("[")
                self.near = ts.next_komma_float()
                self.far = ts.next_float()
            elif token == "compress_rgb:":
                ts.advance_to("[")
                self.compressed_rgb = int(ts.next_komma_float())
                ts.next_float()
            elif token == "min_length:":
                ts.advance_to("[")
                self.min_length = ts.next_komma_float()
                ts.next_float()
            elif token == "compress_depth:":
                ts.advance_to("[")
                self.compressed_depth = bool(int(ts.next_komma_float()))
                ts.next_float()
            # unknown tokens are silently skipped (KinectCalibrationFile.cpp:354)

        self._parse_side_files()
        return self

    def _ext_path(self, suffix: str) -> str:
        # e_filepath.replace(end-3, end, suffix): swap the "yml" extension
        return self.path[:-3] + suffix

    def _parse_side_files(self) -> None:
        for suffix, rot_attr, t_attr in (
            ("ext", "world_rotation", "world_translation"),
            ("ext2", "world_rotation2", "world_translation2"),
            ("ext3", "world_rotation3", "world_translation3"),
        ):
            vals = _read_floats(self._ext_path(suffix), 12)
            if vals is not None:
                setattr(self, t_attr, np.array(vals[:3]))
                setattr(self, rot_attr, _rot3_from9(vals[3:]))
            else:
                setattr(self, t_attr, np.zeros(3))
                setattr(self, rot_attr, np.eye(3))

        bbx = _read_floats(self._ext_path("bbx"), 12)
        if bbx is not None:
            self.pos_min = np.array(bbx[0:3])
            self.pos_max = np.array(bbx[3:6])
            self.neg_min = np.array(bbx[6:9])
            self.neg_max = np.array(bbx[9:12])

        local = _read_floats(self._ext_path("local"), 6)
        if local is not None:
            self.local_translation = np.array(local[:3])
            self.local_rotation_deg = np.array(local[3:])

        serial_path = self._ext_path("serial")
        if os.path.exists(serial_path):
            with open(serial_path) as f:
                toks = f.read().split()
            if toks:
                self.serial = toks[0]

    @property
    def local_rotation_rad(self) -> np.ndarray:
        return self.local_rotation_deg * math.pi / 180.0

    def intrinsic_rgb(self) -> np.ndarray:
        fu, fv = self.color_focal
        cu, cv = self.color_principal
        return np.array([[fu, 0, cu], [0, fv, cv], [0, 0, 1]], np.float64)

    def intrinsic_d(self) -> np.ndarray:
        fu, fv = self.depth_focal
        cu, cv = self.depth_principal
        return np.array([[fu, 0, cu], [0, fv, cv], [0, 0, 1]], np.float64)


class CalibrationFiles:
    """Owns the N per-sensor calibration files and exposes the common
    metadata (≙ calibration_files.cpp — sizes/flags come from sensor 0)."""

    def __init__(self, calib_filenames: list[str]):
        self.filenames = list(calib_filenames)
        self.calibs = [KinectCalibrationFile(p) for p in self.filenames]
        self.reload()

    def reload(self) -> None:
        for c in self.calibs:
            c.parse()

    @property
    def num(self) -> int:
        return len(self.calibs)

    @property
    def width(self) -> int:
        return self.calibs[0].width

    @property
    def height(self) -> int:
        return self.calibs[0].height

    @property
    def width_c(self) -> int:
        return self.calibs[0].width_c

    @property
    def height_c(self) -> int:
        return self.calibs[0].height_c

    @property
    def min_length(self) -> float:
        return self.calibs[0].min_length

    @property
    def compressed_rgb(self) -> int:
        return self.calibs[0].compressed_rgb

    @property
    def compressed_depth(self) -> bool:
        return self.calibs[0].compressed_depth

    def frame_format(self):
        """Derive the stream FrameFormat from the parsed metadata — replaces
        the hand-authored formats of round 1 (NetKinectArray::init sizes,
        NetKinectArray.cpp:112-140)."""
        from ..io.stream import FrameFormat

        return FrameFormat(
            width=self.width, height=self.height,
            width_c=self.width_c, height_c=self.height_c,
            compressed_rgb=self.compressed_rgb,
            compressed_depth=self.compressed_depth,
        )


def file_value(path: str, default: float | None = None) -> float | None:
    """≙ FileValue (io/FileValue.h:10-26): read one float from a file if it
    exists (groundlevel overrides etc)."""
    if not os.path.exists(path):
        return default
    with open(path) as f:
        toks = f.read().split()
    return float(toks[0]) if toks else default


def load_scene(ks_path: str, inv_path: str | None = None):
    """One-call load of a reference scene: ``.ks -> (.yml metadata, rig
    volumes, FrameFormat, bbox)``.

    Returns (CalibrationFiles, RigCalibration, FrameFormat, Bbox). Ref flow:
    kinect_client.cpp:204-246 (parse .ks, CalibrationFiles, CalibVolumes +
    loadInverseCalibs)."""
    from ..io.ks import parse_ks
    from .rig import load_rig

    calib_files, bbox = parse_ks(ks_path)
    cfs = CalibrationFiles(calib_files)
    rig = load_rig(calib_files, bbox, inv_path=inv_path)
    return cfs, rig, cfs.frame_format(), bbox

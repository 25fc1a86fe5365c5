"""The general traffic generator: which input frame and which camera each
frame of a run gets, and which frames the comparison judges.

A traffic mix is a data file of parameters (``traffic/<name>.json``):

- ``frames``: distinct input frames made in set-up, played ``pingpong``
  (forward, then back: 0..F-1, F-2..1, ...);
- ``subject``, ``noise``: read by ``frozen.inputs``;
- ``camera``: ``{"kind": "static", "eye_offset": [...]}`` (one view at the
  volume center + offset), or ``{"kind": "orbit", "distance_m", "offset",
  "hold", "turn_deg"}``: one view per sweep ``(axis, flip)`` in a seeded
  order, the eye ``distance_m`` from the center along the axis with the
  other two coordinates of ``offset``, each view held for ``hold`` frames
  while the eye turns ``turn_deg`` a frame about the vertical through the
  center;
- ``judge``: ``{"count", "within", "group"}``: the frames whose outputs the
  comparison judges, ``count`` of them in distinct groups of ``group``
  consecutive frames among frames 1 .. ``within`` - 1, drawn from the seed.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .frozen.inputs import bbox_of, look_at, perspective, seed_int

VARIANTS = tuple((a, f) for a in (2, 0, 1) for f in (False, True))   # sweep (axis, flip)


def vol_to_world(cfg: dict) -> np.ndarray:
    bbox = bbox_of(cfg)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = bbox.size
    m[:3, 3] = bbox.min
    return m


def pick_axis(modelview: np.ndarray, v2w: np.ndarray) -> tuple[int, bool]:
    """The sweep (axis, flip) a view takes: the volume axis most aligned
    with the view direction, and whether the eye is on its high side (a
    copy of the port's ``raymarch_fast.pick_axis`` at commit c43690d)."""
    inv = np.linalg.inv(np.asarray(modelview) @ np.asarray(v2w))
    eye, fwd = inv[:3, 3], -inv[:3, 2]
    axis = int(np.argmax(np.abs(fwd)))
    return axis, bool(eye[axis] > 0.5)


class Schedule(NamedTuple):
    cameras: list            # [(modelview, proj)], one a frame, cycled
    variants: list           # the sweep (axis, flip) of each camera
    frames: int              # distinct input frames
    judged: list             # frame indices whose outputs are judged

    def at(self, n: int) -> tuple[int, int]:
        """(input frame, camera) of the run's frame ``n``."""
        period = max(1, 2 * self.frames - 2)
        p = n % period
        return (p if p < self.frames else period - p), n % len(self.cameras)


def make(cfg: dict, traffic: dict, seed: int) -> Schedule:
    rng = np.random.default_rng([seed_int(seed), 1])
    center = bbox_of(cfg).center
    w, h = cfg["render"]["width"], cfg["render"]["height"]
    proj = perspective(50.0, w / h, 0.1, 200.0)
    cam = traffic["camera"]
    v2w = vol_to_world(cfg)
    if cam["kind"] == "static":
        mv = look_at(center + np.asarray(cam["eye_offset"], np.float32), center, [0, 1, 0])
        cameras = [(mv, proj)]
    elif cam["kind"] == "orbit":
        hold = cam["hold"]
        cameras, views = [], []
        for vi in rng.permutation(len(VARIANTS)):
            views.append(VARIANTS[vi])
            axis, flip = VARIANTS[vi]
            d = np.asarray(cam["offset"], np.float64)
            d[axis] = cam["distance_m"] if flip else -cam["distance_m"]
            for j in range(hold):
                a = np.radians(cam["turn_deg"] * j)
                rot = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
                mv = look_at(center + rot @ d, center, [0, 0, 1] if axis == 1 else [0, 1, 0])
                cameras.append((mv, proj))
    else:
        raise ValueError(f"unknown camera kind {cam['kind']!r}")
    variants = [pick_axis(mv, v2w) for mv, _ in cameras]
    if cam["kind"] == "orbit":
        for i, v in enumerate(variants):
            want = views[i // hold]
            if v != want:
                raise ValueError(f"orbit camera {i} sweeps {v}, its view {want}")
    return Schedule(cameras, variants, traffic["frames"], judged_frames(traffic["judge"], rng))


def judged_frames(judge: dict, rng) -> list[int]:
    """``count`` frames among 1 .. ``within`` - 1, each in its own group
    of ``group`` consecutive frames."""
    group = judge.get("group", 1)
    frames = np.arange(1, judge["within"])
    groups = np.unique(frames // group)
    picked = rng.choice(groups, judge["count"], replace=False)
    return sorted(int(rng.choice(frames[frames // group == g])) for g in picked)

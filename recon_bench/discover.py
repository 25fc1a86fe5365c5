"""Finds everything of a cell by name: ``BENCHMARK.json`` at the checkout's
root names the cell, its configuration and its traffic; the files are

- a configuration: the ``file`` its ``configs`` entry names;
- a traffic mix: ``traffic/<traffic>.json``;
- the limits of a cell's comparison: ``limits/<cell>.json``;
- a per-layer metric: ``metrics/<name>.py``, whose ``read(record)`` returns
  one number or None.

A cell, a configuration, a traffic mix or a metric is added as new files
and a new entry of ``BENCHMARK.json``; nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
import os
from typing import NamedTuple

from . import compare

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, root: str = ROOT, bench: dict | None = None) -> Cell:
    bench = bench if bench is not None else benchmark(root)
    here = os.path.join(root, os.path.relpath(HERE, ROOT))
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    c = next(c for c in bench["configs"] if c["name"] == w["config"])
    cfg = _json(os.path.join(root, c["file"]))
    traffic = _json(os.path.join(here, "traffic", w["traffic"] + ".json"))
    limits = _json(os.path.join(here, "limits", name + ".json"))
    compare.check_limits(limits)
    return Cell(name, w["chips"], cfg, traffic, limits, bench["end_to_end"], bench["per_layer"])


def reader(metric: str, root: str = ROOT):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = os.path.join(root, os.path.relpath(HERE, ROOT), "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(f"recon_bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

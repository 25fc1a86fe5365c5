"""Import checks: which top-level modules a run may hold.

A name is the part of a module's dotted name before the first dot,
compared whole: ``rgbd_recon_torch`` is not ``rgbd_recon_tpu``'s child.
"""
from __future__ import annotations

import ast
import sys

JAX_NAMES = frozenset({"jax", "jaxlib", "flax", "rgbd_recon_tpu"})
PROGRAM = "rgbd_recon_torch"


def loaded(forbidden=JAX_NAMES, modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default
    ``sys.modules``), sorted."""
    names = {m.partition(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(forbidden))


def imported_by(path: str) -> set[str]:
    """Top-level names that the import statements of the source file at
    ``path`` name (relative imports excluded)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.partition(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level and node.module:
            out.add(node.module.partition(".")[0])
    return out


def check_source(path: str, forbidden) -> None:
    """Raise ImportError if the file at ``path`` imports a forbidden name."""
    bad = sorted(imported_by(path) & set(forbidden))
    if bad:
        raise ImportError(f"{path} imports {', '.join(bad)}, which it must not")

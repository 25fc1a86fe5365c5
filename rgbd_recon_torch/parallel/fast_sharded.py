"""The brick-sparse fast path over z-slabs (mirrors
``rgbd_recon_tpu/parallel/fast_sharded.py``).

* The VOLUME is split along z: rank r owns brick layers [r nbz/n, (r+1)
  nbz/n), i.e. voxel slab [r vz/n, (r+1) vz/n). The brick order is (bz, by,
  bx), so a z-slab is the contiguous brick range [r nb/n, (r+1) nb/n) of
  the affine coefficients, the warp table and the window origins.
* INTEGRATION is embarrassingly parallel: each rank fuses the occupied
  bricks of its slab into a dense slab with the pipeline's integrator cut
  to the slab's bricks (``Integrator.slab``), at capacity
  ``min(max_bricks, nb / n)``. As in JAX, no depth-band cull: the step
  equals the single-card step with ``brick_cull=False``.
* The SWEEP decomposes along the camera's sweep axis. For an x- or
  y-dominant camera the slabs are first resharded onto that axis with one
  all-to-all (each rank keeps 1/n of the volume in flight). Each rank
  sweeps its slab as a logical k-window (``raymarch_fast.SweepWindow``)
  whose carry starts from a 2-slice halo of the logically previous slab
  (an all-gather of the halo slices), and the five hit planes of every
  window are all-gathered and folded front to back with ``merge_sweep``.
* Preprocessing is sensor-parallel when n divides K, as in
  ``sharding``; shading and colorfill run on the merged planes on every
  rank (unsplit, as there).

The per-rank stages are functions of slab tensors (``Integrator.slab``,
``reshard_chunks`` / ``reshard_join``, ``halo_send`` / ``window_of``,
``sweep_local``, ``pack_planes`` / ``merge_planes``): ``fast_sharded_step``
wires them with collectives, ``sweep_slabs`` / ``run_slabs`` run every rank
in turn in one process and pass the tensors between them by hand.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import bricks as brick_ops
from ..ops import raymarch as rm
from ..ops import raymarch_fast as rmf
from ..ops.tsdf_fast import BRICK
from .sharding import (Mesh, all_gather, all_to_all, check_mesh, preprocess_sensors,
                       preprocess_sharded, split_range)


class SlabPlan(NamedTuple):
    """The z-slab decomposition of ``pipe``'s volume over n ranks."""

    nb_local: int           # bricks per slab
    max_bricks: int         # per-slab capacity


def slab_plan(pipe, n: int) -> SlabPlan:
    """Refuses what the JAX step refuses: no brick-sparse path, or a z res
    that is not whole brick layers per rank."""
    if not pipe.use_fast:
        raise ValueError("fast_sharded_step needs the brick-sparse path")
    vx, vy, vz = pipe.tsdf_cfg.res
    if vz % (n * BRICK):
        raise ValueError(f"fast_sharded_step needs vz % (16 * n) == 0: {(vz, n)}")
    nb = (vx // BRICK) * (vy // BRICK) * (vz // BRICK)
    return SlabPlan(nb // n, min(pipe.max_bricks, nb // n))


def check_axis(pipe, n: int, axis: int) -> None:
    """The all-to-all splits the sweep axis into n equal slabs."""
    res = pipe.tsdf_cfg.res[axis]
    if res % n:
        raise ValueError(f"sweep axis {axis} res {res} not divisible by mesh size {n}")


def occupancy(pipe, frames):
    """Brick marking (kernel 4 on the card), the 16^3 block mask (no
    depth-band cull) and the occupied ratio, as every rank computes them."""
    counts = brick_ops.mark_bricks(frames.world, frames.world_valid, pipe.brick_grid)
    mask = brick_ops.occupancy_mask(counts, pipe.cfg.min_voxels_per_brick)
    mask16 = brick_ops.block_occupancy(mask, pipe.brick_grid, pipe.tsdf_cfg.res, BRICK)
    return mask16, brick_ops.occupied_ratio(mask)


def _split_axes(axis: int, zmajor: bool) -> tuple[int, int]:
    """Array axes of the sweep coordinate in the TSDF and the color volume."""
    arr = 2 - axis
    return arr, (arr + 1 if zmajor and arr else arr)


def reshard_chunks(vol_l: torch.Tensor, cvol_l: torch.Tensor, axis: int, n: int,
                   zmajor: bool) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """A z-slab cut into the n pieces the ranks of an ``axis``-slab
    decomposition own (piece j goes to rank j)."""
    a, ca = _split_axes(axis, zmajor)
    return list(zip(vol_l.chunk(n, a), cvol_l.chunk(n, ca)))


def reshard_join(pieces: list[tuple[torch.Tensor, torch.Tensor]]):
    """The pieces every rank sent here, in rank order -> this rank's
    ``axis``-slab (all of z)."""
    return (torch.cat([p[0] for p in pieces]).contiguous(),
            torch.cat([p[1] for p in pieces]).contiguous())


def halo_send(vol_a: torch.Tensor, cvol_a: torch.Tensor, axis: int, flip: bool,
              zmajor: bool) -> torch.Tensor:
    """The two density slices and the color slice the logically next slab
    starts from, f32[6, R, C] (d1, d2, rgba): this slab's last slices in
    sweep order."""
    vp, cp = rmf.sweep_planes(vol_a, cvol_a, axis, zmajor)
    i1, i2 = (0, 1) if flip else (vp.shape[0] - 1, vp.shape[0] - 2)
    return torch.cat([vp[i1][None].float(), vp[i2][None].float(), cp[i1].float()])


def window_of(halos: list[torch.Tensor], rank: int, n: int, ns: int,
              flip: bool) -> rmf.SweepWindow:
    """Rank ``rank``'s sweep window from every rank's ``halo_send``."""
    src = rank + 1 if flip else rank - 1
    valid = 0 <= src < n
    h = halos[src] if valid else torch.zeros_like(halos[rank])
    logical = (n - 1 - rank) if flip else rank
    return rmf.SweepWindow(logical * (ns // n), ns, h[1], h[0], h[2:6], valid)


def slab_flags(pipe, mask16: torch.Tensor, axis: int):
    """The sweep's per-slice flags of the whole axis (host array, one sync)
    or None without ``skip_space``."""
    if not pipe.cfg.skip_space:
        return None
    return rmf.slab_occupancy(mask16, axis, pipe.tsdf_cfg.res[axis])


def sweep_local(pipe, vol_a: torch.Tensor, cvol_a: torch.Tensor, flags, cam,
                axis: int, flip: bool, window: rmf.SweepWindow, rank: int,
                n: int) -> rmf.SweepResult:
    """The windowed sweep of rank ``rank``'s ``axis``-slab."""
    ns_l = pipe.tsdf_cfg.res[axis] // n
    occ = flags[rank * ns_l:(rank + 1) * ns_l] if flags is not None else None
    return rmf.sweep(vol_a, cvol_a, cam, pipe.bbox, float(pipe.tsdf_cfg.limit), axis, flip,
                     rmf.SweepConfig(res=pipe._sweep_res()), occ,
                     zmajor=pipe.integrator.zmajor, window=window)


def pack_planes(res: rmf.SweepResult) -> torch.Tensor:
    """The five hit planes as one f32[Ti, Si, 10] tensor."""
    return torch.cat([res.hit[..., None], res.hit_s[..., None], res.hit_color,
                      res.hit_grad, res.num_samples[..., None]], dim=-1)


def merge_planes(planes: list[torch.Tensor], flip: bool, base_extent,
                 eye_p: torch.Tensor) -> rmf.SweepResult:
    """Every rank's packed planes (rank order) folded front to back in
    logical order (reversed when ``flip``)."""
    def unpack(p):
        return rmf.SweepResult(p[..., 0], p[..., 1], p[..., 2:6], p[..., 6:9], base_extent,
                               eye_p, p[..., 9])

    order = planes[::-1] if flip else planes
    merged = unpack(order[0])
    for p in order[1:]:
        merged = rmf.merge_sweep(merged, unpack(p))
    return merged


def finish(pipe, merged: rmf.SweepResult, cam, axis: int, flip: bool, tsdf, occupied,
           n_occ):
    """Shading and colorfill of the merged planes (every rank)."""
    from ..runtime.pipeline import FrameOutput

    cfg = pipe.cfg
    out = rmf.shade_sweep(merged, cam, pipe.bbox, axis, flip, pipe.tsdf_cfg.res[axis],
                          rm.RenderParams(shade_mode=cfg.shade_mode),
                          rmf.SweepConfig(res=pipe._sweep_res()))
    color = pipe._fill(out.color, out.depth) if cfg.fill_holes else out.color
    return FrameOutput(color=color, depth=out.depth, hit=out.hit, tsdf=tsdf,
                       occupied_ratio=occupied, num_samples=out.num_samples,
                       occupied_bricks=n_occ)


def fast_sharded_step(pipe, mesh: Mesh):
    """The z-slab fast-path step of ``pipe`` on ``mesh`` (JAX
    ``fast_sharded_step``). Returns f(depth, color, modelview, proj) ->
    FrameOutput with the whole image on every rank and ``tsdf`` this
    rank's z-slab. Refuses a volume without whole brick layers per rank
    and a sweep axis the mesh size does not divide."""
    check_mesh(pipe, mesh)
    n, rank = mesh.size, mesh.rank
    slab_plan(pipe, n)
    held = {}

    def plan_and_slab():
        """The slab plan and this rank's integrator, remade with the volume,
        capacity, integrator or windows (a retune, a rebake, a sensor size)."""
        key, win = (pipe.tsdf_cfg, pipe.max_bricks), pipe.integrator.win_off
        if held.get("key") != key or held["win"] is not win:
            plan = slab_plan(pipe, n)
            lo = rank * plan.nb_local
            held.update(key=key, win=win, plan=plan,
                        integ=pipe.integrator.slab(lo, lo + plan.nb_local))
        return held["plan"], held["integ"]

    def step(depth_m, color, modelview, proj):
        depth, col, mv, pr, axis, flip = pipe._inputs(depth_m, color, modelview, proj)
        check_axis(pipe, n, axis)
        frames = preprocess_sharded(pipe, mesh, depth, col, pipe._drig)
        mask16, occupied = occupancy(pipe, frames)
        plan, integ = plan_and_slab()
        vol_l, cvol_l = integ.integrate(frames, mask16, plan.max_bricks)
        zmajor = pipe.integrator.zmajor
        vol_a, cvol_a = vol_l, cvol_l
        if axis != 2:       # z-slabs -> axis-slabs
            pieces = reshard_chunks(vol_l, cvol_l, axis, n, zmajor)
            vol_a, cvol_a = reshard_join(list(zip(
                all_to_all(mesh, [p[0] for p in pieces]),
                all_to_all(mesh, [p[1] for p in pieces]))))
        halos = all_gather(mesh, halo_send(vol_a, cvol_a, axis, flip, zmajor))
        window = window_of(halos, rank, n, pipe.tsdf_cfg.res[axis], flip)
        cam = rm.RenderCamera(mv, pr, pipe.cfg.render_width, pipe.cfg.render_height)
        res = sweep_local(pipe, vol_a, cvol_a, slab_flags(pipe, mask16, axis), cam, axis,
                          flip, window, rank, n)
        merged = merge_planes(all_gather(mesh, pack_planes(res)), flip, res.base_extent,
                              res.eye_p)
        return finish(pipe, merged, cam, axis, flip, vol_l, occupied,
                      mask16.sum().to(torch.int32))

    return step


class SlabSweep(NamedTuple):
    """``run_slabs``' frame before shading: ``finish``'s arguments after
    ``pipe`` (``self[:-1]``), then the sweep's per-slice flags."""

    merged: rmf.SweepResult
    cam: rm.RenderCamera
    axis: int
    flip: bool
    tsdf: torch.Tensor          # the slabs joined
    occupied: torch.Tensor
    n_occ: torch.Tensor
    flags: object               # host bool[ns] of the whole axis, or None


def sweep_slabs(pipe, n: int, depth_m, color, modelview, proj) -> SlabSweep:
    """``fast_sharded_step``'s frame up to the folded planes, with its n
    ranks run in turn in this process through the same per-rank functions,
    the collectives done by hand (each rank's sensors preprocessed alone,
    pieces and halos handed over, the planes folded)."""
    plan = slab_plan(pipe, n)
    depth, col, mv, pr, axis, flip = pipe._inputs(depth_m, color, modelview, proj)
    check_axis(pipe, n, axis)
    k = depth.shape[0]
    if k % n == 0:
        frames = [preprocess_sensors(pipe, depth, col, pipe._drig, *split_range(k, r, n))
                  for r in range(n)]
        frames = type(frames[0])(*[torch.cat(f) for f in zip(*frames)])
    else:
        frames = preprocess_sensors(pipe, depth, col, pipe._drig, 0, k)
    mask16, occupied = occupancy(pipe, frames)
    zmajor = pipe.integrator.zmajor
    slabs = [pipe.integrator.slab(r * plan.nb_local, (r + 1) * plan.nb_local).integrate(
        frames, mask16, plan.max_bricks) for r in range(n)]
    if axis != 2:
        pieces = [reshard_chunks(v, c, axis, n, zmajor) for v, c in slabs]
        owned = [reshard_join([pieces[i][j] for i in range(n)]) for j in range(n)]
    else:
        owned = slabs
    halos = [halo_send(v, c, axis, flip, zmajor) for v, c in owned]
    cam = rm.RenderCamera(mv, pr, pipe.cfg.render_width, pipe.cfg.render_height)
    flags = slab_flags(pipe, mask16, axis)
    results = [sweep_local(pipe, v, c, flags, cam, axis, flip,
                           window_of(halos, r, n, pipe.tsdf_cfg.res[axis], flip), r, n)
               for r, (v, c) in enumerate(owned)]
    merged = merge_planes([pack_planes(r) for r in results], flip, results[0].base_extent,
                          results[0].eye_p)
    return SlabSweep(merged, cam, axis, flip, torch.cat([v for v, _ in slabs]), occupied,
                     mask16.sum().to(torch.int32), flags)


def run_slabs(pipe, n: int, depth_m, color, modelview, proj):
    """``fast_sharded_step``'s frame with its n ranks run in turn in this
    process (``sweep_slabs``, then shading and colorfill). Returns the
    FrameOutput with ``tsdf`` the whole volume (the slabs joined)."""
    return finish(pipe, *sweep_slabs(pipe, n, depth_m, color, modelview, proj)[:-1])

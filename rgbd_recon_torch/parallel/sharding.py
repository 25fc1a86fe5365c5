"""Process-group mesh and the z-slab-sharded dense step (mirrors
``rgbd_recon_tpu/parallel/sharding.py``).

The JAX module jits the dense oracle frame with sharding constraints over a
device mesh and lets XLA partition the producing ops. Here each rank of a
``torch.distributed`` process group runs its share and the collectives are
written out:

* preprocessing is sensor-parallel when the mesh size divides the sensor
  count K: each rank filters its K/n sensors, then the frames are
  all-gathered (otherwise every rank filters all K);
* brick marking and the voxel mask run on every rank (kernel 4 on the card);
* each rank integrates only its z-slab with ``ops/tsdf.{integrate,
  integrate_colors}(z_range=)``; the slabs are all-gathered, since the
  per-ray march reads across slabs;
* each rank marches only its screen rows (``ops/raymarch.render(rows=)``)
  and the rows are all-gathered.

Colorfill runs unsplit on every rank, on the gathered image. The JAX
step's row sharding of colorfill is an XLA layout, not a result: the
whole-image resolve gives the single-card bits at every LOD with no row
halos.

``make_mesh`` stands in for JAX's ``Mesh``: rank, world size, device and
process group. It takes ``nccl`` for the card and ``gloo`` when the caller
asks for the CPU; with no process group initialised it forms a world of
one over a TCP rendezvous on 127.0.0.1. A group whose backend does not
match the device is refused, never used. Collectives move every tensor as
its raw bytes, so bf16 and bool volumes pass through both backends
unchanged.
"""
from __future__ import annotations

import socket
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..calibration.rig import device_rig
from ..ops import bricks as brick_ops
from ..ops import preprocess as pp
from ..ops import raymarch as rm
from ..ops import tsdf as tsdf_ops

RIG_SHARED = ("bbox_min", "bbox_max")     # DeviceRig fields without a sensor axis


class Mesh(NamedTuple):
    """This process's place in the process group."""

    rank: int
    size: int
    device: torch.device
    group: object


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_mesh(n: int | None = None, device: torch.device | str = "cuda") -> Mesh:
    """The mesh of the initialised process group (``n``, when given, must
    be its world size), or a world of one formed here. ``device``: the
    card (``nccl``) unless the caller asks for the CPU (``gloo``)."""
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if not dist.is_initialized():
        if n not in (None, 1):
            raise ValueError(f"a mesh of {n} ranks needs torch.distributed.init_process_group"
                             f"(world_size={n}) in each process first")
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{_free_port()}",
                                world_size=1, rank=0)
    got = dist.get_backend()
    if got != backend:
        raise RuntimeError(f"the process group runs {got}; tensors on {dev.type} need {backend}")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n is not None and n != size:
        raise ValueError(f"mesh of {n} requested, the process group has {size} ranks")
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index if dev.index is not None
                           else rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return Mesh(rank, size, dev, dist.group.WORLD)


def check_mesh(pipe, mesh: Mesh) -> None:
    """The pipeline's tensors must live where the mesh's backend moves them."""
    if pipe.device.type != mesh.device.type:
        raise ValueError(f"pipeline on {pipe.device}, mesh on {mesh.device}")


# -- collectives (raw bytes, any dtype) ------------------------------------

def all_gather(mesh: Mesh, t: torch.Tensor) -> list[torch.Tensor]:
    """Every rank's ``t`` (equal shapes), in rank order."""
    flat = t.contiguous().reshape(-1).view(torch.uint8)
    outs = [torch.empty_like(flat) for _ in range(mesh.size)]
    dist.all_gather(outs, flat, group=mesh.group)
    return [o.view(t.dtype).reshape(t.shape) for o in outs]


def all_to_all(mesh: Mesh, chunks: list[torch.Tensor]) -> list[torch.Tensor]:
    """``chunks[j]`` goes to rank j; returns the chunk each rank i sent
    here, in rank order (chunks of one shape and dtype)."""
    shape, dtype = chunks[0].shape, chunks[0].dtype
    inp = torch.cat([c.contiguous().reshape(-1).view(torch.uint8) for c in chunks])
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=mesh.group)
    return [o.view(dtype).reshape(shape) for o in out.chunk(mesh.size)]


def gather_split(mesh: Mesh, t: torch.Tensor, total: int) -> torch.Tensor:
    """Concatenate along dim 0 the ranks' pieces of a ``total``-long axis
    split as ``[r * total // n, (r + 1) * total // n)``; pieces may differ
    by one in length (padded for the gather)."""
    n = mesh.size
    sizes = [(i + 1) * total // n - i * total // n for i in range(n)]
    pad = max(sizes) - t.shape[0]
    if pad:
        t = torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])
    return torch.cat([g[:s] for g, s in zip(all_gather(mesh, t), sizes)])


def split_range(total: int, rank: int, n: int) -> tuple[int, int]:
    return rank * total // n, (rank + 1) * total // n


def shard_volume(mesh: Mesh, vol: torch.Tensor) -> torch.Tensor:
    """This rank's z-slab of a [Vz, ...] volume (TSDF, channels-last or
    z-major color)."""
    z0, z1 = split_range(vol.shape[0], mesh.rank, mesh.size)
    return vol[z0:z1]


# -- sensor-parallel preprocessing -----------------------------------------

def sensors(nt, lo: int, hi: int, shared=()):
    """A NamedTuple of per-sensor tensors cut to sensors [lo, hi)."""
    return type(nt)(*[v[lo:hi] if isinstance(v, torch.Tensor) and f not in shared else v
                      for f, v in zip(nt._fields, nt)])


def preprocess_sensors(pipe, depth: torch.Tensor, col: torch.Tensor, drig,
                       lo: int, hi: int) -> pp.ProcessedFrames:
    """1preprocess's filtering of sensors [lo, hi) alone (each sensor's
    frames depend on its own inputs only)."""
    warp = pipe._warp
    return pp.preprocess(depth[lo:hi], col[lo:hi], sensors(drig, lo, hi, RIG_SHARED),
                         pipe.pre_cfg, None if warp is None else sensors(warp, lo, hi))


def preprocess_sharded(pipe, mesh: Mesh, depth: torch.Tensor, col: torch.Tensor,
                       drig) -> pp.ProcessedFrames:
    """Sensor-parallel when n divides K (each rank its K/n sensors, then an
    all-gather of the frames), else every rank all K."""
    k, n = depth.shape[0], mesh.size
    if k % n:
        return pp.preprocess(depth, col, drig, pipe.pre_cfg, pipe._warp)
    lo, hi = split_range(k, mesh.rank, n)
    part = preprocess_sensors(pipe, depth, col, drig, lo, hi)
    return pp.ProcessedFrames(*[torch.cat(all_gather(mesh, f)) for f in part])


# -- the dense step ----------------------------------------------------------

def sharded_step(pipe, mesh: Mesh):
    """The dense (voxel-parallel) frame step over ``mesh`` (JAX
    ``sharded_step``): ``pipe`` supplies the rig and config. Returns
    f(depth, color, modelview, proj) -> FrameOutput with the whole image
    on every rank and ``tsdf`` this rank's z-slab (f32[Vz/n, Vy, Vx]; JAX
    leaves it z-sharded). ``occupied_bricks`` counts the occupied bricks
    of the brick grid, as the JAX step does."""
    from ..runtime.pipeline import FrameOutput

    check_mesh(pipe, mesh)
    rigs = {}

    def step(depth_m, color, modelview, proj) -> FrameOutput:
        cfg, tcfg = pipe.cfg, pipe.tsdf_cfg
        n, r = mesh.size, mesh.rank
        depth, col, mv, pr, _, _ = pipe._inputs(depth_m, color, modelview, proj)
        drig = pipe._drig
        if drig.cv_xyz is None:         # the dense integrators sample the cv volumes
            if "volumes" not in rigs:
                rigs["volumes"] = device_rig(pipe.rig, pipe.device, volumes=True)
            drig = rigs["volumes"]
        frames = preprocess_sharded(pipe, mesh, depth, col, drig)

        mask = vox_mask = None
        occupied = torch.ones((), dtype=torch.float32, device=pipe.device)
        n_occ = torch.zeros((), dtype=torch.int32, device=pipe.device)
        if cfg.use_bricks:
            counts = brick_ops.mark_bricks(frames.world, frames.world_valid, pipe.brick_grid)
            mask = brick_ops.occupancy_mask(counts, cfg.min_voxels_per_brick)
            vox_mask = brick_ops.voxel_occupancy(mask, pipe.brick_grid, tcfg.res)
            occupied = brick_ops.occupied_ratio(mask)
            n_occ = mask.sum().to(torch.int32)

        # each rank fuses its z-slab; the march reads across slabs
        vz = tcfg.res[2]
        zr = split_range(vz, r, n)
        vol_l = tsdf_ops.integrate(frames, drig, tcfg, vox_mask, zr)
        cvol_l = tsdf_ops.integrate_colors(frames, drig, tcfg, vox_mask, zr)
        vol, cvol = gather_split(mesh, vol_l, vz), gather_split(mesh, cvol_l, vz)

        h = cfg.render_height
        cam = rm.RenderCamera(mv, pr, cfg.render_width, h)
        grid = pipe.brick_grid
        extent = (np.asarray(grid.res, np.float32) * grid.brick_size
                  / pipe.bbox.size.astype(np.float32))
        out = rm.render(
            vol, cvol, frames, drig, cam, pipe.bbox, float(tcfg.limit),
            rm.RenderParams(shade_mode=cfg.shade_mode),
            brick_mask=mask if cfg.skip_space and cfg.use_bricks else None,
            brick_size_vol=grid.brick_size / float(np.max(pipe.bbox.size)),
            brick_extent=extent, rows=split_range(h, r, n))
        color_o, depth_o, hit_o, nsamp_o = (gather_split(mesh, t, h) for t in out)
        if cfg.fill_holes:
            color_o = pipe._fill(color_o, depth_o)
        return FrameOutput(color=color_o, depth=depth_o, hit=hit_o, tsdf=vol_l,
                           occupied_ratio=occupied, num_samples=nsamp_o,
                           occupied_bricks=n_occ)

    return step

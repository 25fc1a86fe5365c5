"""Block-major integration from the per-brick quadratic warp, for volumes
the dense emit cannot tile (mirrors ``rgbd_recon_tpu/ops/tsdf_persist.py``).

``integrate_affine`` is the port of the TPU kernel
``integrate_affine_pallas``: the fusion of kernel 1 (ops/tsdf_dense.py)
with every sensor FULL (no depth-band classes), by default the TPU
kernel's fixed 64-col windows at stride 16 (``wx``, ``xstride``; the
pipeline gives it the whole frame, see ``runtime.integrator.Integrator``),
emitting f32 TSDF [Vz, Vy, Vx] and bf16
color [Vz, Vy, Vx, 4] in voxel order with the clear values where no brick
is occupied. With ``raw=True`` it returns what the TPU kernel itself
emits, one block per brick (``integrate_affine_pallas(raw=True)``):
TSDF f32[NB, 32, 128], color bf16[NB, 4, 32, 128] and visited bool[NB];
``ops/assemble.scatter_dense`` (kernel 8) places those blocks in voxel
order. The CUDA kernel is a template mode of ``csrc/integrate_dense.cu``
with its own entry point; ``integrate_affine_plain`` is the same function
in PyTorch.
"""
from __future__ import annotations

import torch

from .. import native
from .tsdf import TsdfConfig
from .tsdf_affine import AffineTables
from .tsdf_dense import integrate_quadratic_plain, quadratic_args
from .tsdf_fast import BRICK, occupied_bricks, pack_frames, pack_planes

WX2 = 64         # x window (cols) of the block-major kernel
XSTRIDE2 = 16    # x-block stride


def integrate_affine_plain(packed, coeffs, idx, count, win_off, res, wy, limit,
                           raw: bool = False, wx: int = WX2, xstride: int = XSTRIDE2):
    """PyTorch form of kernel 6 (see integrate_affine); takes the kernel's
    arguments."""
    out = integrate_quadratic_plain(packed, coeffs, idx, count, win_off, None, res,
                                    wy, wx, xstride, limit, raw)
    return (out[0], out[1].to(torch.bfloat16)) + out[2:]


_INTEGRATE_AFFINE = native.Kernel(
    "integrate_affine", [native.P] * 10 + [native.I] * 10 + [native.F])


def integrate_affine_cuda(planes, coeffs, idx, count, slots, win_off, res, wy, limit,
                          raw: bool = False, wx: int = WX2, xstride: int = XSTRIDE2):
    """Kernel 6 on the card (``csrc/integrate_dense.cu``,
    ``rr_integrate_affine``): the arguments of ``integrate_affine_plain``
    with the frame as ``tsdf_fast.pack_planes`` gives it and the per-brick
    slot map ``slots`` (``tsdf_fast.occupied_bricks``). No host sync."""
    vx, vy, vz = res
    ptrs, dims = quadratic_args(planes, coeffs, idx, count, slots, win_off, res)
    nb = dims[3]
    dev = coeffs.device
    if raw:
        tsdf = torch.empty((nb, 32, 128), dtype=torch.float32, device=dev)
        color = torch.empty((nb, 4, 32, 128), dtype=torch.bfloat16, device=dev)
        visited = torch.empty(nb, dtype=torch.bool, device=dev)
    else:
        tsdf = torch.empty((vz, vy, vx), dtype=torch.float32, device=dev)
        color = torch.empty((vz, vy, vx, 4), dtype=torch.bfloat16, device=dev)
        visited = None
    _INTEGRATE_AFFINE(*ptrs, tsdf.data_ptr(), color.data_ptr(),
                      visited.data_ptr() if raw else None, *dims, wy, wx, xstride, limit)
    return (tsdf, color, visited) if raw else (tsdf, color)


def integrate_affine(frames, affine: AffineTables, cfg: TsdfConfig, mask16: torch.Tensor,
                     max_bricks: int, win_off: torch.Tensor, wy: int, raw: bool = False,
                     wx: int = WX2, xstride: int = XSTRIDE2):
    """Fused TSDF f32[Vz, Vy, Vx] + color bf16[Vz, Vy, Vx, 4] of the
    occupied 16^3 bricks of ``mask16`` (the first ``max_bricks`` in
    ascending order). ``win_off`` i32[K, NB, 2] from
    win_offsets_affine(affine, h, w, wy, wx, xstride). ``raw``: the
    block-major (TSDF f32[NB, 32, 128], color bf16[NB, 4, 32, 128], visited
    bool[NB]) instead; blocks that are not visited may hold anything."""
    vx, vy, vz = cfg.res
    if vx % BRICK or vy % BRICK or vz % BRICK:
        raise ValueError(f"the block-major integrator needs a 16-aligned res, got {cfg.res}")
    idx, count, slots = occupied_bricks(mask16, max_bricks)
    if native.is_cuda(frames.depth):
        return integrate_affine_cuda(pack_planes(frames), affine.coeffs, idx, count, slots,
                                     win_off, cfg.res, wy, float(cfg.limit), raw, wx, xstride)
    return integrate_affine_plain(pack_frames(frames), affine.coeffs, idx, count, win_off,
                                  cfg.res, wy, float(cfg.limit), raw, wx, xstride)

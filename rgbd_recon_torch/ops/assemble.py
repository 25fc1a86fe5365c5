"""Block-major -> dense volume assembly (mirrors
``rgbd_recon_tpu/ops/assemble_pallas.py``).

The block-major integrator in raw mode (``tsdf_persist.integrate_affine(...,
raw=True)``) emits one 16^3 block per occupied brick: TSDF f32[NB, 32, 128]
and color bf16[NB, 4, 32, 128], z-major ``[lz, ly, lx]`` inside a block.
``scatter_dense`` places the blocks of the occupied list into the dense
voxel-order volumes, TSDF f32[Vz, Vy, Vx] and CHANNEL-MAJOR color
bf16[4, Vz, Vy, Vx], with the clear values (-limit, 0) everywhere else
(recon_integration.cpp:249-250). It is the port of the TPU kernel
``scatter_dense`` (a DMA queue of strided copies over a pre-cleared
output); on the card it is ``csrc/scatter_dense.cu`` (kernel 8), a pure
copy, and ``scatter_dense_plain`` is the same function in PyTorch.
"""
from __future__ import annotations

import torch

from .. import native
from .tsdf_fast import BRICK


def _grid(res):
    vx, vy, vz = res
    if vx % BRICK or vy % BRICK or vz % BRICK:
        raise ValueError(f"scatter_dense needs a 16-aligned res, got {res}")
    return vz // BRICK, vy // BRICK, vx // BRICK


def scatter_dense_plain(vol_bm, cvol_bm, idx_list, count, res, limit):
    """PyTorch form of kernel 8 (see scatter_dense): one indexed assignment
    per array into the cleared volumes. Syncs once to read the count."""
    nbz, nby, nbx = _grid(res)
    vx, vy, vz = res
    n = int(count.reshape(-1)[0])
    sel = idx_list[:n].to(torch.int64)
    bz, by, bx = sel // (nby * nbx), (sel // nbx) % nby, sel % nbx
    dev = vol_bm.device
    tsdf = torch.full((nbz, BRICK, nby, BRICK, nbx, BRICK), -limit, dtype=torch.float32,
                      device=dev)
    color = torch.zeros((4, nbz, BRICK, nby, BRICK, nbx, BRICK), dtype=torch.bfloat16,
                        device=dev)
    # brick-major views of the dense volumes: [nbz, nby, nbx, (4,) lz, ly, lx]
    tsdf.permute(0, 2, 4, 1, 3, 5)[bz, by, bx] = vol_bm[sel].reshape(n, BRICK, BRICK, BRICK)
    color.permute(1, 3, 5, 0, 2, 4, 6)[bz, by, bx] = cvol_bm[sel].reshape(
        n, 4, BRICK, BRICK, BRICK)
    return tsdf.reshape(vz, vy, vx), color.reshape(4, vz, vy, vx)


_SCATTER_DENSE = native.Kernel("scatter_dense", [native.P] * 6 + [native.I] * 4 + [native.F])


def scatter_dense_cuda(vol_bm, cvol_bm, idx_list, count, res, limit):
    """Kernel 8 on the card (``csrc/scatter_dense.cu``); the arguments of
    ``scatter_dense_plain``. No host sync: slots at or past the count exit
    on the device."""
    nbz, nby, nbx = _grid(res)
    vx, vy, vz = res
    nb = nbz * nby * nbx
    max_bricks = idx_list.shape[0]
    dev = vol_bm.device
    native.check(vol_bm, "vol_bm", torch.float32, (nb, 32, 128), dev)
    native.check(cvol_bm, "cvol_bm", torch.bfloat16, (nb, 4, 32, 128), dev)
    native.check(idx_list, "idx_list", torch.int32, (max_bricks,), dev)
    native.check(count, "count", torch.int32, (1,), dev)
    tsdf = torch.empty((vz, vy, vx), dtype=torch.float32, device=dev)
    color = torch.empty((4, vz, vy, vx), dtype=torch.bfloat16, device=dev)
    _SCATTER_DENSE(vol_bm.data_ptr(), cvol_bm.data_ptr(), idx_list.data_ptr(),
                   count.data_ptr(), tsdf.data_ptr(), color.data_ptr(), nbx, nby, nbz,
                   max_bricks, float(limit))
    return tsdf, color


def scatter_dense(vol_bm: torch.Tensor, cvol_bm: torch.Tensor, idx_list: torch.Tensor,
                  count: torch.Tensor, res: tuple[int, int, int], limit: float):
    """Dense (TSDF f32[Vz, Vy, Vx], color bf16[4, Vz, Vy, Vx]) from the
    block-major ``vol_bm`` f32[NB, 32, 128] and ``cvol_bm`` bf16[NB, 4, 32,
    128] of the bricks ``idx_list`` i32[MB], of which the first ``count``
    i32[1] are valid (entries past it are never read). Unoccupied voxels
    hold -limit and 0."""
    run = scatter_dense_cuda if native.is_cuda(vol_bm) else scatter_dense_plain
    return run(vol_bm, cvol_bm, idx_list, count.reshape(1), res, limit)

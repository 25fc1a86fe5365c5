// Block-major -> dense volume assembly.
//
// Replaces rgbd_recon_tpu/ops/assemble_pallas.py::scatter_dense: the
// block-major output of the block-major integrator (kernel 6 in raw mode,
// one 16^3 block per brick, z-major [lz, ly, lx] inside a block) placed
// into the dense voxel-order TSDF f32[Vz, Vy, Vx] and channel-major color
// bf16[4, Vz, Vy, Vx]; voxels of unoccupied bricks hold the clear values
// (-limit, 0). The TPU kernel is a DMA queue of one strided HBM->HBM copy
// per brick and array over a pre-cleared output; here it is a pure copy.
//
// Bound on the card: bytes. The clear writes 12 bytes a voxel (166 MB at
// 240^3) and the occupied bricks move 48 KB each (~20 MB at 429 bricks),
// so the fill is ~90% of the work. Design: one fill kernel with 16-byte
// stores (float4 of -limit, uint4 of zeros), then one 256-thread block per
// slot of the occupied list that copies its brick's 16 KB of TSDF and
// 32 KB of color with 16-byte loads and stores (each 16-voxel x-row is 4
// float4 / 2 uint4 on both sides). Slots at or past *count exit before
// reading their index: entries past the count are never read, and there
// is no host sync.
#include "common.cuh"

namespace {

constexpr int BRICK = 16;
constexpr int B3 = BRICK * BRICK * BRICK;
constexpr int THREADS = 256;

__global__ void clear_kernel(float4* __restrict__ tsdf, long long n4, uint4* __restrict__ color,
                             long long c16, float limit) {
  const float4 t = make_float4(-limit, -limit, -limit, -limit);
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n4;
       i += stride)
    tsdf[i] = t;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < c16;
       i += stride)
    color[i] = z;
}

__global__ void __launch_bounds__(THREADS)
copy_bricks_kernel(const float4* __restrict__ vol_bm,    // [NB, B3 / 4]
                   const uint4* __restrict__ cvol_bm,    // [NB, 4, B3 / 8]
                   const int* __restrict__ idx, const int* __restrict__ count,
                   float* __restrict__ tsdf, __nv_bfloat16* __restrict__ color, int nbx,
                   int nby, int Vx, int Vy, long long plane_c) {
  const int slot = blockIdx.x;
  if (slot >= *count) return;
  const int b = idx[slot];
  const int bz = b / (nby * nbx);
  const int by = (b / nbx) % nby;
  const int bx = b % nbx;
  // voxel (lz, ly, 0) of the brick in the dense volume
  auto row = [&](int r) {
    return (static_cast<long long>(bz * BRICK + r / BRICK) * Vy + by * BRICK + r % BRICK) *
               Vx + bx * BRICK;
  };
  const float4* sv = vol_bm + static_cast<long long>(b) * (B3 / 4);
  for (int i = threadIdx.x; i < B3 / 4; i += THREADS)   // 4 float4 per x-row
    reinterpret_cast<float4*>(tsdf + row(i / 4))[i % 4] = sv[i];
  const uint4* sc = cvol_bm + static_cast<long long>(b) * (4 * B3 / 8);
  for (int i = threadIdx.x; i < 4 * B3 / 8; i += THREADS) {   // 2 uint4 per x-row
    const int c = i / (B3 / 8);
    const int r = (i % (B3 / 8)) / 2;
    reinterpret_cast<uint4*>(color + c * plane_c + row(r))[i % 2] = sc[i];
  }
}

}  // namespace

// vol_bm f32[NB, 32, 128], cvol_bm bf16[NB, 4, 32, 128], idx i32[max_bricks]
// (the first *count valid), count i32[1] -> tsdf f32[Vz, Vy, Vx],
// color bf16[4, Vz, Vy, Vx]
RR_API int rr_scatter_dense(const float* vol_bm, const __nv_bfloat16* cvol_bm, const int* idx,
                            const int* count, float* tsdf, __nv_bfloat16* color, int nbx,
                            int nby, int nbz, int max_bricks, float limit,
                            cudaStream_t stream) {
  const int Vx = nbx * BRICK, Vy = nby * BRICK;
  const long long n = static_cast<long long>(Vx) * Vy * nbz * BRICK;   // a multiple of 4096
  clear_kernel<<<132 * 8, THREADS, 0, stream>>>(reinterpret_cast<float4*>(tsdf), n / 4,
                                                reinterpret_cast<uint4*>(color), 4 * n / 8,
                                                limit);
  if (max_bricks > 0)
    copy_bricks_kernel<<<max_bricks, THREADS, 0, stream>>>(
        reinterpret_cast<const float4*>(vol_bm), reinterpret_cast<const uint4*>(cvol_bm), idx,
        count, tsdf, color, nbx, nby, Vx, Vy, n);
  return rr_status();
}

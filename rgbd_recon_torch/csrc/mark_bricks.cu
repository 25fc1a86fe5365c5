// Brick occupancy histogram of the valid depth pixels.
//
// Replaces rgbd_recon_tpu/ops/bricks_pallas.py::mark_bricks_pallas
// (histogram_matmul): per valid world point, +1 for its brick and +1 for
// the closest neighbouring brick when the point is more than a tenth of a
// brick off the center along x (inc_bricks.glsl:40-58). Counts are u32 in
// z-major [bz, by, bx] order.
//
// Bound on the card: ~0.9 M points x 12 bytes read at the bench shape, a
// few microseconds of bandwidth; the limit is atomic contention on ~9 K
// bins. Design: one thread per point (grid-stride), the histogram in
// shared memory per block (8,800 bins = 35 KB at brick_size 0.1), flushed
// with one global atomicAdd per non-zero bin; when the bins do not fit in
// shared memory the same kernel adds straight into global memory. The
// brick-center arithmetic uses explicitly rounded intrinsics, so no
// multiply-add is fused and the ids match the plain PyTorch version
// exactly.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_SHARED_BINS = 48 * 1024;   // 192 KB of u32 bins

__device__ __forceinline__ int brick_index(float p, float bmin, float bsize, int n) {
  // floor((p - bmin) / bsize), saturated and clipped to [0, n-1]; NaN -> 0
  const float f = floorf(__fdiv_rn(__fsub_rn(p, bmin), bsize));
  return static_cast<int>(fminf(fmaxf(f, 0.0f), static_cast<float>(n - 1)));
}

__device__ __forceinline__ int sgn(float v) { return (v > 0.f) - (v < 0.f); }

template <bool SHARED>
__global__ void __launch_bounds__(THREADS)
mark_bricks_kernel(const float* __restrict__ world, const uint8_t* __restrict__ valid,
                   unsigned* __restrict__ counts, long long n, float bmx, float bmy,
                   float bmz, float bsize, int bx, int by, int bz) {
  extern __shared__ unsigned hist[];
  const int nbins = bx * by * bz;
  unsigned* bins = SHARED ? hist : counts;
  if (SHARED) {
    for (int i = threadIdx.x; i < nbins; i += blockDim.x) hist[i] = 0u;
    __syncthreads();
  }
  const float thresh = __fmul_rn(bsize, 0.1f);
  for (long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x; p < n;
       p += (long long)gridDim.x * blockDim.x) {
    if (!valid[p]) continue;
    const float px = world[3 * p], py = world[3 * p + 1], pz = world[3 * p + 2];
    const int ix = brick_index(px, bmx, bsize, bx);
    const int iy = brick_index(py, bmy, bsize, by);
    const int iz = brick_index(pz, bmz, bsize, bz);
    // center = bmin + (index + 0.5) * bsize, rounded op by op
    const float cx = __fadd_rn(bmx, __fmul_rn(__fadd_rn((float)ix, 0.5f), bsize));
    const float cy = __fadd_rn(bmy, __fmul_rn(__fadd_rn((float)iy, 0.5f), bsize));
    const float cz = __fadd_rn(bmz, __fmul_rn(__fadd_rn((float)iz, 0.5f), bsize));
    const float dx = __fsub_rn(px, cx), dy = __fsub_rn(py, cy), dz = __fsub_rn(pz, cz);
    const float ax = fabsf(dx), ay = fabsf(dy), az = fabsf(dz);
    const float m = fmaxf(fmaxf(ax, ay), az);
    const int nx = min(max(ix + (ax >= m ? sgn(dx) : 0), 0), bx - 1);
    const int ny = min(max(iy + (ay >= m ? sgn(dy) : 0), 0), by - 1);
    const int nz = min(max(iz + (az >= m ? sgn(dz) : 0), 0), bz - 1);
    atomicAdd(&bins[(iz * by + iy) * bx + ix], 1u);
    if (ax > thresh) atomicAdd(&bins[(nz * by + ny) * bx + nx], 1u);
  }
  if (SHARED) {
    __syncthreads();
    for (int i = threadIdx.x; i < nbins; i += blockDim.x) {
      const unsigned c = hist[i];
      if (c) atomicAdd(&counts[i], c);
    }
  }
}

}  // namespace

// world f32[n, 3], valid u8[n] -> counts u32[bz * by * bx] (zeroed here)
RR_API int rr_mark_bricks(const float* world, const uint8_t* valid, unsigned* counts,
                          long long n, float bmx, float bmy, float bmz, float bsize,
                          int bx, int by, int bz, cudaStream_t stream) {
  const long long nbins = static_cast<long long>(bx) * by * bz;
  cudaMemsetAsync(counts, 0, nbins * sizeof(unsigned), stream);
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int blocks = max(1, min(rr_blocks(n, THREADS), 2 * sms));
  if (nbins <= MAX_SHARED_BINS) {
    const size_t smem = nbins * sizeof(unsigned);
    cudaFuncSetAttribute(mark_bricks_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    mark_bricks_kernel<true><<<blocks, THREADS, smem, stream>>>(
        world, valid, counts, n, bmx, bmy, bmz, bsize, bx, by, bz);
  } else {
    mark_bricks_kernel<false><<<blocks, THREADS, 0, stream>>>(
        world, valid, counts, n, bmx, bmy, bmz, bsize, bx, by, bz);
  }
  return rr_status();
}

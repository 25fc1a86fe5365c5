// Brick occupancy histogram of the valid depth pixels.
//
// Replaces rgbd_recon_tpu/ops/bricks_pallas.py::mark_bricks_pallas
// (histogram_matmul): per valid world point, +1 for its brick and +1 for
// the closest neighbouring brick when the point is more than a tenth of a
// brick off the center along x (inc_bricks.glsl:40-58). Counts are u32 in
// z-major [bz, by, bx] order.
//
// Bound on the card: what the function needs is a flag a point and the 12
// bytes of each valid point; most pixels of a frame are background (12%
// valid at the bench frame), so ~2.1 MB, 0.0006 ms of bandwidth, far under
// the launch floor of 0.0023-0.0034 ms (an empty kernel after the counts'
// memset, graph-replayed) that limits this kernel. Design: one pass over the
// points, a warp on 32 consecutive points a slot and kSlots slots a thread,
// every slot's loads issued before any is used (a grid-stride loop of one
// point at a time waits on memory latency once a point). A warp with a
// valid point aggregates: the lanes that add to one bin find each other
// (__match_any_sync) and the lowest adds their count once, so neighbouring
// pixels of a row, which share a brick, add once. That count goes to a
// direct-mapped cache of kCache bins in the block's shared memory (the
// entry free or holding that bin; else straight to the global counts), and
// the block flushes its entries at the end: a frame whose points crowd
// into a few bricks then reaches each global bin once a block, not once a
// warp. No full histogram in shared memory: zeroing and flushing every bin
// in every block, or in every thread-block cluster over its distributed
// shared memory, and the cluster barriers cost more than the contention
// they remove (timed by a steps tool, in git at 90d5ed3). The same kernel takes
// any number of bins. The counts are zeroed by a memset node before the
// kernel (every block adds to any bin). The brick-center arithmetic uses
// explicitly rounded intrinsics, so no multiply-add is fused and the ids
// match the plain PyTorch version exactly.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int kSlots = 2;            // points a thread a pass (1, 2, 4 timed; git 90d5ed3)
constexpr int kBlocksPerSM = 8;      // resident at <= 32 registers: one pass over a frame
constexpr int kCache = 64;           // bins a block caches in shared memory (16, 64, 256 timed)
constexpr unsigned kNone = 0xffffffffu;   // no bin (invalid point, no neighbour)

__device__ __forceinline__ int brick_index(float p, float bmin, float bsize, int n) {
  // floor((p - bmin) / bsize), saturated and clipped to [0, n-1]; NaN -> 0
  const float f = floorf(__fdiv_rn(__fsub_rn(p, bmin), bsize));
  return static_cast<int>(fminf(fmaxf(f, 0.0f), static_cast<float>(n - 1)));
}

__device__ __forceinline__ int sgn(float v) { return (v > 0.f) - (v < 0.f); }

// The two bins a point adds to: its brick and, when it is more than a
// tenth of a brick off the center along x, the closest neighbour (kNone
// otherwise; both kNone when !ok).
__device__ __forceinline__ void bins_of(bool ok, float px, float py, float pz, float bmx,
                                        float bmy, float bmz, float bsize, int bx, int by,
                                        int bz, unsigned& bin, unsigned& nbin) {
  bin = kNone;
  nbin = kNone;
  if (!ok) return;
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
  bin = static_cast<unsigned>((iz * by + iy) * bx + ix);
  if (ax > __fmul_rn(bsize, 0.1f)) nbin = static_cast<unsigned>((nz * by + ny) * bx + nx);
}

// Called by the whole warp: the lowest of the lanes that add to one bin
// returns their count, the others 0. Warps with no bin at all (the
// background) skip the match.
__device__ __forceinline__ unsigned warp_count(unsigned bin) {
  if (!__any_sync(0xffffffffu, bin != kNone)) return 0u;
  const unsigned peers = __match_any_sync(0xffffffffu, bin);
  const bool leader = (threadIdx.x & 31) == static_cast<unsigned>(__ffs(peers) - 1);
  return bin != kNone && leader ? __popc(peers) : 0u;
}

__global__ void __launch_bounds__(THREADS, kBlocksPerSM)
mark_bricks_kernel(const float* __restrict__ world, const uint8_t* __restrict__ valid,
                   unsigned* __restrict__ counts, long long n, float bmx, float bmy, float bmz,
                   float bsize, int bx, int by, int bz) {
  __shared__ unsigned tag[kCache], cnt[kCache];    // the block's cached bins and counts
  for (int i = threadIdx.x; i < kCache; i += THREADS) tag[i] = kNone, cnt[i] = 0u;
  __syncthreads();
  const auto add = [&](unsigned bin, unsigned c) {
    const unsigned e = bin % kCache;
    const unsigned old = atomicCAS(&tag[e], kNone, bin);   // a tag, once set, stays
    if (old == kNone || old == bin) atomicAdd(&cnt[e], c);
    else atomicAdd(&counts[bin], c);
  };
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS * kSlots;
  // lane l, slot j: point base + 32 j + l (base warp-uniform)
  for (long long base = (blockIdx.x * static_cast<long long>(THREADS) + (threadIdx.x & ~31))
                        * kSlots;
       base < n; base += stride) {
    bool ok[kSlots];
    float px[kSlots], py[kSlots], pz[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const long long p = base + 32 * j + lane;
      ok[j] = p < n && valid[p];
    }
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const long long p = base + 32 * j + lane;
      px[j] = py[j] = pz[j] = 0.f;
      if (ok[j]) px[j] = world[3 * p], py[j] = world[3 * p + 1], pz[j] = world[3 * p + 2];
    }
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      unsigned bin, nbin;
      bins_of(ok[j], px[j], py[j], pz[j], bmx, bmy, bmz, bsize, bx, by, bz, bin, nbin);
      if (const unsigned c = warp_count(bin)) add(bin, c);
      if (const unsigned c = warp_count(nbin)) add(nbin, c);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kCache; i += THREADS)
    if (cnt[i]) atomicAdd(&counts[tag[i]], cnt[i]);
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
  const int blocks = max(1, min(rr_blocks(n, THREADS * kSlots), kBlocksPerSM * sms));
  mark_bricks_kernel<<<blocks, THREADS, 0, stream>>>(world, valid, counts, n, bmx, bmy, bmz,
                                                     bsize, bx, by, bz);
  return rr_status();
}

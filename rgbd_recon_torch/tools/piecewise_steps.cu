// Steps from the first kernels 5 (piecewise_eval) and 4 (mark_bricks) to
// the current ones (csrc/piecewise_eval.cu, csrc/mark_bricks.cu), one change
// at a time, with the side steps tried on the way, for
// rgbd_recon_torch/tools/piecewise_steps.py. Every step computes the same
// function as the current kernel, bit for bit (kernel 4: exactly), except
// the cut-down diagnostics of kernel 4's step 4.
//
// Kernel 5, rr_piecewise_step(step, variant, ...):
//   0    the first kernel: one thread per (k, c, pixel), c outer over the
//        image, 64-bit indices (/ and % per element), the clamped depth dc
//        and knot coordinate cc computed outside and read back;
//   1    + 32-bit indices;
//   2.0  + one thread per pixel, the C channels inside (compile-time C),
//        one hat-weight computation a map, stride-C stores;
//   2.1  + each warp's run staged in shared memory, coalesced stores;
//   3    + the clamp and the knot coordinate inside (D in, no dc / cc);
//   4.0  + one (dy, dx) offset per map (the current kernel's design);
//   4.1  step 4 with streaming (evict-first) output stores;
//   4.2  step 4 with the maps across the grid instead of a loop a thread.
// Kernel 4, rr_mark_step(step, a, b, ...):
//   0    the first kernel: a block-private shared histogram of all bins,
//        zeroed and flushed by each of b blocks an SM, a shared atomicAdd
//        per point (and neighbour);
//   1    + warp aggregation (__match_any_sync, the lowest lane adds); a = 1:
//        only in warps that have a valid point (__any_sync first);
//   2    + the bins split across a thread-block cluster of a = 2, 4 or 8
//        blocks (distributed shared memory), aggregation gated, b blocks an
//        SM;
//   3    + b points a thread with their loads issued before any use, the
//        grid sized for one pass over the points (at most 8 blocks an SM);
//   4    step 3 with 2 points a thread at most 32 registers, cluster of a,
//        cut down: b = 0 loads and bins only, 1 + the histogram (zero,
//        adds, syncs) without the flush, 2 the whole kernel, 3 the loads,
//        the bins, the zeroing and the syncs (no adds, no flush);
//   5    no cluster: one pass, b points a thread, each warp's aggregated
//        count added to the global counts (a = 1: one add a point); a = 0,
//        b = 2 is the current kernel's design;
//   6    step 4 (whole) with the first cluster barrier split around the
//        loads (arrive after the zeroing, wait before the first add);
//   7    step 5 with a direct-mapped cache of a bins a block in shared
//        memory before the global adds, b points a thread.
#include <cooperative_groups.h>

#include "../csrc/common.cuh"

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------- kernel 5

// 0: the first kernel, as the port first shipped it
__global__ void pw_step0(const float* __restrict__ dc, const float* __restrict__ cc,
                         const float* __restrict__ a, const float* __restrict__ b,
                         const __nv_bfloat16* __restrict__ r, float* __restrict__ out, int M,
                         int K, int C, int S, int H, int W) {
  const long long hw = static_cast<long long>(H) * W;
  const long long n = static_cast<long long>(K) * C * hw;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long p = i % hw;
    const int c = static_cast<int>((i / hw) % C);
    const int k = static_cast<int>(i / (hw * C));
    const long long kp = k * hw + p;
    const float av = a[kp * C + c];
    const float bv = b[kp * C + c];
    const __nv_bfloat16* rk = r + (static_cast<long long>(k) * C + c) * S * hw + p;
    for (int m = 0; m < M; ++m) {
      const long long mk = static_cast<long long>(m) * K * hw + kp;
      const float d = dc[mk];
      const float q = cc[mk];
      const float f0 = floorf(q);
      const int s0 = static_cast<int>(f0);
      const int s1 = min(s0 + 1, S - 1);
      const float w0 = fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn(q, f0))), 0.f);
      const float w1 = fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn(q, __fadd_rn(f0, 1.f)))), 0.f);
      float acc = __fadd_rn(av, __fmul_rn(d, bv));
      acc = __fadd_rn(acc, __fmul_rn(w0, __bfloat162float(rk[s0 * hw])));
      acc = __fadd_rn(acc, __fmul_rn(w1, __bfloat162float(rk[s1 * hw])));
      out[mk * C + c] = acc;
    }
  }
}

// 1: the same thread order, 32-bit indices
__global__ void pw_step1(const float* __restrict__ dc, const float* __restrict__ cc,
                         const float* __restrict__ a, const float* __restrict__ b,
                         const __nv_bfloat16* __restrict__ r, float* __restrict__ out, int M,
                         int K, int C, int S, int H, int W) {
  const int hw = H * W;
  const int n = K * C * hw;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const int p = i % hw;
    const int kc = i / hw;
    const int c = kc % C;
    const int k = kc / C;
    const int kp = k * hw + p;
    const float av = a[kp * C + c];
    const float bv = b[kp * C + c];
    const __nv_bfloat16* rk = r + kc * S * hw + p;
    for (int m = 0; m < M; ++m) {
      const int mk = m * K * hw + kp;
      const float d = dc[mk];
      const float q = cc[mk];
      const float f0 = floorf(q);
      const int s0 = static_cast<int>(f0);
      const int s1 = min(s0 + 1, S - 1);
      const float w0 = fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn(q, f0))), 0.f);
      const float w1 = fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn(q, __fadd_rn(f0, 1.f)))), 0.f);
      float acc = __fadd_rn(av, __fmul_rn(d, bv));
      acc = __fadd_rn(acc, __fmul_rn(w0, __bfloat162float(rk[s0 * hw])));
      acc = __fadd_rn(acc, __fmul_rn(w1, __bfloat162float(rk[s1 * hw])));
      out[mk * C + c] = acc;
    }
  }
}

constexpr int kMaps = 8;
constexpr int kRows = 8;

struct Offsets {
  int d[2 * kMaps];
};

// 2-4: one thread per output pixel (k, y, x), a warp a row.
//   COORDS: the clamp and knot coordinate inside (D in; else dc, cc in)
//   STAGE:  the warp's run staged in shared memory, coalesced stores
//   OFFS:   a (dy, dx) per map
//   STREAM: streaming stores;  GRID_MAPS: one map per blockIdx.z slice
template <int C, bool COORDS, bool STAGE, bool OFFS, bool STREAM, bool GRID_MAPS>
__global__ void __launch_bounds__(32 * kRows)
pw_pixel(const float* __restrict__ D, const float* __restrict__ cc,
         const float* __restrict__ a, const float* __restrict__ b,
         const __nv_bfloat16* __restrict__ r, float* __restrict__ out, int M, int K, int S,
         int H, int W, float d_min, float d_max, float span, Offsets offs) {
  __shared__ float stage[kRows][32 * C];
  const int lane = threadIdx.x;
  const int y = blockIdx.y * kRows + threadIdx.y;
  if (y >= H) return;
  const int x0 = blockIdx.x * 32;
  const int x = x0 + lane;
  const int n = min(32, W - x0) * C;
  const int k = blockIdx.z % K;
  const int m0 = blockIdx.z / K * (GRID_MAPS ? 1 : kMaps);
  const int hw = H * W;
  const float scale = static_cast<float>(S - 1);
  float* st = stage[threadIdx.y];
#pragma unroll
  for (int j = 0; j < (GRID_MAPS ? 1 : kMaps); ++j) {
    const int m = m0 + j;
    if (m >= M) break;
    const int mk = (m * K + k) * hw;
    float res[C];
    if (x < W) {
      const int oy = OFFS ? offs.d[2 * (GRID_MAPS ? m : j)] : 0;
      const int ox = OFFS ? offs.d[2 * (GRID_MAPS ? m : j) + 1] : 0;
      const int tp = min(max(y + oy, 0), H - 1) * W + min(max(x + ox, 0), W - 1);
      float dc, q;
      if (COORDS) {
        dc = fminf(fmaxf(D[mk + y * W + x], d_min), d_max);
        q = __fmul_rn(__fdiv_rn(__fsub_rn(dc, d_min), span), scale);
      } else {
        dc = D[mk + y * W + x];
        q = cc[mk + y * W + x];
      }
      const float f0 = floorf(q);
      const int s0 = min(static_cast<int>(f0), S - 1);
      const int s1 = min(s0 + 1, S - 1);
      const float w0 = fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn(q, f0))), 0.f);
      const float w1 = fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn(q, __fadd_rn(f0, 1.f)))), 0.f);
      const float* ap = a + (k * hw + tp) * C;
      const float* bp = b + (k * hw + tp) * C;
      const __nv_bfloat16* rp = r + k * C * S * hw + tp;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const __nv_bfloat16* rc = rp + c * S * hw;
        float acc = __fadd_rn(ap[c], __fmul_rn(dc, bp[c]));
        acc = __fadd_rn(acc, __fmul_rn(w0, __bfloat162float(rc[s0 * hw])));
        res[c] = __fadd_rn(acc, __fmul_rn(w1, __bfloat162float(rc[s1 * hw])));
      }
      if (!STAGE) {
        float* o = out + (mk + y * W + x) * C;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (STREAM) __stcs(o + c, res[c]); else o[c] = res[c];
        }
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) st[lane * C + c] = res[c];
      }
    }
    if (STAGE) {
      __syncwarp();
      float* o = out + (mk + y * W + x0) * C;
      for (int i = lane; i < n; i += 32) {
        if (STREAM) __stcs(o + i, st[i]); else o[i] = st[i];
      }
      __syncwarp();
    }
  }
}

template <int C, bool COORDS, bool STAGE, bool OFFS, bool STREAM, bool GRID_MAPS>
void pw_launch(const float* D, const float* cc, const float* a, const float* b,
               const __nv_bfloat16* r, float* out, int M, int K, int S, int H, int W,
               float d_min, float d_max, float span, const Offsets& offs, cudaStream_t stream) {
  const int chunks = GRID_MAPS ? M : (M + kMaps - 1) / kMaps;
  const dim3 grid((W + 31) / 32, (H + kRows - 1) / kRows, K * chunks);
  pw_pixel<C, COORDS, STAGE, OFFS, STREAM, GRID_MAPS><<<grid, dim3(32, kRows), 0, stream>>>(
      D, cc, a, b, r, out, M, K, S, H, W, d_min, d_max, span, offs);
}

template <int C>
int pw_pixel_step(int step, int variant, const float* D, const float* cc, const float* a,
                  const float* b, const __nv_bfloat16* r, float* out, int M, int K, int S,
                  int H, int W, float d_min, float d_max, float span, const Offsets& offs,
                  cudaStream_t stream) {
  const int key = step * 10 + variant;
#define PW(...) pw_launch<C, __VA_ARGS__>(D, cc, a, b, r, out, M, K, S, H, W, d_min, d_max, \
                                          span, offs, stream)
  switch (key) {
    case 20: PW(false, false, false, false, false); break;
    case 21: PW(false, true, false, false, false); break;
    case 30: PW(true, true, false, false, false); break;
    case 40: PW(true, true, true, false, false); break;
    case 41: PW(true, true, true, true, false); break;
    case 42: PW(true, true, true, false, true); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PW
  return rr_status();
}

// ---------------------------------------------------------------- kernel 4

constexpr int THREADS = 256;
constexpr unsigned kNone = 0xffffffffu;

__device__ __forceinline__ int brick_index(float p, float bmin, float bsize, int n) {
  const float f = floorf(__fdiv_rn(__fsub_rn(p, bmin), bsize));
  return static_cast<int>(fminf(fmaxf(f, 0.0f), static_cast<float>(n - 1)));
}

__device__ __forceinline__ int sgn(float v) { return (v > 0.f) - (v < 0.f); }

__device__ __forceinline__ void bins_of(bool ok, float px, float py, float pz, float bmx,
                                        float bmy, float bmz, float bsize, int bx, int by,
                                        int bz, unsigned& bin, unsigned& nbin) {
  bin = kNone;
  nbin = kNone;
  if (!ok) return;
  const int ix = brick_index(px, bmx, bsize, bx);
  const int iy = brick_index(py, bmy, bsize, by);
  const int iz = brick_index(pz, bmz, bsize, bz);
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

__device__ __forceinline__ void point_bins(const float* __restrict__ world,
                                           const uint8_t* __restrict__ valid, long long p,
                                           long long n, float bmx, float bmy, float bmz,
                                           float bsize, int bx, int by, int bz, unsigned& bin,
                                           unsigned& nbin) {
  const bool ok = p < n && valid[p];
  float px = 0.f, py = 0.f, pz = 0.f;
  if (ok) px = world[3 * p], py = world[3 * p + 1], pz = world[3 * p + 2];
  bins_of(ok, px, py, pz, bmx, bmy, bmz, bsize, bx, by, bz, bin, nbin);
}

__device__ __forceinline__ unsigned warp_count(unsigned bin) {
  const unsigned peers = __match_any_sync(0xffffffffu, bin);
  const bool leader = (threadIdx.x & 31) == static_cast<unsigned>(__ffs(peers) - 1);
  return bin != kNone && leader ? __popc(peers) : 0u;
}

// warp_count in warps that have a bin at all (most warps of a frame see
// only background): __match_any_sync is skipped where no lane adds
__device__ __forceinline__ unsigned warp_count_gated(unsigned bin) {
  if (!__any_sync(0xffffffffu, bin != kNone)) return 0u;
  return warp_count(bin);
}

__device__ __forceinline__ void cluster_add(cg::cluster_group& cluster, unsigned* hist,
                                            unsigned size, unsigned bin) {
  if (const unsigned c = warp_count_gated(bin))
    atomicAdd(cluster.map_shared_rank(hist, bin % size) + bin / size, c);
}

// 0: the first kernel (shared variant), as the port first shipped it
__global__ void __launch_bounds__(THREADS)
mb_step0(const float* __restrict__ world, const uint8_t* __restrict__ valid,
         unsigned* __restrict__ counts, long long n, float bmx, float bmy, float bmz,
         float bsize, int bx, int by, int bz) {
  extern __shared__ unsigned hist[];
  const int nbins = bx * by * bz;
  for (int i = threadIdx.x; i < nbins; i += blockDim.x) hist[i] = 0u;
  __syncthreads();
  const float thresh = __fmul_rn(bsize, 0.1f);
  for (long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x; p < n;
       p += (long long)gridDim.x * blockDim.x) {
    if (!valid[p]) continue;
    const float px = world[3 * p], py = world[3 * p + 1], pz = world[3 * p + 2];
    const int ix = brick_index(px, bmx, bsize, bx);
    const int iy = brick_index(py, bmy, bsize, by);
    const int iz = brick_index(pz, bmz, bsize, bz);
    const float cx = __fadd_rn(bmx, __fmul_rn(__fadd_rn((float)ix, 0.5f), bsize));
    const float cy = __fadd_rn(bmy, __fmul_rn(__fadd_rn((float)iy, 0.5f), bsize));
    const float cz = __fadd_rn(bmz, __fmul_rn(__fadd_rn((float)iz, 0.5f), bsize));
    const float dx = __fsub_rn(px, cx), dy = __fsub_rn(py, cy), dz = __fsub_rn(pz, cz);
    const float ax = fabsf(dx), ay = fabsf(dy), az = fabsf(dz);
    const float m = fmaxf(fmaxf(ax, ay), az);
    const int nx = min(max(ix + (ax >= m ? sgn(dx) : 0), 0), bx - 1);
    const int ny = min(max(iy + (ay >= m ? sgn(dy) : 0), 0), by - 1);
    const int nz = min(max(iz + (az >= m ? sgn(dz) : 0), 0), bz - 1);
    atomicAdd(&hist[(iz * by + iy) * bx + ix], 1u);
    if (ax > thresh) atomicAdd(&hist[(nz * by + ny) * bx + nx], 1u);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nbins; i += blockDim.x) {
    const unsigned c = hist[i];
    if (c) atomicAdd(&counts[i], c);
  }
}

// 1: + warp aggregation, a block-private histogram of all bins; GATED: only
// in warps with a valid point
template <bool GATED>
__global__ void __launch_bounds__(THREADS)
mb_step1(const float* __restrict__ world, const uint8_t* __restrict__ valid,
         unsigned* __restrict__ counts, long long n, float bmx, float bmy, float bmz,
         float bsize, int bx, int by, int bz) {
  extern __shared__ unsigned hist[];
  const unsigned nbins = static_cast<unsigned>(bx) * by * bz;
  for (unsigned i = threadIdx.x; i < nbins; i += THREADS) hist[i] = 0u;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long base = blockIdx.x * static_cast<long long>(THREADS) + (threadIdx.x & ~31);
       base < n; base += stride) {
    unsigned bin, nbin;
    point_bins(world, valid, base + (threadIdx.x & 31), n, bmx, bmy, bmz, bsize, bx, by, bz,
               bin, nbin);
    if (const unsigned c = GATED ? warp_count_gated(bin) : warp_count(bin))
      atomicAdd(&hist[bin], c);
    if (const unsigned c = GATED ? warp_count_gated(nbin) : warp_count(nbin))
      atomicAdd(&hist[nbin], c);
  }
  __syncthreads();
  for (unsigned i = threadIdx.x; i < nbins; i += THREADS) {
    const unsigned c = hist[i];
    if (c) atomicAdd(&counts[i], c);
  }
}

// 2: + the bins split across a cluster (its size set at launch)
__global__ void __launch_bounds__(THREADS)
mb_step2(const float* __restrict__ world, const uint8_t* __restrict__ valid,
         unsigned* __restrict__ counts, long long n, float bmx, float bmy, float bmz,
         float bsize, int bx, int by, int bz) {
  extern __shared__ unsigned hist[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned size = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const unsigned nbins = static_cast<unsigned>(bx) * by * bz;
  const unsigned own = (nbins + size - 1) / size;
  for (unsigned i = threadIdx.x; i < own; i += THREADS) hist[i] = 0u;
  cluster.sync();
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long base = blockIdx.x * static_cast<long long>(THREADS) + (threadIdx.x & ~31);
       base < n; base += stride) {
    unsigned bin, nbin;
    point_bins(world, valid, base + (threadIdx.x & 31), n, bmx, bmy, bmz, bsize, bx, by, bz,
               bin, nbin);
    cluster_add(cluster, hist, size, bin);
    cluster_add(cluster, hist, size, nbin);
  }
  cluster.sync();
  for (unsigned i = threadIdx.x; i < own; i += THREADS) {
    const unsigned c = hist[i];
    if (c) atomicAdd(&counts[i * size + rank], c);
  }
}

// 3: + SLOTS points a thread (lane l, slot j: point base + 32 j + l), their
// loads issued before any use, the grid sized to cover the points in one pass
template <int SLOTS>
__global__ void __launch_bounds__(THREADS)
mb_step3(const float* __restrict__ world, const uint8_t* __restrict__ valid,
         unsigned* __restrict__ counts, long long n, float bmx, float bmy, float bmz,
         float bsize, int bx, int by, int bz) {
  extern __shared__ unsigned hist[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned size = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const unsigned nbins = static_cast<unsigned>(bx) * by * bz;
  const unsigned own = (nbins + size - 1) / size;
  for (unsigned i = threadIdx.x; i < own; i += THREADS) hist[i] = 0u;
  cluster.sync();
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS * SLOTS;
  for (long long base = (blockIdx.x * static_cast<long long>(THREADS) + (threadIdx.x & ~31))
                        * SLOTS;
       base < n; base += stride) {
    bool ok[SLOTS];
    float px[SLOTS], py[SLOTS], pz[SLOTS];
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const long long p = base + 32 * j + lane;
      ok[j] = p < n && valid[p];
    }
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const long long p = base + 32 * j + lane;
      px[j] = py[j] = pz[j] = 0.f;
      if (ok[j]) px[j] = world[3 * p], py[j] = world[3 * p + 1], pz[j] = world[3 * p + 2];
    }
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      unsigned bin, nbin;
      bins_of(ok[j], px[j], py[j], pz[j], bmx, bmy, bmz, bsize, bx, by, bz, bin, nbin);
      cluster_add(cluster, hist, size, bin);
      cluster_add(cluster, hist, size, nbin);
    }
  }
  cluster.sync();
  for (unsigned i = threadIdx.x; i < own; i += THREADS) {
    const unsigned c = hist[i];
    if (c) atomicAdd(&counts[i * size + rank], c);
  }
}

// 4: step 3 (2 points a thread) at most 32 registers (8 blocks an SM
// resident), cut down to find where its time goes. MODE 0: the loads and
// the bins only (no histogram, no cluster); 1: + the cluster's shared
// histogram zeroed, the aggregated adds and both cluster syncs, no flush;
// 2: + the flush (the whole kernel).
template <int MODE>
__global__ void __launch_bounds__(THREADS, 8)
mb_step4(const float* __restrict__ world, const uint8_t* __restrict__ valid,
         unsigned* __restrict__ counts, long long n, float bmx, float bmy, float bmz,
         float bsize, int bx, int by, int bz) {
  constexpr int SLOTS = 2;
  extern __shared__ unsigned hist[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned size = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const unsigned nbins = static_cast<unsigned>(bx) * by * bz;
  const unsigned own = (nbins + size - 1) / size;
  if (MODE >= 1) {   // MODE 3: the zeroing and the syncs, no adds
    for (unsigned i = threadIdx.x; i < own; i += THREADS) hist[i] = 0u;
    cluster.sync();
  }
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS * SLOTS;
  for (long long base = (blockIdx.x * static_cast<long long>(THREADS) + (threadIdx.x & ~31))
                        * SLOTS;
       base < n; base += stride) {
    bool ok[SLOTS];
    float px[SLOTS], py[SLOTS], pz[SLOTS];
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const long long p = base + 32 * j + lane;
      ok[j] = p < n && valid[p];
    }
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const long long p = base + 32 * j + lane;
      px[j] = py[j] = pz[j] = 0.f;
      if (ok[j]) px[j] = world[3 * p], py[j] = world[3 * p + 1], pz[j] = world[3 * p + 2];
    }
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      unsigned bin, nbin;
      bins_of(ok[j], px[j], py[j], pz[j], bmx, bmy, bmz, bsize, bx, by, bz, bin, nbin);
      if (MODE == 0 || MODE == 3) {
        if (bin == kNone - 1 || nbin == kNone - 1) counts[0] = 1u;   // never: keeps the work
      } else {
        cluster_add(cluster, hist, size, bin);
        cluster_add(cluster, hist, size, nbin);
      }
    }
  }
  if (MODE >= 1) cluster.sync();
  if (MODE == 2) {
    for (unsigned i = threadIdx.x; i < own; i += THREADS) {
      const unsigned c = hist[i];
      if (c) atomicAdd(&counts[i * size + rank], c);
    }
  }
}

// 5: no cluster: one pass (2 points a thread, <= 32 registers), each
// warp's aggregated count added straight to the global counts (a fire-and-
// forget reduction in L2); AGG false: one global add a point
template <int SLOTS, bool AGG>
__global__ void __launch_bounds__(THREADS, 8)
mb_step5(const float* __restrict__ world, const uint8_t* __restrict__ valid,
         unsigned* __restrict__ counts, long long n, float bmx, float bmy, float bmz,
         float bsize, int bx, int by, int bz) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS * SLOTS;
  for (long long base = (blockIdx.x * static_cast<long long>(THREADS) + (threadIdx.x & ~31))
                        * SLOTS;
       base < n; base += stride) {
    bool ok[SLOTS];
    float px[SLOTS], py[SLOTS], pz[SLOTS];
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const long long p = base + 32 * j + lane;
      ok[j] = p < n && valid[p];
    }
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const long long p = base + 32 * j + lane;
      px[j] = py[j] = pz[j] = 0.f;
      if (ok[j]) px[j] = world[3 * p], py[j] = world[3 * p + 1], pz[j] = world[3 * p + 2];
    }
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      unsigned bin, nbin;
      bins_of(ok[j], px[j], py[j], pz[j], bmx, bmy, bmz, bsize, bx, by, bz, bin, nbin);
      if (AGG) {
        if (const unsigned c = warp_count_gated(bin)) atomicAdd(&counts[bin], c);
        if (const unsigned c = warp_count_gated(nbin)) atomicAdd(&counts[nbin], c);
      } else {
        if (bin != kNone) atomicAdd(&counts[bin], 1u);
        if (nbin != kNone) atomicAdd(&counts[nbin], 1u);
      }
    }
  }
}

// 6: step 4 (whole) with the first cluster barrier split: arrive after the
// zeroing, wait after the loads, so the barrier overlaps them
__global__ void __launch_bounds__(THREADS, 8)
mb_step6(const float* __restrict__ world, const uint8_t* __restrict__ valid,
         unsigned* __restrict__ counts, long long n, float bmx, float bmy, float bmz,
         float bsize, int bx, int by, int bz) {
  constexpr int SLOTS = 2;
  extern __shared__ unsigned hist[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned size = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const unsigned nbins = static_cast<unsigned>(bx) * by * bz;
  const unsigned own = (nbins + size - 1) / size;
  for (unsigned i = threadIdx.x; i < own; i += THREADS) hist[i] = 0u;
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  bool waited = false;
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS * SLOTS;
  for (long long base = (blockIdx.x * static_cast<long long>(THREADS) + (threadIdx.x & ~31))
                        * SLOTS;
       base < n; base += stride) {
    bool ok[SLOTS];
    float px[SLOTS], py[SLOTS], pz[SLOTS];
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const long long p = base + 32 * j + lane;
      ok[j] = p < n && valid[p];
    }
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const long long p = base + 32 * j + lane;
      px[j] = py[j] = pz[j] = 0.f;
      if (ok[j]) px[j] = world[3 * p], py[j] = world[3 * p + 1], pz[j] = world[3 * p + 2];
    }
    if (!waited) {
      asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
      waited = true;
    }
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      unsigned bin, nbin;
      bins_of(ok[j], px[j], py[j], pz[j], bmx, bmy, bmz, bsize, bx, by, bz, bin, nbin);
      cluster_add(cluster, hist, size, bin);
      cluster_add(cluster, hist, size, nbin);
    }
  }
  if (!waited) asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  cluster.sync();
  for (unsigned i = threadIdx.x; i < own; i += THREADS) {
    const unsigned c = hist[i];
    if (c) atomicAdd(&counts[i * size + rank], c);
  }
}

// 7: step 5 (aggregated adds, one pass) with a direct-mapped cache of
// CACHE bins a block in shared memory between the warps' counts and the
// global counts: a warp's count goes to its bin's cache entry when the
// entry is free or holds that bin (atomicCAS on the tag), else straight to
// global; the block flushes its entries at the end. Same-bin adds of a
// block (the contention of a frame whose points fall in a few bricks) then
// reach L2 once a block.
template <int SLOTS, int CACHE>
__global__ void __launch_bounds__(THREADS, 8)
mb_step7(const float* __restrict__ world, const uint8_t* __restrict__ valid,
         unsigned* __restrict__ counts, long long n, float bmx, float bmy, float bmz,
         float bsize, int bx, int by, int bz) {
  __shared__ unsigned tag[CACHE], cnt[CACHE];
  for (int i = threadIdx.x; i < CACHE; i += THREADS) tag[i] = kNone, cnt[i] = 0u;
  __syncthreads();
  auto add = [&](unsigned bin, unsigned c) {
    const unsigned e = bin % CACHE;
    const unsigned old = atomicCAS(&tag[e], kNone, bin);
    if (old == kNone || old == bin) atomicAdd(&cnt[e], c);
    else atomicAdd(&counts[bin], c);
  };
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS * SLOTS;
  for (long long base = (blockIdx.x * static_cast<long long>(THREADS) + (threadIdx.x & ~31))
                        * SLOTS;
       base < n; base += stride) {
    bool ok[SLOTS];
    float px[SLOTS], py[SLOTS], pz[SLOTS];
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const long long p = base + 32 * j + lane;
      ok[j] = p < n && valid[p];
    }
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const long long p = base + 32 * j + lane;
      px[j] = py[j] = pz[j] = 0.f;
      if (ok[j]) px[j] = world[3 * p], py[j] = world[3 * p + 1], pz[j] = world[3 * p + 2];
    }
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      unsigned bin, nbin;
      bins_of(ok[j], px[j], py[j], pz[j], bmx, bmy, bmz, bsize, bx, by, bz, bin, nbin);
      if (const unsigned c = warp_count_gated(bin)) add(bin, c);
      if (const unsigned c = warp_count_gated(nbin)) add(nbin, c);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < CACHE; i += THREADS)
    if (cnt[i]) atomicAdd(&counts[tag[i]], cnt[i]);
}

template <typename Kern>
void cluster_launch(Kern kern, int blocks, int cluster, size_t smem, cudaStream_t stream,
                    const float* world, const uint8_t* valid, unsigned* counts, long long n,
                    float bmx, float bmy, float bmz, float bsize, int bx, int by, int bz) {
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((blocks + cluster - 1) / cluster * cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, kern, world, valid, counts, n, bmx, bmy, bmz, bsize, bx, by, bz);
}

}  // namespace

RR_API int rr_piecewise_step(int step, int variant, const float* D, const float* cc,
                             const float* a, const float* b, const __nv_bfloat16* r,
                             const int* offsets, float* out, int M, int K, int C, int S, int H,
                             int W, float d_min, float d_max, float span, cudaStream_t stream) {
  if (step == 0 || step == 1) {   // D is dc here
    const long long n = static_cast<long long>(K) * C * H * W;
    const int blocks = min(rr_blocks(n, 256), 8 * 132 * 8);
    if (step == 0)
      pw_step0<<<blocks, 256, 0, stream>>>(D, cc, a, b, r, out, M, K, C, S, H, W);
    else
      pw_step1<<<blocks, 256, 0, stream>>>(D, cc, a, b, r, out, M, K, C, S, H, W);
    return rr_status();
  }
  Offsets offs;
  for (int i = 0; i < 2 * kMaps; ++i) offs.d[i] = offsets[i];
  switch (C) {
    case 2: return pw_pixel_step<2>(step, variant, D, cc, a, b, r, out, M, K, S, H, W, d_min,
                                    d_max, span, offs, stream);
    case 3: return pw_pixel_step<3>(step, variant, D, cc, a, b, r, out, M, K, S, H, W, d_min,
                                    d_max, span, offs, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// step 0, 1: a = 0 (1: aggregation gated by a ballot), b blocks an SM;
// step 2: a = cluster size, b blocks an SM; step 3: a = cluster size,
// b = points a thread, blocks for one pass (at most 8 an SM); step 4: a =
// cluster size, b = how much of the kernel runs
RR_API int rr_mark_step(int step, int a, int b, const float* world, const uint8_t* valid,
                        unsigned* counts, long long n, float bmx, float bmy, float bmz,
                        float bsize, int bx, int by, int bz, cudaStream_t stream) {
  const long long nbins = static_cast<long long>(bx) * by * bz;
  cudaMemsetAsync(counts, 0, nbins * sizeof(unsigned), stream);
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (step == 0 || step == 1) {
    const int blocks = max(1, min(rr_blocks(n, THREADS), b * sms));
    const size_t smem = nbins * sizeof(unsigned);
#define MB(kern)                                                                              \
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,                   \
                       static_cast<int>(smem));                                             \
  kern<<<blocks, THREADS, smem, stream>>>(world, valid, counts, n, bmx, bmy, bmz, bsize, bx, \
                                          by, bz)
    if (step == 0) {
      MB(mb_step0);
    } else if (a == 0) {
      MB(mb_step1<false>);
    } else {
      MB(mb_step1<true>);
    }
#undef MB
    return rr_status();
  }
  if (step == 5) {   // a = 0: aggregated, 1: one add a point; b points a thread
    const int blocks = max(1, min(rr_blocks(n, THREADS * b), 8 * sms));
#define MB5(S, A)                                                                             \
  mb_step5<S, A><<<blocks, THREADS, 0, stream>>>(world, valid, counts, n, bmx, bmy, bmz, bsize, \
                                                bx, by, bz)
    if (a == 0 && b == 1) MB5(1, true);
    else if (a == 0 && b == 2) MB5(2, true);
    else if (a == 0 && b == 4) MB5(4, true);
    else if (a == 1 && b == 2) MB5(2, false);
    else return static_cast<int>(cudaErrorInvalidValue);
#undef MB5
    return rr_status();
  }
  if (step == 7) {   // a = cache entries, b = points a thread
    const int blocks = max(1, min(rr_blocks(n, THREADS * b), 8 * sms));
#define MB7(S, E)                                                                             \
  mb_step7<S, E><<<blocks, THREADS, 0, stream>>>(world, valid, counts, n, bmx, bmy, bmz, bsize, \
                                                bx, by, bz)
    if (a == 64 && b == 2) MB7(2, 64);
    else if (a == 64 && b == 4) MB7(4, 64);
    else if (a == 256 && b == 2) MB7(2, 256);
    else if (a == 16 && b == 2) MB7(2, 16);
    else return static_cast<int>(cudaErrorInvalidValue);
#undef MB7
    return rr_status();
  }
  if (a < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (nbins + a - 1) / a * sizeof(unsigned);
  if (step == 2) {
    cluster_launch(mb_step2, max(1, min(rr_blocks(n, THREADS), b * sms)), a, smem, stream,
                   world, valid, counts, n, bmx, bmy, bmz, bsize, bx, by, bz);
    return rr_status();
  }
  if (step == 4) {
    const int blocks = max(1, min(rr_blocks(n, THREADS * 2), 8 * sms));
    switch (b) {
      case 0: cluster_launch(mb_step4<0>, blocks, a, smem, stream, world, valid, counts, n, bmx,
                             bmy, bmz, bsize, bx, by, bz); break;
      case 1: cluster_launch(mb_step4<1>, blocks, a, smem, stream, world, valid, counts, n, bmx,
                             bmy, bmz, bsize, bx, by, bz); break;
      case 2: cluster_launch(mb_step4<2>, blocks, a, smem, stream, world, valid, counts, n, bmx,
                             bmy, bmz, bsize, bx, by, bz); break;
      case 3: cluster_launch(mb_step4<3>, blocks, a, smem, stream, world, valid, counts, n, bmx,
                             bmy, bmz, bsize, bx, by, bz); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return rr_status();
  }
  if (step == 6) {
    cluster_launch(mb_step6, max(1, min(rr_blocks(n, THREADS * 2), 8 * sms)), a, smem, stream,
                   world, valid, counts, n, bmx, bmy, bmz, bsize, bx, by, bz);
    return rr_status();
  }
  const int blocks = max(1, min(rr_blocks(n, THREADS * b), 8 * sms));
  switch (b) {
    case 1: cluster_launch(mb_step3<1>, blocks, a, smem, stream, world, valid, counts, n, bmx,
                           bmy, bmz, bsize, bx, by, bz); break;
    case 2: cluster_launch(mb_step3<2>, blocks, a, smem, stream, world, valid, counts, n, bmx,
                           bmy, bmz, bsize, bx, by, bz); break;
    case 4: cluster_launch(mb_step3<4>, blocks, a, smem, stream, world, valid, counts, n, bmx,
                           bmy, bmz, bsize, bx, by, bz); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return rr_status();
}

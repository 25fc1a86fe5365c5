// Brick-sparse TSDF + color fusion from the per-brick quadratic warp, in
// three output layouts (one device body, a template store mode):
//
//   rr_integrate_dense   replaces rgbd_recon_tpu/ops/tsdf_dense.py::
//                        integrate_dense_pallas (zmajor=True, bf16): TSDF
//                        bf16 [Vz, Vy, Vx], color bf16 [Vz, 4, Vy, Vx],
//                        per-(sensor, brick) classes from the depth-band cull.
//   rr_integrate_affine  replaces rgbd_recon_tpu/ops/tsdf_persist.py::
//                        integrate_affine_pallas (the block-major kernel for
//                        volumes with Vx % 128 != 0): TSDF f32 [Vz, Vy, Vx],
//                        color bf16 [Vz, Vy, Vx, 4] in voxel order, every
//                        sensor FULL, fixed 64-col windows at stride 16.
//                        Given a visited buffer (raw mode, kBlockMajor) it
//                        stores what the TPU kernel itself emits
//                        (integrate_affine_pallas(raw=True)): TSDF f32
//                        [NB, 32, 128] and color bf16 [NB, 4, 32, 128], one
//                        z-major [lz, ly, lx] block per fused brick, and
//                        visited bool [NB]; nothing else is written (blocks
//                        of other bricks keep whatever the buffer held).
//
// Fusion math tsdf_persist.py::fuse_chunk_v3 / _fuse_update (reference
// tsdf_integration.vs:23-59, tsdf_raymarch.fs:295-320). For every voxel of
// every fused 16^3 brick and every sensor k: evaluate the brick's quadratic
// voxel -> (u, v, d) warp from AffineTables.coeffs, place it in the brick's
// sampling window (window-relative pixel coordinates, clamped to the
// window), read the depth NEAREST and (1 - silhouette), quality and
// registered rgb LINEAR from the packed frame, substitute the corner pixel
// for voxels outside the image or depth range, apply the per-(sensor,
// brick) class (FULL / NONE / FRONT / INVALID) and fuse. Voxels of bricks
// that are not fused hold the clear values (-limit, 0). The fused bricks
// are the first max_bricks occupied ones in ascending order; the per-brick
// slot map (tsdf_fast.occupied_bricks) holds -1 for every other brick.
//
// Bound on the card (the bench frames: 4 sensors at 512x424, 470 fused
// bricks of 4,096 at 256^3, 429 of 3,375 at 240^3): the dense modes write
// every output byte once, 168 MB at 256^3 (10 bytes a voxel) and 166 MB at
// 240^3 (12 bytes), against a 21 MB frame that stays in L2, so they are
// bound by bytes; raw mode writes only the fused blocks (~21 MB) and is
// bound by bytes and the fusion's operations about equally
// (chip_smoke.py FUSE_OPS). What holds the fusion back is the L1 data path
// of the four taps' gathers, not the operation count
// (timed step by step by a steps tool, in git at 90d5ed3).
//
// Design: one launch writes every output byte once. Block j fuses slot j
// of the occupied list (below the count, read from device memory) and,
// first, clears the bricks among 4j .. 4j+3 that the per-brick slot map
// marks idle (-1), with 16-byte stores of the 16-voxel x-runs; the fused
// blocks thus come first and the clear-only blocks after them. A fused
// brick is one block of 1,024 threads, one a voxel of 4 slices, each
// looping over 4 slices (x-adjacent threads on x-adjacent voxels), so the
// fused bricks fill the card in under four waves. The brick's K sets of
// scaled, window-folded coefficients, folded further over each slice's z
// into 6-term quadratics in (y, x), its windows, classes and corner pixels
// are staged in shared memory once; the class branch is uniform per
// block. The frame comes in two planes, (depth, qual, sil, r) and (g, b),
// so a tap is one 16-byte and one 8-byte load over dense rows, and the
// NEAREST depth is one of the four LINEAR taps, picked by comparing
// indices.
#include "fuse.cuh"

namespace {

using namespace rr;
constexpr int NBASIS = 10;
constexpr int TZ = 4;                   // slices of threads a block
constexpr int ZL = BRICK / TZ;          // slices each thread loops over
constexpr int BLOCK = THREADS * TZ;     // 1,024 threads: one a voxel of 4 slices
constexpr int CB = 4;                   // bricks each block clears (when idle)
constexpr int NQ = 6;                   // (y, x) quadratic: c, cy, cx, cyy, cxx, cyx

enum Store { kZMajor, kChannelsLast, kBlockMajor };

__device__ __forceinline__ uint4 splat(uint32_t w) { return make_uint4(w, w, w, w); }

// The clear values over one brick: 16-byte stores of its 16-voxel x-runs
// (32, 64 or 128 contiguous bytes).
template <Store kStore>
__device__ __forceinline__ void clear_brick(void* tsdf_out, __nv_bfloat16* color, int z0,
                                            int y0, int x0, int Vx, int Vy, float limit) {
  const size_t plane = static_cast<size_t>(Vy) * Vx;
  constexpr int ROWS = BRICK * BRICK;
  if (kStore == kZMajor) {
    // TSDF bf16: 2 vectors a row; color bf16 [z, c, y, x]: 2 a row and channel
    const uint16_t h = __bfloat16_as_ushort(__float2bfloat16_rn(-limit));
    const uint4 tv = splat((static_cast<uint32_t>(h) << 16) | h);
    auto* tsdf = static_cast<__nv_bfloat16*>(tsdf_out);
    for (int i = threadIdx.x; i < ROWS * 2 * 5; i += BLOCK) {
      const int q = i & 1, row = (i >> 1) % ROWS, c = (i >> 1) / ROWS;
      const size_t z = z0 + row / BRICK, y = y0 + row % BRICK;
      __nv_bfloat16* p = c == 4 ? tsdf + z * plane + y * Vx + x0
                                : color + (z * 4 + c) * plane + y * Vx + x0;
      reinterpret_cast<uint4*>(p)[q] = c == 4 ? tv : splat(0u);
    }
  } else {
    // TSDF f32: 4 vectors a row; color bf16 [z, y, x, 4]: 8 a row
    const uint4 tv = splat(__float_as_uint(-limit));
    for (int i = threadIdx.x; i < ROWS * 12; i += BLOCK) {
      const int q = i % 12, row = i / 12;
      const size_t at = (static_cast<size_t>(z0 + row / BRICK) * Vy + y0 + row % BRICK) * Vx + x0;
      if (q < 4)
        reinterpret_cast<uint4*>(static_cast<float*>(tsdf_out) + at)[q] = tv;
      else
        reinterpret_cast<uint4*>(color + at * 4)[q - 4] = splat(0u);
    }
  }
}

// LINEAR taps of (1 - silhouette), quality and rgb at rows v0/v1, columns
// u0/u1 with fractions gu, gv, from the frame's two planes: a = (depth,
// qual, sil, r) [H, W, 4] and b = (g, b) [H, W, 2], one 16-byte and one
// 8-byte load a tap; out = (sflip, qual, r, g, b), the depths of the four
// taps to depth4 = (d00, d01, d10, d11). The arithmetic of rr::bilinear5.
__device__ __forceinline__ void bilinear5_planes(const float* __restrict__ pa,
                                                 const float* __restrict__ pb, int W, int v0,
                                                 int v1, int u0, int u1, float gu, float gv,
                                                 float out[5], float depth4[4]) {
  const int rows[2] = {v0, v1}, cols[2] = {u0, u1};
  float t[4][6];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t px = static_cast<size_t>(rows[i >> 1]) * W + cols[i & 1];
    const float4 a = reinterpret_cast<const float4*>(pa)[px];
    const float2 b = reinterpret_cast<const float2*>(pb)[px];
    t[i][0] = a.x; t[i][1] = a.y; t[i][2] = a.z; t[i][3] = a.w; t[i][4] = b.x; t[i][5] = b.y;
    depth4[i] = a.x;
  }
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const int q = c == 0 ? 2 : (c == 1 ? 1 : c + 1);   // sil, qual, r, g, b
    float a00 = t[0][q], a01 = t[1][q], a10 = t[2][q], a11 = t[3][q];
    if (c == 0) { a00 = 1.f - a00; a01 = 1.f - a01; a10 = 1.f - a10; a11 = 1.f - a11; }
    const float left = (1.f - gv) * a00 + gv * a10;
    const float right = (1.f - gv) * a01 + gv * a11;
    out[c] = (1.f - gu) * left + gu * right;
  }
}

template <Store kStore>
__global__ void __launch_bounds__(BLOCK)
integrate_quadratic_kernel(const float* __restrict__ plane_a,  // [K, H, W, 4]
                           const float* __restrict__ plane_b,  // [K, H, W, 2]
                           const float* __restrict__ coeffs,   // [K, NB, 4, NBASIS]
                           const int* __restrict__ idx,        // [max_bricks]
                           const int* __restrict__ count,      // [1]
                           const int* __restrict__ slots,      // [NB], -1: not fused
                           const int* __restrict__ win_off,    // [K, NB, 2] (y0, xb)
                           const int* __restrict__ cls,        // [K, NB] or null
                           void* __restrict__ tsdf_out,        // see Store
                           __nv_bfloat16* __restrict__ color,  // see Store
                           bool* __restrict__ visited,         // [NB], kBlockMajor
                           int K, int H, int W, int NB, int nbx, int nby, int Vx, int Vy,
                           int wy, int wx, int xstride, float limit) {
  const int j = blockIdx.x;
  const int tid = threadIdx.x;
  // Two roles: block j < count fuses slot j of the occupied list, and
  // block j clears the idle bricks among CB j .. CB j + CB - 1 before. The
  // fused blocks come first; the clear-only blocks after them.
  int st[CB];
#pragma unroll
  for (int i = 0; i < CB; ++i) st[i] = j * CB + i < NB ? slots[j * CB + i] : 0;
#pragma unroll
  for (int i = 0; i < CB; ++i) {
    const int q = j * CB + i;
    if (q >= NB) break;
    if (kStore == kBlockMajor) {
      if (tid == 0) visited[q] = st[i] >= 0;
    } else if (st[i] < 0) {
      clear_brick<kStore>(tsdf_out, color, q / (nby * nbx) * BRICK, (q / nbx) % nby * BRICK,
                          q % nbx * BRICK, Vx, Vy, limit);
    }
  }
  if (j >= *count) return;
  const int b = idx[j];

  // the brick's warps: u -> u*W - 0.5 - x_lo (the GL half-texel and the
  // window origin folded into the constant), v likewise, d as baked; then
  // each slice's z folded in, leaving c + cy y + cx x + cyy y^2 + cxx x^2
  // + cyx y x
  __shared__ float cq[MAXK][3][BRICK * NQ];
  __shared__ int s_ylo[MAXK], s_xlo[MAXK], s_cls[MAXK], s_hiu[MAXK], s_hiv[MAXK];
  __shared__ float s_corner[MAXK][6];
  for (int i = tid; i < K * 3 * BRICK; i += BLOCK) {
    const int k = i / (3 * BRICK), c = (i / BRICK) % 3, sl = i % BRICK;
    const size_t kb = static_cast<size_t>(k) * NB + b;
    const float* src = coeffs + (kb * 4 + c) * NBASIS;
    float a[NBASIS];
    for (int n = 0; n < NBASIS; ++n) {
      float v = src[n];
      if (c == 0) v = v * static_cast<float>(W);
      if (c == 1) v = v * static_cast<float>(H);
      a[n] = v;
    }
    if (c == 0) a[0] = a[0] + -(static_cast<float>(win_off[kb * 2 + 1] * xstride) + 0.5f);
    if (c == 1) a[0] = a[0] + -(static_cast<float>(win_off[kb * 2]) + 0.5f);
    // basis (1, z, y, x, z^2, y^2, x^2, zy, zx, yx) at centred coordinates
    const float z = static_cast<float>(sl) - 7.5f;
    float* o = &cq[k][c][sl * NQ];
    o[0] = a[0] + z * a[1] + z * z * a[4];
    o[1] = a[2] + z * a[7];
    o[2] = a[3] + z * a[8];
    o[3] = a[5];
    o[4] = a[6];
    o[5] = a[9];
  }
  if (tid < K) {
    const size_t kb = static_cast<size_t>(tid) * NB + b;
    const int ylo = win_off[kb * 2], xlo = win_off[kb * 2 + 1] * xstride;
    s_ylo[tid] = ylo;
    s_xlo[tid] = xlo;
    s_hiu[tid] = min(W - 1 - xlo, wx - 1);
    s_hiv[tid] = min(H - 1 - ylo, wy - 1);
    s_cls[tid] = cls ? cls[kb] : 0;
    const size_t px = static_cast<size_t>(tid) * H * W;   // the corner pixel
    for (int c = 0; c < 4; ++c) s_corner[tid][c] = plane_a[px * 4 + c];
    for (int c = 0; c < 2; ++c) s_corner[tid][4 + c] = plane_b[px * 2 + c];
  }
  __syncthreads();

  const int bz = b / (nby * nbx);
  const int by = (b / nbx) % nby;
  const int bx = b % nbx;
  const int ly = (tid / BRICK) % BRICK;
  const int lx = tid % BRICK;
  const float fy = static_cast<float>(ly) - 7.5f;
  const float fx = static_cast<float>(lx) - 7.5f;
  for (int zl = 0; zl < ZL; ++zl) {
    const int lz = tid / THREADS * ZL + zl;
    Fuse s = fuse_init(limit);
    for (int k = 0; k < K; ++k) {
      const int kc = s_cls[k];
      if (kc == 1) continue;                       // NONE: provably no change
      if (kc == 2) { s.wt = -limit; continue; }    // FRONT
      const float* cv = s_corner[k];
      if (kc == 3) {                               // INVALID: corner constants, d = 0
        fuse(s, 0.f, cv[0], cv[1], 1.f - cv[2], cv[3], cv[4], cv[5], limit);
        continue;
      }
      float p[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float* q = &cq[k][c][lz * NQ];
        const float ty = fmaf(q[5], fx, fmaf(q[3], fy, q[1]));
        const float tx = fmaf(q[4], fx, q[2]);
        p[c] = fmaf(fx, tx, fmaf(fy, ty, q[0]));
      }
      const float pu = p[0], pv = p[1], pd = p[2];
      const int xlo = s_xlo[k], ylo = s_ylo[k];
      const bool invalid = pu < -0.5f - (float)xlo || pu > (float)W - 0.5f - (float)xlo ||
                           pv < -0.5f - (float)ylo || pv > (float)H - 0.5f - (float)ylo ||
                           pd < 0.f || pd > 1.f;
      float depth;
      float ch[5];
      if (invalid) {
        depth = cv[0];
        ch[0] = 1.f - cv[2]; ch[1] = cv[1]; ch[2] = cv[3]; ch[3] = cv[4]; ch[4] = cv[5];
      } else {
        const float hu = (float)s_hiu[k], hv = (float)s_hiv[k];
        const size_t img = static_cast<size_t>(k) * H * W;
        const float cu = fminf(fmaxf(pu, 0.f), hu);
        const float cvv = fminf(fmaxf(pv, 0.f), hv);
        const float iu = floorf(cu), iv = floorf(cvv);
        float d4[4];
        bilinear5_planes(plane_a + img * 4, plane_b + img * 2, W, ylo + (int)iv,
                         ylo + min((int)iv + 1, s_hiv[k]), xlo + (int)iu,
                         xlo + min((int)iu + 1, s_hiu[k]), cu - iu, cvv - iv, ch, d4);
        // NEAREST: floor(p + 0.5) clamped to the window is the LINEAR tap's
        // index or the next one
        const float nu = fminf(fmaxf(floorf(pu + 0.5f), 0.f), hu);
        const float nv = fminf(fmaxf(floorf(pv + 0.5f), 0.f), hv);
        const float d_top = nu == iu ? d4[0] : d4[1];
        const float d_bot = nu == iu ? d4[2] : d4[3];
        depth = nv == iv ? d_top : d_bot;
      }
      fuse(s, pd, depth, ch[1], ch[0], ch[2], ch[3], ch[4], limit);
    }
    float o[4];
    fuse_color(s, o);

    if (kStore == kBlockMajor) {
      const int t = lz * THREADS + ly * BRICK + lx;    // z-major voxel within the brick
      static_cast<float*>(tsdf_out)[static_cast<size_t>(b) * B3 + t] = s.wt;
      __nv_bfloat16* cb = color + static_cast<size_t>(b) * 4 * B3 + t;
#pragma unroll
      for (int c = 0; c < 4; ++c) cb[c * B3] = __float2bfloat16_rn(o[c]);
      continue;
    }
    const size_t plane = static_cast<size_t>(Vy) * Vx;
    const size_t z = static_cast<size_t>(bz * BRICK + lz);
    const size_t col = static_cast<size_t>(by * BRICK + ly) * Vx + bx * BRICK + lx;
    if (kStore == kChannelsLast) {
      static_cast<float*>(tsdf_out)[z * plane + col] = s.wt;
      const __nv_bfloat162 rg = __floats2bfloat162_rn(o[0], o[1]);
      const __nv_bfloat162 bf = __floats2bfloat162_rn(o[2], o[3]);
      uint2 packed4;
      packed4.x = *reinterpret_cast<const uint32_t*>(&rg);
      packed4.y = *reinterpret_cast<const uint32_t*>(&bf);
      reinterpret_cast<uint2*>(color)[z * plane + col] = packed4;
    } else {
      static_cast<__nv_bfloat16*>(tsdf_out)[z * plane + col] = __float2bfloat16_rn(s.wt);
      __nv_bfloat16* cz = color + z * 4 * plane + col;
#pragma unroll
      for (int c = 0; c < 4; ++c) cz[c * plane] = __float2bfloat16_rn(o[c]);
    }
  }
}

template <Store kStore>
int launch(const float* plane_a, const float* plane_b, const float* coeffs, const int* idx,
           const int* count, const int* slots, const int* win_off, const int* cls, void* tsdf,
           __nv_bfloat16* color, bool* visited, int K, int H, int W, int NB, int nbx, int nby,
           int max_bricks, int wy, int wx, int xstride, float limit, cudaStream_t stream) {
  if (K < 1 || K > MAXK) return static_cast<int>(cudaErrorInvalidValue);
  // enough blocks for every slot of the list and for the clear
  const int grid = max(max_bricks, (NB + CB - 1) / CB);
  if (grid > 0)
    integrate_quadratic_kernel<kStore><<<grid, BLOCK, 0, stream>>>(
        plane_a, plane_b, coeffs, idx, count, slots, win_off, cls, tsdf, color, visited, K, H,
        W, NB, nbx, nby, nbx * BRICK, nby * BRICK, wy, wx, xstride, limit);
  return rr_status();
}

}  // namespace

RR_API int rr_integrate_dense(const float* plane_a, const float* plane_b, const float* coeffs,
                              const int* idx, const int* count, const int* slots,
                              const int* win_off, const int* cls, __nv_bfloat16* tsdf,
                              __nv_bfloat16* color, int K, int H, int W, int NB, int nbx,
                              int nby, int max_bricks, int wy, int wx, int xstride, float limit,
                              cudaStream_t stream) {
  return launch<kZMajor>(plane_a, plane_b, coeffs, idx, count, slots, win_off, cls, tsdf,
                         color, nullptr, K, H, W, NB, nbx, nby, max_bricks, wy, wx, xstride,
                         limit, stream);
}

RR_API int rr_integrate_affine(const float* plane_a, const float* plane_b, const float* coeffs,
                               const int* idx, const int* count, const int* slots,
                               const int* win_off, float* tsdf, __nv_bfloat16* color,
                               bool* visited, int K, int H, int W, int NB, int nbx, int nby,
                               int max_bricks, int wy, int wx, int xstride, float limit,
                               cudaStream_t stream) {
  // visited (raw mode) null: voxel order
  if (visited)
    return launch<kBlockMajor>(plane_a, plane_b, coeffs, idx, count, slots, win_off, nullptr,
                               tsdf, color, visited, K, H, W, NB, nbx, nby, max_bricks, wy, wx,
                               xstride, limit, stream);
  return launch<kChannelsLast>(plane_a, plane_b, coeffs, idx, count, slots, win_off, nullptr,
                               tsdf, color, nullptr, K, H, W, NB, nbx, nby, max_bricks, wy, wx,
                               xstride, limit, stream);
}

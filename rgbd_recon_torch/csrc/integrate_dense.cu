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
//                        z-major [lz, ly, lx] block per occupied brick, and
//                        visited bool [NB]; nothing else is cleared (blocks
//                        of unoccupied bricks keep whatever the buffer held).
//
// Fusion math tsdf_persist.py::fuse_chunk_v3 / _fuse_update (reference
// tsdf_integration.vs:23-59, tsdf_raymarch.fs:295-320). For every voxel of
// every occupied 16^3 brick and every sensor k: evaluate the brick's
// quadratic voxel -> (u, v, d) warp from AffineTables.coeffs, place it in
// the brick's sampling window (window-relative pixel coordinates, clamped
// to the window), read the depth NEAREST and (1 - silhouette), quality and
// registered rgb LINEAR from the packed frame, substitute the corner pixel
// for voxels outside the image or depth range, apply the per-(sensor,
// brick) class (FULL / NONE / FRONT / INVALID) and fuse. Voxels of
// unoccupied bricks hold the clear values (-limit, 0).
//
// Bound on the card: the per-voxel work (~60 flops of warp + 21 scattered
// 4-byte reads per sensor) over ~1-2 K occupied bricks x 4 sensors at the
// bench shape reads ~0.7 GB of mostly L2-resident frame data; the full
// clear of the dense outputs (256^3 x 10 bytes = 168 MB for the z-major
// layout, 14 bytes a voxel for the block-major one) is the largest single
// memory term. Design: one 256-thread block per occupied brick (blocks
// past the occupied count exit at once), one thread per (y, x) column of
// the brick looping over its 16 z voxels, the brick's warp coefficients
// (scaled and window-folded) and window origins staged in shared memory,
// fp32 taps read straight from the packed frame (no bf16 windows, no
// hat-weight matmuls).
#include "fuse.cuh"

namespace {

using namespace rr;
constexpr int NBASIS = 10;

enum Store { kZMajor, kChannelsLast, kBlockMajor };

template <Store kStore>
__global__ void __launch_bounds__(THREADS)
integrate_quadratic_kernel(const float* __restrict__ packed,   // [K, H, W, 6]
                           const float* __restrict__ coeffs,   // [K, NB, 4, NBASIS]
                           const int* __restrict__ idx,        // [max_bricks]
                           const int* __restrict__ count,      // [1]
                           const int* __restrict__ win_off,    // [K, NB, 2] (y0, xb)
                           const int* __restrict__ cls,        // [K, NB] or null
                           void* __restrict__ tsdf_out,        // see Store
                           __nv_bfloat16* __restrict__ color,  // see Store
                           bool* __restrict__ visited,         // [NB], kBlockMajor
                           int K, int H, int W, int NB, int nbx, int nby, int Vx, int Vy,
                           int wy, int wx, int xstride, float limit) {
  const int slot = blockIdx.x;
  if (slot >= *count) return;
  const int b = idx[slot];
  if (kStore == kBlockMajor && threadIdx.x == 0) visited[b] = true;

  __shared__ float cs[MAXK][3][NBASIS];
  __shared__ int s_ylo[MAXK], s_xlo[MAXK], s_cls[MAXK], s_hiu[MAXK], s_hiv[MAXK];
  __shared__ float s_corner[MAXK][6];
  const int tid = threadIdx.x;
  for (int i = tid; i < K * 3 * NBASIS; i += THREADS) {
    const int k = i / (3 * NBASIS);
    const int c = (i / NBASIS) % 3;
    const int a = i % NBASIS;
    const size_t kb = static_cast<size_t>(k) * NB + b;
    float v = coeffs[(kb * 4 + c) * NBASIS + a];
    // scale u, v to pixels, then fold the window origin (and the GL
    // half-texel) into the constant term: u -> u*W - 0.5 - x_lo
    if (c == 0) v = v * static_cast<float>(W);
    if (c == 1) v = v * static_cast<float>(H);
    if (a == 0 && c == 0) v = v + -(static_cast<float>(win_off[kb * 2 + 1] * xstride) + 0.5f);
    if (a == 0 && c == 1) v = v + -(static_cast<float>(win_off[kb * 2]) + 0.5f);
    cs[k][c][a] = v;
  }
  if (tid < K) {
    const size_t kb = static_cast<size_t>(tid) * NB + b;
    const int ylo = win_off[kb * 2];
    const int xlo = win_off[kb * 2 + 1] * xstride;
    s_ylo[tid] = ylo;
    s_xlo[tid] = xlo;
    s_hiu[tid] = min(W - 1 - xlo, wx - 1);
    s_hiv[tid] = min(H - 1 - ylo, wy - 1);
    s_cls[tid] = cls ? cls[kb] : 0;
    const float* c0 = packed + static_cast<size_t>(tid) * H * W * 6;
    for (int c = 0; c < 6; ++c) s_corner[tid][c] = c0[c];
  }
  __syncthreads();

  const int bz = b / (nby * nbx);
  const int by = (b / nbx) % nby;
  const int bx = b % nbx;
  const int ly = tid / BRICK;
  const int lx = tid % BRICK;
  const float fly = static_cast<float>(ly) - 7.5f;
  const float flx = static_cast<float>(lx) - 7.5f;
  const size_t plane = static_cast<size_t>(Vy) * Vx;
  const size_t col = static_cast<size_t>(by * BRICK + ly) * Vx + bx * BRICK + lx;

  for (int lz = 0; lz < BRICK; ++lz) {
    const float flz = static_cast<float>(lz) - 7.5f;
    const float basis[NBASIS] = {1.f,       flz,       fly,       flx,       flz * flz,
                                 fly * fly, flx * flx, flz * fly, flz * flx, fly * flx};
    Fuse s = fuse_init(limit);
    for (int k = 0; k < K; ++k) {
      const int kc = s_cls[k];
      if (kc == 1) continue;                 // NONE: provably no change
      if (kc == 2) { s.wt = -limit; continue; }   // FRONT
      const float* cv = s_corner[k];
      if (kc == 3) {                         // INVALID: corner constants, d = 0
        fuse(s, 0.f, cv[0], cv[1], 1.f - cv[2], cv[3], cv[4], cv[5], limit);
        continue;
      }
      float pu = 0.f, pv = 0.f, pd = 0.f;
#pragma unroll
      for (int a = 0; a < NBASIS; ++a) {
        pu += cs[k][0][a] * basis[a];
        pv += cs[k][1][a] * basis[a];
        pd += cs[k][2][a] * basis[a];
      }
      const int xlo = s_xlo[k], ylo = s_ylo[k];
      const bool invalid =
          pu < -0.5f - (float)xlo || pu > (float)W - 0.5f - (float)xlo ||
          pv < -0.5f - (float)ylo || pv > (float)H - 0.5f - (float)ylo ||
          pd < 0.f || pd > 1.f;
      float depth;
      float ch[5];
      if (invalid) {
        depth = cv[0];
        ch[0] = 1.f - cv[2]; ch[1] = cv[1]; ch[2] = cv[3]; ch[3] = cv[4]; ch[4] = cv[5];
      } else {
        const float hu = (float)s_hiu[k], hv = (float)s_hiv[k];
        const float* img = packed + static_cast<size_t>(k) * H * W * 6;
        // NEAREST depth
        const int nu = (int)fminf(fmaxf(floorf(pu + 0.5f), 0.f), hu);
        const int nv = (int)fminf(fmaxf(floorf(pv + 0.5f), 0.f), hv);
        depth = img[(static_cast<size_t>(ylo + nv) * W + xlo + nu) * 6];
        // LINEAR (1 - sil), qual, rgb
        const float cu = fminf(fmaxf(pu, 0.f), hu);
        const float cvv = fminf(fmaxf(pv, 0.f), hv);
        const float iu = floorf(cu), iv = floorf(cvv);
        bilinear5(img, W, ylo + (int)iv, ylo + min((int)iv + 1, s_hiv[k]), xlo + (int)iu,
                  xlo + min((int)iu + 1, s_hiu[k]), cu - iu, cvv - iv, ch);
      }
      fuse(s, pd, depth, ch[1], ch[0], ch[2], ch[3], ch[4], limit);
    }
    float o[4];
    fuse_color(s, o);
    const size_t z = static_cast<size_t>(bz * BRICK + lz);
    if (kStore == kBlockMajor) {
      const size_t v = static_cast<size_t>(b) * B3 + lz * THREADS + tid;
      static_cast<float*>(tsdf_out)[v] = s.wt;
      __nv_bfloat16* cb = color + static_cast<size_t>(b) * 4 * B3 + lz * THREADS + tid;
#pragma unroll
      for (int c = 0; c < 4; ++c) cb[c * B3] = __float2bfloat16_rn(o[c]);
    } else if (kStore == kChannelsLast) {
      static_cast<float*>(tsdf_out)[z * plane + col] = s.wt;
      __nv_bfloat16* cz = color + (z * plane + col) * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c) cz[c] = __float2bfloat16_rn(o[c]);
    } else {
      static_cast<__nv_bfloat16*>(tsdf_out)[z * plane + col] = __float2bfloat16_rn(s.wt);
      __nv_bfloat16* cz = color + z * 4 * plane + col;
#pragma unroll
      for (int c = 0; c < 4; ++c) cz[c * plane] = __float2bfloat16_rn(o[c]);
    }
  }
}

template <Store kStore>
int launch(const float* packed, const float* coeffs, const int* idx, const int* count,
           const int* win_off, const int* cls, void* tsdf, __nv_bfloat16* color,
           bool* visited, int K,
           int H, int W, int NB, int nbx, int nby, int nbz, int max_bricks, int wy, int wx,
           int xstride, float limit, cudaStream_t stream) {
  if (K > MAXK) return static_cast<int>(cudaErrorInvalidValue);
  const int Vx = nbx * BRICK, Vy = nby * BRICK, Vz = nbz * BRICK;
  const long long n = static_cast<long long>(Vx) * Vy * Vz;
  if (kStore == kChannelsLast)
    fill_kernel<float><<<1024, 256, 0, stream>>>(static_cast<float*>(tsdf), n, -limit);
  else if (kStore == kZMajor)
    fill_kernel<__nv_bfloat16><<<1024, 256, 0, stream>>>(
        static_cast<__nv_bfloat16*>(tsdf), n, __float2bfloat16_rn(-limit));
  if (kStore != kBlockMajor) cudaMemsetAsync(color, 0, 4 * n * sizeof(__nv_bfloat16), stream);
  if (kStore == kBlockMajor) cudaMemsetAsync(visited, 0, NB * sizeof(bool), stream);
  if (max_bricks > 0)
    integrate_quadratic_kernel<kStore><<<max_bricks, THREADS, 0, stream>>>(
        packed, coeffs, idx, count, win_off, cls, tsdf, color, visited, K, H, W, NB, nbx, nby,
        Vx, Vy, wy, wx, xstride, limit);
  return rr_status();
}

}  // namespace

RR_API int rr_integrate_dense(const float* packed, const float* coeffs, const int* idx,
                              const int* count, const int* win_off, const int* cls,
                              __nv_bfloat16* tsdf, __nv_bfloat16* color, int K, int H,
                              int W, int NB, int nbx, int nby, int nbz, int max_bricks,
                              int wy, int wx, int xstride, float limit,
                              cudaStream_t stream) {
  return launch<kZMajor>(packed, coeffs, idx, count, win_off, cls, tsdf, color, nullptr, K,
                         H, W, NB, nbx, nby, nbz, max_bricks, wy, wx, xstride, limit, stream);
}

RR_API int rr_integrate_affine(const float* packed, const float* coeffs, const int* idx,
                               const int* count, const int* win_off, float* tsdf,
                               __nv_bfloat16* color, bool* visited, int K, int H, int W,
                               int NB, int nbx, int nby, int nbz, int max_bricks, int wy,
                               int wx, int xstride, float limit, cudaStream_t stream) {
  // visited (raw mode) null: voxel order
  if (visited)
    return launch<kBlockMajor>(packed, coeffs, idx, count, win_off, nullptr, tsdf, color,
                               visited, K, H, W, NB, nbx, nby, nbz, max_bricks, wy, wx,
                               xstride, limit, stream);
  return launch<kChannelsLast>(packed, coeffs, idx, count, win_off, nullptr, tsdf, color,
                               nullptr, K, H, W, NB, nbx, nby, nbz, max_bricks, wy, wx,
                               xstride, limit, stream);
}

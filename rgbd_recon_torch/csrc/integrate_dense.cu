// Brick-sparse TSDF + color fusion writing the dense bf16 volumes.
//
// Replaces rgbd_recon_tpu/ops/tsdf_dense.py::integrate_dense_pallas (fusion
// math tsdf_persist.py::fuse_chunk_v3 / _fuse_update; reference
// tsdf_integration.vs:23-59 and tsdf_raymarch.fs:295-320). For every voxel
// of every occupied 16^3 brick and every sensor k: evaluate the brick's
// quadratic voxel -> (u, v, d) warp from AffineTables.coeffs, place it in
// the brick's sampling window (window-relative pixel coordinates, clamped
// to the window), read the depth NEAREST and (1 - silhouette), quality and
// registered rgb LINEAR from the packed frame, substitute the corner pixel
// for voxels outside the image or depth range, apply the per-(sensor,
// brick) class (FULL / NONE / FRONT / INVALID from the depth-band cull) and
// fuse; then write bf16 TSDF [Vz, Vy, Vx] and bf16 color [Vz, 4, Vy, Vx].
// Voxels of unoccupied bricks hold the clear values (-limit, 0).
//
// Bound on the card: the per-voxel work (~60 flops of warp + 21 scattered
// 4-byte reads per sensor) over ~1-2 K occupied bricks x 4 sensors at the
// bench shape reads ~0.7 GB of mostly L2-resident frame data; the full
// clear of the dense outputs (256^3 x 10 bytes = 168 MB) is the largest
// single memory term. Design: one 256-thread block per occupied brick
// (blocks past the occupied count exit at once), one thread per (y, x)
// column of the brick looping over its 16 z voxels, the brick's warp
// coefficients (scaled and window-folded) and window origins staged in
// shared memory, fp32 taps read straight from the packed frame (no bf16
// windows, no hat-weight matmuls), and coalesced 16-voxel rows stored.
#include "common.cuh"

namespace {

constexpr int BRICK = 16;
constexpr int NBASIS = 10;
constexpr int MAXK = 8;
constexpr int THREADS = BRICK * BRICK;
// silhouette gate: (1 - sil) sampled LINEAR must stay under 1 - 0.998
// (tsdf_pallas.py SIL_PL), the constant rounded from double as in the
// reference
constexpr float SIL_GATE = static_cast<float>(1.0 - 0.998);

struct Fuse {
  float wt, tw, tc0, tc1, tc2, tcw, td0, td1, td2, tdw;
};

__device__ __forceinline__ void fuse(Fuse& s, float d_vox, float depth, float qual,
                                     float sflip, float r, float g, float b,
                                     float limit) {
  const float sdist = d_vox - depth;
  const bool skip = (sflip > SIL_GATE) && (s.wt >= limit);
  const bool in_front = sdist <= -limit;
  const bool in_band = (sdist > -limit) && (sdist < limit);
  const float new_tw = s.tw + qual;
  const float accum = new_tw > 0.f ? (s.wt * s.tw + qual * sdist) / new_tw : s.wt;
  const float wt_next = in_front ? -limit : (in_band ? accum : s.wt);
  const float tw_next = (in_band && new_tw > 0.f) ? new_tw : s.tw;
  s.wt = skip ? -limit : wt_next;
  s.tw = skip ? s.tw : tw_next;

  const float dist = fabsf(depth - d_vox);
  const float q_c = dist < limit ? qual : 0.f;
  const float w_c = q_c / (dist + 0.01f);
  s.tc0 += r * w_c;
  s.tc1 += g * w_c;
  s.tc2 += b * w_c;
  s.tcw += w_c;
  const float w2 = 1.f / fmaxf(dist, 1e-9f);
  s.td0 += r * w2;
  s.td1 += g * w2;
  s.td2 += b * w2;
  s.tdw += w2;
}

__global__ void clear_tsdf_kernel(__nv_bfloat16* __restrict__ tsdf, long long n,
                                  float value) {
  const __nv_bfloat16 v = __float2bfloat16_rn(value);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    tsdf[i] = v;
}

__global__ void __launch_bounds__(THREADS)
integrate_dense_kernel(const float* __restrict__ packed,   // [K, H, W, 6]
                       const float* __restrict__ coeffs,   // [K, NB, 4, NBASIS]
                       const int* __restrict__ idx,        // [max_bricks]
                       const int* __restrict__ count,      // [1]
                       const int* __restrict__ win_off,    // [K, NB, 2] (y0, xb)
                       const int* __restrict__ cls,        // [K, NB] or null
                       __nv_bfloat16* __restrict__ tsdf,   // [Vz, Vy, Vx]
                       __nv_bfloat16* __restrict__ color,  // [Vz, 4, Vy, Vx]
                       int K, int H, int W, int NB, int nbx, int nby, int Vx, int Vy,
                       int wy, int wx, int xstride, float limit) {
  const int slot = blockIdx.x;
  if (slot >= *count) return;
  const int b = idx[slot];

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
    Fuse s = {limit, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
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
      float depth, qual, sflip, r, g, bb;
      if (invalid) {
        depth = cv[0]; qual = cv[1]; sflip = 1.f - cv[2];
        r = cv[3]; g = cv[4]; bb = cv[5];
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
        const float gu = cu - iu, gv = cvv - iv;
        const int u0 = xlo + (int)iu, u1 = xlo + min((int)iu + 1, s_hiu[k]);
        const int v0 = ylo + (int)iv, v1 = ylo + min((int)iv + 1, s_hiv[k]);
        const float* t00 = img + (static_cast<size_t>(v0) * W + u0) * 6;
        const float* t01 = img + (static_cast<size_t>(v0) * W + u1) * 6;
        const float* t10 = img + (static_cast<size_t>(v1) * W + u0) * 6;
        const float* t11 = img + (static_cast<size_t>(v1) * W + u1) * 6;
        float ch[5];
#pragma unroll
        for (int c = 0; c < 5; ++c) {
          const int q = c == 0 ? 2 : (c == 1 ? 1 : c + 1);   // sil, qual, r, g, b
          float a00 = t00[q], a01 = t01[q], a10 = t10[q], a11 = t11[q];
          if (c == 0) { a00 = 1.f - a00; a01 = 1.f - a01; a10 = 1.f - a10; a11 = 1.f - a11; }
          const float left = (1.f - gv) * a00 + gv * a10;
          const float right = (1.f - gv) * a01 + gv * a11;
          ch[c] = (1.f - gu) * left + gu * right;
        }
        sflip = ch[0]; qual = ch[1]; r = ch[2]; g = ch[3]; bb = ch[4];
      }
      fuse(s, pd, depth, qual, sflip, r, g, bb, limit);
    }
    const bool hasq = s.tcw > 0.f;
    const float o0 = hasq ? s.tc0 / fmaxf(s.tcw, 1e-20f) : s.td0 / fmaxf(s.tdw, 1e-20f);
    const float o1 = hasq ? s.tc1 / fmaxf(s.tcw, 1e-20f) : s.td1 / fmaxf(s.tdw, 1e-20f);
    const float o2 = hasq ? s.tc2 / fmaxf(s.tcw, 1e-20f) : s.td2 / fmaxf(s.tdw, 1e-20f);
    const size_t z = static_cast<size_t>(bz * BRICK + lz);
    tsdf[z * plane + col] = __float2bfloat16_rn(s.wt);
    __nv_bfloat16* cz = color + z * 4 * plane + col;
    cz[0] = __float2bfloat16_rn(o0);
    cz[plane] = __float2bfloat16_rn(o1);
    cz[2 * plane] = __float2bfloat16_rn(o2);
    cz[3 * plane] = __float2bfloat16_rn(hasq ? 1.f : -1.f);
  }
}

}  // namespace

RR_API int rr_integrate_dense(const float* packed, const float* coeffs, const int* idx,
                              const int* count, const int* win_off, const int* cls,
                              __nv_bfloat16* tsdf, __nv_bfloat16* color, int K, int H,
                              int W, int NB, int nbx, int nby, int nbz, int max_bricks,
                              int wy, int wx, int xstride, float limit,
                              cudaStream_t stream) {
  if (K > MAXK) return static_cast<int>(cudaErrorInvalidValue);
  const int Vx = nbx * BRICK, Vy = nby * BRICK, Vz = nbz * BRICK;
  const long long n = static_cast<long long>(Vx) * Vy * Vz;
  clear_tsdf_kernel<<<1024, 256, 0, stream>>>(tsdf, n, -limit);
  cudaMemsetAsync(color, 0, 4 * n * sizeof(__nv_bfloat16), stream);
  if (max_bricks > 0)
    integrate_dense_kernel<<<max_bricks, THREADS, 0, stream>>>(
        packed, coeffs, idx, count, win_off, cls, tsdf, color, K, H, W, NB, nbx, nby,
        Vx, Vy, wy, wx, xstride, limit);
  return rr_status();
}

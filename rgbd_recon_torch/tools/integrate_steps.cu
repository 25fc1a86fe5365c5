// The steps from the first quadratic integrator (kernels 1 and 6,
// csrc/integrate_dense.cu) to the current one, one change at a time, for
// timing them apart (integrate_steps.py). Each step runs in the three store
// modes: z-major (kernel 1), channels-last voxel order and block-major raw
// (kernel 6).
//   step 0  the first kernel: a fill kernel and a memset clear the dense
//           outputs, then one 256-thread block per occupied slot loops its
//           (y, x) column over the brick's 16 z voxels;
//   step 1  + one launch over every brick, the clear stored by the blocks
//           of bricks that are not fused (16-byte stores), the per-brick
//           slot map instead of the list (same block shape and math);
//   step 2  + one thread per voxel, each brick in z-slabs of ZS slices
//           (ZS = 1, 2, 4);
//   step 3  + __fdividef for the quotients of the fusion update, one
//           reciprocal for the final color;
//   step 4  + each pixel read as three 8-byte loads, the NEAREST depth
//           picked from the LINEAR taps;
//   step 5  + the warp folded over each slice's z into a 6-term (y, x)
//           quadratic (ZS = 1, 2, 4);
//   step 6  + the bricks taken in a spread order, brick = item * 1031 mod
//           NB, so the blocks of fused bricks mix with those of idle ones
//           (ZS = 1, 2);
//   step 7  + 32-byte pixels (the frame padded to 8 channels), two 16-byte
//           loads a tap (ZS = 1, 2);
//   step 8  step 5 with two roles a block: block q clears brick q's slab
//           in ascending order if q is not fused, and fuses the slab of
//           slot (q * 1031 mod NB) of the occupied list if that is below
//           the count (ZS = 1, 2);
//   step 9  + the frame in two planes, (depth, qual, sil, r) and (g, b):
//           one 16-byte and one 8-byte load a tap, each over dense rows
//           (ZS = 1, 2);
//   step 10 step 9 at 32 registers (ZS = 2);
//   step 11 step 5 with one block a brick: TZ slices of threads each
//           looping over 16 / TZ slices (TZ = 1, 2, 4), so the clear is one
//           block a brick (40-48 KB) and the fused bricks fit in about one
//           wave;
//   step 12 step 11 with the two planes of step 9 (TZ = 2, 4; and TZ = 2
//           held to 40 registers, zs = 3);
//   step 13 step 12 with the taps weighted first: the four bilinear weights
//           once, then each tap's channels added in as it arrives (20 FMA
//           for the five channels instead of 30 operations, and one tap's
//           values live at a time) (TZ = 2 at 40 registers, TZ = 4);
//   step 14 step 12's fusion in a grid that puts the fused bricks first
//           (block j fuses slot j of the occupied list), with four layouts
//           of the clear (first_kernel); layout 0 at 1,024 threads is the
//           current kernel's.
// Every step computes the function of the plain version to the integrator
// bound; steps 0-2 share one arithmetic, steps 3-14 another.
#include "../csrc/fuse.cuh"

namespace {

using namespace rr;
constexpr int NBASIS = 10;
enum Store { kZMajor, kChannelsLast, kBlockMajor };

// ---- the first kernel's fusion arithmetic: IEEE quotients, scalar taps ----
namespace v0 {

__device__ __forceinline__ void fuse(Fuse& s, float d_vox, float depth, float qual,
                                     float sflip, float r, float g, float b, float limit) {
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

__device__ __forceinline__ void fuse_color(const Fuse& s, float out[4]) {
  const bool hasq = s.tcw > 0.f;
  out[0] = hasq ? s.tc0 / fmaxf(s.tcw, 1e-20f) : s.td0 / fmaxf(s.tdw, 1e-20f);
  out[1] = hasq ? s.tc1 / fmaxf(s.tcw, 1e-20f) : s.td1 / fmaxf(s.tdw, 1e-20f);
  out[2] = hasq ? s.tc2 / fmaxf(s.tcw, 1e-20f) : s.td2 / fmaxf(s.tdw, 1e-20f);
  out[3] = hasq ? 1.f : -1.f;
}

__device__ __forceinline__ void bilinear5(const float* __restrict__ img, int W, int v0,
                                          int v1, int u0, int u1, float gu, float gv,
                                          float out[5]) {
  const float* t00 = img + (static_cast<size_t>(v0) * W + u0) * 6;
  const float* t01 = img + (static_cast<size_t>(v0) * W + u1) * 6;
  const float* t10 = img + (static_cast<size_t>(v1) * W + u0) * 6;
  const float* t11 = img + (static_cast<size_t>(v1) * W + u1) * 6;
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const int q = c == 0 ? 2 : (c == 1 ? 1 : c + 1);
    float a00 = t00[q], a01 = t01[q], a10 = t10[q], a11 = t11[q];
    if (c == 0) { a00 = 1.f - a00; a01 = 1.f - a01; a10 = 1.f - a10; a11 = 1.f - a11; }
    const float left = (1.f - gv) * a00 + gv * a10;
    const float right = (1.f - gv) * a01 + gv * a11;
    out[c] = (1.f - gu) * left + gu * right;
  }
}

}  // namespace v0

// One voxel's store in each layout.
template <Store kStore>
__device__ __forceinline__ void store_voxel(void* tsdf_out, __nv_bfloat16* color, int b,
                                            int lz, int ly, int lx, int bz, int by, int bx,
                                            int Vx, int Vy, float wt, const float o[4]) {
  const int t = lz * THREADS + ly * BRICK + lx;
  if (kStore == kBlockMajor) {
    static_cast<float*>(tsdf_out)[static_cast<size_t>(b) * B3 + t] = wt;
    __nv_bfloat16* cb = color + static_cast<size_t>(b) * 4 * B3 + t;
#pragma unroll
    for (int c = 0; c < 4; ++c) cb[c * B3] = __float2bfloat16_rn(o[c]);
    return;
  }
  const size_t plane = static_cast<size_t>(Vy) * Vx;
  const size_t z = static_cast<size_t>(bz * BRICK + lz);
  const size_t col = static_cast<size_t>(by * BRICK + ly) * Vx + bx * BRICK + lx;
  if (kStore == kChannelsLast) {
    static_cast<float*>(tsdf_out)[z * plane + col] = wt;
    __nv_bfloat16* cz = color + (z * plane + col) * 4;
#pragma unroll
    for (int c = 0; c < 4; ++c) cz[c] = __float2bfloat16_rn(o[c]);
  } else {
    static_cast<__nv_bfloat16*>(tsdf_out)[z * plane + col] = __float2bfloat16_rn(wt);
    __nv_bfloat16* cz = color + z * 4 * plane + col;
#pragma unroll
    for (int c = 0; c < 4; ++c) cz[c * plane] = __float2bfloat16_rn(o[c]);
  }
}

// ---- step 0: the first kernel ---------------------------------------------
template <Store kStore>
__global__ void __launch_bounds__(THREADS)
step0_kernel(const float* __restrict__ packed, const float* __restrict__ coeffs,
             const int* __restrict__ idx, const int* __restrict__ count,
             const int* __restrict__ win_off, const int* __restrict__ cls,
             void* __restrict__ tsdf_out, __nv_bfloat16* __restrict__ color,
             bool* __restrict__ visited, int K, int H, int W, int NB, int nbx, int nby, int Vx,
             int Vy, int wy, int wx, int xstride, float limit) {
  const int slot = blockIdx.x;
  if (slot >= *count) return;
  const int b = idx[slot];
  if (kStore == kBlockMajor && threadIdx.x == 0) visited[b] = true;
  __shared__ float cs[MAXK][3][NBASIS];
  __shared__ int s_ylo[MAXK], s_xlo[MAXK], s_cls[MAXK], s_hiu[MAXK], s_hiv[MAXK];
  __shared__ float s_corner[MAXK][6];
  const int tid = threadIdx.x;
  for (int i = tid; i < K * 3 * NBASIS; i += THREADS) {
    const int k = i / (3 * NBASIS), c = (i / NBASIS) % 3, a = i % NBASIS;
    const size_t kb = static_cast<size_t>(k) * NB + b;
    float v = coeffs[(kb * 4 + c) * NBASIS + a];
    if (c == 0) v = v * static_cast<float>(W);
    if (c == 1) v = v * static_cast<float>(H);
    if (a == 0 && c == 0) v = v + -(static_cast<float>(win_off[kb * 2 + 1] * xstride) + 0.5f);
    if (a == 0 && c == 1) v = v + -(static_cast<float>(win_off[kb * 2]) + 0.5f);
    cs[k][c][a] = v;
  }
  if (tid < K) {
    const size_t kb = static_cast<size_t>(tid) * NB + b;
    const int ylo = win_off[kb * 2], xlo = win_off[kb * 2 + 1] * xstride;
    s_ylo[tid] = ylo;
    s_xlo[tid] = xlo;
    s_hiu[tid] = min(W - 1 - xlo, wx - 1);
    s_hiv[tid] = min(H - 1 - ylo, wy - 1);
    s_cls[tid] = cls ? cls[kb] : 0;
    const float* c0 = packed + static_cast<size_t>(tid) * H * W * 6;
    for (int c = 0; c < 6; ++c) s_corner[tid][c] = c0[c];
  }
  __syncthreads();
  const int bz = b / (nby * nbx), by = (b / nbx) % nby, bx = b % nbx;
  const int ly = tid / BRICK, lx = tid % BRICK;
  const float fly = static_cast<float>(ly) - 7.5f, flx = static_cast<float>(lx) - 7.5f;
  for (int lz = 0; lz < BRICK; ++lz) {
    const float flz = static_cast<float>(lz) - 7.5f;
    const float basis[NBASIS] = {1.f,       flz,       fly,       flx,       flz * flz,
                                 fly * fly, flx * flx, flz * fly, flz * flx, fly * flx};
    Fuse s = fuse_init(limit);
    for (int k = 0; k < K; ++k) {
      const int kc = s_cls[k];
      if (kc == 1) continue;
      if (kc == 2) { s.wt = -limit; continue; }
      const float* cv = s_corner[k];
      if (kc == 3) {
        v0::fuse(s, 0.f, cv[0], cv[1], 1.f - cv[2], cv[3], cv[4], cv[5], limit);
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
      const bool invalid = pu < -0.5f - (float)xlo || pu > (float)W - 0.5f - (float)xlo ||
                           pv < -0.5f - (float)ylo || pv > (float)H - 0.5f - (float)ylo ||
                           pd < 0.f || pd > 1.f;
      float depth, ch[5];
      if (invalid) {
        depth = cv[0];
        ch[0] = 1.f - cv[2]; ch[1] = cv[1]; ch[2] = cv[3]; ch[3] = cv[4]; ch[4] = cv[5];
      } else {
        const float hu = (float)s_hiu[k], hv = (float)s_hiv[k];
        const float* img = packed + static_cast<size_t>(k) * H * W * 6;
        const int nu = (int)fminf(fmaxf(floorf(pu + 0.5f), 0.f), hu);
        const int nv = (int)fminf(fmaxf(floorf(pv + 0.5f), 0.f), hv);
        depth = img[(static_cast<size_t>(ylo + nv) * W + xlo + nu) * 6];
        const float cu = fminf(fmaxf(pu, 0.f), hu), cvv = fminf(fmaxf(pv, 0.f), hv);
        const float iu = floorf(cu), iv = floorf(cvv);
        v0::bilinear5(img, W, ylo + (int)iv, ylo + min((int)iv + 1, s_hiv[k]), xlo + (int)iu,
                      xlo + min((int)iu + 1, s_hiu[k]), cu - iu, cvv - iv, ch);
      }
      v0::fuse(s, pd, depth, ch[1], ch[0], ch[2], ch[3], ch[4], limit);
    }
    float o[4];
    v0::fuse_color(s, o);
    store_voxel<kStore>(tsdf_out, color, b, lz, ly, lx, bz, by, bx, Vx, Vy, s.wt, o);
  }
}

// ---- steps 1-5: one launch over every brick ---------------------------------
// TZ slices of threads, each thread looping over ZL slices: a slab of
// TZ * ZL slices a block. MATH: 0 the first arithmetic, 1 + __fdividef,
// 2 + 8-byte pixel loads, 3 + the z-folded warp (ZL = 1 only).
template <Store kStore, int TZ, int ZL>
__device__ __forceinline__ void clear_slab(void* tsdf_out, __nv_bfloat16* color, int z0,
                                           int y0, int x0, int Vx, int Vy, float limit) {
  constexpr int ZS = TZ * ZL, NT = THREADS * TZ;
  const size_t plane = static_cast<size_t>(Vy) * Vx;
  if (kStore == kZMajor) {
    const uint16_t h = __bfloat16_as_ushort(__float2bfloat16_rn(-limit));
    const uint32_t hw = (static_cast<uint32_t>(h) << 16) | h;
    const uint4 tv = make_uint4(hw, hw, hw, hw);
    auto* tsdf = static_cast<__nv_bfloat16*>(tsdf_out);
    for (int i = threadIdx.x; i < ZS * BRICK * 2 * 5; i += NT) {
      const int q = i & 1, row = (i >> 1) % (ZS * BRICK), c = (i >> 1) / (ZS * BRICK);
      const size_t z = z0 + row / BRICK, y = y0 + row % BRICK;
      __nv_bfloat16* p = c == 4 ? tsdf + z * plane + y * Vx + x0
                                : color + (z * 4 + c) * plane + y * Vx + x0;
      reinterpret_cast<uint4*>(p)[q] = c == 4 ? tv : make_uint4(0, 0, 0, 0);
    }
  } else {
    const uint32_t fw = __float_as_uint(-limit);
    const uint4 tv = make_uint4(fw, fw, fw, fw);
    for (int i = threadIdx.x; i < ZS * BRICK * 12; i += NT) {
      const int q = i % 12, row = i / 12;
      const size_t at = (static_cast<size_t>(z0 + row / BRICK) * Vy + y0 + row % BRICK) * Vx + x0;
      if (q < 4)
        reinterpret_cast<uint4*>(static_cast<float*>(tsdf_out) + at)[q] = tv;
      else
        reinterpret_cast<uint4*>(color + at * 4)[q - 4] = make_uint4(0, 0, 0, 0);
    }
  }
}

// rr::bilinear5 (three 8-byte loads a pixel) that also returns the depths
// of the four taps from the first load, depth4 = (d00, d01, d10, d11): the
// NEAREST depth of steps 4-8 and 11.
__device__ __forceinline__ void bilinear5_d4(const float* __restrict__ img, int W, int v0,
                                             int v1, int u0, int u1, float gu, float gv,
                                             float out[5], float depth4[4]) {
  const int rows[2] = {v0, v1}, cols[2] = {u0, u1};
  float t[4][6];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2* p = reinterpret_cast<const float2*>(
        img + (static_cast<size_t>(rows[i >> 1]) * W + cols[i & 1]) * 6);
    const float2 a = p[0], b = p[1], c = p[2];
    t[i][0] = a.x; t[i][1] = a.y; t[i][2] = b.x; t[i][3] = b.y; t[i][4] = c.x; t[i][5] = c.y;
    depth4[i] = a.x;
  }
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const int q = c == 0 ? 2 : (c == 1 ? 1 : c + 1);
    float a00 = t[0][q], a01 = t[1][q], a10 = t[2][q], a11 = t[3][q];
    if (c == 0) { a00 = 1.f - a00; a01 = 1.f - a01; a10 = 1.f - a10; a11 = 1.f - a11; }
    const float left = (1.f - gv) * a00 + gv * a10;
    const float right = (1.f - gv) * a01 + gv * a11;
    out[c] = (1.f - gu) * left + gu * right;
  }
}

// LINEAR taps as bilinear5 from a frame padded to 8 channels: two 16-byte
// loads a pixel.
__device__ __forceinline__ void bilinear5_p8(const float* __restrict__ img, int W, int v0,
                                             int v1, int u0, int u1, float gu, float gv,
                                             float out[5], float depth4[4]) {
  const int rows[2] = {v0, v1}, cols[2] = {u0, u1};
  float t[4][6];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4* p = reinterpret_cast<const float4*>(
        img + (static_cast<size_t>(rows[i >> 1]) * W + cols[i & 1]) * 8);
    const float4 a = p[0];
    const float2 b = *reinterpret_cast<const float2*>(p + 1);
    t[i][0] = a.x; t[i][1] = a.y; t[i][2] = a.z; t[i][3] = a.w; t[i][4] = b.x; t[i][5] = b.y;
    depth4[i] = a.x;
  }
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const int q = c == 0 ? 2 : (c == 1 ? 1 : c + 1);
    float a00 = t[0][q], a01 = t[1][q], a10 = t[2][q], a11 = t[3][q];
    if (c == 0) { a00 = 1.f - a00; a01 = 1.f - a01; a10 = 1.f - a10; a11 = 1.f - a11; }
    const float left = (1.f - gv) * a00 + gv * a10;
    const float right = (1.f - gv) * a01 + gv * a11;
    out[c] = (1.f - gu) * left + gu * right;
  }
}

// LINEAR taps as bilinear5 from the two planes of step 9: a = (depth, qual,
// sil, r) [H, W, 4], b = (g, b) [H, W, 2].
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
    const int q = c == 0 ? 2 : (c == 1 ? 1 : c + 1);
    float a00 = t[0][q], a01 = t[1][q], a10 = t[2][q], a11 = t[3][q];
    if (c == 0) { a00 = 1.f - a00; a01 = 1.f - a01; a10 = 1.f - a10; a11 = 1.f - a11; }
    const float left = (1.f - gv) * a00 + gv * a10;
    const float right = (1.f - gv) * a01 + gv * a11;
    out[c] = (1.f - gu) * left + gu * right;
  }
}

// bilinear5_planes with the weights formed first: out = sum of w_tap * tap
// over the four taps; sflip = 1 - the weighted silhouette.
__device__ __forceinline__ void bilinear5_planes_w(const float* __restrict__ pa,
                                                   const float* __restrict__ pb, int W, int v0,
                                                   int v1, int u0, int u1, float gu, float gv,
                                                   float out[5], float depth4[4]) {
  const int rows[2] = {v0, v1}, cols[2] = {u0, u1};
  const float w[4] = {(1.f - gv) * (1.f - gu), (1.f - gv) * gu, gv * (1.f - gu), gv * gu};
  float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t px = static_cast<size_t>(rows[i >> 1]) * W + cols[i & 1];
    const float4 a = reinterpret_cast<const float4*>(pa)[px];
    const float2 b = reinterpret_cast<const float2*>(pb)[px];
    depth4[i] = a.x;
    acc[0] = fmaf(w[i], a.z, acc[0]);   // sil
    acc[1] = fmaf(w[i], a.y, acc[1]);   // qual
    acc[2] = fmaf(w[i], a.w, acc[2]);   // r
    acc[3] = fmaf(w[i], b.x, acc[3]);   // g
    acc[4] = fmaf(w[i], b.y, acc[4]);   // b
  }
  out[0] = 1.f - acc[0];
#pragma unroll
  for (int c = 1; c < 5; ++c) out[c] = acc[c];
}

constexpr int SPREAD = 1031;   // a prime above any per-axis brick count

// The fusion of one slab (slices part*ZS .. part*ZS + ZS - 1) of brick b
// by a block of THREADS * TZ threads, each over ZL slices.
template <Store kStore, int TZ, int ZL, int MATH, int PIX>
__device__ __forceinline__ void fuse_part(
    int b, int part, const float* __restrict__ packed, const float* __restrict__ packed_b,
    const float* __restrict__ coeffs, const int* __restrict__ win_off,
    const int* __restrict__ cls, void* __restrict__ tsdf_out,
    __nv_bfloat16* __restrict__ color, int K, int H, int W, int NB, int nbx, int nby, int Vx,
    int Vy, int wy, int wx, int xstride, float limit) {
  constexpr int ZS = TZ * ZL, NT = THREADS * TZ;
  const int tid = threadIdx.x;
  const int bz = b / (nby * nbx), by = (b / nbx) % nby, bx = b % nbx;
  constexpr int NC = MATH == 3 ? ZS * 6 : NBASIS;   // coefficients a channel
  __shared__ float cq[MAXK][3][NC];
  __shared__ int s_ylo[MAXK], s_xlo[MAXK], s_cls[MAXK], s_hiu[MAXK], s_hiv[MAXK];
  __shared__ float s_corner[MAXK][6];
  for (int i = tid; i < K * 3; i += NT) {
    const int k = i / 3, c = i % 3;
    const size_t kb = static_cast<size_t>(k) * NB + b;
    const float* src = coeffs + (kb * 4 + c) * NBASIS;
    float a[NBASIS];
    for (int j = 0; j < NBASIS; ++j) {
      float v = src[j];
      if (c == 0) v = v * static_cast<float>(W);
      if (c == 1) v = v * static_cast<float>(H);
      a[j] = v;
    }
    if (c == 0) a[0] = a[0] + -(static_cast<float>(win_off[kb * 2 + 1] * xstride) + 0.5f);
    if (c == 1) a[0] = a[0] + -(static_cast<float>(win_off[kb * 2]) + 0.5f);
    if constexpr (MATH == 3) {
      for (int s = 0; s < ZS; ++s) {
        const float z = static_cast<float>(part * ZS + s) - 7.5f;
        float* o = &cq[k][c][s * 6];
        o[0] = a[0] + z * a[1] + z * z * a[4];
        o[1] = a[2] + z * a[7];
        o[2] = a[3] + z * a[8];
        o[3] = a[5];
        o[4] = a[6];
        o[5] = a[9];
      }
    } else {
      for (int j = 0; j < NBASIS; ++j) cq[k][c][j] = a[j];
    }
  }
  if (tid < K) {
    const size_t kb = static_cast<size_t>(tid) * NB + b;
    const int ylo = win_off[kb * 2], xlo = win_off[kb * 2 + 1] * xstride;
    s_ylo[tid] = ylo;
    s_xlo[tid] = xlo;
    s_hiu[tid] = min(W - 1 - xlo, wx - 1);
    s_hiv[tid] = min(H - 1 - ylo, wy - 1);
    s_cls[tid] = cls ? cls[kb] : 0;
    const float* c0 = packed + static_cast<size_t>(tid) * H * W * (PIX == 5 ? 4 : PIX);
    for (int c = 0; c < 6; ++c)
      s_corner[tid][c] = (PIX == 4 || PIX == 5) && c >= 4
                             ? packed_b[static_cast<size_t>(tid) * H * W * 2 + c - 4]
                             : c0[c];
  }
  __syncthreads();
  const int ly = (tid / BRICK) % BRICK, lx = tid % BRICK, tz = tid / THREADS;
  const float fly = static_cast<float>(ly) - 7.5f, flx = static_cast<float>(lx) - 7.5f;
  for (int zl = 0; zl < ZL; ++zl) {
    const int sl = tz * ZL + zl;           // slice within the slab
    const int lz = part * ZS + sl;
    const float flz = static_cast<float>(lz) - 7.5f;
    const float basis[NBASIS] = {1.f,       flz,       fly,       flx,       flz * flz,
                                 fly * fly, flx * flx, flz * fly, flz * flx, fly * flx};
    Fuse s = fuse_init(limit);
    for (int k = 0; k < K; ++k) {
      const int kc = s_cls[k];
      if (kc == 1) continue;
      if (kc == 2) { s.wt = -limit; continue; }
      const float* cv = s_corner[k];
      if (kc == 3) {
        if constexpr (MATH == 0)
          v0::fuse(s, 0.f, cv[0], cv[1], 1.f - cv[2], cv[3], cv[4], cv[5], limit);
        else
          fuse(s, 0.f, cv[0], cv[1], 1.f - cv[2], cv[3], cv[4], cv[5], limit);
        continue;
      }
      float p[3];
      if constexpr (MATH == 3) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float* q = &cq[k][c][sl * 6];
          const float ty = fmaf(q[5], flx, fmaf(q[3], fly, q[1]));
          const float tx = fmaf(q[4], flx, q[2]);
          p[c] = fmaf(flx, tx, fmaf(fly, ty, q[0]));
        }
      } else {
        p[0] = p[1] = p[2] = 0.f;
#pragma unroll
        for (int a = 0; a < NBASIS; ++a) {
          p[0] += cq[k][0][a] * basis[a];
          p[1] += cq[k][1][a] * basis[a];
          p[2] += cq[k][2][a] * basis[a];
        }
      }
      const float pu = p[0], pv = p[1], pd = p[2];
      const int xlo = s_xlo[k], ylo = s_ylo[k];
      const bool invalid = pu < -0.5f - (float)xlo || pu > (float)W - 0.5f - (float)xlo ||
                           pv < -0.5f - (float)ylo || pv > (float)H - 0.5f - (float)ylo ||
                           pd < 0.f || pd > 1.f;
      float depth, ch[5];
      if (invalid) {
        depth = cv[0];
        ch[0] = 1.f - cv[2]; ch[1] = cv[1]; ch[2] = cv[3]; ch[3] = cv[4]; ch[4] = cv[5];
      } else {
        const float hu = (float)s_hiu[k], hv = (float)s_hiv[k];
        const float* img = packed + static_cast<size_t>(k) * H * W * (PIX == 5 ? 4 : PIX);
        const float cu = fminf(fmaxf(pu, 0.f), hu), cvv = fminf(fmaxf(pv, 0.f), hv);
        const float iu = floorf(cu), iv = floorf(cvv);
        const float nu = fminf(fmaxf(floorf(pu + 0.5f), 0.f), hu);
        const float nv = fminf(fmaxf(floorf(pv + 0.5f), 0.f), hv);
        const int v0r = ylo + (int)iv, v1r = ylo + min((int)iv + 1, s_hiv[k]);
        const int u0c = xlo + (int)iu, u1c = xlo + min((int)iu + 1, s_hiu[k]);
        if constexpr (MATH >= 2) {
          float d4[4];
          if constexpr (PIX == 8)
            bilinear5_p8(img, W, v0r, v1r, u0c, u1c, cu - iu, cvv - iv, ch, d4);
          else if constexpr (PIX == 5)
            bilinear5_planes_w(img, packed_b + static_cast<size_t>(k) * H * W * 2, W, v0r,
                               v1r, u0c, u1c, cu - iu, cvv - iv, ch, d4);
          else if constexpr (PIX == 4)
            bilinear5_planes(img, packed_b + static_cast<size_t>(k) * H * W * 2, W, v0r, v1r,
                             u0c, u1c, cu - iu, cvv - iv, ch, d4);
          else
            bilinear5_d4(img, W, v0r, v1r, u0c, u1c, cu - iu, cvv - iv, ch, d4);
          const float d_top = nu == iu ? d4[0] : d4[1];
          const float d_bot = nu == iu ? d4[2] : d4[3];
          depth = nv == iv ? d_top : d_bot;
        } else {
          depth = img[(static_cast<size_t>(ylo + (int)nv) * W + xlo + (int)nu) * 6];
          v0::bilinear5(img, W, v0r, v1r, u0c, u1c, cu - iu, cvv - iv, ch);
        }
      }
      if constexpr (MATH == 0)
        v0::fuse(s, pd, depth, ch[1], ch[0], ch[2], ch[3], ch[4], limit);
      else
        fuse(s, pd, depth, ch[1], ch[0], ch[2], ch[3], ch[4], limit);
    }
    float o[4];
    if constexpr (MATH == 0)
      v0::fuse_color(s, o);
    else
      fuse_color(s, o);
    store_voxel<kStore>(tsdf_out, color, b, lz, ly, lx, bz, by, bx, Vx, Vy, s.wt, o);
  }
}


// ORDER: 0 bricks ascending, 1 brick = item * SPREAD mod NB, 2 two roles
// (step 8); PIX: the frame's channel stride (6, 8 for the padded frame of
// step 7, 4 for plane a of step 9 with plane b in packed_b, 5 the same
// planes with the taps weighted first); MINB: blocks
// an SM must hold (caps the registers).
template <Store kStore, int TZ, int ZL, int MATH, int ORDER = 0, int PIX = 6, int MINB = 1>
__global__ void __launch_bounds__(THREADS * TZ, MINB)
step_kernel(const float* __restrict__ packed, const float* __restrict__ packed_b,
            const float* __restrict__ coeffs, const int* __restrict__ idx,
            const int* __restrict__ count, const int* __restrict__ slots,
            const int* __restrict__ win_off, const int* __restrict__ cls,
            void* __restrict__ tsdf_out, __nv_bfloat16* __restrict__ color,
            bool* __restrict__ visited, int K, int H, int W, int NB, int nbx, int nby, int Vx,
            int Vy, int wy, int wx, int xstride, float limit) {
  constexpr int ZS = TZ * ZL, NPART = BRICK / ZS, NT = THREADS * TZ;
  const int item = blockIdx.x / NPART, part = blockIdx.x % NPART, tid = threadIdx.x;
  int b = ORDER == 1 ? static_cast<int>((static_cast<long long>(item) * SPREAD) % NB) : item;
  if (ORDER == 2) {
    const bool q_fused = slots[item] >= 0;
    if (kStore == kBlockMajor && part == 0 && tid == 0) visited[item] = q_fused;
    if (kStore != kBlockMajor && !q_fused)
      clear_slab<kStore, TZ, ZL>(tsdf_out, color, item / (nby * nbx) * BRICK + part * ZS,
                                 (item / nbx) % nby * BRICK, item % nbx * BRICK, Vx, Vy, limit);
    const int slot = static_cast<int>((static_cast<long long>(item) * SPREAD) % NB);
    if (slot >= *count) return;
    b = idx[slot];
  } else {
    const bool fused = slots[b] >= 0;
    if (kStore == kBlockMajor && part == 0 && tid == 0) visited[b] = fused;
    if (!fused) {
      if (kStore != kBlockMajor)
        clear_slab<kStore, TZ, ZL>(tsdf_out, color, b / (nby * nbx) * BRICK + part * ZS,
                                   (b / nbx) % nby * BRICK, b % nbx * BRICK, Vx, Vy, limit);
      return;
    }
  }
  fuse_part<kStore, TZ, ZL, MATH, PIX>(b, part, packed, packed_b, coeffs, win_off, cls,
                                       tsdf_out, color, K, H, W, NB, nbx, nby, Vx, Vy, wy, wx,
                                       xstride, limit);
}

// Steps 14: step 12's fusion (1,024 or 512 threads, one block a brick) in a
// grid that puts the fused bricks first, block j fusing slot j of the
// occupied list, with the clear laid out by CLEAR: 0 block j clears the
// idle bricks among 4j .. 4j + 3 at its start (the fused blocks first,
// then clear-only blocks); 1 the first max(count, NB/16) blocks share
// the clear in equal contiguous ranges, a fused block a quarter before
// each quarter of its fusion, every fourth brick; 2 odd block 2s + 1
// fuses slot s and the first max(2 count, NB/4) blocks clear equal
// contiguous ranges at their start; 3 as 1 but each range cleared at the
// block's start.
template <Store kStore, int TZ, int CLEAR>
__global__ void __launch_bounds__(THREADS * TZ)
first_kernel(const float* __restrict__ packed, const float* __restrict__ packed_b,
             const float* __restrict__ coeffs, const int* __restrict__ idx,
             const int* __restrict__ count, const int* __restrict__ slots,
             const int* __restrict__ win_off, const int* __restrict__ cls,
             void* __restrict__ tsdf_out, __nv_bfloat16* __restrict__ color,
             bool* __restrict__ visited, int K, int H, int W,
             int NB, int nbx, int nby, int Vx, int Vy, int wy, int wx, int xstride,
             float limit) {
  constexpr int ZL = BRICK / TZ, NT = THREADS * TZ;
  const int j = blockIdx.x, tid = threadIdx.x;
  const int n_fused = *count;
  const int n_clear = CLEAR == 0 ? (NB + 3) / 4
                                 : (CLEAR == 2 ? max(2 * n_fused, (NB + 3) / 4)
                                               : max(n_fused, (NB + 15) / 16));
  auto edge = [&](int i) {
    return i < n_clear ? static_cast<int>(static_cast<long long>(i) * NB / n_clear) : NB;
  };
  const int q0 = CLEAR == 0 ? min(4 * j, NB) : edge(j);
  const int q1 = CLEAR == 0 ? min(4 * j + 4, NB) : edge(j + 1);
  auto clear_idle = [&](int first, int step) {
    for (int q = first; q < q1; q += step) {
      const bool idle = slots[q] < 0;
      if (kStore == kBlockMajor) {
        if (tid == 0) visited[q] = !idle;
      } else if (idle) {
        clear_slab<kStore, TZ, ZL>(tsdf_out, color, q / (nby * nbx) * BRICK,
                                   (q / nbx) % nby * BRICK, q % nbx * BRICK, Vx, Vy, limit);
      }
    }
  };
  const int slot = CLEAR == 2 ? ((j & 1) ? j / 2 : n_fused) : j;
  if (CLEAR != 1 || slot >= n_fused) clear_idle(q0, 1);
  if (slot >= n_fused) return;
  if (CLEAR == 1 && kStore == kBlockMajor) clear_idle(q0, 1);
  // CLEAR 1: the quarters are cleared by the fusion loop of a one-slice
  // slab at a time, ZL calls of fuse_part with ZL = 1
  if constexpr (CLEAR == 1) {
    for (int zl = 0; zl < ZL; ++zl) {
      if (kStore != kBlockMajor) clear_idle(q0 + zl, ZL);
      __syncthreads();
      fuse_part<kStore, TZ, 1, 3, 4>(idx[slot], zl, packed, packed_b, coeffs, win_off, cls,
                                     tsdf_out, color, K, H, W, NB, nbx, nby, Vx, Vy,
                                     wy, wx, xstride, limit);
    }
  } else {
    fuse_part<kStore, TZ, ZL, 3, 4>(idx[slot], 0, packed, packed_b, coeffs, win_off, cls,
                                    tsdf_out, color, K, H, W, NB, nbx, nby, Vx, Vy, wy, wx,
                                    xstride, limit);
  }
}

template <Store kStore, int TZ, int ZL, int MATH, int ORDER = 0, int PIX = 6, int MINB = 1>
void launch_step(const float* packed, const float* packed_b, const float* coeffs,
                 const int* idx, const int* count, const int* slots, const int* win_off,
                 const int* cls, void* tsdf, __nv_bfloat16* color, bool* visited, int K, int H,
                 int W, int NB, int nbx, int nby, int wy, int wx, int xstride, float limit,
                 cudaStream_t stream) {
  step_kernel<kStore, TZ, ZL, MATH, ORDER, PIX, MINB>
      <<<NB * (BRICK / (TZ * ZL)), THREADS * TZ, 0, stream>>>(
          packed, packed_b, coeffs, idx, count, slots, win_off, cls, tsdf, color, visited, K,
          H, W, NB, nbx, nby, nbx * BRICK, nby * BRICK, wy, wx, xstride, limit);
}

// blocks of first_kernel<CLEAR>: every slot (two blocks a slot for CLEAR
// 2) and every range of the clear
inline int first_grid(int clear, int max_bricks, int NB) {
  const int per = clear % 2 ? 16 : 4;
  return max((clear == 2 ? 2 : 1) * max_bricks, (NB + per - 1) / per);
}

// (step, zs) -> the launch of one store mode
template <Store kStore>
int run_step(int step, int zs, const float* packed, const float* packed_b,
             const float* coeffs, const int* idx,
             const int* count, const int* slots, const int* win_off, const int* cls,
             void* tsdf, __nv_bfloat16* color, bool* visited, int K, int H, int W, int NB,
             int nbx, int nby, int nbz, int max_bricks, int wy, int wx, int xstride,
             float limit, cudaStream_t stream) {
  if (step == 0) {
    const long long n = static_cast<long long>(NB) * B3;
    if (kStore == kChannelsLast)
      fill_kernel<float><<<1024, 256, 0, stream>>>(static_cast<float*>(tsdf), n, -limit);
    else if (kStore == kZMajor)
      fill_kernel<__nv_bfloat16><<<1024, 256, 0, stream>>>(
          static_cast<__nv_bfloat16*>(tsdf), n, __float2bfloat16_rn(-limit));
    if (kStore != kBlockMajor) cudaMemsetAsync(color, 0, 4 * n * sizeof(__nv_bfloat16), stream);
    if (kStore == kBlockMajor) cudaMemsetAsync(visited, 0, NB * sizeof(bool), stream);
    if (max_bricks > 0)
      step0_kernel<kStore><<<max_bricks, THREADS, 0, stream>>>(
          packed, coeffs, idx, count, win_off, cls, tsdf, color, visited, K, H, W, NB, nbx,
          nby, nbx * BRICK, nby * BRICK, wy, wx, xstride, limit);
    return rr_status();
  }
#define RR_STEP(TZ, ZL, MATH, ...)                                                     \
  launch_step<kStore, TZ, ZL, MATH, ##__VA_ARGS__>(                                      \
      packed, packed_b, coeffs, idx, count, slots, win_off, cls, tsdf, color, visited, K, \
      H, W, NB, nbx, nby, wy, wx, xstride, limit, stream)
#define RR_FIRST(TZ, CLEAR)                                                              \
  first_kernel<kStore, TZ, CLEAR><<<first_grid(CLEAR, max_bricks, NB), THREADS * TZ, 0,   \
                                    stream>>>(                                            \
      packed, packed_b, coeffs, idx, count, slots, win_off, cls, tsdf, color, visited, K, H, \
      W, NB, nbx, nby, nbx * BRICK, nby * BRICK, wy, wx, xstride, limit)
  if (step == 1) RR_STEP(1, 16, 0);
  else if (step == 2 && zs == 1) RR_STEP(1, 1, 0);
  else if (step == 2 && zs == 2) RR_STEP(2, 1, 0);
  else if (step == 2 && zs == 4) RR_STEP(4, 1, 0);
  else if (step == 3) RR_STEP(2, 1, 1);
  else if (step == 4) RR_STEP(2, 1, 2);
  else if (step == 5 && zs == 1) RR_STEP(1, 1, 3);
  else if (step == 5 && zs == 2) RR_STEP(2, 1, 3);
  else if (step == 5 && zs == 4) RR_STEP(4, 1, 3);
  else if (step == 6 && zs == 1) RR_STEP(1, 1, 3, 1);
  else if (step == 6 && zs == 2) RR_STEP(2, 1, 3, 1);
  else if (step == 7 && zs == 1) RR_STEP(1, 1, 3, 1, 8);
  else if (step == 7 && zs == 2) RR_STEP(2, 1, 3, 1, 8);
  else if (step == 8 && zs == 1) RR_STEP(1, 1, 3, 2);
  else if (step == 8 && zs == 2) RR_STEP(2, 1, 3, 2);
  else if (step == 9 && zs == 1) RR_STEP(1, 1, 3, 2, 4);
  else if (step == 9 && zs == 2) RR_STEP(2, 1, 3, 2, 4);
  else if (step == 10) RR_STEP(2, 1, 3, 2, 4, 4);
  else if (step == 11 && zs == 1) RR_STEP(1, 16, 3);
  else if (step == 11 && zs == 2) RR_STEP(2, 8, 3);
  else if (step == 11 && zs == 4) RR_STEP(4, 4, 3);
  else if (step == 12 && zs == 2) RR_STEP(2, 8, 3, 0, 4);
  else if (step == 12 && zs == 4) RR_STEP(4, 4, 3, 0, 4);
  else if (step == 12 && zs == 3) RR_STEP(2, 8, 3, 0, 4, 3);
  else if (step == 13 && zs == 3) RR_STEP(2, 8, 3, 0, 5, 3);
  else if (step == 13 && zs == 4) RR_STEP(4, 4, 3, 0, 5);
  else if (step == 14 && zs == 0) RR_FIRST(4, 0);
  else if (step == 14 && zs == 1) RR_FIRST(4, 1);
  else if (step == 14 && zs == 2) RR_FIRST(4, 2);
  else if (step == 14 && zs == 3) RR_FIRST(4, 3);
  else if (step == 14 && zs == 5) RR_FIRST(2, 0);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef RR_STEP
#undef RR_FIRST
  return rr_status();
}

}  // namespace

// mode 0: z-major (kernel 1), 1: channels-last voxel order, 2: block-major
// raw (kernel 6). Steps 1-7 read the slot map, step 0 idx/count, steps
// 8-10 both; step 7 reads a frame of 8 channels, steps 9-10 the two planes
// (packed, packed_b), the others a frame of 6.
RR_API int rr_integrate_step(int step, int zs, int mode, const float* packed,
                             const float* packed_b, const float* coeffs, const int* idx,
                             const int* count, const int* slots, const int* win_off,
                             const int* cls, void* tsdf, __nv_bfloat16* color, bool* visited,
                             int K, int H, int W, int NB, int nbx, int nby, int nbz,
                             int max_bricks, int wy, int wx, int xstride, float limit,
                             cudaStream_t stream) {
  if (K < 1 || K > MAXK) return static_cast<int>(cudaErrorInvalidValue);
#define RR_RUN(STORE)                                                                         \
  run_step<STORE>(step, zs, packed, packed_b, coeffs, idx, count, slots, win_off, cls, tsdf,  \
                  color, visited, K, H, W, NB, nbx, nby, nbz, max_bricks, wy, wx, xstride,     \
                  limit, stream)
  const int rc = mode == 0 ? RR_RUN(kZMajor) : (mode == 1 ? RR_RUN(kChannelsLast)
                                                           : RR_RUN(kBlockMajor));
#undef RR_RUN
  return rc;
}

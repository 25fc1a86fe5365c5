// Per-voxel TSDF + color-blend update shared by the integration kernels
// (rgbd_recon_tpu/ops/tsdf_persist.py::_fuse_update; reference
// tsdf_integration.vs:23-59 and tsdf_raymarch.fs:295-320).
#pragma once

#include "common.cuh"

namespace rr {

constexpr int BRICK = 16;
constexpr int MAXK = 8;
constexpr int THREADS = BRICK * BRICK;
constexpr int B3 = BRICK * BRICK * BRICK;
// silhouette gate: (1 - sil) sampled LINEAR must stay under 1 - 0.998
// (tsdf_pallas.py SIL_PL), the constant rounded from double as in the
// reference
constexpr float SIL_GATE = static_cast<float>(1.0 - 0.998);
// the XLA table integrator's gate (tsdf_fast.py SIL_FULL): the silhouette
// itself sampled LINEAR, "fully inside" below 0.9999
constexpr float SIL_FULL = 0.9999f;

struct Fuse {
  float wt, tw, tc0, tc1, tc2, tcw, td0, td1, td2, tdw;
};

__device__ __forceinline__ Fuse fuse_init(float limit) {
  return Fuse{limit, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
}

// The three quotients are __fdividef (a reciprocal and a product, 2 ulp)
// instead of IEEE division, whose multi-instruction sequence and branch
// were the largest single cost of the update; the integrator bound between
// formulations (tests/test_tsdf_affine.py:109-116) is six orders of
// magnitude wider than the difference. ``sil``: (1 - silhouette) under the
// SIL_PL gate, or with kSilDirect the silhouette itself under SIL_FULL.
template <bool kSilDirect = false>
__device__ __forceinline__ void fuse(Fuse& s, float d_vox, float depth, float qual,
                                     float sil, float r, float g, float b, float limit) {
  const float sdist = d_vox - depth;
  const bool outside = kSilDirect ? sil < SIL_FULL : sil > SIL_GATE;
  const bool skip = outside && (s.wt >= limit);
  const bool in_front = sdist <= -limit;
  const bool in_band = (sdist > -limit) && (sdist < limit);
  const float new_tw = s.tw + qual;
  const float accum = new_tw > 0.f ? __fdividef(s.wt * s.tw + qual * sdist, new_tw) : s.wt;
  const float wt_next = in_front ? -limit : (in_band ? accum : s.wt);
  const float tw_next = (in_band && new_tw > 0.f) ? new_tw : s.tw;
  s.wt = skip ? -limit : wt_next;
  s.tw = skip ? s.tw : tw_next;

  const float dist = fabsf(depth - d_vox);
  const float q_c = dist < limit ? qual : 0.f;
  const float w_c = __fdividef(q_c, dist + 0.01f);
  s.tc0 += r * w_c;
  s.tc1 += g * w_c;
  s.tc2 += b * w_c;
  s.tcw += w_c;
  const float w2 = __fdividef(1.f, fmaxf(dist, 1e-9f));
  s.td0 += r * w2;
  s.td1 += g * w2;
  s.td2 += b * w2;
  s.tdw += w2;
}

// Final color: the quality-weighted blend where any sensor saw the voxel
// inside the band, else the inverse-distance fallback; flag +1 / -1. One
// reciprocal of the chosen weight sum, three products.
__device__ __forceinline__ void fuse_color(const Fuse& s, float out[4]) {
  const bool hasq = s.tcw > 0.f;
  const float inv = __fdividef(1.f, fmaxf(hasq ? s.tcw : s.tdw, 1e-20f));
  out[0] = (hasq ? s.tc0 : s.td0) * inv;
  out[1] = (hasq ? s.tc1 : s.td1) * inv;
  out[2] = (hasq ? s.tc2 : s.td2) * inv;
  out[3] = hasq ? 1.f : -1.f;
}

// LINEAR taps of (1 - silhouette), quality and rgb from a packed frame
// [H, W, 6] (depth | quality | silhouette | rgb) at rows v0/v1, columns
// u0/u1 with fractions gu, gv: out = (sflip, qual, r, g, b); with
// kSilDirect the silhouette itself in place of sflip. A 24-byte pixel is
// read as three 8-byte loads (depth, qual) (sil, r) (g, b), not five
// scalars.
template <bool kSilDirect = false>
__device__ __forceinline__ void bilinear5(const float* __restrict__ img, int W, int v0,
                                          int v1, int u0, int u1, float gu, float gv,
                                          float out[5]) {
  const int rows[2] = {v0, v1}, cols[2] = {u0, u1};
  float t[4][6];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2* p = reinterpret_cast<const float2*>(
        img + (static_cast<size_t>(rows[i >> 1]) * W + cols[i & 1]) * 6);
    const float2 a = p[0], b = p[1], c = p[2];
    t[i][0] = a.x; t[i][1] = a.y; t[i][2] = b.x; t[i][3] = b.y; t[i][4] = c.x; t[i][5] = c.y;
  }
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const int q = c == 0 ? 2 : (c == 1 ? 1 : c + 1);   // sil, qual, r, g, b
    float a00 = t[0][q], a01 = t[1][q], a10 = t[2][q], a11 = t[3][q];
    if (c == 0 && !kSilDirect) { a00 = 1.f - a00; a01 = 1.f - a01; a10 = 1.f - a10; a11 = 1.f - a11; }
    const float left = (1.f - gv) * a00 + gv * a10;
    const float right = (1.f - gv) * a01 + gv * a11;
    out[c] = (1.f - gu) * left + gu * right;
  }
}

}  // namespace rr

namespace {

// Fill n elements with one value (the clear values of the dense outputs).
template <typename T>
__global__ void fill_kernel(T* __restrict__ p, long long n, T value) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x)
    p[i] = value;
}

}  // namespace

// Hole filling of the rendered image (tsdf_inpaint.fs, tsdf_colorfill.fs):
// the inpaint pyramid's levels and the colorfill resolve (kernel 11).
//
// Replaces no TPU kernel: the JAX package fills holes with XLA ops
// (rgbd_recon_tpu/ops/inpaint.py, the 16-tap downsample and the per-pixel
// colorfill; its banded-matmul forms `*_mm` are TPU layouts of the same
// math and are not ported). The port ran them as eager PyTorch
// (ops/inpaint.py's `inpaint_downsample_plain` and `colorfill_plain`, kept
// as the CPU path and the oracle): each level padded by two index gathers
// and stacked as 16 shifted copies; the resolve gathering every LOD to full
// size, upsampling every LOD through two dense GEMMs against hat-weight
// matrices and blending every LOD, to keep one blend a pixel. About a
// thousand ops a frame at 1280 x 720 with 6 LODs.
//
// Bound on the card: bytes. At 1280 x 720 with 6 LODs the image is read once
// (color 14.75 MB, depth 3.69 MB), the coarser levels are written and read
// again (~6 MB) and the output is written (14.75 MB): ~40 MB, 0.012 ms at
// 3.35 TB/s. The design:
//   - one launch a level (`holefill_level`): a level's 4 x 4 windows overlap
//     and read the level before, so one level ends before the next starts.
//     One thread an output pixel reads its edge-clamped window in place
//     (float4 color loads; L1 serves the overlap of neighbouring windows),
//     with no padded copy and no stack of taps;
//   - one resolve a frame (`holefill_resolve`), one thread a full-size
//     pixel: the finest LOD whose nearest sample is no hole and, where that
//     LOD is coarser than 0, only the two upsampled values its blend uses,
//     each from its 2 x 2 taps (the GL hat weights have at most two
//     non-zeros a row: the wrapper bakes them into a table, rows then
//     columns). The coarse levels it reads stay in L2. The twin computes
//     every LOD's upsample and blend and keeps one; this computes the one.
//   - every rounding the twin's, each operation rounded once (__fadd_rn,
//     __fmul_rn, __fdiv_rn, __fsqrt_rn keep nvcc from contracting), so the
//     outputs are the twin's bits:
//       * a sum over the 16 stacked taps is PyTorch's CUDA reduction over
//         the outer dimension: each thread reduces its outputs' 16 inputs
//         with four accumulators, tap k into k % 4 (from 0), then
//         ((a0 + a1) + a2) + a3 (`sum16`; probes on the card matched it);
//       * the bool counts are exact; a division by the clamped count is an
//         IEEE division;
//       * resize2d_gl rounds weights, input and the row pass's result to
//         bf16. A product of two bf16 values is exact in float32, and each
//         output of a pass has at most two non-zero products, so cuBLAS's
//         sum rounds once whatever its order: (0 + p0) + p1 here;
//       * (x + 0.5) / W divides by a host scalar, which PyTorch's CUDA
//         division computes as a product with the float reciprocal.
#include "common.cuh"

namespace {

constexpr int MAX_LODS = 16;   // ops/inpaint.py MAX_LODS
constexpr int TX = 32;
constexpr int TY = 8;

struct Levels {
  const float4* c[MAX_LODS];
  int h[MAX_LODS];
  int w[MAX_LODS];
};

// a sum over the 16 stacked taps as PyTorch's CUDA reduction takes it
__device__ __forceinline__ float sum16(const float (&v)[16]) {
  float a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[i] = 0.f;
#pragma unroll
    for (int k = i; k < 16; k += 4) a[i] = __fadd_rn(a[i], v[k]);
  }
  return __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), a[2]), a[3]);
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// one output of a resize pass: its two weighted taps, summed from +0
__device__ __forceinline__ float pass2(float w0, float a, float w1, float b) {
  return __fadd_rn(__fadd_rn(0.f, __fmul_rn(w0, a)), __fmul_rn(w1, b));
}

__global__ void __launch_bounds__(TX * TY)
level_kernel(const float4* __restrict__ color, const float* __restrict__ depth,
             float4* __restrict__ c_out, float* __restrict__ d_out, int H, int W, int H2,
             int W2) {
  const int X = blockIdx.x * TX + threadIdx.x;
  const int Y = blockIdx.y * TY + threadIdx.y;
  if (X >= W2 || Y >= H2) return;
  // window tap (oy, ox) reads source (2Y + oy - 1, 2X + ox - 1), edge-clamped
  // (_pad_edge2's rule: the bottom and right pads only size the padded copy)
  int rows[4], cols[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rows[i] = min(max(2 * Y + i - 1, 0), H - 1);
    cols[i] = min(max(2 * X + i - 1, 0), W - 1);
  }
  float4 c[16];
  float d[16];
#pragma unroll
  for (int oy = 0; oy < 4; ++oy) {
#pragma unroll
    for (int ox = 0; ox < 4; ++ox) {
      const size_t p = static_cast<size_t>(rows[oy]) * W + cols[ox];
      c[oy * 4 + ox] = __ldg(color + p);
      d[oy * 4 + ox] = __ldg(depth + p);
    }
  }
  bool nonhole[16];
  float t[16];
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    nonhole[k] = !(c[k].w <= 0.f);
    cnt += nonhole[k];
    t[k] = nonhole[k] ? d[k] : 0.f;
  }
  const size_t q = static_cast<size_t>(Y) * W2 + X;
  if (cnt == 0) {
    // all-hole window (tsdf_inpaint.fs:59-68): the center depth, tap (1, 1);
    // a hole in front of geometry (alpha -1), background otherwise
    const float dc = d[5];
    c_out[q] = dc < 1.f ? make_float4(0.f, 0.f, 0.f, -1.f) : make_float4(0.f, 1.f, 0.f, 0.f);
    d_out[q] = dc;
    return;
  }
  const float depth_av = __fdiv_rn(sum16(t), static_cast<float>(cnt));
  float r[16], g[16], b[16];
  int n_keep = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const bool keep = nonhole[k] && d[k] >= depth_av;
    n_keep += keep;
    t[k] = keep ? d[k] : 0.f;
    r[k] = keep ? c[k].x : 0.f;
    g[k] = keep ? c[k].y : 0.f;
    b[k] = keep ? c[k].z : 0.f;
  }
  const float wsum = static_cast<float>(max(n_keep, 1));
  c_out[q] = make_float4(__fdiv_rn(sum16(r), wsum), __fdiv_rn(sum16(g), wsum),
                         __fdiv_rn(sum16(b), wsum), 1.f);
  d_out[q] = __fdiv_rn(sum16(t), wsum);
}

// resize2d_gl's value of LOD l at full-size pixel (y, x): the row pass at
// the two source columns, each rounded to bf16, then the column pass
__device__ __forceinline__ float4 upsampled(const Levels& lv, int l, const int2* __restrict__ idx,
                                            const float2* __restrict__ wt, int H, int W, int y,
                                            int x) {
  const size_t e = static_cast<size_t>(l) * (H + W);
  const int2 ri = __ldg(idx + e + y);
  const float2 rw = __ldg(wt + e + y);
  const int2 ci = __ldg(idx + e + H + x);
  const float2 cw = __ldg(wt + e + H + x);
  const int wl = lv.w[l];
  float4 t[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int col = j ? ci.y : ci.x;
    const float4 a = __ldg(lv.c[l] + static_cast<size_t>(ri.x) * wl + col);
    const float4 b = __ldg(lv.c[l] + static_cast<size_t>(ri.y) * wl + col);
    t[j] = make_float4(bf16r(pass2(rw.x, bf16r(a.x), rw.y, bf16r(b.x))),
                       bf16r(pass2(rw.x, bf16r(a.y), rw.y, bf16r(b.y))),
                       bf16r(pass2(rw.x, bf16r(a.z), rw.y, bf16r(b.z))),
                       bf16r(pass2(rw.x, bf16r(a.w), rw.y, bf16r(b.w))));
  }
  return make_float4(pass2(cw.x, t[0].x, cw.y, t[1].x), pass2(cw.x, t[0].y, cw.y, t[1].y),
                     pass2(cw.x, t[0].z, cw.y, t[1].z), pass2(cw.x, t[0].w, cw.y, t[1].w));
}

__device__ __forceinline__ float blend(float c1, float w1, float c2, float w2, float den) {
  return __fdiv_rn(__fadd_rn(__fmul_rn(c1, w1), __fmul_rn(c2, w2)), den);
}

__global__ void __launch_bounds__(TX * TY)
resolve_kernel(Levels lv, int n, const float* __restrict__ depth0,
               const int2* __restrict__ idx, const float2* __restrict__ wt,
               float4* __restrict__ out, int H, int W, float inv_w, float inv_h) {
  const int x = blockIdx.x * TX + threadIdx.x;
  const int y = blockIdx.y * TY + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t p = static_cast<size_t>(y) * W + x;
  const float4 c0 = __ldg(lv.c[0] + p);
  if (c0.w <= 0.f && __ldg(depth0 + p) >= 1.f) {   // background stays transparent
    out[p] = c0;
    return;
  }
  // the finest LOD whose nearest sample is no hole, else the coarsest
  int first = 0;
  float4 base = c0;
  for (int l = 0; l < n; ++l) {
    const long long yl = static_cast<long long>(y) * lv.h[l] / H;
    const long long xl = static_cast<long long>(x) * lv.w[l] / W;
    base = __ldg(lv.c[l] + yl * lv.w[l] + xl);
    first = l;
    if (base.w > 0.f) break;
  }
  if (first == 0) {
    out[p] = base;
    return;
  }
  const float4 c1 = upsampled(lv, min(first + 1, n - 1), idx, wt, H, W, y, x);
  const float4 c2 = upsampled(lv, min(first + 2, n - 1), idx, wt, H, W, y, x);
  const float s = __fmul_rn(__fadd_rn(static_cast<float>(x), 0.5f), inv_w);
  const float t = __fmul_rn(__fadd_rn(static_cast<float>(y), 0.5f), inv_h);
  const float w1 = __fsqrt_rn(__fadd_rn(__fmul_rn(s, s), __fmul_rn(t, t)));
  const float w2 = __fsub_rn(1.f, w1);
  const float den = __fadd_rn(w1, w2);
  out[p] = make_float4(blend(c1.x, w1, c2.x, w2, den), blend(c1.y, w1, c2.y, w2, den),
                       blend(c1.z, w1, c2.z, w2, den), blend(c1.w, w1, c2.w, w2, den));
}

}  // namespace

// color f32[H, W, 4], depth f32[H, W] -> c_out f32[H/2, W/2, 4], d_out f32[H/2, W/2]
RR_API int rr_holefill_level(const float* color, const float* depth, float* c_out, float* d_out,
                             int H, int W, cudaStream_t stream) {
  const int H2 = H / 2, W2 = W / 2;
  dim3 grid((W2 + TX - 1) / TX, (H2 + TY - 1) / TY);
  level_kernel<<<grid, dim3(TX, TY), 0, stream>>>(
      reinterpret_cast<const float4*>(color), depth, reinterpret_cast<float4*>(c_out), d_out,
      H, W, H2, W2);
  return rr_status();
}

// colors: n device pointers (host array) to LOD l's f32[hs[l], ws[l], 4];
// depth0 f32[H, W]; idx i32[n, H + W, 2] and wt f32[n, H + W, 2], each LOD's
// row taps then column taps -> out f32[H, W, 4]
RR_API int rr_holefill_resolve(const long long* colors, const int* hs, const int* ws, int n,
                               const float* depth0, const int* idx, const float* wt, float* out,
                               int H, int W, cudaStream_t stream) {
  if (n < 1 || n > MAX_LODS) return static_cast<int>(cudaErrorInvalidValue);
  Levels lv{};
  for (int l = 0; l < n; ++l) {
    lv.c[l] = reinterpret_cast<const float4*>(colors[l]);
    lv.h[l] = hs[l];
    lv.w[l] = ws[l];
  }
  // what PyTorch's CUDA division by a host scalar multiplies by
  const float inv_w = 1.0f / static_cast<float>(W);
  const float inv_h = 1.0f / static_cast<float>(H);
  dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY);
  resolve_kernel<<<grid, dim3(TX, TY), 0, stream>>>(
      lv, n, depth0, reinterpret_cast<const int2*>(idx), reinterpret_cast<const float2*>(wt),
      reinterpret_cast<float4*>(out), H, W, inv_w, inv_h);
  return rr_status();
}

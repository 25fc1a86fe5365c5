// Piecewise-linear-in-depth calibration warp for M stacked depth maps.
//
// Replaces rgbd_recon_tpu/ops/piecewise_pallas.py::piecewise_eval_pallas:
//   dc = clamp(D[m, k, y, x], d_min, d_max)
//   cc = (dc - d_min) / (d_max - d_min) * (S - 1)
//   out[m, k, y, x, c] = A[k, p, c] + dc * B[k, p, c]
//                        + sum_s max(1 - |cc - s|, 0) * R[k, c, s, p]
// with p = (clamp(y + dy_m), clamp(x + dx_m)) the pixel map m reads (offset
// (0, 0) unless the caller gives one per map). The TPU kernel walks all S
// knots per pixel with a band of R resident in VMEM, and its caller gets
// the shifted taps of the normal stencil by shifting the depth maps against
// the table and back; here each thread reads the table at the shifted pixel
// directly, and only the two knots that bracket cc (the others add exactly 0).
//
// Bound on the card: memory. Per map-pixel D (4 bytes), two knots a channel
// (4 C bytes) and the output (4 C bytes); per pixel A and B (8 C bytes). At
// the bench shape (K = 4, 424 x 512) that is 45 MB for xyz (M = 1, C = 3)
// and 142 MB for the normal stencil (M = 5, C = 3). Design: one thread per
// output pixel (k, y, x), x fastest, a warp a row: the clamp, the knot
// coordinate and the two hat weights are computed once a map and shared by
// the C channels; the maps of one call (at most kMaps) are a loop inside
// the thread, so a map whose tap is a neighbour pixel finds A, B and the
// knots in L1. Each warp stages its C-float pixels in shared memory and
// stores the row's contiguous run with coalesced 4-byte stores. 32-bit
// indices (the wrapper raises at 2^31 elements).
//
// Rounding: every multiply, add and the division is an explicitly rounded
// intrinsic (no FMA contraction), in the plain PyTorch version's order, so
// the two agree bit for bit.
#include "common.cuh"

namespace {

constexpr int kMaps = 8;      // maps a thread loops over; offsets for at most this many
constexpr int kRows = 8;      // rows (warps) a block

struct Offsets {
  int d[2 * kMaps];           // (dy, dx) per map
};

// OFFS: the maps carry offsets (else every tap is the pixel itself)
template <int C, bool OFFS>
__global__ void __launch_bounds__(32 * kRows)
piecewise_eval_kernel(const float* __restrict__ D,             // [M, K, H, W]
                      const float* __restrict__ a,             // [K, H, W, C]
                      const float* __restrict__ b,             // [K, H, W, C]
                      const __nv_bfloat16* __restrict__ r,     // [K, C, S, H, W]
                      float* __restrict__ out,                 // [M, K, H, W, C]
                      int M, int K, int S, int H, int W, float d_min, float d_max,
                      float span, Offsets offs) {
  __shared__ float stage[kRows][32 * C];
  const int lane = threadIdx.x;
  const int y = blockIdx.y * kRows + threadIdx.y;
  if (y >= H) return;                                  // a whole warp: one row
  const int x0 = blockIdx.x * 32;
  const int x = x0 + lane;
  const int n = min(32, W - x0) * C;                   // floats of the warp's run
  const int k = blockIdx.z % K;
  const int m0 = blockIdx.z / K * kMaps;
  const int hw = H * W;
  const float scale = static_cast<float>(S - 1);
  float* st = stage[threadIdx.y];
#pragma unroll
  for (int j = 0; j < kMaps; ++j) {
    const int m = m0 + j;
    if (m >= M) break;
    const int mk = (m * K + k) * hw;
    if (x < W) {
      const int oy = OFFS ? offs.d[2 * j] : 0;
      const int ox = OFFS ? offs.d[2 * j + 1] : 0;
      const int tp = min(max(y + oy, 0), H - 1) * W + min(max(x + ox, 0), W - 1);
      const float dc = fminf(fmaxf(D[mk + y * W + x], d_min), d_max);
      const float q = __fmul_rn(__fdiv_rn(__fsub_rn(dc, d_min), span), scale);
      const float f0 = floorf(q);
      const int s0 = min(static_cast<int>(f0), S - 1);
      const int s1 = min(s0 + 1, S - 1);
      const float w0 = fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn(q, f0))), 0.f);
      const float w1 = fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn(q, __fadd_rn(f0, 1.f)))), 0.f);
      const float* ap = a + (k * hw + tp) * C;
      const float* bp = b + (k * hw + tp) * C;
      const __nv_bfloat16* rp = r + k * C * S * hw + tp;
      float res[C];   // every channel's loads issued before the shared stores
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const __nv_bfloat16* rc = rp + c * S * hw;
        const float acc = __fadd_rn(ap[c], __fmul_rn(dc, bp[c]));
        res[c] = __fadd_rn(__fadd_rn(acc, __fmul_rn(w0, __bfloat162float(rc[s0 * hw]))),
                           __fmul_rn(w1, __bfloat162float(rc[s1 * hw])));
      }
#pragma unroll
      for (int c = 0; c < C; ++c) st[lane * C + c] = res[c];
    }
    __syncwarp();
    float* o = out + (mk + y * W + x0) * C;
    for (int i = lane; i < n; i += 32) o[i] = st[i];
    __syncwarp();
  }
}

template <int C>
void launch(const float* D, const float* a, const float* b, const __nv_bfloat16* r, float* out,
            int M, int K, int S, int H, int W, float d_min, float d_max, float span,
            const Offsets& offs, bool with_offsets, cudaStream_t stream) {
  const dim3 grid((W + 31) / 32, (H + kRows - 1) / kRows, K * ((M + kMaps - 1) / kMaps));
  if (with_offsets)
    piecewise_eval_kernel<C, true><<<grid, dim3(32, kRows), 0, stream>>>(
        D, a, b, r, out, M, K, S, H, W, d_min, d_max, span, offs);
  else
    piecewise_eval_kernel<C, false><<<grid, dim3(32, kRows), 0, stream>>>(
        D, a, b, r, out, M, K, S, H, W, d_min, d_max, span, offs);
}

}  // namespace

// offsets: host int[2 * kMaps], (dy, dx) of map m at [2m], [2m + 1], or
// null: no offsets (the wrapper gives offsets for at most kMaps maps);
// span: d_max - d_min rounded once to float, as the plain version's divisor;
// C: 3 (xyz) or 2 (uv).
RR_API int rr_piecewise_eval(const float* D, const float* a, const float* b,
                             const __nv_bfloat16* r, const int* offsets, float* out, int M,
                             int K, int C, int S, int H, int W, float d_min, float d_max,
                             float span, cudaStream_t stream) {
  if (M <= 0 || K <= 0 || H <= 0 || W <= 0) return rr_status();
  Offsets offs = {};
  if (offsets != nullptr)
    for (int i = 0; i < 2 * kMaps; ++i) offs.d[i] = offsets[i];
  const bool o = offsets != nullptr;
  switch (C) {
    case 2: launch<2>(D, a, b, r, out, M, K, S, H, W, d_min, d_max, span, offs, o, stream); break;
    case 3: launch<3>(D, a, b, r, out, M, K, S, H, W, d_min, d_max, span, offs, o, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return rr_status();
}

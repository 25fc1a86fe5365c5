// Piecewise-linear-in-depth calibration warp for M stacked depth maps.
//
// Replaces rgbd_recon_tpu/ops/piecewise_pallas.py::piecewise_eval_pallas:
//   out[m, k, y, x, c] = A[k, y, x, c] + dc[m, k, y, x] * B[k, y, x, c]
//                        + sum_s max(1 - |cc[m, k, y, x] - s|, 0) * R[k, c, s, y, x]
// with the clamped depth dc and knot coordinate cc computed by the wrapper
// (as the TPU wrapper does). The TPU kernel walks all S knots per pixel
// with a band of R resident in VMEM; only the two knots that bracket cc
// have a non-zero hat weight, and the others add exactly 0, so here each
// thread reads just those two.
//
// Bound on the card: memory. Per (pixel, channel) and map the kernel reads
// two bf16 knots (scattered across the S planes by depth, 2 x 2 bytes), the
// map's dc and cc (8 bytes, shared by the C channels through L1/L2) and
// writes 4 bytes; A and B (8 bytes) are read once for all M maps. At the
// bench shape (M = 5, K = 4, 424 x 512, C = 3) that is ~0.15 GB per call,
// against the whole R (~125 MB per table) the TPU kernel streams. Design:
// one thread per (k, c, y, x), x fastest (R's and the maps' contiguous
// axis: coalesced knot reads), looping over the M maps.
//
// Rounding: every multiply and add is an explicit round-to-nearest
// intrinsic (no FMA contraction), in the plain PyTorch version's order, so
// the two agree bit for bit.
#include "common.cuh"

namespace {

__global__ void piecewise_eval_kernel(const float* __restrict__ dc,           // [M, K, H, W]
                                      const float* __restrict__ cc,           // [M, K, H, W]
                                      const float* __restrict__ a,            // [K, H, W, C]
                                      const float* __restrict__ b,            // [K, H, W, C]
                                      const __nv_bfloat16* __restrict__ r,    // [K, C, S, H, W]
                                      float* __restrict__ out,                // [M, K, H, W, C]
                                      int M, int K, int C, int S, int H, int W) {
  const long long hw = static_cast<long long>(H) * W;
  const long long n = static_cast<long long>(K) * C * hw;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long p = i % hw;                 // y * W + x
    const int c = static_cast<int>((i / hw) % C);
    const int k = static_cast<int>(i / (hw * C));
    const long long kp = k * hw + p;            // (k, y, x)
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

}  // namespace

RR_API int rr_piecewise_eval(const float* dc, const float* cc, const float* a, const float* b,
                             const __nv_bfloat16* r, float* out, int M, int K, int C, int S,
                             int H, int W, cudaStream_t stream) {
  const long long n = static_cast<long long>(K) * C * H * W;
  if (n > 0 && M > 0)
    piecewise_eval_kernel<<<min(rr_blocks(n, 256), 8 * 132 * 8), 256, 0, stream>>>(
        dc, cc, a, b, r, out, M, K, C, S, H, W);
  return rr_status();
}

// 13x13 bilateral-filter accumulators of the depth preprocessing pass.
//
// Replaces rgbd_recon_tpu/ops/preprocess_pallas.py::bilateral_accum_pallas
// (pre_depth.fs:85-127): for every pixel of every sensor, over the 13x13
// edge-clamped window, the weighted depth sum, the total weight and the
// range-weight sum of the taps inside the sensor's depth limits whose
// distance to the center is within 0.35 * d / 4.5. The spatial weight is a
// tent that goes negative in the window corners, as the reference has it.
//
// Bound on the card: 169 taps x ~10 flops per pixel on ~0.9 M pixels at the
// bench shape (4 x 424 x 512) is ~1.5 GFLOP against 3.5 MB read and 10 MB
// written, so it is compute-bound. Design: one thread per output pixel, a
// 32x8 output tile per block staged once in shared memory with its 6-pixel
// halo (edge-clamped on load), so every tap is a shared-memory read; the
// spatial weights are compile-time constants of the unrolled tap loop.
#include "common.cuh"

namespace {

constexpr int KS = 6;
constexpr int TX = 32;
constexpr int TY = 8;
constexpr int SX = TX + 2 * KS;
constexpr int SY = TY + 2 * KS;

__global__ void __launch_bounds__(TX * TY)
bilateral_accum_kernel(const float* __restrict__ depth,
                       const float* __restrict__ limits,
                       float* __restrict__ out, int K, int H, int W) {
  __shared__ float tile[SY][SX];
  const int k = blockIdx.z;
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const float* d = depth + static_cast<size_t>(k) * H * W;
  for (int i = threadIdx.y * TX + threadIdx.x; i < SY * SX; i += TX * TY) {
    const int ty = i / SX;
    const int tx = i - ty * SX;
    const int gy = min(max(y0 + ty - KS, 0), H - 1);
    const int gx = min(max(x0 + tx - KS, 0), W - 1);
    tile[ty][tx] = d[static_cast<size_t>(gy) * W + gx];
  }
  __syncthreads();
  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;

  const float cv_min = limits[2 * k];
  const float cv_max = limits[2 * k + 1];
  const float dc = tile[threadIdx.y + KS][threadIdx.x + KS];
  const float drm = 0.35f * (dc / 4.5f);
  const float drm_div = fmaxf(drm, 1e-20f);
  float bf = 0.f, wa = 0.f, wr = 0.f;
#pragma unroll
  for (int dy = -KS; dy <= KS; ++dy) {
#pragma unroll
    for (int dx = -KS; dx <= KS; ++dx) {
      const float s = tile[threadIdx.y + KS + dy][threadIdx.x + KS + dx];
      const float dist = fabsf(s - dc);
      const bool accept = (s >= cv_min) && (s <= cv_max) && (dist <= drm);
      const float gs = 1.0f - sqrtf(static_cast<float>(dx * dx + dy * dy)) / 6.0f;
      const float gr = 1.0f - fminf(dist, drm) / drm_div;
      const float ws = gs * gr;
      if (accept) {
        bf += ws * s;
        wa += ws;
        wr += gr;
      }
    }
  }
  const size_t plane = static_cast<size_t>(K) * H * W;
  const size_t o = (static_cast<size_t>(k) * H + y) * W + x;
  out[o] = bf;
  out[plane + o] = wa;
  out[2 * plane + o] = wr;
}

}  // namespace

// depth f32[K, H, W], limits f32[K, 2] -> out f32[3, K, H, W]
RR_API int rr_bilateral_accum(const float* depth, const float* limits,
                              float* out, int K, int H, int W,
                              cudaStream_t stream) {
  dim3 block(TX, TY);
  dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, K);
  bilateral_accum_kernel<<<grid, block, 0, stream>>>(depth, limits, out, K, H, W);
  return rr_status();
}

// 13x13 bilateral-filter accumulators of the depth preprocessing pass.
//
// Replaces rgbd_recon_tpu/ops/preprocess_pallas.py::bilateral_accum_pallas
// (pre_depth.fs:85-127): for every pixel of every sensor, over the 13x13
// edge-clamped window, the weighted depth sum, the total weight and the
// range-weight sum of the taps inside the sensor's depth limits whose
// distance to the center is within 0.35 * d / 4.5. The spatial weight is a
// tent that goes negative in the window corners, as the reference has it.
//
// Bound on the card: operations. A tap is 8 fp32 operations, counting an
// FMA as two: s - dc (the abs is an operand modifier), 1 - dist * inv (FMA),
// the clamp at 0 (a max, not counted), gs * gr, wr += gr, wa += ws and
// bf += ws * s (FMA). 169 taps x 8 on the 0.87 M pixels of the bench shape
// (4 x 424 x 512) are 1.17 G operations (17.5 us at 67 TFLOP/s) against
// 3.5 MB read and 10 MB written (4 us). The tap is 7 arithmetic
// instructions and half a shared-memory load, so instruction issue (one
// warp instruction a cycle per SM sub-partition) holds the kernel near
// twice that bound. The
// first design (one output per thread, an IEEE division and a branch in
// every tap) issued ~3x the instructions of the arithmetic. This one:
//   - divides once per pixel (1 / drm) and multiplies in the taps;
//   - gives each thread a column of R = 2 outputs: it slides over the 14
//     staged rows, so every shared-memory value it loads serves up to two
//     outputs. On an H100 SXM at 700 W, R = 1 and 4 ran within 7% of
//     R = 2, and R = 8 (1,352 unrolled tap bodies) 9x slower;
//   - tests the sensor's depth limits once per staged value: a depth
//     outside them is staged as OUT (1e30), which no range window accepts
//     (the centers are read unmasked from global memory);
//   - takes the range weight as max(1 - dist / drm, 0), which is 0 exactly
//     for the taps the reference rejects (dist > drm, up to rounding at the
//     window's edge where the weight is 0 either way), and accumulates all
//     three sums from it, no branch and no select; the spatial weights are
//     compile-time constants of the unrolled loops;
//   - stages a 32 x 16 output tile with its 6-pixel edge-clamped halo in
//     shared memory (28 x 44 floats; the halo is 2.4x the tile).
#include "common.cuh"

namespace {

constexpr int KS = 6;
constexpr int TAPS = 2 * KS + 1;
constexpr int TX = 32;
constexpr int TY = 8;
constexpr int R = 2;            // output rows per thread
constexpr int SX = TX + 2 * KS;
constexpr int SY = TY * R + 2 * KS;
constexpr float OUT = 1e30f;   // staged for depths outside the sensor's limits

__global__ void __launch_bounds__(TX * TY)
bilateral_accum_kernel(const float* __restrict__ depth,
                       const float* __restrict__ limits,
                       float* __restrict__ out, int K, int H, int W) {
  __shared__ float tile[SY][SX];
  const int k = blockIdx.z;
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY * R;
  const float* d = depth + static_cast<size_t>(k) * H * W;
  const float cv_min = limits[2 * k];
  const float cv_max = limits[2 * k + 1];
  for (int i = threadIdx.y * TX + threadIdx.x; i < SY * SX; i += TX * TY) {
    const int ty = i / SX;
    const int tx = i - ty * SX;
    const int gy = min(max(y0 + ty - KS, 0), H - 1);
    const int gx = min(max(x0 + tx - KS, 0), W - 1);
    const float s = d[static_cast<size_t>(gy) * W + gx];
    tile[ty][tx] = (s >= cv_min && s <= cv_max) ? s : OUT;
  }
  __syncthreads();

  const int row0 = threadIdx.y * R;   // this thread's first output row in the tile
  const int col = threadIdx.x + KS;
  const int xc = min(x0 + threadIdx.x, W - 1);
  float dc[R], drm[R], inv[R], bf[R], wa[R], wr[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    dc[r] = d[static_cast<size_t>(min(y0 + row0 + r, H - 1)) * W + xc];
    drm[r] = 0.35f * (dc[r] / 4.5f);
    inv[r] = 1.0f / fmaxf(drm[r], 1e-20f);
    bf[r] = wa[r] = wr[r] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < TAPS + R - 1; ++j) {       // staged rows this column reads
#pragma unroll
    for (int dx = -KS; dx <= KS; ++dx) {
      const float s = tile[row0 + j][col + dx];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int dy = j - r - KS;               // tap row of output r
        if (dy < -KS || dy > KS) continue;       // resolved at compile time
        const float gs = 1.0f - sqrtf(static_cast<float>(dx * dx + dy * dy)) / 6.0f;
        // a rejected tap (dist > drm, or an OUT value) weighs 0, and its
        // product with a zero weight is 0
        const float gr = fmaxf(fmaf(-fabsf(s - dc[r]), inv[r], 1.0f), 0.f);
        const float ws = gs * gr;
        wr[r] += gr;
        wa[r] += ws;
        bf[r] += ws * s;
      }
    }
  }
  const int x = x0 + threadIdx.x;
  if (x >= W) return;
  const size_t plane = static_cast<size_t>(K) * H * W;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int y = y0 + row0 + r;
    if (y >= H) break;
    const size_t o = (static_cast<size_t>(k) * H + y) * W + x;
    out[o] = bf[r];
    out[plane + o] = wa[r];
    out[2 * plane + o] = wr[r];
  }
}

}  // namespace

// depth f32[K, H, W], limits f32[K, 2] -> out f32[3, K, H, W]
RR_API int rr_bilateral_accum(const float* depth, const float* limits, float* out, int K,
                              int H, int W, cudaStream_t stream) {
  dim3 block(TX, TY);
  dim3 grid((W + TX - 1) / TX, (H + TY * R - 1) / (TY * R), K);
  bilateral_accum_kernel<<<grid, block, 0, stream>>>(depth, limits, out, K, H, W);
  return rr_status();
}

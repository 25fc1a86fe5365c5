// Per-pixel fusion weight of the depth preprocessing pass (pre_quality.fs).
//
// Replaces no TPU kernel: the JAX package computes it with XLA ops
// (rgbd_recon_tpu/ops/preprocess.py::quality), which the port ran as 169
// shifted eager passes of ~14 elementwise ops each over all K x H x W pixels
// (preprocess.quality_plain, kept as the CPU path and the oracle): ~2,370
// kernels and graph nodes a frame, each moving 3.5-10 MB.
//
// For every pixel inside (0 < d < 1) of every sensor, over the 13x13
// edge-clamped window of d = depth_b[..., 0]: the count of taps rejected
// (outside (0, 1), or farther than 0.35 d from the center) and the range
// weight sum of the others; then (1 - border / 169)^6 (w_range / 169)^6 /
// (6.5 d), times the squared cosine between the normal and the direction to
// the sensor. Pixels outside write 0.
//
// Bound on the card: operations. An accepted tap is 4 fp32 operations and an
// IEEE division (s - d, the compare, the quotient, 1 - q, the sum), about 7
// counted as the twin's; 169 taps on the 0.87 M pixels of the bench shape (4
// x 424 x 512) are ~1.0 G operations (15 us at 67 TFLOP/s) against 31 MB in
// and out (9 us at 3.35 TB/s). The design, kernel 3's layout:
//   - a 32 x 16 output tile with its 6-pixel edge-clamped halo staged in
//     shared memory (28 x 44 floats), read in place from depth_b's channel 0
//     (stride 2); a depth outside (0, 1) is staged as OUT (1e30), whose
//     distance to any center inside exceeds the range window, so a tap tests
//     one compare;
//   - each thread a column of R = 2 outputs, sliding over the 14 staged rows
//     it reads, the taps unrolled at compile time; a thread whose two
//     centers are outside skips the taps (most of a Kinect frame);
//   - every operation the twin's, in its order (dy outer, dx inner), one
//     IEEE rounding each (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn keep
//     nvcc from contracting or approximating), so both sums equal the twin's
//     bit for bit; the epilogue repeats the roundings of PyTorch's CUDA ops
//     in the twin: a division by the host scalar 169 is a product with its
//     float reciprocal, ** 6 is powf, a sum or norm over the 3 channels adds
//     channel 2 to channel 0 first, then channel 1 (the reduction kernel's
//     two lanes).
#include "common.cuh"

namespace {

constexpr int KS = 6;
constexpr int TAPS = 2 * KS + 1;
constexpr int TX = 32;
constexpr int TY = 8;
constexpr int R = 2;            // output rows per thread
constexpr int SX = TX + 2 * KS;
constexpr int SY = TY * R + 2 * KS;
constexpr float OUT = 1e30f;    // staged for depths outside (0, 1)
// what PyTorch's CUDA division by a host scalar multiplies by
constexpr float INV_TAPS = 1.0f / static_cast<float>(TAPS * TAPS);
constexpr float RANGE = static_cast<float>(0.35);
constexpr float DEPTH_SCALE = static_cast<float>(6.5);
constexpr float TINY = static_cast<float>(1e-20);

// a sum over 3 channels as PyTorch's reduction kernel takes it: lane 0 adds
// channels 0 and 2, lane 1 holds channel 1, then the lanes combine
__device__ __forceinline__ float sum3(float a0, float a1, float a2) {
  return __fadd_rn(__fadd_rn(a0, a2), a1);
}

// torch.clamp(x, min=lo): NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

__global__ void __launch_bounds__(TX * TY)
quality_kernel(const float* __restrict__ depth_b, const float* __restrict__ normals,
               const float* __restrict__ world, const float* __restrict__ cam,
               float* __restrict__ out, int H, int W) {
  __shared__ float tile[SY][SX];
  const int k = blockIdx.z;
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY * R;
  const float* d = depth_b + static_cast<size_t>(k) * H * W * 2;
  for (int i = threadIdx.y * TX + threadIdx.x; i < SY * SX; i += TX * TY) {
    const int ty = i / SX;
    const int tx = i - ty * SX;
    const int gy = min(max(y0 + ty - KS, 0), H - 1);
    const int gx = min(max(x0 + tx - KS, 0), W - 1);
    const float s = d[(static_cast<size_t>(gy) * W + gx) * 2];
    tile[ty][tx] = (s <= 0.f || s >= 1.f) ? OUT : s;
  }
  __syncthreads();

  const int row0 = threadIdx.y * R;   // this thread's first output row in the tile
  const int col = threadIdx.x + KS;
  float dc[R], drm[R], drm_div[R], wr[R];
  int border[R];
  bool inside[R];
  bool any_inside = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    dc[r] = tile[row0 + r + KS][col];
    inside[r] = dc[r] != OUT;
    any_inside |= inside[r];
    drm[r] = __fmul_rn(dc[r], RANGE);
    drm_div[r] = drm[r] > 0.f ? drm[r] : 1.0f;
    wr[r] = 0.f;
    border[r] = 0;
  }
  if (any_inside) {
#pragma unroll
    for (int j = 0; j < TAPS + R - 1; ++j) {       // staged rows this column reads
#pragma unroll
      for (int dx = -KS; dx <= KS; ++dx) {
        const float s = tile[row0 + j][col + dx];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int dy = j - r - KS;               // tap row of output r
          if (dy < -KS || dy > KS) continue;       // resolved at compile time
          const float dist = fabsf(__fsub_rn(s, dc[r]));
          // rejected: outside (0, 1) (staged OUT) or beyond the range window;
          // an accepted tap has min(dist, drm) == dist
          if (dist > drm[r]) {
            ++border[r];
          } else {
            wr[r] = __fadd_rn(wr[r], __fsub_rn(1.0f, __fdiv_rn(dist, drm_div[r])));
          }
        }
      }
    }
  }

  const int x = x0 + threadIdx.x;
  if (x >= W) return;
  const float c0 = cam[3 * k], c1 = cam[3 * k + 1], c2 = cam[3 * k + 2];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int y = y0 + row0 + r;
    if (y >= H) break;
    const size_t p = (static_cast<size_t>(k) * H + y) * W + x;
    if (!inside[r]) {
      out[p] = 0.f;
      continue;
    }
    const float lateral_q = __fsub_rn(1.0f, __fmul_rn(static_cast<float>(border[r]), INV_TAPS));
    float strong = __fmul_rn(powf(lateral_q, 6.0f), powf(__fmul_rn(wr[r], INV_TAPS), 6.0f));
    strong = __fdiv_rn(strong, clamp_min(__fmul_rn(dc[r], DEPTH_SCALE), TINY));
    const float t0 = __fsub_rn(c0, world[3 * p]);
    const float t1 = __fsub_rn(c1, world[3 * p + 1]);
    const float t2 = __fsub_rn(c2, world[3 * p + 2]);
    const float norm = clamp_min(
        __fsqrt_rn(sum3(__fmul_rn(t0, t0), __fmul_rn(t1, t1), __fmul_rn(t2, t2))), TINY);
    const float angle = sum3(__fmul_rn(__fdiv_rn(t0, norm), normals[3 * p]),
                             __fmul_rn(__fdiv_rn(t1, norm), normals[3 * p + 1]),
                             __fmul_rn(__fdiv_rn(t2, norm), normals[3 * p + 2]));
    out[p] = __fmul_rn(strong, __fmul_rn(angle, angle));
  }
}

}  // namespace

// depth_b f32[K, H, W, 2], normals and world f32[K, H, W, 3], cam f32[K, 3]
// -> out f32[K, H, W]
RR_API int rr_quality(const float* depth_b, const float* normals, const float* world,
                      const float* cam, float* out, int K, int H, int W, cudaStream_t stream) {
  dim3 block(TX, TY);
  dim3 grid((W + TX - 1) / TX, (H + TY * R - 1) / (TY * R), K);
  quality_kernel<<<grid, block, 0, stream>>>(depth_b, normals, world, cam, out, H, W);
  return rr_status();
}

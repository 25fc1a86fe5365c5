// The steps from the first warp_screen kernel to the current one, one
// change at a time, for timing them apart (warp_screen_steps.py):
//   step 0  the first kernel: one thread per pixel on a 32 x 8 block grid,
//           the tile index from three integer divisions, the channel count
//           a runtime argument, taps of the unpadded source and stores as
//           scalars;
//   step 1  + the block grid carries the tile row and x shifts by log2(tw):
//           no division;
//   step 2  + the channel count known at compile time;
//   step 3  + the 9-channel source padded to 12, each tap three float4;
//   step 4  + each warp's output staged in shared memory and written as
//           float4: csrc/warp_screen.cu itself, not repeated here.
// Every step computes the same function with the same operations.
#include "../csrc/common.cuh"

namespace {

__device__ __forceinline__ float lerp2(float gy, float gx, float va, float vb, float vc,
                                       float vd) {
  // rows first, then columns (the reference's y-stage / x-stage order)
  const float left = (1.f - gy) * va + gy * vc;
  const float right = (1.f - gy) * vb + gy * vd;
  return (1.f - gx) * left + gx * right;
}

__global__ void step0_kernel(const float* __restrict__ img, const float* __restrict__ fy,
                             const float* __restrict__ fx, const int* __restrict__ y0t,
                             const int* __restrict__ x0t, float* __restrict__ out, int Ti,
                             int Si, int C, int H, int W, int th, int tw, int wh, int wxw) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const int t = (y / th) * (W / tw) + x / tw;
  const int oy = y0t[t];
  const int ox = x0t[t];
  const size_t p = static_cast<size_t>(y) * W + x;
  const float ry = fminf(fmaxf(fy[p] - (float)oy, 0.f), (float)(wh - 1));
  const float rx = fminf(fmaxf(fx[p] - (float)ox, 0.f), (float)(wxw - 1));
  const float iy = floorf(ry), ix = floorf(rx);
  const float gy = ry - iy, gx = rx - ix;
  const int r0 = min(oy + (int)iy, Ti - 1);
  const int r1 = min(oy + min((int)iy + 1, wh - 1), Ti - 1);
  const int c0 = min(ox + (int)ix, Si - 1);
  const int c1 = min(ox + min((int)ix + 1, wxw - 1), Si - 1);
  const float* a = img + (static_cast<size_t>(r0) * Si + c0) * C;
  const float* b = img + (static_cast<size_t>(r0) * Si + c1) * C;
  const float* c = img + (static_cast<size_t>(r1) * Si + c0) * C;
  const float* d = img + (static_cast<size_t>(r1) * Si + c1) * C;
  float* o = out + p * C;
  for (int ch = 0; ch < C; ++ch) o[ch] = lerp2(gy, gx, a[ch], b[ch], c[ch], d[ch]);
}

// CT: the channel count at compile time (0: the runtime C); CP: the
// source's channel stride (12: float4 taps)
template <int CT, int CP>
__global__ void step_kernel(const float* __restrict__ img, const float* __restrict__ fy,
                            const float* __restrict__ fx, const int* __restrict__ y0t,
                            const int* __restrict__ x0t, float* __restrict__ out, int Ti,
                            int Si, int C_, int W, int ntx, int tw_shift, int wh, int wxw) {
  const int C = CT ? CT : C_;
  const int stride = CP ? CP : C;
  const int x = blockIdx.x * 32 + threadIdx.x;
  const int y = (blockIdx.z * gridDim.y + blockIdx.y) * 8 + threadIdx.y;
  const int t = blockIdx.z * ntx + (x >> tw_shift);
  const int oy = y0t[t];
  const int ox = x0t[t];
  const size_t p = static_cast<size_t>(y) * W + x;
  const float ry = fminf(fmaxf(fy[p] - (float)oy, 0.f), (float)(wh - 1));
  const float rx = fminf(fmaxf(fx[p] - (float)ox, 0.f), (float)(wxw - 1));
  const float iy = floorf(ry), ix = floorf(rx);
  const float gy = ry - iy, gx = rx - ix;
  const int r0 = min(oy + (int)iy, Ti - 1);
  const int r1 = min(oy + min((int)iy + 1, wh - 1), Ti - 1);
  const int c0 = min(ox + (int)ix, Si - 1);
  const int c1 = min(ox + min((int)ix + 1, wxw - 1), Si - 1);
  const float* a = img + (static_cast<size_t>(r0) * Si + c0) * stride;
  const float* b = img + (static_cast<size_t>(r0) * Si + c1) * stride;
  const float* c = img + (static_cast<size_t>(r1) * Si + c0) * stride;
  const float* d = img + (static_cast<size_t>(r1) * Si + c1) * stride;
  float* o = out + p * C;
  if constexpr (CP == 12) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float4 A = reinterpret_cast<const float4*>(a)[q];
      const float4 B = reinterpret_cast<const float4*>(b)[q];
      const float4 Cc = reinterpret_cast<const float4*>(c)[q];
      const float4 D = reinterpret_cast<const float4*>(d)[q];
      const float v[4] = {lerp2(gy, gx, A.x, B.x, Cc.x, D.x), lerp2(gy, gx, A.y, B.y, Cc.y, D.y),
                          lerp2(gy, gx, A.z, B.z, Cc.z, D.z), lerp2(gy, gx, A.w, B.w, Cc.w, D.w)};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * q + j < C) o[4 * q + j] = v[j];
    }
  } else {
    for (int ch = 0; ch < C; ++ch) o[ch] = lerp2(gy, gx, a[ch], b[ch], c[ch], d[ch]);
  }
}

}  // namespace

// step 0-3 of the list above on the arguments of rr_warp_screen; img holds
// C channels (steps 0-2) or 9 of 12 (step 3, C = 9). Steps 1-3 take the
// tiles rr_warp_screen takes.
RR_API int rr_warp_step(int step, const float* img, const float* fy, const float* fx,
                        const int* y0, const int* x0, float* out, int Ti, int Si, int C,
                        int H, int W, int th, int tw, int wh, int wxw, cudaStream_t stream) {
  if (step == 0) {
    dim3 grid((W + 31) / 32, (H + 7) / 8);
    step0_kernel<<<grid, dim3(32, 8), 0, stream>>>(img, fy, fx, y0, x0, out, Ti, Si, C, H,
                                                   W, th, tw, wh, wxw);
    return rr_status();
  }
  int tw_shift = 0;
  while ((1 << tw_shift) < tw) ++tw_shift;
  if (th % 8 || (1 << tw_shift) != tw || tw < 32 || H % th || W % tw)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(W / 32, th / 8, H / th), block(32, 8);
  const int ntx = W / tw;
#define RR_STEP(CT, CP)                                                                  \
  step_kernel<CT, CP><<<grid, block, 0, stream>>>(img, fy, fx, y0, x0, out, Ti, Si, C, W, \
                                                  ntx, tw_shift, wh, wxw)
  if (step == 1) RR_STEP(0, 0);
  else if (step == 2 && C == 9) RR_STEP(9, 0);
  else if (step == 2 && C == 3) RR_STEP(3, 0);
  else if (step == 3 && C == 9) RR_STEP(9, 12);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef RR_STEP
  return rr_status();
}

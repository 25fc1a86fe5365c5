// Windowed bilinear resample of an image onto a pixel grid.
//
// Replaces rgbd_recon_tpu/ops/warp_pallas.py::warp_screen_pallas, used for
// the color registration of preprocessing and the sweep-to-screen warp of
// the renderer: out[y, x, :] = bilinear(img, fy[y, x], fx[y, x]), with the
// taps confined to the window of the pixel's screen tile (origins y0/x0
// per tile, wh rows x wxw columns, rows and columns past the image edge
// read the edge). The window placement is computed per tile in PyTorch;
// where a tile's footprint overflows its window the coordinate clamps to
// the window edge, exactly as on the TPU.
//
// Bound on the card: bytes. At the screen warp (512x512x9 -> 1280x720x9)
// it must write 33 MB and read 7.4 MB of coordinates and the 9.4 MB source
// (15 us at 3.35 TB/s). On an H100 SXM at 700 W the first design took
// 91 us, over twice F.grid_sample's 40 us on the same image. Timed one
// change at a time (a steps tool, in git at 90d5ed3), its
// 9-float (36-byte) pixels stored as scalars, so each warp-wide store
// touched ~9x the sectors of a planar layout, cost the most, then its
// loop over a runtime channel count; its three integer divisions per
// pixel cost 1%. This one:
//   - launches one block row per 8 image rows inside one tile row
//     (blockIdx.z is the tile row, th % 8 == 0) and shifts x by log2(tw):
//     no division;
//   - takes the channel count as a template argument, so the tap loads
//     of all channels are unrolled and in flight together;
//   - reads each tap of the 9-channel source from a copy padded to 12
//     channels (the renderer packs it so), three aligned float4 loads;
//   - stages each warp's 32 output pixels (32 x C floats, a multiple of
//     16 bytes) in shared memory and writes them as contiguous float4.
// The 3-channel registration source is read as three scalars a tap.
#include "common.cuh"

namespace {

constexpr int TX = 32;   // one warp = 32 pixels of one row
constexpr int TY = 8;

template <int CP, int C>
__global__ void __launch_bounds__(TX * TY)
warp_screen_kernel(const float* __restrict__ img, const float* __restrict__ fy,
                   const float* __restrict__ fx, const int* __restrict__ y0t,
                   const int* __restrict__ x0t, float* __restrict__ out, int Ti, int Si,
                   int W, int ntx, int tw_shift, int wh, int wxw) {
  __shared__ __align__(16) float stage[TY][TX * C];
  const int lane = threadIdx.x;
  const int x = blockIdx.x * TX + lane;
  const int y = (blockIdx.z * gridDim.y + blockIdx.y) * TY + threadIdx.y;
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
  const float* a = img + (static_cast<size_t>(r0) * Si + c0) * CP;
  const float* b = img + (static_cast<size_t>(r0) * Si + c1) * CP;
  const float* c = img + (static_cast<size_t>(r1) * Si + c0) * CP;
  const float* d = img + (static_cast<size_t>(r1) * Si + c1) * CP;
  float* st = stage[threadIdx.y] + lane * C;
  // rows first, then columns (the reference's y-stage / x-stage order)
  auto lerp2 = [&](float va, float vb, float vc, float vd) {
    const float left = (1.f - gy) * va + gy * vc;
    const float right = (1.f - gy) * vb + gy * vd;
    return (1.f - gx) * left + gx * right;
  };
  if constexpr (CP % 4 == 0) {
#pragma unroll
    for (int q = 0; q < CP / 4; ++q) {
      const float4 A = reinterpret_cast<const float4*>(a)[q];
      const float4 B = reinterpret_cast<const float4*>(b)[q];
      const float4 Cc = reinterpret_cast<const float4*>(c)[q];
      const float4 D = reinterpret_cast<const float4*>(d)[q];
      const float v[4] = {lerp2(A.x, B.x, Cc.x, D.x), lerp2(A.y, B.y, Cc.y, D.y),
                          lerp2(A.z, B.z, Cc.z, D.z), lerp2(A.w, B.w, Cc.w, D.w)};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * q + j < C) st[4 * q + j] = v[j];
    }
  } else {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) st[ch] = lerp2(a[ch], b[ch], c[ch], d[ch]);
  }
  __syncwarp();
  // the warp's 32 pixels are 32 * C contiguous floats of the output
  float4* dst = reinterpret_cast<float4*>(out + (static_cast<size_t>(y) * W + x - lane) * C);
  const float4* src = reinterpret_cast<const float4*>(stage[threadIdx.y]);
#pragma unroll
  for (int i = lane; i < TX * C / 4; i += TX) dst[i] = src[i];
}

template <int CP, int C>
void launch(const float* img, const float* fy, const float* fx, const int* y0,
            const int* x0, float* out, int Ti, int Si, int H, int W, int th, int tw,
            int tw_shift, int wh, int wxw, cudaStream_t stream) {
  dim3 block(TX, TY);
  dim3 grid(W / TX, th / TY, H / th);
  warp_screen_kernel<CP, C><<<grid, block, 0, stream>>>(img, fy, fx, y0, x0, out, Ti, Si, W,
                                                        W / tw, tw_shift, wh, wxw);
}

}  // namespace

// img f32[Ti, Si, CP] (CP = 3, or 12 holding 9 channels and 3 of padding),
// fy/fx f32[H, W], y0/x0 i32[(H/th) * (W/tw)] -> out f32[H, W, C]. Takes
// th % 8 == 0, tw a power of two >= 32, H % th == 0 and W % tw == 0 (the
// tiles of both callers).
RR_API int rr_warp_screen(const float* img, const float* fy, const float* fx,
                          const int* y0, const int* x0, float* out, int Ti, int Si, int CP,
                          int C, int H, int W, int th, int tw, int wh, int wxw,
                          cudaStream_t stream) {
  int tw_shift = 0;
  while ((1 << tw_shift) < tw) ++tw_shift;
  if (th % TY || (1 << tw_shift) != tw || tw < TX || H % th || W % tw)
    return static_cast<int>(cudaErrorInvalidValue);
  if (CP == 12 && C == 9)
    launch<12, 9>(img, fy, fx, y0, x0, out, Ti, Si, H, W, th, tw, tw_shift, wh, wxw, stream);
  else if (CP == 3 && C == 3)
    launch<3, 3>(img, fy, fx, y0, x0, out, Ti, Si, H, W, th, tw, tw_shift, wh, wxw, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return rr_status();
}

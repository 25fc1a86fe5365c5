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
// Bound on the card: memory. At the screen warp (1280x720 x 9 channels)
// it reads 4 taps x 36 bytes and writes 36 bytes per pixel, ~0.2 GB/s-ms
// worth of traffic (about 50 us at HBM rate); the source (512x512x9 f32,
// 9 MB) stays in L2. Design: one thread per output pixel, fp32 taps read
// directly (no hat-weight matmuls, no hi/lo split), consecutive threads on
// consecutive pixels of a row.
#include "common.cuh"

namespace {

__global__ void warp_screen_kernel(const float* __restrict__ img,
                                   const float* __restrict__ fy,
                                   const float* __restrict__ fx,
                                   const int* __restrict__ y0t,
                                   const int* __restrict__ x0t,
                                   float* __restrict__ out, int Ti, int Si, int C,
                                   int H, int W, int th, int tw, int wh, int wxw) {
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
  for (int ch = 0; ch < C; ++ch) {
    // rows first, then columns (the reference's y-stage / x-stage order)
    const float left = (1.f - gy) * a[ch] + gy * c[ch];
    const float right = (1.f - gy) * b[ch] + gy * d[ch];
    o[ch] = (1.f - gx) * left + gx * right;
  }
}

}  // namespace

// img f32[Ti, Si, C], fy/fx f32[H, W], y0/x0 i32[(H/th) * (W/tw)]
//   -> out f32[H, W, C]
RR_API int rr_warp_screen(const float* img, const float* fy, const float* fx,
                          const int* y0, const int* x0, float* out, int Ti, int Si,
                          int C, int H, int W, int th, int tw, int wh, int wxw,
                          cudaStream_t stream) {
  dim3 block(32, 8);
  dim3 grid((W + 31) / 32, (H + 7) / 8);
  warp_screen_kernel<<<grid, block, 0, stream>>>(img, fy, fx, y0, x0, out, Ti, Si, C,
                                                 H, W, th, tw, wh, wxw);
  return rr_status();
}

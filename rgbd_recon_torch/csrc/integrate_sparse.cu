// Brick-sparse TSDF + color fusion from the dense voxel -> sensor warp
// table, in two window modes.
//
// Replaces rgbd_recon_tpu/ops/tsdf_pallas.py::integrate_sparse_pallas (the
// table tier: use_affine=False, or an affine residual over affine_tol) and,
// in the window mode, the XLA table integrator
// rgbd_recon_tpu/ops/tsdf_fast.py::integrate_sparse (use_pallas=False, or a
// volume under 8 bricks on an axis; ReconIntegration). Per occupied 16^3
// brick and sensor k, the warp (u, v, d) of each voxel is read from
// IntegrationTables.pos_blocked [K, NB, 4096, 3] (u < 0 marks a voxel
// outside the sensor's frustum). The windows are kept, because they decide
// which pixels a brick with an oversized footprint reads:
// - table tier (rr_integrate_sparse): the TPU windows, WY = 48 rows from an
//   8-aligned origin and WX = 128 columns from an x-block at stride 64
//   (win_offsets_pallas); the SIL_PL = 0.998 gate on (1 - silhouette);
// - window mode (rr_integrate_sparse_window): a window x window square at
//   the arbitrary origin of tsdf_fast.win_offsets; the SIL_FULL = 0.9999
//   gate on the silhouette itself, as the XLA integrator samples it.
// Sample coordinates are clamped first to the image, then to the window.
// Depth NEAREST at floor(u * W), silhouette, quality and registered rgb
// LINEAR; invalid voxels take the corner pixel's values; f32 TSDF
// [Vz, Vy, Vx] and f32 color [Vz, Vy, Vx, 4] out, clear values (-limit, 0)
// where no brick is occupied (the XLA integrator's assemble_blocks). The TPU
// kernel samples through bf16 hat matmuls with a hi/lo depth split, the XLA
// integrator through f32 hat matmuls; this one samples in fp32 directly.
//
// Bound on the card: memory. Per voxel and sensor 12 bytes of table (the
// largest input stream: 805 MB for all bricks at 256^3 x 4 sensors, of which
// an occupied subset is read) plus 13 scattered, mostly L2-resident frame
// reads (the NEAREST depth and three 8-byte loads for each LINEAR tap,
// csrc/fuse.cuh); the clear of the outputs (256^3 x 20 bytes = 336 MB) is the
// largest write. Design: one 256-thread block per occupied brick (blocks
// past the occupied count exit at once), one thread per (y, x) column of the
// brick looping over its 16 z voxels; the window origins and corner values
// staged in shared memory.
#include "fuse.cuh"

namespace {

using namespace rr;
constexpr int WY = 48;
constexpr int WX = 128;
constexpr int XSTRIDE = 64;

// kWindow: the XLA integrator's square window and silhouette gate
template <bool kWindow>
__global__ void __launch_bounds__(THREADS)
integrate_sparse_kernel(const float* __restrict__ packed,   // [K, H, W, 6]
                        const float* __restrict__ pos,      // [K, NB, B3, 3]
                        const int* __restrict__ idx,        // [max_bricks]
                        const int* __restrict__ count,      // [1]
                        const int* __restrict__ win_off,    // [K, NB, 2] (y8, xb) or (y, x)
                        float* __restrict__ tsdf,           // [Vz, Vy, Vx]
                        float* __restrict__ color,          // [Vz, Vy, Vx, 4]
                        int K, int H, int W, int NB, int nbx, int nby, int Vx, int Vy,
                        int window, float limit) {
  const int slot = blockIdx.x;
  if (slot >= *count) return;
  const int b = idx[slot];

  __shared__ int s_ylo[MAXK], s_xlo[MAXK];
  __shared__ float s_corner[MAXK][6];
  const int tid = threadIdx.x;
  if (tid < K) {
    const size_t kb = static_cast<size_t>(tid) * NB + b;
    if (kWindow) {   // origins clamped into the image, as dynamic_slice clamps them
      s_ylo[tid] = min(max(win_off[kb * 2], 0), H - window);
      s_xlo[tid] = min(max(win_off[kb * 2 + 1], 0), W - window);
    } else {
      s_ylo[tid] = win_off[kb * 2];
      s_xlo[tid] = win_off[kb * 2 + 1] * XSTRIDE;
    }
    const float* c0 = packed + static_cast<size_t>(tid) * H * W * 6;
    for (int c = 0; c < 6; ++c) s_corner[tid][c] = c0[c];
  }
  __syncthreads();

  const int bz = b / (nby * nbx);
  const int by = (b / nbx) % nby;
  const int bx = b % nbx;
  const int ly = tid / BRICK;
  const int lx = tid % BRICK;
  const size_t plane = static_cast<size_t>(Vy) * Vx;
  const size_t col = static_cast<size_t>(by * BRICK + ly) * Vx + bx * BRICK + lx;
  const float fw = static_cast<float>(W), fh = static_cast<float>(H);
  const int wy = kWindow ? window : WY, wx = kWindow ? window : WX;

  for (int lz = 0; lz < BRICK; ++lz) {
    const int v = lz * BRICK * BRICK + tid;      // voxel within the brick, z-major
    Fuse s = fuse_init(limit);
    for (int k = 0; k < K; ++k) {
      const float* pc = pos + ((static_cast<size_t>(k) * NB + b) * B3 + v) * 3;
      const float u = pc[0], vv = pc[1], d_vox = pc[2];
      const float* cv = s_corner[k];
      float depth;
      float ch[5];
      if (u < 0.f) {                      // off-frustum marker: corner values
        depth = cv[0];
        ch[0] = kWindow ? cv[2] : 1.f - cv[2];
        ch[1] = cv[1]; ch[2] = cv[3]; ch[3] = cv[4]; ch[4] = cv[5];
      } else {
        const float* img = packed + static_cast<size_t>(k) * H * W * 6;
        const int xlo = s_xlo[k], ylo = s_ylo[k];
        const float xl = static_cast<float>(xlo), yl = static_cast<float>(ylo);
        // LINEAR coords: clamp to the image, then to the window
        const float ux = fminf(fmaxf(fminf(fmaxf(u * fw - 0.5f, 0.f), fw - 1.f) - xl, 0.f),
                               static_cast<float>(wx - 1));
        const float vy = fminf(fmaxf(fminf(fmaxf(vv * fh - 0.5f, 0.f), fh - 1.f) - yl, 0.f),
                               static_cast<float>(wy - 1));
        // NEAREST: floor(u * W) clamped the same way
        const int nu = min(max(static_cast<int>(fminf(fmaxf(floorf(u * fw), 0.f), fw - 1.f)) - xlo, 0),
                           wx - 1);
        const int nv = min(max(static_cast<int>(fminf(fmaxf(floorf(vv * fh), 0.f), fh - 1.f)) - ylo, 0),
                           wy - 1);
        depth = img[(static_cast<size_t>(ylo + nv) * W + xlo + nu) * 6];
        const float iu = floorf(ux), iv = floorf(vy);
        bilinear5<kWindow>(img, W, ylo + (int)iv, ylo + min((int)iv + 1, wy - 1),
                           xlo + (int)iu, xlo + min((int)iu + 1, wx - 1), ux - iu, vy - iv, ch);
      }
      fuse<kWindow>(s, d_vox, depth, ch[1], ch[0], ch[2], ch[3], ch[4], limit);
    }
    float o[4];
    fuse_color(s, o);
    const size_t at = static_cast<size_t>(bz * BRICK + lz) * plane + col;
    tsdf[at] = s.wt;
    reinterpret_cast<float4*>(color)[at] = make_float4(o[0], o[1], o[2], o[3]);
  }
}

template <bool kWindow>
int launch(const float* packed, const float* pos, const int* idx, const int* count,
           const int* win_off, float* tsdf, float* color, int K, int H, int W, int NB, int nbx,
           int nby, int nbz, int max_bricks, int window, float limit, cudaStream_t stream) {
  const int Vx = nbx * BRICK, Vy = nby * BRICK, Vz = nbz * BRICK;
  const long long n = static_cast<long long>(Vx) * Vy * Vz;
  fill_kernel<float><<<1024, 256, 0, stream>>>(tsdf, n, -limit);
  cudaMemsetAsync(color, 0, 4 * n * sizeof(float), stream);
  if (max_bricks > 0)
    integrate_sparse_kernel<kWindow><<<max_bricks, THREADS, 0, stream>>>(
        packed, pos, idx, count, win_off, tsdf, color, K, H, W, NB, nbx, nby, Vx, Vy, window,
        limit);
  return rr_status();
}

}  // namespace

RR_API int rr_integrate_sparse(const float* packed, const float* pos, const int* idx,
                               const int* count, const int* win_off, float* tsdf,
                               float* color, int K, int H, int W, int NB, int nbx, int nby,
                               int nbz, int max_bricks, float limit, cudaStream_t stream) {
  if (K > MAXK || H < WY || W < WX) return static_cast<int>(cudaErrorInvalidValue);
  return launch<false>(packed, pos, idx, count, win_off, tsdf, color, K, H, W, NB, nbx, nby,
                       nbz, max_bricks, 0, limit, stream);
}

// The XLA integrator's window mode: win_off holds (y, x) window origins of
// window x window squares (tsdf_fast.win_offsets).
RR_API int rr_integrate_sparse_window(const float* packed, const float* pos, const int* idx,
                                      const int* count, const int* win_off, float* tsdf,
                                      float* color, int K, int H, int W, int NB, int nbx,
                                      int nby, int nbz, int max_bricks, int window,
                                      float limit, cudaStream_t stream) {
  if (K > MAXK || window < 1 || H < window || W < window)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(packed, pos, idx, count, win_off, tsdf, color, K, H, W, NB, nbx, nby,
                      nbz, max_bricks, window, limit, stream);
}

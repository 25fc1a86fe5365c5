// The renderer's plane sweep in one launch: every slice of the sweep axis
// resampled onto the intermediate ray grid and composited front to back.
//
// Replaces no TPU kernel: the JAX package sweeps with lax.scan over XLA ops
// (rgbd_recon_tpu/ops/raymarch_fast.py::sweep), which the port first ran as
// a loop of PyTorch ops, two f32 GEMMs of hat weights and ~90 small
// elementwise ops a slice (raymarch_fast.sweep_plain, kept as the CPU path
// and the oracle). Of the 256-512 weights a GEMM row holds at most two are
// non-zero, the carry went through device memory between every op, and the
// slab flags of the fused frame only selected values.
//
// Bound on the card: the bytes the frame's volume needs. The occupied
// bricks' TSDF and color are read once (10 bytes a voxel) and the planes
// written once (36 bytes a ray): ~29 MB at 256^3, ~108 MB at 512^3, 9 and
// 32 us at 3.35 TB/s. What it meets instead is the latency of its gathers:
// every occupied slice reads 2 x 2 taps of 5 channels a ray. This design:
//   - a block owns a tile of BT x BS rays and marches the slices front to
//     back, G at a time; each ray's carry (prev density, bf16 color and
//     gradient, the hit state and the sample count) stays in registers and
//     the planes are written once at the end;
//   - a slice that the slab flags call empty is not resampled: the sample
//     count grows and the carry decays to the clear values, the twin's skip
//     without its work;
//   - each ray resamples at its <= 2 x 2 non-zero hat taps, with the twin's
//     roundings: bf16 weights and slice values, the row stage summed in f32
//     and rounded to bf16, the column stage in f32. A product of two bf16
//     values is exact in f32 and each stage sums at most two non-zero
//     terms, so the GEMMs' summation order cannot change a value; every
//     other operation is the twin's, one IEEE rounding each (__fadd_rn,
//     __fmul_rn and __fdiv_rn keep nvcc from contracting or approximating);
//   - a group's G slices are resampled first, every (slice, position) of
//     the tile and its one-ray halo in parallel, into shared memory; then
//     each thread carries its ray through them, reading the neighbours'
//     density for the in-plane gradient. Tile positions hold rays modulo
//     the grid, which is torch.roll's wrap at the grid edges;
//   - the resample's lanes run along whichever of the slice and the column
//     is the volumes' contiguous dimension: along the columns on axes 1
//     and 2, along the slices on axis 0, where a warp along the columns
//     touched a cache line a lane (13.4 against 2.3 ms at 512^3, the first
//     design's axis 0 against its axis 2);
//   - a ray that has hit resamples its density alone (its neighbours'
//     gradients need it), and a block whose rays have all hit stops;
//   - the camera's values come from device tensors (the grid, the eye and
//     each slice's sigma), so one captured graph serves every camera of its
//     (axis, flip).
// Strides of the sweep-frame views are arguments, so one kernel reads both
// color layouts (z-major, channels-last), every axis, a bf16 or f32 TSDF and
// color, and a slab of a larger volume (the sharded windows).
#include "common.cuh"

namespace {

constexpr int BS = 32;                  // tile columns: one warp a row
constexpr int BT = 8;                   // tile rows
constexpr int NT = BS * BT;             // threads a block, one a ray of the tile
constexpr int NPOS = (BT + 2) * (BS + 2);   // the tile and its one-ray halo
constexpr int G = 8;                    // slices resampled together

struct Params {
  const void* vol;
  const void* col;
  const unsigned char* flags;     // torch bools [ns_local], physical order; null: all occupied
  const float* r_grid;            // [ti]
  const float* c_grid;            // [si]
  const float* eye_p;             // [3]
  const float* sigma;             // [ns_local] logical order, from k0
  const float* s_back;            // s_k - ds
  const float* grad_r;            // dr2 * sigma + 1e-12
  const float* grad_c;            // dc2 * sigma + 1e-12
  const float* init_d;            // [ti, si] or null: the clear carry
  const __nv_bfloat16* init_c;    // [4, ti, si]
  const __nv_bfloat16* init_g;    // [3, ti, si]
  float* hit;                     // [ti, si]
  float* hit_s;                   // [ti, si]
  float* hit_color;               // [ti, si, 4]
  float* hit_grad;                // [ti, si, 3]
  float* nsamp;                   // [ti, si]
  long long ss, sr, sc;           // TSDF view [S, R, C] strides (elements)
  long long cs, cch, cr, cc;      // color view [S, 4, R, C] strides
  int ns_local, nr, nc, ti, si, ns, k0, p0, flip;
  float ds, clear_d;
};

__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float ld(const float* p, long long i) { return __ldg(p + i); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p) + i)));
}

// The twin's hat weight of sample i at coordinate c, clamp(1 - |c - i|, 0, 1)
// rounded to bf16.
__device__ __forceinline__ float hat(float c, int i) {
  const float w = __fsub_rn(1.f, fabsf(__fsub_rn(c, static_cast<float>(i))));
  return bf(fminf(fmaxf(w, 0.f), 1.f));
}

// A ray's two hat taps along one axis of n samples: indices (clamped into
// the axis where their weight is 0) and weights.
struct Taps {
  int i0, i1;
  float w0, w1;
};

// p = e + sigma (g - e), coordinate p n - 0.5 (the twin's pr / pc and
// _hat_rows); every weight but those of floor(c) and floor(c) + 1 is 0.
__device__ __forceinline__ Taps taps_of(float g, float e, float sigma, int n) {
  const float p = __fadd_rn(e, __fmul_rn(sigma, __fsub_rn(g, e)));
  const float c = __fsub_rn(__fmul_rn(p, static_cast<float>(n)), 0.5f);
  const float f = floorf(c);
  Taps t{0, 0, 0.f, 0.f};
  if (f >= -1.f && f <= static_cast<float>(n - 1)) {   // false for inf and NaN too
    const int i0 = static_cast<int>(f);
    if (i0 >= 0) {
      t.i0 = i0;
      t.w0 = hat(c, i0);
    }
    if (i0 + 1 < n) {
      t.i1 = i0 + 1;
      t.w1 = hat(c, i0 + 1);
    }
  }
  return t;
}

__device__ __forceinline__ bool empty(const Taps& t) { return t.w0 == 0.f && t.w1 == 0.f; }

// One channel at a ray: the row stage at each column tap (f32 sum of two
// exact products, rounded to bf16), then the column stage in f32.
template <typename T>
__device__ __forceinline__ float resample(const T* base, long long sr, long long sc,
                                          const Taps& R, const Taps& C) {
  const long long r0 = R.i0 * sr, r1 = R.i1 * sr, c0 = C.i0 * sc, c1 = C.i1 * sc;
  const float a0 = __fadd_rn(__fmul_rn(R.w0, bf(ld(base, r0 + c0))),
                             __fmul_rn(R.w1, bf(ld(base, r1 + c0))));
  const float a1 = __fadd_rn(__fmul_rn(R.w0, bf(ld(base, r0 + c1))),
                             __fmul_rn(R.w1, bf(ld(base, r1 + c1))));
  return __fadd_rn(__fmul_rn(bf(a0), C.w0), __fmul_rn(bf(a1), C.w1));
}

template <typename TD, typename TC, bool SLICES_FAST>
__global__ void __launch_bounds__(NT) sweep_march_kernel(const Params p) {
  // a group's resampled slices: density at the tile and its halo, color
  // at the tile (f32: the column stage's unrounded values)
  __shared__ float dens[G][BT + 2][BS + 2];
  __shared__ float rgba[G][4][BT][BS];
  __shared__ float pos_r[NPOS], pos_c[NPOS];  // each position's grid row and column
  __shared__ unsigned char live[BT][BS];      // the ray has not hit yet
  const TD* vol = static_cast<const TD*>(p.vol);
  const TC* col = static_cast<const TC*>(p.col);
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * BS + tx;
  const int t0 = blockIdx.y * BT, s0 = blockIdx.x * BS;
  // tile position (y, x) holds ray ((t0 + y) mod ti, (s0 + x) mod si):
  // torch.roll's wrap, and rays past a ragged edge stand in for the
  // wrapped ones (they write nothing)
  const int t = (t0 + ty) % p.ti, s = (s0 + tx) % p.si;
  const bool valid = t0 + ty < p.ti && s0 + tx < p.si;
  const float e1 = __ldg(p.eye_p + 1), e2 = __ldg(p.eye_p + 2);
  for (int pos = tid; pos < NPOS; pos += NT) {
    const int py = pos / (BS + 2) - 1, px = pos % (BS + 2) - 1;
    pos_r[pos] = __ldg(p.r_grid + (t0 + py + p.ti) % p.ti);
    pos_c[pos] = __ldg(p.c_grid + (s0 + px + p.si) % p.si);
  }

  // the carry
  const long long plane = static_cast<long long>(p.ti) * p.si;
  const long long ray = static_cast<long long>(t) * p.si + s;
  float prev_d = p.clear_d, prev_c[4] = {0.f, 0.f, 0.f, 0.f}, prev_g[3] = {0.f, 0.f, 0.f};
  if (p.init_d != nullptr) {
    prev_d = p.init_d[ray];
    for (int i = 0; i < 4; ++i) prev_c[i] = __bfloat162float(p.init_c[i * plane + ray]);
    for (int i = 0; i < 3; ++i) prev_g[i] = __bfloat162float(p.init_g[i * plane + ray]);
  }
  float hit_s = -1.f, hit_c[4] = {0.f, 0.f, 0.f, 0.f}, hit_g[3] = {0.f, 0.f, 0.f};
  float nsamp = 0.f;
  live[ty][tx] = valid;
  __syncthreads();

  const int k_end = p.k0 + p.ns_local;
  for (int kg = p.k0; kg < k_end; kg += G) {
    const int ng = min(G, k_end - kg);
    // resample the group's occupied slices, every (slice, position) item
    // in parallel: density at the tile and its halo, color at live rays
    for (int it = tid; it < G * NPOS; it += NT) {
      const int g = SLICES_FAST ? it % G : it / NPOS;
      const int pos = SLICES_FAST ? it / G : it % NPOS;
      const int k = kg + g;
      if (g >= ng) continue;
      const int kp = (p.flip ? p.ns - 1 - k : k) - p.p0;
      if (p.flags != nullptr && !p.flags[kp]) continue;
      const int py = pos / (BS + 2) - 1, px = pos % (BS + 2) - 1;
      const bool in_tile = py >= 0 && py < BT && px >= 0 && px < BS;
      if (!in_tile && (py < 0 || py >= BT) && (px < 0 || px >= BS)) continue;   // a corner
      const float sigma = __ldg(p.sigma + (k - p.k0));
      const Taps R = taps_of(pos_r[pos], e1, sigma, p.nr);
      const Taps C = taps_of(pos_c[pos], e2, sigma, p.nc);
      const bool inside = !empty(R) && !empty(C);
      dens[g][py + 1][px + 1] = inside ? resample(vol + kp * p.ss, p.sr, p.sc, R, C) : 0.f;
      if (in_tile && live[py][px]) {
        const TC* cs = col + kp * p.cs;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          rgba[g][i][py][px] = inside ? resample(cs + i * p.cch, p.cr, p.cc, R, C) : 0.f;
      }
    }
    __syncthreads();

    // the carry through the group's slices, front to back
    for (int g = 0; g < ng; ++g) {
      const int k = kg + g;
      const int kp = (p.flip ? p.ns - 1 - k : k) - p.p0;
      const bool active = hit_s < 0.f;
      if (p.flags != nullptr && !p.flags[kp]) {
        // an empty slice: no crossing, the carry decays to the clear values
        if (active) nsamp = __fadd_rn(nsamp, 1.f);
        prev_d = p.clear_d;
        for (int i = 0; i < 4; ++i) prev_c[i] = 0.f;
        for (int i = 0; i < 3; ++i) prev_g[i] = 0.f;
        continue;
      }
      if (!active || !valid) continue;
      const int kl = k - p.k0;
      const float d = dens[g][ty + 1][tx + 1];
      float c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) c[i] = rgba[g][i][ty][tx];
      const float g3[3] = {
          __fdiv_rn(__fsub_rn(d, prev_d), p.ds),
          __fdiv_rn(__fsub_rn(dens[g][ty + 2][tx + 1], dens[g][ty][tx + 1]),
                    __ldg(p.grad_r + kl)),
          __fdiv_rn(__fsub_rn(dens[g][ty + 1][tx + 2], dens[g][ty + 1][tx]),
                    __ldg(p.grad_c + kl))};
      if (d > 0.f && k > 0) {
        const float den = __fsub_rn(d, prev_d);
        const float frac = __fdiv_rn(prev_d, fabsf(den) > 1e-20f ? den : 1e-20f);
        hit_s = __fsub_rn(__ldg(p.s_back + kl), __fmul_rn(p.ds, frac));
        const float alpha = fminf(fmaxf(-frac, 0.f), 1.f);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          hit_c[i] = bf(__fadd_rn(prev_c[i], __fmul_rn(__fsub_rn(c[i], prev_c[i]), alpha)));
#pragma unroll
        for (int i = 0; i < 3; ++i)
          hit_g[i] = bf(__fadd_rn(prev_g[i], __fmul_rn(__fsub_rn(g3[i], prev_g[i]), alpha)));
      }
      nsamp = __fadd_rn(nsamp, 1.f);
      prev_d = d;
#pragma unroll
      for (int i = 0; i < 4; ++i) prev_c[i] = bf(c[i]);
#pragma unroll
      for (int i = 0; i < 3; ++i) prev_g[i] = bf(g3[i]);
    }
    const bool alive = valid && hit_s < 0.f;
    live[ty][tx] = alive;
    // the next group's resample overwrites the buffers and reads live
    if (!__syncthreads_or(alive)) break;   // every ray has hit
  }

  if (!valid) return;
  p.hit[ray] = hit_s >= 0.f ? 1.f : 0.f;
  p.hit_s[ray] = fmaxf(hit_s, 0.f);
  p.nsamp[ray] = nsamp;
  reinterpret_cast<float4*>(p.hit_color)[ray] = make_float4(hit_c[0], hit_c[1], hit_c[2], hit_c[3]);
  for (int i = 0; i < 3; ++i) p.hit_grad[ray * 3 + i] = hit_g[i];
}

template <typename TD, typename TC>
int launch(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.si + BS - 1) / BS, (p.ti + BT - 1) / BT), block(BS, BT);
  // the resample's lanes run along the smaller of the slice and the column
  // stride: along the columns on axes 1 and 2, along the slices on axis 0
  // (x is then the sweep axis and the volumes' contiguous dimension)
  if (p.ss < p.sc) {
    sweep_march_kernel<TD, TC, true><<<grid, block, 0, stream>>>(p);
  } else {
    sweep_march_kernel<TD, TC, false><<<grid, block, 0, stream>>>(p);
  }
  return rr_status();
}

}  // namespace

RR_API int rr_sweep_march(const void* vol, const void* col, const unsigned char* flags,
                          const float* r_grid, const float* c_grid, const float* eye_p,
                          const float* sigma, const float* s_back, const float* grad_r,
                          const float* grad_c, const float* init_d,
                          const __nv_bfloat16* init_c, const __nv_bfloat16* init_g,
                          float* hit, float* hit_s, float* hit_color, float* hit_grad,
                          float* nsamp, long long ss, long long sr, long long sc,
                          long long cs, long long cch, long long cr, long long cc,
                          int ns_local, int nr, int nc, int ti, int si, int ns, int k0, int p0,
                          int flip, int vol_f32, int col_f32, float ds, float clear_d,
                          cudaStream_t stream) {
  const Params p{vol, col, flags, r_grid, c_grid, eye_p, sigma, s_back, grad_r, grad_c,
                 init_d, init_c, init_g, hit, hit_s, hit_color, hit_grad, nsamp,
                 ss, sr, sc, cs, cch, cr, cc, ns_local, nr, nc, ti, si, ns, k0, p0, flip,
                 ds, clear_d};
  if (vol_f32) {
    return col_f32 ? launch<float, float>(p, stream) : launch<float, __nv_bfloat16>(p, stream);
  }
  return col_f32 ? launch<__nv_bfloat16, float>(p, stream)
                 : launch<__nv_bfloat16, __nv_bfloat16>(p, stream);
}

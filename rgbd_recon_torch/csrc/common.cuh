// Shared helpers of the port's CUDA kernels (built by rgbd_recon_torch/native.py).
//
// Every C entry point takes device pointers plus the launch stream last,
// launches on that stream, never synchronises, and returns
// cudaGetLastError() so the Python wrapper raises on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define RR_API extern "C" __attribute__((visibility("default")))

static inline int rr_status() { return static_cast<int>(cudaGetLastError()); }

static inline int rr_blocks(long long n, int threads) {
  return static_cast<int>((n + threads - 1) / threads);
}

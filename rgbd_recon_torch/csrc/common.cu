// Error strings for the C entry points' return codes.
#include "common.cuh"

RR_API const char* rr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

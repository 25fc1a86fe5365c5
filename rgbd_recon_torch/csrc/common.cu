// Error strings for the C entry points' return codes, the launch floor, and
// a CUDA graph's node count.
#include "common.cuh"

RR_API const char* rr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {

__global__ void empty_kernel() {}

}  // namespace

// An empty kernel of blocks x threads, after a memset of ``bytes`` at buf
// when bytes > 0: the floor under a small kernel's graph-replayed time (no
// counter, no path calls it).
RR_API int rr_launch_floor(void* buf, long long bytes, int blocks, int threads,
                           cudaStream_t stream) {
  if (bytes > 0) cudaMemsetAsync(buf, 0, bytes, stream);
  empty_kernel<<<blocks, threads, 0, stream>>>();
  return rr_status();
}

// The node count of a CUDA graph (the span recorder's graph.nodes counter,
// read once a capture; no path replays through it).
RR_API int rr_graph_nodes(void* graph, long long* count) {
  size_t n = 0;
  cudaError_t rc = cudaGraphGetNodes(static_cast<cudaGraph_t>(graph), nullptr, &n);
  *count = static_cast<long long>(n);
  return static_cast<int>(rc);
}

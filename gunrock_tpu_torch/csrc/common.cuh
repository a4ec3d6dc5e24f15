// Device helpers shared by the port's kernels.
#pragma once

#include <cuda_runtime.h>

namespace gr {

constexpr int kThreads = 256;
constexpr float kBig = 3.0e38f;  // f32-safe infinity stand-in (_BIG)

// Append `value` to `queue` for every lane of the calling warp with
// `keep` set, with one atomicAdd on `count` per warp. All 32 lanes of the
// warp must call it (the callers loop with a warp-uniform bound and no
// lane returns early); the order of the appended values is unspecified.
__device__ __forceinline__ void warp_append(bool keep, int value, int* queue,
                                            int* count) {
  constexpr unsigned kAll = 0xffffffffu;
  const unsigned ballot = __ballot_sync(kAll, keep);
  if (ballot == 0) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(ballot) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(count, __popc(ballot));
  base = __shfl_sync(kAll, base, leader);
  if (keep) queue[base + __popc(ballot & ((1u << lane) - 1u))] = value;
}

// Float atomic min that is right for either sign: non-negative floats
// order like signed ints, negative ones inversely to unsigned ints.
// The sign bit (not v >= 0) picks the path so that -0.0 orders correctly.
__device__ __forceinline__ void atomic_min_float(float* addr, float v) {
  if ((__float_as_uint(v) >> 31) == 0u)
    atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMax(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
}

// queue[0:*count] = the vertices v < n_vertices with front[v] set, in an
// unspecified order; *count must be 0 on entry. The loop bound is
// warp-uniform, so every lane reaches warp_append.
__global__ void compact_frontier(const unsigned char* __restrict__ front,
                                 int n_vertices, int* __restrict__ queue,
                                 int* __restrict__ count) {
  const int stride = gridDim.x * blockDim.x;
  for (int base = blockIdx.x * blockDim.x; base < n_vertices; base += stride) {
    const int v = base + threadIdx.x;
    warp_append(v < n_vertices && front[v], v, queue, count);
  }
}

// Grid of `kThreads`-thread blocks covering `n` items, at most `cap` blocks
// (the kernels loop with a grid stride past that).
inline int grid_for(long n, int cap) {
  long blocks = (n + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  return blocks < cap ? static_cast<int>(blocks) : cap;
}

}  // namespace gr

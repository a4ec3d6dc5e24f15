// Device helpers shared by the port's kernels.
#pragma once

#include <cuda_runtime.h>

namespace gr {

constexpr int kThreads = 256;

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

// Grid of `kThreads`-thread blocks covering `n` items, at most `cap` blocks
// (the kernels loop with a grid stride past that).
inline int grid_for(long n, int cap) {
  long blocks = (n + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  return blocks < cap ? static_cast<int>(blocks) : cap;
}

}  // namespace gr

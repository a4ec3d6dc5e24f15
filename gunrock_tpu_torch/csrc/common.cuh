// Device helpers shared by the port's kernels.
#pragma once

#include <cuda_runtime.h>

namespace gr {

constexpr int kThreads = 256;
constexpr float kBig = 3.0e38f;  // f32-safe infinity stand-in (_BIG)

}  // namespace gr

// Range checks of computed indices: the checked build (-DGR_CHECKED, built
// by _build.build(checked=True) under its own library names) stands in for
// a memory checker where none runs. Every index a kernel computes from
// its inputs (window base + local id, queue entries, CSR offsets) goes
// through GR_IN_RANGE(index, limit) before the access. In the checked
// build a bad index is not used: the access is skipped, the first one is
// recorded in the device words gr::fault = {source line, index, limit},
// and the launch function (gr::finish) waits for the stream and returns
// gr::kRangeFault; gr_last_fault() then hands the three words to the
// host. In the normal build the macro is `true` and costs nothing.
#ifdef GR_CHECKED
namespace gr {
__device__ long long fault[3];  // zero-initialised: line 0 = no fault
__device__ __forceinline__ bool in_range(long long i, long long n, int line) {
  if (i >= 0 && i < n) return true;
  if (atomicCAS(reinterpret_cast<unsigned long long*>(&fault[0]), 0ull,
                static_cast<unsigned long long>(line)) == 0ull) {
    fault[1] = i;
    fault[2] = n;
  }
  return false;
}
}  // namespace gr
#define GR_IN_RANGE(i, n) gr::in_range((i), (n), __LINE__)
#else
#define GR_IN_RANGE(i, n) ((void)(i), (void)(n), true)
#endif

namespace gr {

constexpr int kRangeFault = 10001;  // no cudaError_t has this value

#ifdef GR_CHECKED
static long long host_fault[3];
#endif

// What every launch function returns: the launch error, and in the
// checked build also a fault met while the kernels ran (which costs a
// stream synchronisation per call).
inline int finish(cudaStream_t s) {
  cudaError_t err = cudaGetLastError();
#ifdef GR_CHECKED
  if (err != cudaSuccess) return err;
  err = cudaStreamSynchronize(s);
  if (err != cudaSuccess) return err;
  long long f[3];
  err = cudaMemcpyFromSymbol(f, fault, sizeof(f));
  if (err != cudaSuccess) return err;
  if (f[0] != 0) {
    for (int i = 0; i < 3; ++i) host_fault[i] = f[i];
    const long long zero[3] = {0, 0, 0};
    cudaMemcpyToSymbol(fault, zero, sizeof(zero));
    return kRangeFault;
  }
#else
  (void)s;
#endif
  return err;
}

// Append `value` to `queue` for every lane of the calling warp with
// `keep` set, with one atomicAdd on `count` per warp. All 32 lanes of the
// warp must call it (the callers loop with a warp-uniform bound and no
// lane returns early); the order of the appended values is unspecified.
// `capacity` is the queue's length, for the checked build.
__device__ __forceinline__ void warp_append(bool keep, int value, int* queue,
                                            int* count, int capacity) {
  constexpr unsigned kAll = 0xffffffffu;
  const unsigned ballot = __ballot_sync(kAll, keep);
  if (ballot == 0) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(ballot) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(count, __popc(ballot));
  base = __shfl_sync(kAll, base, leader);
  const int at = base + __popc(ballot & ((1u << lane) - 1u));
  if (keep && GR_IN_RANGE(at, capacity)) queue[at] = value;
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
    warp_append(v < n_vertices && front[v], v, queue, count, n_vertices);
  }
}

// The sum of `v` over the calling block (at most 1024 threads, a whole
// number of warps), returned to every thread. `scratch` is 32 floats of
// shared memory; the call synchronises the block twice, so every thread
// must make it.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) s += scratch[w];
  __syncthreads();  // scratch may be written again after this
  return s;
}

// Grid of `kThreads`-thread blocks covering `n` items, at most `cap` blocks
// (the kernels loop with a grid stride past that).
inline int grid_for(long n, int cap) {
  long blocks = (n + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  return blocks < cap ? static_cast<int>(blocks) : cap;
}

}  // namespace gr

#ifdef GR_CHECKED
// out[0:3] = {source line, index, limit} of the last fault gr::finish met
// in this library since the last call (zeros if none).
extern "C" int gr_last_fault(long long* out) {
  for (int i = 0; i < 3; ++i) {
    out[i] = gr::host_fault[i];
    gr::host_fault[i] = 0;  // read once
  }
  return 0;
}
#endif

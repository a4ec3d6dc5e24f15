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

// Float atomic min that is right for either sign: non-negative floats
// order like signed ints, negative ones inversely to unsigned ints.
// The sign bit (not v >= 0) picks the path so that -0.0 orders correctly.
__device__ __forceinline__ void atomic_min_float(float* addr, float v) {
  if ((__float_as_uint(v) >> 31) == 0u)
    atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMax(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
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

// The float4 or int4 of four T.
template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
  static __device__ __forceinline__ float4 fill(float e) {
    return make_float4(e, e, e, e);
  }
};
template <>
struct Vec4<int> {
  using type = int4;
  static __device__ __forceinline__ int4 fill(int e) {
    return make_int4(e, e, e, e);
  }
};

// The second pass of the span kernels (semiring.cu, hits_fused.cu,
// mst_min.cu): one block of kReduceWarps warps writes entries [r_base,
// r_base + kStrip) of one output block `y` (a window of `window` T, float
// or int, window % 4 == 0), combining with Op::apply the touched partials
// of spans [lo, hi): span s holds `window` T at partial + s * window, and
// touched[s] says whether it was written. Warp g takes spans lo + g, lo +
// g + 16, ...: one touched flag per lane and a ballot name up to 32 of
// them, whose partials it loads two at a time (the chain of loads of a
// hub block's many spans, not the bytes, sets the pass's time); a lane
// holds four 16-byte vectors of the strip, 128 entries apart. Entries no
// touched span reaches get `e`. Every thread of the block must call it.
constexpr int kReduceWarps = 16;
constexpr int kLaneVecs = 4;
constexpr int kStrip = 128 * kLaneVecs;

template <typename Op, typename T>
__device__ __forceinline__ void reduce_span_strip(
    const T* __restrict__ partial, const int* __restrict__ touched, int lo,
    int hi, int n_spans, int window, int r_base, T e, T* __restrict__ y) {
  using V4 = typename Vec4<T>::type;
  __shared__ V4 part[kReduceWarps][kLaneVecs][32];
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int r0 = r_base + 4 * lane;  // window % 4 == 0: all 4 or none
  const V4 ident = Vec4<T>::fill(e);
  V4 acc[kLaneVecs];
#pragma unroll
  for (int k = 0; k < kLaneVecs; ++k) acc[k] = ident;
  for (int base = lo + g; base < hi; base += 32 * kReduceWarps) {
    const int mine = base + kReduceWarps * lane;
    unsigned todo = __ballot_sync(0xffffffffu, mine < hi &&
                                  GR_IN_RANGE(mine, n_spans) && touched[mine]);
    while (todo) {  // warp-uniform
      V4 p[2][kLaneVecs];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        int s = -1;
        if (todo) {
          s = base + kReduceWarps * (__ffs(todo) - 1);
          todo &= todo - 1u;
        }
        const T* src = partial + static_cast<long>(s) * window;
#pragma unroll
        for (int k = 0; k < kLaneVecs; ++k) {
          const int r = r0 + 128 * k;
          p[j][k] = s >= 0 && r < window
                        ? *reinterpret_cast<const V4*>(src + r)
                        : ident;
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int k = 0; k < kLaneVecs; ++k) acc[k] = Op::apply(acc[k], p[j][k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kLaneVecs; ++k) part[g][k][lane] = acc[k];
  __syncthreads();
  if (g != 0) return;
#pragma unroll
  for (int k = 0; k < kLaneVecs; ++k) {
    const int r = r0 + 128 * k;
    if (r >= window) continue;
    for (int w = 1; w < kReduceWarps; ++w)
      acc[k] = Op::apply(acc[k], part[w][k][lane]);
    *reinterpret_cast<V4*>(y + r) = acc[k];
  }
}

// Op of reduce_span_strip for sums.
struct Add4 {
  static __device__ __forceinline__ float4 apply(float4 a, float4 b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
};

// How many blocks of `kernel` (`threads` threads, no dynamic shared
// memory) the current device holds at once: the most a cooperative
// launch may take; 0 where it takes no cooperative launch or on an error.
template <typename Kernel>
int coresident_blocks(Kernel kernel, int threads) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev) !=
          cudaSuccess ||
      !coop ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    0) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

// Whether `p` (null counts as aligned: a missing optional input) allows
// 16-byte loads.
inline bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<unsigned long long>(p) % 16 == 0;
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

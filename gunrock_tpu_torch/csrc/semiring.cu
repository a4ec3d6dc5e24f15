// Frontier-sparse semiring pull over the bucketed chunk layout.
//
// Replaces: gunrock_tpu/ops/pallas/semiring.py::bucketed_semiring_spmv_sparse
// (kernel body _make_sparse_kernel, v5: dynamic-gather x, MXU one-hot
// scatter, launched through _tail_grid_dispatch).
//
// Contract: for every chunk in `queue[0:*count]` (the active chunks from
// chunkplan.cu) and every real slot e of it,
//   y[rb*W + row_local[e]] (+)= msg(x[cb*W + col_local[e]], values[e]),
// with y filled with the semiring identity by the caller. Padding slots
// carry row_local == W and are skipped before any load of x.
//   plus_times: msg = val * x (x when unit), reduced with atomicAdd
//   max_times:  msg = val * x, reduced with an atomic max; identity 0
//   min_plus:   msg = min(val + x, BIG) (min(x, BIG) when unit: the
//               value-free form is the (x)-identity, not weight 1)
//
// What bounds it on this card: bytes. Each active slot reads 8 B of
// row/col metadata (12 B valued) and gathers 4 B of x from one 8 KB
// window (L1/L2 resident); each non-identity message is one 4 B atomic.
// A full frontier at R-MAT scale 18 (20,548 chunks x 256 slots) moves
// ~44 MB, ~13 us at 3.35 TB/s.
//
// Design: a persistent grid of a few blocks per SM loops over the queue
// (`q += gridDim.x`), so the active-chunk count is read on the device and
// never by the host. A block takes one chunk at a time with one thread
// per slot: neighbouring threads read neighbouring metadata. Messages that
// cannot change y are not sent: 0 for plus_times (y starts at +0 and
// x + 0 == x), <= 0 for max_times (identity 0), >= BIG for min_plus.
// The TPU's one-hot gathers, bf16 hi/lo splits and [Cr,128] metadata
// tiles have no counterpart: Hopper gathers and reduces natively.

#include "common.cuh"

namespace {

constexpr float kBig = 3.0e38f;
enum Semiring { kPlusTimes = 0, kMinPlus = 1, kMaxTimes = 2 };

// Float atomic min that is right for either sign: non-negative floats
// order like signed ints, negative ones inversely to unsigned ints.
// The sign bit (not v >= 0) picks the path so that -0.0 orders correctly.
__device__ __forceinline__ void atomic_min_float(float* addr, float v) {
  if ((__float_as_uint(v) >> 31) == 0u)
    atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMax(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
}

template <int kSemiring, bool kUnit>
__global__ void spmv_sparse(const int* __restrict__ queue,
                            const int* __restrict__ count,
                            const int* __restrict__ chunk_rb,
                            const int* __restrict__ chunk_cb,
                            const int* __restrict__ row_local,
                            const int* __restrict__ col_local,
                            const float* __restrict__ values,
                            const float* __restrict__ x, float* __restrict__ y,
                            int window, int chunk) {
  const int n_active = *count;
  for (int q = blockIdx.x; q < n_active; q += gridDim.x) {
    const int ch = queue[q];
    const long xbase = static_cast<long>(chunk_cb[ch]) * window;
    const long ybase = static_cast<long>(chunk_rb[ch]) * window;
    const long sbase = static_cast<long>(ch) * chunk;
    for (int s = threadIdx.x; s < chunk; s += blockDim.x) {
      const int r = row_local[sbase + s];
      if (r == window) continue;  // padding slot
      const float xv = x[xbase + col_local[sbase + s]];
      float* dst = y + ybase + r;
      if (kSemiring == kPlusTimes) {
        const float m = kUnit ? xv : values[sbase + s] * xv;
        if (m != 0.0f) atomicAdd(dst, m);
      } else if (kSemiring == kMaxTimes) {
        const float m = kUnit ? xv : values[sbase + s] * xv;
        // positive floats order like their int bit patterns
        if (m > 0.0f) atomicMax(reinterpret_cast<int*>(dst), __float_as_int(m));
      } else {
        const float m = fminf(kUnit ? xv : values[sbase + s] + xv, kBig);
        if (m < kBig) atomic_min_float(dst, m);
      }
    }
  }
}

template <int kSemiring, bool kUnit>
void launch(int blocks, cudaStream_t s, const int* queue, const int* count,
            const int* rb, const int* cb, const int* row, const int* col,
            const float* val, const float* x, float* y, int window, int chunk) {
  spmv_sparse<kSemiring, kUnit><<<blocks, gr::kThreads, 0, s>>>(
      queue, count, rb, cb, row, col, val, x, y, window, chunk);
}

}  // namespace

// semiring: 0 plus_times, 1 min_plus, 2 max_times. values may be null
// when unit. y: float[n_row_blocks * window], already the identity.
extern "C" int gr_spmv_sparse(int semiring, int unit, int blocks,
                              const void* queue, const void* count,
                              const void* chunk_rb, const void* chunk_cb,
                              const void* row_local, const void* col_local,
                              const void* values, const void* x, void* y,
                              int window, int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto q = static_cast<const int*>(queue);
  auto c = static_cast<const int*>(count);
  auto rb = static_cast<const int*>(chunk_rb);
  auto cb = static_cast<const int*>(chunk_cb);
  auto row = static_cast<const int*>(row_local);
  auto col = static_cast<const int*>(col_local);
  auto val = static_cast<const float*>(values);
  auto xs = static_cast<const float*>(x);
  auto ys = static_cast<float*>(y);
  switch (semiring * 2 + (unit ? 1 : 0)) {
    case kPlusTimes * 2: launch<kPlusTimes, false>(blocks, s, q, c, rb, cb, row, col, val, xs, ys, window, chunk); break;
    case kPlusTimes * 2 + 1: launch<kPlusTimes, true>(blocks, s, q, c, rb, cb, row, col, val, xs, ys, window, chunk); break;
    case kMinPlus * 2: launch<kMinPlus, false>(blocks, s, q, c, rb, cb, row, col, val, xs, ys, window, chunk); break;
    case kMinPlus * 2 + 1: launch<kMinPlus, true>(blocks, s, q, c, rb, cb, row, col, val, xs, ys, window, chunk); break;
    case kMaxTimes * 2: launch<kMaxTimes, false>(blocks, s, q, c, rb, cb, row, col, val, xs, ys, window, chunk); break;
    case kMaxTimes * 2 + 1: launch<kMaxTimes, true>(blocks, s, q, c, rb, cb, row, col, val, xs, ys, window, chunk); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

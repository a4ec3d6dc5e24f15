// Semiring pull over the bucketed chunk layout: the frontier-sparse pass,
// the dense pass and the fused max/min pass.
//
// Replaces:
// - gunrock_tpu/ops/pallas/semiring.py::bucketed_semiring_spmv_sparse
//   (kernel body _make_sparse_kernel, v5: dynamic-gather x, MXU one-hot
//   scatter, launched through _tail_grid_dispatch);
// - gunrock_tpu/ops/pallas/semiring.py::bucketed_semiring_spmv (kernel
//   bodies _make_kernel_v1..v5, one contract: every chunk of the grid in
//   order, first-visit init of each row window, rb_occupied mask after);
// - gunrock_tpu/ops/pallas/semiring.py::bucketed_semiring_spmv_sparse_minmax
//   (kernel body _sparse_minmax_kernel: one windowed one-hot gather feeding
//   a max-reduce and a positives-only min-reduce, for coloring's paired
//   neighbour scans).
//
// Contract: for every chunk in `queue[0:*count]` (sparse: the active
// chunks from chunkplan.cu) or every chunk 0..n_chunks-1 (dense), and
// every real slot e of it,
//   y[rb*W + row_local[e]] (+)= msg(x[cb*W + col_local[e]], values[e]),
// with y filled with the semiring identity by the caller, so that rows no
// chunk reaches keep it. Padding slots carry row_local == W and are
// skipped before any load of x.
//   plus_times: msg = val * x (x when unit), reduced with atomicAdd
//   max_times:  msg = val * x, reduced with an atomic max; identity 0
//   min_plus:   msg = min(val + x, BIG) (min(x, BIG) when unit: the
//               value-free form is the (x)-identity, not weight 1)
//
// The fused max/min pass (minmax_pull) walks the queued chunks the same
// way and sends each positive message m = val * x twice: an atomic max
// into ymax (identity 0) and an atomic min into ymin (identity BIG, which
// a row with no positive message keeps: BIG, not inf). It needs x >= 0
// and values >= 0, so m > 0 picks the real messages and both atomics can
// order the floats by their int bits.
//
// What bounds it on this card: bytes. Each slot reads 8 B of row/col
// metadata (12 B valued) and gathers 4 B of x from one window (L1/L2
// resident); each non-identity message is one 4 B atomic. A full pass at
// R-MAT scale 18 moves ~44 MB unit at W=2048/C=256 (20,548 chunks) and
// ~68 MB valued at W=4096/C=1024 (5,359 chunks): 13-20 us at 3.35 TB/s.
// The max/min pass over the symmetrized R-MAT 18 coloring layout reads
// 12 B per slot over ~7.8M slots plus x and writes two f32[V]: ~97 MB,
// ~29 us on a full frontier.
//
// Design: a persistent grid of a few blocks per SM loops over the chunks
// (`q += gridDim.x`); in the sparse pass the active-chunk count is read on
// the device and never by the host. A block takes one chunk at a time and
// its threads stride over the chunk's slots, so C may exceed the block
// (the dense layout of PageRank and HITS has C = 1024): neighbouring
// threads read neighbouring metadata. Messages that cannot change y are
// not sent: 0 for plus_times (y starts at +0 and x + 0 == x), <= 0 for
// max_times (identity 0), >= BIG for min_plus. The TPU's one-hot
// gathers, bf16 hi/lo splits, [Cr,128] metadata tiles, first-visit init
// and rb_occupied mask have no counterpart: Hopper gathers and reduces
// natively, and y starts at the identity.

#include "common.cuh"

namespace {

enum Semiring { kPlusTimes = 0, kMinPlus = 1, kMaxTimes = 2 };

template <int kSemiring, bool kUnit, bool kDense>
__global__ void spmv_pull(const int* __restrict__ queue,
                          const int* __restrict__ count, int n_chunks,
                          const int* __restrict__ chunk_rb,
                          const int* __restrict__ chunk_cb,
                          const int* __restrict__ row_local,
                          const int* __restrict__ col_local,
                          const float* __restrict__ values,
                          const float* __restrict__ x, float* __restrict__ y,
                          int window, int chunk, long n_x, long n_y) {
  const int n_work = kDense ? n_chunks : *count;
  const long n_slots = static_cast<long>(n_chunks) * chunk;
  for (int q = blockIdx.x; q < n_work; q += gridDim.x) {
    const int ch = kDense ? q : queue[q];
    if (!GR_IN_RANGE(ch, n_chunks)) continue;
    const long xbase = static_cast<long>(chunk_cb[ch]) * window;
    const long ybase = static_cast<long>(chunk_rb[ch]) * window;
    const long sbase = static_cast<long>(ch) * chunk;
    for (int s = threadIdx.x; s < chunk; s += blockDim.x) {
      if (!GR_IN_RANGE(sbase + s, n_slots)) continue;
      const int r = row_local[sbase + s];
      if (r == window) continue;  // padding slot
      const long xi = xbase + col_local[sbase + s];
      if (!GR_IN_RANGE(xi, n_x) || !GR_IN_RANGE(ybase + r, n_y)) continue;
      const float xv = x[xi];
      float* dst = y + ybase + r;
      if (kSemiring == kPlusTimes) {
        const float m = kUnit ? xv : values[sbase + s] * xv;
        if (m != 0.0f) atomicAdd(dst, m);
      } else if (kSemiring == kMaxTimes) {
        const float m = kUnit ? xv : values[sbase + s] * xv;
        // positive floats order like their int bit patterns
        if (m > 0.0f) atomicMax(reinterpret_cast<int*>(dst), __float_as_int(m));
      } else {
        const float m = fminf(kUnit ? xv : values[sbase + s] + xv, gr::kBig);
        if (m < gr::kBig) gr::atomic_min_float(dst, m);
      }
    }
  }
}

// ymax[row] = max m, ymin[row] = min m over the positive messages
// m = values * x of the queued chunks; ymax starts at 0, ymin at BIG.
__global__ void minmax_pull(const int* __restrict__ queue,
                            const int* __restrict__ count, int n_chunks,
                            const int* __restrict__ chunk_rb,
                            const int* __restrict__ chunk_cb,
                            const int* __restrict__ row_local,
                            const int* __restrict__ col_local,
                            const float* __restrict__ values,
                            const float* __restrict__ x,
                            float* __restrict__ ymax, float* __restrict__ ymin,
                            int window, int chunk, long n_x, long n_y) {
  const int n_work = *count;
  const long n_slots = static_cast<long>(n_chunks) * chunk;
  for (int q = blockIdx.x; q < n_work; q += gridDim.x) {
    const int ch = queue[q];
    if (!GR_IN_RANGE(ch, n_chunks)) continue;
    const long xbase = static_cast<long>(chunk_cb[ch]) * window;
    const long ybase = static_cast<long>(chunk_rb[ch]) * window;
    const long sbase = static_cast<long>(ch) * chunk;
    for (int s = threadIdx.x; s < chunk; s += blockDim.x) {
      if (!GR_IN_RANGE(sbase + s, n_slots)) continue;
      const int r = row_local[sbase + s];
      if (r == window) continue;  // padding slot
      const long xi = xbase + col_local[sbase + s];
      if (!GR_IN_RANGE(xi, n_x) || !GR_IN_RANGE(ybase + r, n_y)) continue;
      const float m = values[sbase + s] * x[xi];
      if (m > 0.0f) {  // positive floats order like their int bit patterns
        atomicMax(reinterpret_cast<int*>(ymax + ybase + r), __float_as_int(m));
        atomicMin(reinterpret_cast<int*>(ymin + ybase + r), __float_as_int(m));
      }
    }
  }
}

struct Args {
  const int* queue;
  const int* count;
  int n_chunks;
  const int* rb;
  const int* cb;
  const int* row;
  const int* col;
  const float* val;
  const float* x;
  float* y;
  int window;
  int chunk;
  long n_x;  // length of x (n_vertices)
  long n_y;  // length of y (n_row_blocks * window)
};

template <int kSemiring, bool kUnit, bool kDense>
void launch(int blocks, cudaStream_t s, const Args& a) {
  spmv_pull<kSemiring, kUnit, kDense><<<blocks, gr::kThreads, 0, s>>>(
      a.queue, a.count, a.n_chunks, a.rb, a.cb, a.row, a.col, a.val, a.x,
      a.y, a.window, a.chunk, a.n_x, a.n_y);
}

template <bool kDense>
int dispatch(int semiring, int unit, int blocks, cudaStream_t s,
             const Args& a) {
  switch (semiring * 2 + (unit ? 1 : 0)) {
    case kPlusTimes * 2: launch<kPlusTimes, false, kDense>(blocks, s, a); break;
    case kPlusTimes * 2 + 1: launch<kPlusTimes, true, kDense>(blocks, s, a); break;
    case kMinPlus * 2: launch<kMinPlus, false, kDense>(blocks, s, a); break;
    case kMinPlus * 2 + 1: launch<kMinPlus, true, kDense>(blocks, s, a); break;
    case kMaxTimes * 2: launch<kMaxTimes, false, kDense>(blocks, s, a); break;
    case kMaxTimes * 2 + 1: launch<kMaxTimes, true, kDense>(blocks, s, a); break;
    default: return cudaErrorInvalidValue;
  }
  return gr::finish(s);
}

}  // namespace

// semiring: 0 plus_times, 1 min_plus, 2 max_times. values may be null
// when unit. x: float[n_vertices]. y: float[n_row_blocks * window],
// already the identity.
extern "C" int gr_spmv_sparse(int semiring, int unit, int blocks,
                              const void* queue, const void* count,
                              int n_chunks, const void* chunk_rb,
                              const void* chunk_cb, const void* row_local,
                              const void* col_local, const void* values,
                              const void* x, void* y, int window, int chunk,
                              int n_vertices, int n_row_blocks, void* stream) {
  const Args a{static_cast<const int*>(queue), static_cast<const int*>(count),
               n_chunks, static_cast<const int*>(chunk_rb),
               static_cast<const int*>(chunk_cb),
               static_cast<const int*>(row_local),
               static_cast<const int*>(col_local),
               static_cast<const float*>(values), static_cast<const float*>(x),
               static_cast<float*>(y), window, chunk, n_vertices,
               static_cast<long>(n_row_blocks) * window};
  return dispatch<false>(semiring, unit, blocks,
                         static_cast<cudaStream_t>(stream), a);
}

// The dense pass over all n_chunks chunks; arguments as gr_spmv_sparse.
extern "C" int gr_spmv_dense(int semiring, int unit, int blocks, int n_chunks,
                             const void* chunk_rb, const void* chunk_cb,
                             const void* row_local, const void* col_local,
                             const void* values, const void* x, void* y,
                             int window, int chunk, int n_vertices,
                             int n_row_blocks, void* stream) {
  const Args a{nullptr, nullptr, n_chunks, static_cast<const int*>(chunk_rb),
               static_cast<const int*>(chunk_cb),
               static_cast<const int*>(row_local),
               static_cast<const int*>(col_local),
               static_cast<const float*>(values), static_cast<const float*>(x),
               static_cast<float*>(y), window, chunk, n_vertices,
               static_cast<long>(n_row_blocks) * window};
  return dispatch<true>(semiring, unit, blocks,
                        static_cast<cudaStream_t>(stream), a);
}

// The fused max/min pass over the queued chunks. ymax, ymin:
// float[n_row_blocks * window], already 0 and BIG.
extern "C" int gr_spmv_sparse_minmax(int blocks, const void* queue,
                                     const void* count, int n_chunks,
                                     const void* chunk_rb, const void* chunk_cb,
                                     const void* row_local,
                                     const void* col_local, const void* values,
                                     const void* x, void* ymax, void* ymin,
                                     int window, int chunk, int n_vertices,
                                     int n_row_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  minmax_pull<<<blocks, gr::kThreads, 0, s>>>(
      static_cast<const int*>(queue), static_cast<const int*>(count), n_chunks,
      static_cast<const int*>(chunk_rb), static_cast<const int*>(chunk_cb),
      static_cast<const int*>(row_local), static_cast<const int*>(col_local),
      static_cast<const float*>(values), static_cast<const float*>(x),
      static_cast<float*>(ymax), static_cast<float*>(ymin), window, chunk,
      n_vertices, static_cast<long>(n_row_blocks) * window);
  return gr::finish(s);
}

// Bucketed SpMM, Y = A . X over plus_times, for a dense multi-vector X:
// the dense pass and the frontier-sparse pass.
//
// Replaces:
// - gunrock_tpu/ops/pallas/spmm.py::bucketed_spmm (_make_kernel: per
//   chunk, a [C,W] one-hot bf16 matmul gathers X's window and a [W,C] one
//   matmul scatters the messages, with a hi/lo split for f32 inputs);
// - gunrock_tpu/ops/pallas/spmm.py::bucketed_spmm_sparse (_sparse_kernel:
//   the same per chunk, over the active chunks only, launched through
//   _tail_grid_dispatch; `exact` drops the hi/lo split).
//
// Contract: Y[rb*W + row_local[e], k] += values[e] * X[cb*W + col_local[e], k]
// for every real slot e and every column k, of every chunk (dense) or of
// every chunk in `queue[0:*count]` (sparse: the active chunks from
// chunkplan.cu, the count read on the device); Y starts at 0, so rows no
// (active) chunk reaches stay 0 and a caller can accumulate the result.
// Padding slots (row_local == W) are skipped.
//
// What bounds it on this card: bytes. At R-MAT scale 18 with K=32 the
// dense pass reads 12 B of metadata per slot (63 MB over 5.26M slots) and
// X once (33.5 MB), and writes Y (33.5 MB): ~130 MB, ~39 us at 3.35 TB/s.
// The 2*K flops per slot (0.34 GFLOP) are ~5 us at the 67 TFLOP/s f32
// rate. The sparse pass over coloring's symmetrized layout (~7.8M slots)
// on a full frontier moves ~160 MB, ~48 us; on a collapsed frontier it
// moves the queued chunks' metadata and the Y fill only.
//
// Design: a block takes one chunk at a time (the dense grid has one block
// per chunk; the sparse grid is persistent and strides over the queue),
// threads laid over (slot, k) with k fastest, so neighbouring threads read
// neighbouring X[c, k] and add into neighbouring Y[r, k]. All arithmetic
// is f32, which covers the TPU's `exact` (bf16-exact) mode as well. Zero
// messages are not sent: Y starts at +0 and y + 0 == y; the multi-source
// BFS frontier and coloring's signed one-hot deltas (-1, 0, +1) are
// mostly 0. The test is m != 0, not m > 0: a delta may be negative.

#include "common.cuh"

namespace {

template <bool kDense>
__global__ void spmm(const int* __restrict__ queue,
                     const int* __restrict__ count, int n_chunks,
                     const int* __restrict__ chunk_rb,
                     const int* __restrict__ chunk_cb,
                     const int* __restrict__ row_local,
                     const int* __restrict__ col_local,
                     const float* __restrict__ values,
                     const float* __restrict__ x, float* __restrict__ y,
                     int window, int chunk, int k, long n_x, long n_y) {
  const int n_work = kDense ? n_chunks : *count;
  const long n_slots = static_cast<long>(n_chunks) * chunk;
  const int total = chunk * k;
  for (int q = blockIdx.x; q < n_work; q += gridDim.x) {
    const int ch = kDense ? q : queue[q];
    if (!GR_IN_RANGE(ch, n_chunks)) continue;
    const long xbase = static_cast<long>(chunk_cb[ch]) * window;
    const long ybase = static_cast<long>(chunk_rb[ch]) * window;
    const long sbase = static_cast<long>(ch) * chunk;
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      const int s = t / k;
      const int j = t - s * k;
      if (!GR_IN_RANGE(sbase + s, n_slots)) continue;
      const int r = row_local[sbase + s];
      if (r == window) continue;  // padding slot
      const long xi = xbase + col_local[sbase + s];
      if (!GR_IN_RANGE(xi, n_x) || !GR_IN_RANGE(ybase + r, n_y)) continue;
      const float m = values[sbase + s] * x[xi * k + j];
      if (m != 0.0f) atomicAdd(&y[(ybase + r) * k + j], m);
    }
  }
}

}  // namespace

// x: float[n_vertices, k]. y: float[n_row_blocks * window, k], already
// zero. queue == null: the dense pass over all n_chunks chunks with
// `blocks` ignored (one block per chunk); else the chunks queue[0:*count]
// on a persistent grid of `blocks` blocks.
extern "C" int gr_spmm(int blocks, const void* queue, const void* count,
                       int n_chunks, const void* chunk_rb, const void* chunk_cb,
                       const void* row_local, const void* col_local,
                       const void* values, const void* x, void* y, int window,
                       int chunk, int k, int n_vertices, int n_row_blocks,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* rb = static_cast<const int*>(chunk_rb);
  const int* cb = static_cast<const int*>(chunk_cb);
  const int* row = static_cast<const int*>(row_local);
  const int* col = static_cast<const int*>(col_local);
  const float* val = static_cast<const float*>(values);
  const long n_y = static_cast<long>(n_row_blocks) * window;
  if (queue == nullptr)
    spmm<true><<<n_chunks, gr::kThreads, 0, s>>>(
        nullptr, nullptr, n_chunks, rb, cb, row, col, val,
        static_cast<const float*>(x), static_cast<float*>(y), window, chunk, k,
        n_vertices, n_y);
  else
    spmm<false><<<blocks, gr::kThreads, 0, s>>>(
        static_cast<const int*>(queue), static_cast<const int*>(count),
        n_chunks, rb, cb, row, col, val, static_cast<const float*>(x),
        static_cast<float*>(y), window, chunk, k, n_vertices, n_y);
  return gr::finish(s);
}

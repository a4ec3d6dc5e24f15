// Bucketed SpMM, Y = A . X over plus_times, for a dense multi-vector X.
//
// Replaces: gunrock_tpu/ops/pallas/spmm.py::bucketed_spmm (_make_kernel:
// per chunk, a [C,W] one-hot bf16 matmul gathers X's window and a [W,C]
// one matmul scatters the messages, with a hi/lo split for f32 inputs).
//
// Contract: Y[rb*W + row_local[e], k] += values[e] * X[cb*W + col_local[e], k]
// for every real slot e of every chunk and every column k; Y starts at 0,
// so rows no chunk reaches stay 0. Padding slots (row_local == W) are
// skipped.
//
// What bounds it on this card: bytes. At R-MAT scale 18 with K=32 it reads
// 12 B of metadata per slot (63 MB over 5.26M slots) and X once (33.5 MB),
// and writes Y (33.5 MB): ~130 MB, ~39 us at 3.35 TB/s. The 2*K flops per
// slot (0.34 GFLOP) are ~5 us at the 67 TFLOP/s f32 rate.
//
// Design: one block per chunk, threads laid over (slot, k) with k fastest,
// so neighbouring threads read neighbouring X[c, k] and add into
// neighbouring Y[r, k]. All arithmetic is f32, which covers the TPU's
// `exact` (bf16-exact) mode as well. Zero messages are not sent: Y starts
// at +0 and y + 0 == y, and the multi-source BFS frontier X is mostly 0.

#include "common.cuh"

namespace {

__global__ void spmm(const int* __restrict__ chunk_rb,
                     const int* __restrict__ chunk_cb,
                     const int* __restrict__ row_local,
                     const int* __restrict__ col_local,
                     const float* __restrict__ values,
                     const float* __restrict__ x, float* __restrict__ y,
                     int window, int chunk, int k) {
  const int ch = blockIdx.x;
  const long xbase = static_cast<long>(chunk_cb[ch]) * window;
  const long ybase = static_cast<long>(chunk_rb[ch]) * window;
  const long sbase = static_cast<long>(ch) * chunk;
  const int total = chunk * k;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int s = t / k;
    const int j = t - s * k;
    const int r = row_local[sbase + s];
    if (r == window) continue;  // padding slot
    const float m = values[sbase + s] * x[(xbase + col_local[sbase + s]) * k + j];
    if (m != 0.0f) atomicAdd(&y[(ybase + r) * k + j], m);
  }
}

}  // namespace

// y: float[n_row_blocks * window, k], already zero.
extern "C" int gr_spmm(int n_chunks, const void* chunk_rb, const void* chunk_cb,
                       const void* row_local, const void* col_local,
                       const void* values, const void* x, void* y, int window,
                       int chunk, int k, void* stream) {
  spmm<<<n_chunks, gr::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(chunk_rb), static_cast<const int*>(chunk_cb),
      static_cast<const int*>(row_local), static_cast<const int*>(col_local),
      static_cast<const float*>(values), static_cast<const float*>(x),
      static_cast<float*>(y), window, chunk, k);
  return cudaGetLastError();
}

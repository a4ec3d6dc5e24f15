// Fused HITS pass: both Jacobi accumulations in one sweep of the push
// layout.
//
// Replaces: gunrock_tpu/ops/pallas/hits_fused.py::hits_fused_pass (kernel
// body _make_hits_kernel: per chunk, a one-hot gather of auth over the col
// window scattered by row, and a gather of hub over the row window
// scattered by col into a VMEM-resident whole-array accumulator).
//
// Contract: over the unit push layout (rows = sources, cols =
// destinations), for every real slot e of every chunk,
//   hub_raw[rb*W + row_local[e]]  += auth[cb*W + col_local[e]]
//   auth_raw[cb*W + col_local[e]] += hub[rb*W + row_local[e]]
// with both outputs zero on entry, so rows and columns no edge reaches
// stay 0 (this covers the TPU's rb_occupied mask). Padding slots carry
// row_local == W but col_local == 0: the auth side scatters by column, so
// the row sentinel would not drop them. They are skipped before either
// atomic, or vertex cb*W would gain phantom hub mass.
//
// What bounds it on this card: bytes. Each slot reads 8 B of row/col
// metadata and gathers 4 B from each of auth and hub; each slot sends two
// 4 B atomics. At R-MAT scale 18 on the W=4096/C=1024 layout (5,359
// chunks, 5.49M slots) the metadata and four f32[V] vectors are ~48 MB,
// ~14 us at 3.35 TB/s.
//
// Design: the dense pull's shape (semiring.cu): a persistent grid loops
// over the chunks, a block takes one chunk and its threads stride over
// its slots, so C may exceed the block. Each real slot issues its two
// atomicAdds; zero messages are not sent (outputs start at +0). One
// metadata stream serves both sums, which is the point of the fusion on
// the TPU as here.

#include "common.cuh"

namespace {

__global__ void hits_fused(int n_chunks, const int* __restrict__ chunk_rb,
                           const int* __restrict__ chunk_cb,
                           const int* __restrict__ row_local,
                           const int* __restrict__ col_local,
                           const float* __restrict__ auth,
                           const float* __restrict__ hub,
                           float* __restrict__ hub_raw,
                           float* __restrict__ auth_raw, int window,
                           int chunk, long n_vertices) {
  const long n_slots = static_cast<long>(n_chunks) * chunk;
  for (int ch = blockIdx.x; ch < n_chunks; ch += gridDim.x) {
    const long rbase = static_cast<long>(chunk_rb[ch]) * window;
    const long cbase = static_cast<long>(chunk_cb[ch]) * window;
    const long sbase = static_cast<long>(ch) * chunk;
    for (int s = threadIdx.x; s < chunk; s += blockDim.x) {
      if (!GR_IN_RANGE(sbase + s, n_slots)) continue;
      const int r = row_local[sbase + s];
      if (r == window) continue;  // padding slot: skip BOTH sides
      const long src = rbase + r;
      const long dst = cbase + col_local[sbase + s];
      // both ends of a real slot are vertices: inside auth and hub (V) and
      // so inside the window-padded outputs
      if (!GR_IN_RANGE(src, n_vertices) || !GR_IN_RANGE(dst, n_vertices))
        continue;
      const float a = auth[dst];
      const float h = hub[src];
      if (a != 0.0f) atomicAdd(hub_raw + src, a);
      if (h != 0.0f) atomicAdd(auth_raw + dst, h);
    }
  }
}

}  // namespace

// hub_raw: float[n_row_blocks * window], auth_raw: float[n_col_blocks *
// window], both already zero. auth, hub: float[V].
extern "C" int gr_hits_fused(int blocks, int n_chunks, const void* chunk_rb,
                             const void* chunk_cb, const void* row_local,
                             const void* col_local, const void* auth,
                             const void* hub, void* hub_raw, void* auth_raw,
                             int window, int chunk, int n_vertices,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  hits_fused<<<blocks, gr::kThreads, 0, s>>>(
      n_chunks, static_cast<const int*>(chunk_rb),
      static_cast<const int*>(chunk_cb), static_cast<const int*>(row_local),
      static_cast<const int*>(col_local), static_cast<const float*>(auth),
      static_cast<const float*>(hub), static_cast<float*>(hub_raw),
      static_cast<float*>(auth_raw), window, chunk, n_vertices);
  return gr::finish(s);
}

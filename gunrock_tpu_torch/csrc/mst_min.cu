// Boruvka min-cut pass: per row, the least rank over the edges whose two
// endpoints lie in different components.
//
// Replaces: gunrock_tpu/ops/pallas/mst_min.py::bucketed_min_rank_cut
// (_make_mst_min_kernel: two dynamic-gather select trees fetch root[col]
// and root[row] from the col and row windows of one f32 roots array, then
// a one-hot min scatter per 128-lane tile; ranks and roots ride as f32,
// exact below 2^24, and padding columns read a -1 root).
//
// Contract: over the layout of the doubled canonical edge set (each
// undirected edge once from either endpoint), with ranks[e] the edge's
// position in the (weight, id) order, for every real slot e of every chunk
//   if root[cb*W + col_local[e]] != root[rb*W + row_local[e]]:
//       y[rb*W + row_local[e]] = min(y[...], ranks[e])
// with y filled with the sentinel 2^30 ("no cut edge") by the caller, so
// rows with no cut edge keep it. Ranks and roots are int32 and the
// reduction is atomicMin on int: the f32 ride is a TPU constraint, and
// int32 keeps the pass exact up to 2^30 edges. Padding slots carry
// row_local == W and are skipped before either root is loaded, which
// replaces the -1 root of the TPU kernel's padded window.
//
// What bounds it on this card: bytes. Each slot reads 12 B (row, col,
// rank) and gathers two 4 B roots from two windows (L1/L2 resident); a cut
// edge that beats the value it reads sends one 4 B atomic. At R-MAT scale
// 18 (doubled canonical set, ~7.6M slots) with V-sized roots and y it
// moves ~94 MB: ~28 us at 3.35 TB/s. Late rounds have few cut edges and
// send few atomics, but every round still reads every slot: it is a dense
// pass with no chunk queue.
//
// Design: the dense pull's shape (semiring.cu): a persistent grid loops
// over the chunks, a block takes one chunk and its threads stride over
// its slots. y only decreases, so a rank that does not beat the value
// read now cannot win later and is not sent.

#include "common.cuh"

namespace {

__global__ void min_rank_cut(int n_chunks, const int* __restrict__ chunk_rb,
                             const int* __restrict__ chunk_cb,
                             const int* __restrict__ row_local,
                             const int* __restrict__ col_local,
                             const int* __restrict__ ranks,
                             const int* __restrict__ roots,
                             int* __restrict__ y, int window, int chunk,
                             long n_x, long n_y) {
  const long n_slots = static_cast<long>(n_chunks) * chunk;
  for (int ch = blockIdx.x; ch < n_chunks; ch += gridDim.x) {
    const long cbase = static_cast<long>(chunk_cb[ch]) * window;
    const long rbase = static_cast<long>(chunk_rb[ch]) * window;
    const long sbase = static_cast<long>(ch) * chunk;
    for (int s = threadIdx.x; s < chunk; s += blockDim.x) {
      if (!GR_IN_RANGE(sbase + s, n_slots)) continue;
      const int r = row_local[sbase + s];
      if (r == window) continue;  // padding slot: before either root load
      const long ci = cbase + col_local[sbase + s];
      const long ri = rbase + r;
      // a real slot's row is a vertex, so ri < n_x as well as < n_y
      if (!GR_IN_RANGE(ci, n_x) || !GR_IN_RANGE(ri, n_x) ||
          !GR_IN_RANGE(ri, n_y))
        continue;
      if (roots[ci] == roots[ri]) continue;  // not a cut edge
      const int rank = ranks[sbase + s];
      if (rank < y[ri]) atomicMin(y + ri, rank);
    }
  }
}

}  // namespace

// ranks: int32[n_chunks * chunk] in slot order. roots: int32[n_vertices].
// y: int32[n_row_blocks * window], already the sentinel.
extern "C" int gr_min_rank_cut(int blocks, int n_chunks, const void* chunk_rb,
                               const void* chunk_cb, const void* row_local,
                               const void* col_local, const void* ranks,
                               const void* roots, void* y, int window,
                               int chunk, int n_vertices, int n_row_blocks,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  min_rank_cut<<<blocks, gr::kThreads, 0, s>>>(
      n_chunks, static_cast<const int*>(chunk_rb),
      static_cast<const int*>(chunk_cb), static_cast<const int*>(row_local),
      static_cast<const int*>(col_local), static_cast<const int*>(ranks),
      static_cast<const int*>(roots), static_cast<int*>(y), window, chunk,
      n_vertices, static_cast<long>(n_row_blocks) * window);
  return gr::finish(s);
}

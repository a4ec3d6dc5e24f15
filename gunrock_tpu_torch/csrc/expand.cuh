// The edge-balanced frontier expansion: Gunrock's load-balanced advance
// in one cooperative launch (sssp_push.cu, bfs_push.cu).
// Apart from common.cuh because cooperative_groups.h doubles the compile
// time of a small source.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace gr {

// Exclusive scan of (v.x, v.y) over the threads of the block (a whole
// number of warps), in thread order; `total` gets the sums over the
// block. Every thread must call it; `sh` is 64 ints of shared memory, free
// again when it returns.
__device__ __forceinline__ int2 block_scan2(int2 v, int2& total, int* sh) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int2 inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int x = __shfl_up_sync(kAll, inc.x, off);
    const int y = __shfl_up_sync(kAll, inc.y, off);
    if (lane >= off) inc.x += x, inc.y += y;
  }
  if (lane == 31) sh[warp] = inc.x, sh[32 + warp] = inc.y;
  __syncthreads();
  int2 before = make_int2(0, 0);
  total = make_int2(0, 0);
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    const int x = sh[w], y = sh[32 + w];
    if (w < warp) before.x += x, before.y += y;
    total.x += x, total.y += y;
  }
  __syncthreads();
  return make_int2(before.x + inc.x - v.x, before.y + inc.y - v.y);
}

// The arrays of an edge-balanced frontier expansion (expand_frontier).
struct Expansion {
  const unsigned char* front;  // bool[n_vertices]
  const int* row_offsets;      // int32[n_vertices + 1]
  int* block_counts;           // int32[2 * gridDim.x]: vertices, edges
  int* queue;                  // int32[n_vertices]
  int* first;                  // int32[n_vertices]
  int n_vertices;
  int n_edges;
};

// v's out-degree if it is on the frontier, else 0.
__device__ __forceinline__ int queued_degree(const Expansion& x, int v) {
  if (!x.front[v] || !GR_IN_RANGE(v + 1, x.n_vertices + 1)) return 0;
  return x.row_offsets[v + 1] - x.row_offsets[v];
}

// Gunrock's load-balanced advance in one cooperative launch (grid <= the
// co-resident blocks): own(v) for every vertex v, then, after a grid
// barrier, relax(v, e) for every out-edge e of every frontier vertex v,
// each once, spread over the whole grid by edge. No memset and no global
// atomic. Every thread of the grid must call it.
// 1. Block b owns the vertex range [b*per, (b+1)*per): it calls own(v)
//    over it and counts its frontier vertices of nonzero out-degree and
//    their out-edges.
// 2. grid.sync(). Each block sums the counts of the blocks before it (the
//    bases) and of all blocks (the totals), then writes its range's
//    queued vertices at the base, ascending, and beside each the
//    exclusive scan of the out-degrees (`first`: its first out-edge id in
//    [0, total)), a tile of blockDim vertices at a time.
// 3. grid.sync(). Thread t of the grid takes the edge ids t, t + T, ...
//    below the total (T threads in all): a hub's out-edges spread over
//    every SM, and a warp takes 32 consecutive edges. It finds an edge's
//    queue entry by a binary search in `first` (strictly ascending: no
//    vertex of degree 0 is queued), starting from its last one.
template <typename Own, typename Relax>
__device__ __forceinline__ void expand_frontier(const Expansion& x, Own own,
                                                Relax relax) {
  __shared__ int sh[64];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int per = (x.n_vertices + gridDim.x - 1) / gridDim.x;
  const int lo = min(x.n_vertices, static_cast<int>(blockIdx.x) * per);
  const int hi = min(x.n_vertices, lo + per);

  // 1. own(v) and the range's counts
  int2 mine = make_int2(0, 0);
  for (int v = lo + threadIdx.x; v < hi; v += blockDim.x) {
    own(v);
    const int deg = queued_degree(x, v);
    if (deg > 0) mine.x += 1, mine.y += deg;
  }
  int2 block;
  block_scan2(mine, block, sh);
  if (threadIdx.x == 0) {
    x.block_counts[2 * blockIdx.x] = block.x;
    x.block_counts[2 * blockIdx.x + 1] = block.y;
  }
  grid.sync();

  // 2. the bases and totals, then the range's queue entries and scan
  int2 before = make_int2(0, 0), all = make_int2(0, 0);
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += blockDim.x) {
    const int n = x.block_counts[2 * b], e = x.block_counts[2 * b + 1];
    if (b < static_cast<int>(blockIdx.x)) before.x += n, before.y += e;
    all.x += n, all.y += e;
  }
  int2 base, total;
  block_scan2(before, base, sh);
  block_scan2(all, total, sh);
  for (int t0 = lo; t0 < hi; t0 += blockDim.x) {  // uniform over the block
    const int v = t0 + threadIdx.x;
    const int deg = v < hi ? queued_degree(x, v) : 0;
    int2 tile;
    const int2 at = block_scan2(make_int2(deg > 0, deg), tile, sh);
    const int q = base.x + at.x;
    if (deg > 0 && GR_IN_RANGE(q, x.n_vertices)) {
      x.queue[q] = v;
      x.first[q] = base.y + at.y;
    }
    base.x += tile.x, base.y += tile.y;
  }
  grid.sync();

  // 3. relax(v, e), edge by edge over the whole grid
  const int n_q = total.x, n_e = total.y;
  const int stride = gridDim.x * blockDim.x;
  int q = 0;  // this thread's last queue entry: its edge ids ascend
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_e; i += stride) {
    int top = n_q;  // first[q] <= i < first[top] (first[n_q] = n_e)
    while (top - q > 1) {
      const int mid = (q + top) >> 1;
      if (!GR_IN_RANGE(mid, x.n_vertices)) break;
      if (x.first[mid] <= i) q = mid; else top = mid;
    }
    if (!GR_IN_RANGE(q, x.n_vertices)) continue;
    const int v = x.queue[q];
    if (!GR_IN_RANGE(v, x.n_vertices)) continue;
    const int e = x.row_offsets[v] + (i - x.first[q]);
    if (!GR_IN_RANGE(e, x.n_edges)) continue;
    relax(v, e);
  }
}

}  // namespace gr

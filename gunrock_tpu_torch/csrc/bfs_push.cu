// Sparse push step of direction-optimizing BFS.
//
// Replaces: gunrock_tpu/algorithms/bfs.py::bfs_push_step, which is XLA on
// the TPU: jnp.nonzero(size=Q) compaction, a scatter-max/cummax expansion
// of the queue's out-edges into a fixed edge budget, and a scatter-min of
// the new level.
//
// Contract: every vertex u with an in-edge from a frontier vertex and
// dist[u] == UNREACHED gets dist[u] = level and new_mask[u] = 1; nothing
// else changes. This is the set and the distances of bfs.py:107-110.
//
// What bounds it on this card: launch latency on the levels where the DO
// switch picks it (frontier out-edges under E/512, ~7.7K edges at R-MAT
// scale 18). Its bytes are the frontier mask (V bytes), the queued rows'
// offsets and edges, and the neighbours' distances: tens of kilobytes.
//
// Design: two launches on the caller's stream. gr::compact_frontier
// (common.cuh) turns the mask into a queue with one warp-aggregated
// atomicAdd per warp (no torch.nonzero, which would synchronise with the
// host). push_expand gives each queued vertex one warp, whose lanes walk
// its out-edges with a stride of 32 (coalesced col_indices reads) and
// claim each unreached neighbour with atomicCAS, so each new vertex is
// marked exactly once. A persistent grid reads the queue length on the
// device.

#include "common.cuh"

namespace {

constexpr int kUnreached = 0x7fffffff;

__global__ void push_expand(const int* __restrict__ queue,
                            const int* __restrict__ count,
                            const int* __restrict__ row_offsets,
                            const int* __restrict__ col_indices,
                            int* __restrict__ dist,
                            unsigned char* __restrict__ new_mask, int level,
                            int n_vertices, int n_edges) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x / 32);
  const int n_front = *count;
  for (int q = (blockIdx.x * blockDim.x + threadIdx.x) / 32; q < n_front;
       q += warps) {
    const int v = queue[q];
    if (!GR_IN_RANGE(v, n_vertices)) continue;
    const int begin = row_offsets[v];
    const int end = row_offsets[v + 1];
    // the range holds edges begin..end-1; an empty row may sit at n_edges
    if (begin < end && (!GR_IN_RANGE(begin, n_edges) ||
                        !GR_IN_RANGE(end - 1, n_edges)))
      continue;
    for (int e = begin + lane; e < end; e += 32) {
      const int u = col_indices[e];
      if (!GR_IN_RANGE(u, n_vertices)) continue;
      if (dist[u] == kUnreached &&
          atomicCAS(&dist[u], kUnreached, level) == kUnreached)
        new_mask[u] = 1;
    }
  }
}

}  // namespace

// scratch: int32[1 + n_vertices] ([count | queue]). new_mask: bool[V];
// both are cleared here. dist is updated in place.
extern "C" int gr_bfs_push_step(const void* front, int n_vertices,
                                int n_edges, const void* row_offsets,
                                const void* col_indices, void* dist,
                                void* new_mask, int level, void* scratch,
                                int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* count = static_cast<int*>(scratch);
  int* queue = count + 1;
  cudaMemsetAsync(count, 0, sizeof(int), s);
  cudaMemsetAsync(new_mask, 0, n_vertices, s);
  gr::compact_frontier<<<gr::grid_for(n_vertices, 4096), gr::kThreads, 0, s>>>(
      static_cast<const unsigned char*>(front), n_vertices, queue, count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  push_expand<<<blocks, gr::kThreads, 0, s>>>(
      queue, count, static_cast<const int*>(row_offsets),
      static_cast<const int*>(col_indices), static_cast<int*>(dist),
      static_cast<unsigned char*>(new_mask), level, n_vertices, n_edges);
  return gr::finish(s);
}

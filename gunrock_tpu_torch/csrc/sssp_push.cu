// Sparse push relaxation step of direction-optimizing SSSP.
//
// Replaces: gunrock_tpu/algorithms/sssp.py::sssp_push_step, which is XLA
// on the TPU (no Pallas): jnp.nonzero(size=Q) compaction, a
// scatter-max/cummax expansion of the queue's out-edges into a fixed edge
// budget, and a scatter-min of the relaxed candidates.
//
// Contract (Jacobi, as sssp.py:111-119): with `old` the distances before
// the step and new_dist == old on entry, for every out-edge (v, u, w) of
// every frontier vertex v,
//   new_dist[u] = min(new_dist[u], old[v] + w)
// and then improved[u] = new_dist[u] < old[u]. Candidates are formed from
// `old` only, never from new_dist: a frontier vertex lowered in this step
// does not feed the same step, so the frontiers and the depth are the
// reference's.
//
// What bounds it on this card: launch latency on the levels where the DO
// switch picks it (frontier out-edges under E/192 on a hub-ordered graph,
// ~20K edges at R-MAT scale 18). Its bytes are the frontier mask, the
// queued rows' offsets, edges and weights, the neighbours' distances and
// one pass over V for the improved mask: a few megabytes at most.
//
// Design: three launches on the caller's stream. gr::compact_frontier
// (common.cuh) queues the frontier with one warp-aggregated atomicAdd per
// warp. relax gives each queued vertex one warp whose lanes stride its
// out-edges (coalesced col/value reads); a candidate that beats the value
// it reads is sent with the sign-correct float atomic min of common.cuh.
// mark_improved compares new_dist with old over all V.

#include "common.cuh"

namespace {

__global__ void relax(const int* __restrict__ queue,
                      const int* __restrict__ count,
                      const int* __restrict__ row_offsets,
                      const int* __restrict__ col_indices,
                      const float* __restrict__ values,
                      const float* __restrict__ old_dist,
                      float* __restrict__ new_dist, int n_vertices,
                      int n_edges) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x / 32);
  const int n_front = *count;
  for (int q = (blockIdx.x * blockDim.x + threadIdx.x) / 32; q < n_front;
       q += warps) {
    const int v = queue[q];
    if (!GR_IN_RANGE(v, n_vertices)) continue;
    const float dv = old_dist[v];
    const int begin = row_offsets[v];
    const int end = row_offsets[v + 1];
    // the range holds edges begin..end-1; an empty row may sit at n_edges
    if (begin < end && (!GR_IN_RANGE(begin, n_edges) ||
                        !GR_IN_RANGE(end - 1, n_edges)))
      continue;
    for (int e = begin + lane; e < end; e += 32) {
      const int u = col_indices[e];
      if (!GR_IN_RANGE(u, n_vertices)) continue;
      const float cand = dv + values[e];
      // new_dist only decreases, so a candidate that does not beat the
      // value read now cannot win later
      if (cand < new_dist[u]) gr::atomic_min_float(&new_dist[u], cand);
    }
  }
}

__global__ void mark_improved(const float* __restrict__ old_dist,
                              const float* __restrict__ new_dist,
                              int n_vertices,
                              unsigned char* __restrict__ improved) {
  const int stride = gridDim.x * blockDim.x;
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < n_vertices;
       v += stride)
    improved[v] = new_dist[v] < old_dist[v];
}

}  // namespace

// scratch: int32[1 + n_vertices] ([count | queue]), cleared here.
// new_dist: float[V], a copy of old_dist on entry. improved: bool[V].
extern "C" int gr_sssp_push_step(const void* front, int n_vertices,
                                 int n_edges, const void* row_offsets,
                                 const void* col_indices, const void* values,
                                 const void* old_dist, void* new_dist,
                                 void* improved, void* scratch, int blocks,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* count = static_cast<int*>(scratch);
  int* queue = count + 1;
  cudaMemsetAsync(count, 0, sizeof(int), s);
  const int grid_v = gr::grid_for(n_vertices, 4096);
  gr::compact_frontier<<<grid_v, gr::kThreads, 0, s>>>(
      static_cast<const unsigned char*>(front), n_vertices, queue, count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  relax<<<blocks, gr::kThreads, 0, s>>>(
      queue, count, static_cast<const int*>(row_offsets),
      static_cast<const int*>(col_indices), static_cast<const float*>(values),
      static_cast<const float*>(old_dist), static_cast<float*>(new_dist),
      n_vertices, n_edges);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mark_improved<<<grid_v, gr::kThreads, 0, s>>>(
      static_cast<const float*>(old_dist),
      static_cast<const float*>(new_dist), n_vertices,
      static_cast<unsigned char*>(improved));
  return gr::finish(s);
}

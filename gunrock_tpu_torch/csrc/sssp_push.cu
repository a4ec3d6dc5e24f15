// Sparse push relaxation step of direction-optimizing SSSP.
//
// Replaces: gunrock_tpu/algorithms/sssp.py::sssp_push_step, which is XLA
// on the TPU (no Pallas): jnp.nonzero(size=Q) compaction, a
// scatter-max/cummax expansion of the queue's out-edges into a fixed edge
// budget, and a scatter-min of the relaxed candidates.
//
// Contract (Jacobi, as sssp.py:111-119): with `old` the distances before
// the step, for every out-edge (v, u, w) of every frontier vertex v,
//   new_dist[u] = min(old[u], min over those edges of old[v] + w)
// and improved[u] = new_dist[u] < old[u]. Candidates are formed from
// `old` only, never from new_dist: a frontier vertex lowered in this step
// does not feed the same step, so the frontiers and the depth are the
// reference's. A float min does not depend on the order of its terms, so
// the result is exactly the plain version's.
//
// What bounds it on this card: launch latency on the levels where the DO
// switch picks it (frontier out-edges under E/192 on a hub-ordered graph,
// ~20K edges at R-MAT scale 18). Its bytes are the frontier mask, the
// distances in and out, the improved mask, and the queued rows' offsets,
// edges and weights: ~2.6 MB at V = 262,144, under a microsecond.
//
// Design: an edge-balanced expansion, Gunrock's load-balanced advance
// (gr::expand_frontier in expand.cuh), in one cooperative launch (grid <=
// the co-resident blocks), no memset and no global atomic but the
// relaxation's own float min. Each block copies old into new_dist and
// clears improved over the vertex range it owns while it counts the
// range's queued vertices and out-edges; after the queue and the scan of
// the out-degrees, thread t of the grid relaxes the frontier's out-edge
// ids t, t + T, ...: the candidate is sent with the sign-correct float
// atomic min of common.cuh only if it beats the value read (new_dist
// only decreases, so one that does not cannot win later), and a candidate
// below old[u] marks u improved. That mark is the contract's: new_dist[u]
// < old[u] iff some candidate is below old[u]; it spares a pass over V
// after a third grid barrier.
//
// The earlier design gave each queued vertex one warp whose lanes strode
// its out-edges: on the path's largest pushed frontier (one hub, 15,810
// out-edges) one warp walked ~494 rounds of dependent loads while the
// other SMs waited, and each call took four device operations (a memset,
// the frontier's compaction, the relaxation, a pass over V for the marks)
// beside the wrapper's copy of the distances.

#include "expand.cuh"

namespace {

struct Args {
  gr::Expansion x;        // the frontier, the CSR offsets and the scratch
  const int* col_indices;  // int32[n_edges]
  const float* values;     // f32[n_edges]
  const float* old_dist;   // f32[n_vertices]
  float* new_dist;         // f32[n_vertices], written whole
  unsigned char* improved;  // bool[n_vertices], written whole
};

__global__ void __launch_bounds__(gr::kThreads) push_step(const Args a) {
  gr::expand_frontier(
      a.x,
      [&](int v) {
        a.new_dist[v] = a.old_dist[v];
        a.improved[v] = 0;
      },
      [&](int v, int e) {
        const int u = a.col_indices[e];
        if (!GR_IN_RANGE(u, a.x.n_vertices)) return;
        const float cand = a.old_dist[v] + a.values[e];
        if (cand < a.new_dist[u]) gr::atomic_min_float(&a.new_dist[u], cand);
        if (cand < a.old_dist[u]) a.improved[u] = 1;
      });
}

}  // namespace

// new_dist: f32[V] and improved: bool[V], both written whole; old_dist is
// not written. scratch: int32[2 * max_blocks + 2 * n_vertices], laid out
// as [block counts | queue | first]; nothing in it needs to be set. The
// grid is at most max_blocks blocks. Returns cudaErrorNotSupported where
// the device has no cooperative launch.
extern "C" int gr_sssp_push_step(const void* front, int n_vertices,
                                 int n_edges, const void* row_offsets,
                                 const void* col_indices, const void* values,
                                 const void* old_dist, void* new_dist,
                                 void* improved, void* scratch,
                                 int max_blocks, void* stream) {
  static int coresident = -1;  // one card per process
  if (coresident < 0) coresident = gr::coresident_blocks(push_step, gr::kThreads);
  if (coresident == 0) return cudaErrorNotSupported;
  if (max_blocks < 1) return cudaErrorInvalidValue;
  Args a{};
  gr::Expansion& x = a.x;
  x.front = static_cast<const unsigned char*>(front);
  x.row_offsets = static_cast<const int*>(row_offsets);
  x.block_counts = static_cast<int*>(scratch);
  x.queue = x.block_counts + 2 * max_blocks;
  x.first = x.queue + n_vertices;
  x.n_vertices = n_vertices;
  x.n_edges = n_edges;
  a.col_indices = static_cast<const int*>(col_indices);
  a.values = static_cast<const float*>(values);
  a.old_dist = static_cast<const float*>(old_dist);
  a.new_dist = static_cast<float*>(new_dist);
  a.improved = static_cast<unsigned char*>(improved);
  // at least one vertex a thread in the first phase
  const long want = (static_cast<long>(n_vertices) + gr::kThreads - 1) / gr::kThreads;
  int blocks = static_cast<int>(want < 1 ? 1 : want);
  if (blocks > coresident) blocks = coresident;
  if (blocks > max_blocks) blocks = max_blocks;
  void* params[] = {&a};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(push_step), dim3(blocks), dim3(gr::kThreads),
      params, 0, s);
  if (err != cudaSuccess) return err;
  return gr::finish(s);
}

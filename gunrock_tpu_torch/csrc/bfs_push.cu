// Sparse push step of direction-optimizing BFS.
//
// Replaces: gunrock_tpu/algorithms/bfs.py::bfs_push_step, which is XLA on
// the TPU: jnp.nonzero(size=Q) compaction, a scatter-max/cummax expansion
// of the queue's out-edges into a fixed edge budget, and a scatter-min of
// the new level.
//
// Contract: every vertex u with an in-edge from a frontier vertex and
// dist[u] == UNREACHED gets dist[u] = level + 1 and new_mask[u] = 1;
// nothing else changes. This is the set and the distances of
// bfs.py:107-110. The result does not depend on the order of the edges:
// atomicCAS claims each new vertex once, and every claim writes the same
// level.
//
// What bounds it on this card: launch latency and the grid's two
// barriers on the levels where the DO switch picks it (frontier out-edges
// under E/512, ~7.7K edges at R-MAT scale 18). Its bytes are the frontier
// mask and new_mask over V (2 * 262,144 B at scale 18), the queued rows'
// offsets and edges, and the neighbours' distances: well under a
// microsecond at 3.35 TB/s.
//
// Design: an edge-balanced expansion, Gunrock's load-balanced advance
// (gr::expand_frontier in expand.cuh), in one cooperative launch (grid <=
// the co-resident blocks), no memset. Each block clears new_mask over the
// vertex range it owns while it counts the range's queued vertices and
// out-edges; after the queue and the scan of the out-degrees, thread t of
// the grid takes the frontier's out-edge ids t, t + T, ...: a neighbour
// read as UNREACHED is claimed by atomicCAS, and the claiming thread sets
// its mark. new_mask must not alias the frontier, which other blocks
// still read while a block clears its range.
//
// Edge-balanced, not a warp per queued vertex: on a hub that warp would
// walk the whole row while the other SMs wait.

#include "expand.cuh"

namespace {

constexpr int kUnreached = 0x7fffffff;

struct Args {
  gr::Expansion x;          // the frontier, the CSR offsets and the scratch
  const int* col_indices;   // int32[n_edges]
  int* dist;                // int32[n_vertices], updated in place
  unsigned char* new_mask;  // bool[n_vertices], written whole
  int level;                // the frontier's level, unless level_at is set
  const int* level_at;      // int32[1] on the device: the level, or null
};

__global__ void __launch_bounds__(gr::kThreads) push_step(const Args a) {
  const int next = (a.level_at ? *a.level_at : a.level) + 1;
  gr::expand_frontier(
      a.x, [&](int v) { a.new_mask[v] = 0; },
      [&](int, int e) {
        const int u = a.col_indices[e];
        if (!GR_IN_RANGE(u, a.x.n_vertices)) return;
        if (a.dist[u] == kUnreached &&
            atomicCAS(&a.dist[u], kUnreached, next) == kUnreached)
          a.new_mask[u] = 1;
      });
}

}  // namespace

// new_mask: bool[V], written whole; it must not alias front. dist is
// updated in place. The frontier's level is level, or, where level_at is
// not null, the int32 it points to on the device, which the kernel reads
// there, so that a captured CUDA graph replays at any level. scratch:
// int32[2 * max_blocks + 2 * n_vertices], laid out as [block counts |
// queue | first]; nothing in it needs to be set. The grid is at most
// max_blocks blocks. Returns cudaErrorNotSupported where the device has
// no cooperative launch.
extern "C" int gr_bfs_push_step(const void* front, int n_vertices,
                                int n_edges, const void* row_offsets,
                                const void* col_indices, void* dist,
                                void* new_mask, int level,
                                const void* level_at, void* scratch,
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
  a.dist = static_cast<int*>(dist);
  a.new_mask = static_cast<unsigned char*>(new_mask);
  a.level = level;
  a.level_at = static_cast<const int*>(level_at);
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

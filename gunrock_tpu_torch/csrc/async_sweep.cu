// Gauss-Seidel block sweeps of the async solver: the whole multi-sweep
// loop of one search in one cooperative launch.
//
// Replaces: gunrock_tpu/experimental/async_sweep.py::_sweep_kernel (:62,
// min-plus: SSSP, and BFS on unit weights) and ::_pr_gs_kernel (:215,
// PageRank), which are XLA on the TPU (no Pallas): one lax.while_loop over
// the sweeps, a fori_loop over the blocks of a sweep (forward on even
// sweeps, backward on odd ones) and, for min-plus, an inner while_loop
// that relaxes one block to its local fixed point. The host reads nothing
// inside the loop; here neither: one launch and one read of the counts a
// search.
//
// The plan: blocks are contiguous vertex ranges [v_starts[b],
// v_starts[b+1]) whose in-edges are the contiguous CSC range [e_starts[b],
// e_starts[b+1]) (E for the last), cut so that each holds about E/n_blocks
// edges (experimental/async_sweep.py::_block_plan).
//
// Contract of gs_sweep_min (the JAX semantics, pass for pass, since the
// pass and sweep counts are part of the result): a block pass forms every
// candidate d[src] + w from d as it stood before that pass (earlier blocks
// of the sweep already updated, the block's own not), then sets each of
// the block's vertices to min(d[v], least candidate) and reports whether
// any went down. A block repeats passes until one changes nothing (so a
// block costs at least one pass, an edgeless one exactly one). A sweep
// walks every block; the sweeps stop after one that changed nothing or at
// max_sweeps. A float min does not depend on the order of its terms, so
// the distances and both counts are the plain version's, bit for bit.
//
// Contract of gs_sweep_pr: a block pass sets each of the block's vertices
// to base + sum over its in-edges of p[src] * iw[src] * w, with base =
// (1 - alpha + dsum) / V from the running dangling mass dsum, every term
// read from p as it stood before the pass (Jacobi within the block, Gauss-
// Seidel across blocks); then dsum += alpha * (sum of the block's dangling
// vertices' changes) and err = max(err, max |change|). The sweeps stop
// once a whole sweep's err is below tol, or at max_sweeps.
//
// What bounds it on this card: grid barriers, not bytes. A block pass
// reads the block's E/n_blocks edges (12 bytes each: source, weight,
// destination) and its V/n_blocks vertices (8 bytes each): at R-MAT scale
// 18 and 32 blocks 1.5 MB, 0.45 us at 3.35 TB/s; on a Delaunay mesh of
// 2^18 points 0.6 MB, 0.2 us. Each pass takes two grid barriers, a few
// microseconds each, and a mesh takes tens of thousands of passes.
//
// Design: one cooperative launch (grid <= the co-resident blocks, at most
// one block of kSweepThreads threads an SM, so that the barriers are
// cheap), every thread of the grid walking the same sweeps, blocks and
// passes, so every block takes the same branches. Cross-block data
// (distances, ranks, partial sums, flags) is read with __ldcg (L2, never a
// stale L1 line) after the grid barrier that orders it.
// - min-plus pass: (1) the grid strides over the block's edges a warp-
//   wide tile of 32 at a time; each run of equal destinations (CSC slots
//   are sorted by destination) is folded onto its first lane by a
//   segmented shuffle min, and that lane sends one atomicMin (on the int
//   bits of a non-negative float: exact and order-free) into a scratch
//   vector, only if it beats the destination's distance, so a hub's tens
//   of thousands of in-edges send one atomic a tile, not one an edge;
//   barrier; (2) each of the block's vertices commits a lower scratch
//   value and resets its scratch entry to +inf, and a block that lowered
//   one raises this pass's flag; the other of two flags is cleared for
//   the next pass; barrier; every thread reads the flag. A sweep changed
//   iff one of its passes did (distances only go down).
// - PageRank pass, in a fixed order of summation, so that a run is bit-
//   equal to the next (no float atomic): each vertex's in-edges are cut
//   into pieces of kPiece edges (a vertex without in-edges has one empty
//   piece; piece_first, the pieces' prefix, is the wrapper's), (1) a warp
//   sums a piece lane by lane and folds the lanes by a fixed shuffle tree;
//   barrier; (2) each of the block's vertices adds its pieces in order and
//   takes its new rank, and each block reduces its dangling change and
//   largest change in a fixed order into its own slot; barrier; (3) every
//   block folds the slots in the same fixed order (fold_slots), so all
//   hold the same dsum and err.
//   A hub's in-edges spread over many warps; the Delaunay mesh's six are
//   one warp's.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kSweepThreads = 512;
constexpr int kPiece = 256;  // in-edges of one destination a warp sums
constexpr unsigned kAll = 0xffffffffu;

struct MinArgs {
  const int* rows;      // csc_rows int32[n_edges]: source of each slot
  const float* vals;    // f32[n_edges]: weight of each slot
  const int* dst;       // csc_dst int32[n_edges]: destination, ascending
  const int* v_starts;  // int32[n_blocks + 1]
  const int* e_starts;  // int32[n_blocks]
  const float* dist0;   // f32[n_vertices]
  float* dist;          // f32[n_vertices], written whole
  float* relaxed;       // f32[n_vertices] scratch
  int* flags;           // int32[2] scratch
  long long* out;       // int64[2]: sweeps, block passes
  long long max_sweeps;
  int n_vertices;
  int n_edges;
  int n_blocks;
};

struct PrArgs {
  const int* rows;         // csc_rows int32[n_edges]
  const float* vals;       // f32[n_edges], alpha folded in
  const int* offsets;      // csc offsets int32[n_vertices + 1]
  const int* piece_first;  // int32[n_vertices + 1]: each vertex's first piece
  const int* v_starts;     // int32[n_blocks + 1]
  const float* iweights;   // f32[n_vertices]: 1 / out-weight, 0 if dangling
  const unsigned char* dangling;  // bool[n_vertices]
  const float* p0;         // f32[n_vertices]
  float* p;                // f32[n_vertices], written whole
  float* piece_sum;        // f32[n_pieces] scratch
  int* piece_vertex;       // int32[n_pieces] scratch
  float* part;             // f32[2 * gridDim.x] scratch
  long long* out;          // int64[1]: sweeps
  long long max_sweeps;
  float alpha;
  float one_minus_alpha;
  float tol;
  int n_vertices;
  int n_edges;
  int n_blocks;
  int n_pieces;
};

// The max of `v` over the calling block (as gr::block_sum), to every thread.
__device__ __forceinline__ float block_max(float v, float* scratch) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_down_sync(kAll, v, off));
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = 0.0f;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w)
    m = fmaxf(m, scratch[w]);
  __syncthreads();
  return m;
}

// total[0] = the sum of the grid's slots part[2g], total[1] = the max of
// part[2g + 1], in a fixed order (warp 0: lane l adds slots l, l + 32,
// ... in turn, then a fixed shuffle tree), so every block gets the same
// bits. Every thread of the block must call it.
__device__ __forceinline__ void fold_slots(const float* part, float* total) {
  if (threadIdx.x < 32) {
    float s = 0.0f, m = 0.0f;
    for (int g = threadIdx.x; g < static_cast<int>(gridDim.x); g += 32) {
      s += __ldcg(part + 2 * g);
      m = fmaxf(m, __ldcg(part + 2 * g + 1));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(kAll, s, off);
      m = fmaxf(m, __shfl_xor_sync(kAll, m, off));
    }
    if (threadIdx.x == 0) {
      total[0] = s;
      total[1] = m;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kSweepThreads, 1) sweep_min(const MinArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int n_threads = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = tid >> 5, n_warps = n_threads >> 5;
  const float inf = __int_as_float(0x7f800000);
  for (int v = tid; v < a.n_vertices; v += n_threads) {
    a.dist[v] = a.dist0[v];
    a.relaxed[v] = inf;
  }
  if (tid == 0) a.flags[0] = a.flags[1] = 0;
  grid.sync();

  long long sweeps = 0, passes = 0;
  int parity = 0;  // the flag of the current pass
  bool changed = true;
  while (changed && sweeps < a.max_sweeps) {
    const bool forward = (sweeps & 1) == 0;
    changed = false;
    for (int i = 0; i < a.n_blocks; ++i) {
      const int b = forward ? i : a.n_blocks - 1 - i;
      const int v0 = a.v_starts[b], v1 = a.v_starts[b + 1];
      const int e0 = a.e_starts[b];
      const int e1 = b + 1 < a.n_blocks ? a.e_starts[b + 1] : a.n_edges;
      if (e1 <= e0) {  // no in-edge: one pass that lowers nothing
        ++passes;
        continue;
      }
      bool again;
      do {
        // 1. candidates, folded per destination run, into relaxed
        for (int base = e0 + 32 * warp; base < e1; base += 32 * n_warps) {
          const int e = base + lane;
          int key = -1;
          float cand = inf;
          if (e < e1 && GR_IN_RANGE(e, a.n_edges)) {
            const int s = a.rows[e];
            key = a.dst[e];
            if (GR_IN_RANGE(s, a.n_vertices)) cand = __ldcg(a.dist + s) + a.vals[e];
          }
          // lane l ends with the min over [l, end of its run]: runs are
          // contiguous, so an equal key `off` lanes on is in the same run
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const float c = __shfl_down_sync(kAll, cand, off);
            const int k = __shfl_down_sync(kAll, key, off);
            if (lane + off < 32 && k == key) cand = fminf(cand, c);
          }
          const int prev = __shfl_up_sync(kAll, key, 1);
          if (key >= 0 && (lane == 0 || prev != key) &&
              GR_IN_RANGE(key, a.n_vertices) && cand < __ldcg(a.dist + key))
            gr::atomic_min_float(a.relaxed + key, cand);
        }
        grid.sync();
        // 2. commit the block's lowered vertices
        bool lowered = false;
        for (int v = v0 + tid; v < v1; v += n_threads) {
          if (!GR_IN_RANGE(v, a.n_vertices)) continue;
          const float x = __ldcg(a.relaxed + v);
          if (x < __ldcg(a.dist + v)) {
            a.dist[v] = x;
            lowered = true;
          }
          if (x != inf) a.relaxed[v] = inf;
        }
        if (__syncthreads_or(lowered) && threadIdx.x == 0) a.flags[parity] = 1;
        if (tid == 0) a.flags[parity ^ 1] = 0;  // read by no one until then
        grid.sync();
        again = __ldcg(a.flags + parity) != 0;
        parity ^= 1;
        ++passes;
        changed |= again;
      } while (again);
    }
    ++sweeps;
  }
  if (tid == 0) {
    a.out[0] = sweeps;
    a.out[1] = passes;
  }
}

__global__ void __launch_bounds__(kSweepThreads, 1) sweep_pr(const PrArgs a) {
  __shared__ float red[32];
  __shared__ float total[2];
  cg::grid_group grid = cg::this_grid();
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int n_threads = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = tid >> 5, n_warps = n_threads >> 5;
  const float inf = __int_as_float(0x7f800000);

  // p = p0, each piece's vertex, and the dangling mass slot by slot
  float mine = 0.0f;
  for (int v = tid; v < a.n_vertices; v += n_threads) {
    const float x = a.p0[v];
    a.p[v] = x;
    if (a.dangling[v]) mine += a.alpha * x;
    for (int q = a.piece_first[v]; q < a.piece_first[v + 1]; ++q)
      if (GR_IN_RANGE(q, a.n_pieces)) a.piece_vertex[q] = v;
  }
  mine = gr::block_sum(mine, red);
  if (threadIdx.x == 0) {
    a.part[2 * blockIdx.x] = mine;
    a.part[2 * blockIdx.x + 1] = 0.0f;
  }
  grid.sync();
  fold_slots(a.part, total);
  float dsum = total[0];

  long long sweeps = 0;
  float err = inf;
  while (err >= a.tol && sweeps < a.max_sweeps) {
    const bool forward = (sweeps & 1) == 0;
    err = 0.0f;
    for (int i = 0; i < a.n_blocks; ++i) {
      const int b = forward ? i : a.n_blocks - 1 - i;
      const int v0 = a.v_starts[b], v1 = a.v_starts[b + 1];
      if (v1 <= v0) continue;  // no vertex: the pass changes nothing
      // 1. a warp a piece: its in-edges' terms, lane by lane, then a
      // fixed shuffle tree
      const int q1 = a.piece_first[v1];
      for (int q = a.piece_first[v0] + warp; q < q1; q += n_warps) {
        if (!GR_IN_RANGE(q, a.n_pieces)) continue;  // warp-uniform
        const int v = a.piece_vertex[q];
        if (!GR_IN_RANGE(v, a.n_vertices)) continue;
        const int start = a.offsets[v] + (q - a.piece_first[v]) * kPiece;
        const int end = min(start + kPiece, a.offsets[v + 1]);
        float s = 0.0f;
        for (int e = start + lane; e < end; e += 32) {
          if (!GR_IN_RANGE(e, a.n_edges)) break;
          const int u = a.rows[e];
          if (!GR_IN_RANGE(u, a.n_vertices)) continue;
          s += __ldcg(a.p + u) * a.iweights[u] * a.vals[e];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kAll, s, off);
        if (lane == 0) a.piece_sum[q] = s;
      }
      grid.sync();
      // 2. the block's new ranks; its dangling change and largest change
      const float base = (a.one_minus_alpha + dsum) / static_cast<float>(a.n_vertices);
      float dd = 0.0f, de = 0.0f;
      for (int v = v0 + tid; v < v1; v += n_threads) {
        if (!GR_IN_RANGE(v, a.n_vertices)) continue;
        float s = 0.0f;
        for (int q = a.piece_first[v]; q < a.piece_first[v + 1]; ++q)
          if (GR_IN_RANGE(q, a.n_pieces)) s += __ldcg(a.piece_sum + q);
        const float nw = base + s;
        const float d = nw - __ldcg(a.p + v);
        if (a.dangling[v]) dd += d;
        de = fmaxf(de, fabsf(d));
        a.p[v] = nw;
      }
      dd = gr::block_sum(dd, red);
      de = block_max(de, red);
      if (threadIdx.x == 0) {
        a.part[2 * blockIdx.x] = dd;
        a.part[2 * blockIdx.x + 1] = de;
      }
      grid.sync();
      // 3. every block folds the slots in the same order
      fold_slots(a.part, total);
      dsum = dsum + a.alpha * total[0];
      err = fmaxf(err, total[1]);
    }
    ++sweeps;
  }
  if (tid == 0) a.out[0] = sweeps;
}

// The grid: one block an SM at most (cheap barriers), no more than the
// co-resident blocks and max_grid. 0 where the device has no cooperative
// launch.
template <typename Kernel>
int sweep_grid(Kernel kernel, int max_grid) {
  int dev = 0, sms = 0;
  const int coresident = gr::coresident_blocks(kernel, kSweepThreads);
  if (coresident == 0 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  int blocks = coresident < sms ? coresident : sms;
  return blocks < max_grid ? blocks : max_grid;
}

}  // namespace

// dist: f32[n_vertices], written whole. scratch: f32[n_vertices] then two
// int32 (nothing in it needs to be set). out: int64[2] = {sweeps, block
// passes}. Returns cudaErrorNotSupported where the device has no
// cooperative launch.
extern "C" int gr_gs_sweep_min(const void* rows, const void* vals,
                               const void* dst, const void* v_starts,
                               const void* e_starts, const void* dist0,
                               void* dist, void* scratch, void* out,
                               int n_vertices, int n_edges, int n_blocks,
                               long long max_sweeps, int max_grid,
                               void* stream) {
  static int grid_blocks = -1;  // one card per process
  if (grid_blocks < 0) grid_blocks = sweep_grid(sweep_min, 1 << 30);
  if (grid_blocks == 0) return cudaErrorNotSupported;
  if (n_blocks < 1 || max_grid < 1) return cudaErrorInvalidValue;
  MinArgs a{};
  a.rows = static_cast<const int*>(rows);
  a.vals = static_cast<const float*>(vals);
  a.dst = static_cast<const int*>(dst);
  a.v_starts = static_cast<const int*>(v_starts);
  a.e_starts = static_cast<const int*>(e_starts);
  a.dist0 = static_cast<const float*>(dist0);
  a.dist = static_cast<float*>(dist);
  a.relaxed = static_cast<float*>(scratch);
  a.flags = reinterpret_cast<int*>(a.relaxed + n_vertices);
  a.out = static_cast<long long*>(out);
  a.max_sweeps = max_sweeps;
  a.n_vertices = n_vertices;
  a.n_edges = n_edges;
  a.n_blocks = n_blocks;
  const int blocks = grid_blocks < max_grid ? grid_blocks : max_grid;
  void* params[] = {&a};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(sweep_min), dim3(blocks), dim3(kSweepThreads),
      params, 0, s);
  if (err != cudaSuccess) return err;
  return gr::finish(s);
}

// p: f32[n_vertices], written whole. scratch: f32[n_pieces], int32
// [n_pieces], then f32[2 * max_grid] (nothing in it needs to be set);
// n_pieces >= piece_first[n_vertices]. out: int64[1] = {sweeps}. Returns
// cudaErrorNotSupported where the device has no cooperative launch.
extern "C" int gr_gs_sweep_pr(const void* rows, const void* vals,
                              const void* offsets, const void* piece_first,
                              const void* v_starts, const void* iweights,
                              const void* dangling, const void* p0, void* p,
                              void* scratch, void* out, int n_vertices,
                              int n_edges, int n_blocks, int n_pieces,
                              long long max_sweeps, float alpha,
                              float one_minus_alpha, float tol, int max_grid,
                              void* stream) {
  static int grid_blocks = -1;  // one card per process
  if (grid_blocks < 0) grid_blocks = sweep_grid(sweep_pr, 1 << 30);
  if (grid_blocks == 0) return cudaErrorNotSupported;
  if (n_blocks < 1 || max_grid < 1 || n_vertices < 1)
    return cudaErrorInvalidValue;
  PrArgs a{};
  a.rows = static_cast<const int*>(rows);
  a.vals = static_cast<const float*>(vals);
  a.offsets = static_cast<const int*>(offsets);
  a.piece_first = static_cast<const int*>(piece_first);
  a.v_starts = static_cast<const int*>(v_starts);
  a.iweights = static_cast<const float*>(iweights);
  a.dangling = static_cast<const unsigned char*>(dangling);
  a.p0 = static_cast<const float*>(p0);
  a.p = static_cast<float*>(p);
  a.piece_sum = static_cast<float*>(scratch);
  a.piece_vertex = reinterpret_cast<int*>(a.piece_sum + n_pieces);
  a.part = reinterpret_cast<float*>(a.piece_vertex + n_pieces);
  a.out = static_cast<long long*>(out);
  a.max_sweeps = max_sweeps;
  a.alpha = alpha;
  a.one_minus_alpha = one_minus_alpha;
  a.tol = tol;
  a.n_vertices = n_vertices;
  a.n_edges = n_edges;
  a.n_blocks = n_blocks;
  a.n_pieces = n_pieces;
  const int blocks = grid_blocks < max_grid ? grid_blocks : max_grid;
  void* params[] = {&a};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(sweep_pr), dim3(blocks), dim3(kSweepThreads),
      params, 0, s);
  if (err != cudaSuccess) return err;
  return gr::finish(s);
}

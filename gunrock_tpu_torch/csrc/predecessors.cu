// Predecessors of a single-source search from its distances: one kernel
// for BFS and SSSP.
//
// Replaces no TPU kernel. The JAX package finds predecessors with a
// segment_min over the CSC order, left to XLA
// (gunrock_tpu/algorithms/bfs.py::_predecessors_from_distances,
// sssp.py::recover_predecessors); the port's plain version
// (ops/kernels/predecessors.py::predecessors_plain) gathers the distances
// over every slot and ends in an atomic scatter-min into V entries. On a
// degree-sorted Kronecker graph of 31.4M slots that pass took 4.4 ms a
// BFS query, most of the query (PERF.md).
//
// Contract: pred[v] = the smallest in-neighbour u = csc_rows[k] (k a slot
// of v's run csc_offsets[v] .. csc_offsets[v + 1]) that is tight for v;
// -1 where v is unreached or none is tight. Tight:
//   BFS  (int dist):   dist[u] != UNREACHED && dist[u] + 1 == dist[v]
//   SSSP (float dist): torch.isclose(dist[u] + w[k], dist[v], rtol=1e-5,
//                      atol=1e-8) && dist[u] < inf
// where isclose is evaluated in float32 as torch does it: a == b, or
// |a - b| finite and <= atol + |rtol * b|, each operation rounded once
// (the _rn intrinsics keep nvcc from contracting them into an FMA).
// Unreached: BFS dist[v] == UNREACHED, SSSP dist[v] infinite.
//
// Why the first tight slot is enough: graph/build.py sorts CSC slots by
// (dst, src) (graph/graph.py), so csc_rows ascends within each run, and
// the first tight slot of a run in ascending slot order holds its
// smallest tight source. Every path below scans in ascending order and
// stops at the first stride (or round) holding a tight slot, whose
// smallest tight source is the answer: bit for bit the plain pass's.
//
// What bounds it on this card: the latency of a chain of dependent loads
// (a run's sources, then their distances), not bytes. Read whole, a
// scale-20 graph's runs are 126 MB of csc_rows (and as much of csc_values
// for SSSP) against 4 MB of distances, which stay in L2: 0.04 ms (0.08
// ms) at 3.35 TB/s; a scan that stops early reads less.
//
// Design: one launch, no global atomic, no scratch, no host sync; the
// work is split by run length, read from csc_offsets in the kernel.
//  - Runs blocks (blockIdx >= hub_blocks) take 512 consecutive vertices,
//    a warp 32 of them. A run of at most kLaneRun slots is scanned by its
//    own lane, kLaneLoads slots in flight. A run of up to kBlockRun slots
//    is scanned by the whole warp, one run after another: strides of 32 x
//    kWarpLoads slots, __ballot_sync and __ffs pick the first tight slot.
//    Vertex-level reads and the pred write are coalesced.
//  - Hub blocks (blockIdx < hub_blocks, one an SM, scheduled first) own
//    the runs longer than kBlockRun. Block b checks vertices b, b +
//    hub_blocks, ...: interleaved, so that the hubs a degree sort puts at
//    the lowest ids spread one a block (the ordering only balances the
//    work; any order is right). It lists its long runs in shared memory
//    and scans each with the whole block in ascending rounds of kThreads
//    x kBlockLoads slots, reducing the round's smallest tight source in
//    shared memory and stopping at the first round that has one. A hub
//    one hop from a random source has one tight in-neighbour, anywhere in
//    a run of up to ~10^5 slots: a warp alone would walk it for about a
//    millisecond.
// The runs' sources and weights are read once, streamed past L2 (__ldcs,
// as csrc/banded.cu does); the distances through the read-only path
// (__ldg), so that they stay in L1 and L2.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;      // threads a block, in both roles
constexpr int kWarps = kThreads / 32;
constexpr int kLaneRun = 32;       // runs up to this many slots: one lane
constexpr int kBlockRun = 2048;    // runs over this many slots: one block
constexpr int kLaneLoads = 8;      // slots a lane scan has in flight
constexpr int kWarpLoads = 4;      // a lane's slots in a warp stride (128)
constexpr int kBlockLoads = 8;     // a thread's slots in a block round (4096)
constexpr int kChecks = 4;         // vertices a hub-block thread checks at once
constexpr int kNone = 0x7fffffff;  // no tight source yet; BFS's UNREACHED
constexpr unsigned kFull = 0xffffffffu;
// torch.isclose's defaults, converted to float as torch converts them
constexpr float kRtol = static_cast<float>(1e-5);
constexpr float kAtol = static_cast<float>(1e-8);

struct Bfs {
  using D = int;
  static constexpr bool kWeighted = false;
  static __device__ __forceinline__ bool reached(int dv) { return dv != kNone; }
  static __device__ __forceinline__ bool tight(int du, float, int dv) {
    return du != kNone &&
           static_cast<int>(static_cast<unsigned>(du) + 1u) == dv;
  }
};

struct Sssp {
  using D = float;
  static constexpr bool kWeighted = true;
  static __device__ __forceinline__ bool reached(float dv) { return !isinf(dv); }
  static __device__ __forceinline__ bool tight(float du, float w, float dv) {
    const float a = __fadd_rn(du, w);
    const float err = fabsf(__fsub_rn(a, dv));
    const float allowed = __fadd_rn(kAtol, fabsf(__fmul_rn(kRtol, dv)));
    // du < +inf, false for NaN as in torch
    return (a == dv || (isfinite(err) && err <= allowed)) &&
           du < __int_as_float(0x7f800000);
  }
};

template <typename T>
struct Args {
  const int* offsets;      // int32[n_vertices + 1], the CSC runs
  const int* rows;         // int32[n_slots], each slot's source
  const float* values;     // float32[n_slots], each slot's weight (SSSP)
  const typename T::D* dist;  // [n_vertices]
  int* pred;               // int32[n_vertices], written whole
  int n_vertices;
  int n_slots;
  int hub_blocks;          // 0 where no run can be longer than kBlockRun
};

// N slots of a run, `step` apart from s0 (those at or past `end` are not
// loaded), and their sources' distances: every load is issued before the
// first test.
template <typename T, int N>
struct Slots {
  int u[N];
  float w[N];
  typename T::D du[N];
  bool ok[N];

  __device__ __forceinline__ void load(const Args<T>& a, long s0, long step,
                                       long end) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const long s = s0 + j * step;
      ok[j] = s < end && GR_IN_RANGE(s, a.n_slots);
      u[j] = ok[j] ? __ldcs(a.rows + s) : 0;
      w[j] = ok[j] && T::kWeighted ? __ldcs(a.values + s) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      ok[j] = ok[j] && GR_IN_RANGE(u[j], a.n_vertices);
      du[j] = ok[j] ? __ldg(a.dist + u[j]) : static_cast<typename T::D>(0);
    }
  }

  __device__ __forceinline__ bool tight(int j, typename T::D dv) const {
    return ok[j] && T::tight(du[j], w[j], dv);
  }
};

// A short run [beg, end) scanned by one lane.
template <typename T>
__device__ int scan_lane(const Args<T>& a, long beg, long end,
                         typename T::D dv) {
  for (long s0 = beg; s0 < end; s0 += kLaneLoads) {
    Slots<T, kLaneLoads> x;
    x.load(a, s0, 1, end);
#pragma unroll
    for (int j = 0; j < kLaneLoads; ++j)
      if (x.tight(j, dv)) return x.u[j];
  }
  return kNone;
}

// A run [beg, end) scanned by the whole warp (every lane calls it with
// the same run), in strides of 32 x kWarpLoads slots.
template <typename T>
__device__ int scan_warp(const Args<T>& a, long beg, long end,
                         typename T::D dv, int lane) {
  for (long s0 = beg; s0 < end; s0 += 32 * kWarpLoads) {
    Slots<T, kWarpLoads> x;
    x.load(a, s0 + lane, 32, end);
#pragma unroll
    for (int j = 0; j < kWarpLoads; ++j) {
      const unsigned hit = __ballot_sync(kFull, x.tight(j, dv));
      if (hit) return __shfl_sync(kFull, x.u[j], __ffs(hit) - 1);
    }
  }
  return kNone;
}

// A long run [beg, end) scanned by the whole block (every thread calls it
// with the same run), in rounds of kThreads x kBlockLoads slots. `red`:
// kWarps ints of shared memory.
template <typename T>
__device__ int scan_block(const Args<T>& a, long beg, long end,
                          typename T::D dv, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (long s0 = beg; s0 < end; s0 += kThreads * kBlockLoads) {
    Slots<T, kBlockLoads> x;
    x.load(a, s0 + threadIdx.x, kThreads, end);
    int mine = kNone;
#pragma unroll
    for (int j = 0; j < kBlockLoads; ++j)
      if (x.tight(j, dv)) mine = min(mine, x.u[j]);
    mine = __reduce_min_sync(kFull, mine);
    if (lane == 0) red[warp] = mine;
    __syncthreads();
    int best = kNone;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) best = min(best, red[i]);
    __syncthreads();  // red is written again in the next round
    if (best != kNone) return best;
  }
  return kNone;
}

template <typename T>
__device__ void hub_role(const Args<T>& a) {
  __shared__ int list[kThreads * kChecks];
  __shared__ int count;
  __shared__ int red[kWarps];
  const long stride = a.hub_blocks;
  // this block's vertices: blockIdx.x + i * stride for i = 0, 1, ...
  for (long i0 = 0; blockIdx.x + i0 * stride < a.n_vertices;
       i0 += kThreads * kChecks) {
    if (threadIdx.x == 0) count = 0;
    __syncthreads();
    int beg[kChecks], end[kChecks];
    long v[kChecks];
#pragma unroll
    for (int k = 0; k < kChecks; ++k) {
      v[k] = blockIdx.x + (i0 + threadIdx.x + k * kThreads) * stride;
      const bool in = v[k] < a.n_vertices && GR_IN_RANGE(v[k] + 1, a.n_vertices + 1L);
      beg[k] = in ? __ldg(a.offsets + v[k]) : 0;
      end[k] = in ? __ldg(a.offsets + v[k] + 1) : 0;
    }
#pragma unroll
    for (int k = 0; k < kChecks; ++k)
      if (end[k] - static_cast<long>(beg[k]) > kBlockRun)
        list[atomicAdd(&count, 1)] = static_cast<int>(v[k]);
    __syncthreads();
    const int n = count;
    for (int i = 0; i < n; ++i) {  // block-uniform
      const int hub = list[i];
      const typename T::D dv = __ldg(a.dist + hub);
      int p = kNone;
      if (T::reached(dv))
        p = scan_block<T>(a, __ldg(a.offsets + hub), __ldg(a.offsets + hub + 1),
                          dv, red);
      if (threadIdx.x == 0) a.pred[hub] = p == kNone ? -1 : p;
    }
    __syncthreads();  // count and list are written again in the next pass
  }
}

template <typename T>
__device__ void runs_role(const Args<T>& a, long block) {
  const int lane = threadIdx.x & 31;
  const long v = block * kThreads + threadIdx.x;
  const bool live = v < a.n_vertices && GR_IN_RANGE(v + 1, a.n_vertices + 1L);
  const int beg = live ? __ldg(a.offsets + v) : 0;
  const int end = live ? __ldg(a.offsets + v + 1) : 0;
  const typename T::D dv = live ? __ldg(a.dist + v) : static_cast<typename T::D>(0);
  const long len = end - static_cast<long>(beg);
  const bool scan = live && T::reached(dv);
  int p = kNone;
  if (scan && len <= kLaneRun) p = scan_lane<T>(a, beg, end, dv);
  unsigned todo = __ballot_sync(kFull, scan && len > kLaneRun && len <= kBlockRun);
  while (todo) {  // warp-uniform: one run at a time, the whole warp on it
    const int src = __ffs(todo) - 1;
    todo &= todo - 1u;
    const int q = scan_warp<T>(a, __shfl_sync(kFull, beg, src),
                               __shfl_sync(kFull, end, src),
                               __shfl_sync(kFull, dv, src), lane);
    if (lane == src) p = q;
  }
  // runs longer than kBlockRun are the hub blocks'
  if (live && len <= kBlockRun) a.pred[v] = p == kNone ? -1 : p;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) predecessors(const Args<T> a) {
  if (blockIdx.x < a.hub_blocks)
    hub_role<T>(a);
  else
    runs_role<T>(a, static_cast<long>(blockIdx.x) - a.hub_blocks);
}

template <typename T>
int launch(const void* offsets, const void* rows, const void* values,
           const void* dist, void* pred, int n_vertices, int n_slots,
           int sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_vertices < 0 || n_slots < 0 || sms < 1) return cudaErrorInvalidValue;
  if (n_vertices == 0) return cudaSuccess;
  Args<T> a{};
  a.offsets = static_cast<const int*>(offsets);
  a.rows = static_cast<const int*>(rows);
  a.values = static_cast<const float*>(values);
  a.dist = static_cast<const typename T::D*>(dist);
  a.pred = static_cast<int*>(pred);
  a.n_vertices = n_vertices;
  a.n_slots = n_slots;
  // a run longer than kBlockRun needs more slots than that in the graph
  a.hub_blocks = n_slots > kBlockRun ? (n_vertices < sms ? n_vertices : sms) : 0;
  const long runs = (n_vertices + kThreads - 1L) / kThreads;
  predecessors<T><<<static_cast<unsigned>(a.hub_blocks + runs), kThreads, 0, s>>>(a);
  return gr::finish(s);
}

}  // namespace

// offsets: int32[n_vertices + 1]; rows: int32[n_slots], ascending within
// each run; dist: int32[n_vertices] (UNREACHED = int32 max); pred:
// int32[n_vertices], written whole. sms: the card's multiprocessors (the
// hub blocks' count).
extern "C" int gr_bfs_predecessors(const void* offsets, const void* rows,
                                   const void* dist, void* pred,
                                   int n_vertices, int n_slots, int sms,
                                   void* stream) {
  return launch<Bfs>(offsets, rows, nullptr, dist, pred, n_vertices, n_slots,
                     sms, stream);
}

// As gr_bfs_predecessors, with values: float32[n_slots], the slots'
// weights, and dist: float32[n_vertices] (+inf unreached).
extern "C" int gr_sssp_predecessors(const void* offsets, const void* rows,
                                    const void* values, const void* dist,
                                    void* pred, int n_vertices, int n_slots,
                                    int sms, void* stream) {
  return launch<Sssp>(offsets, rows, values, dist, pred, n_vertices, n_slots,
                      sms, stream);
}

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
// once a whole sweep's err is below tol, or at max_sweeps. Every float sum
// is taken in an order fixed by the plan and the grid, so two launches
// give the same bits.
//
// What bounds it on this card: the barrier between block passes, the
// chains of dependent loads inside one, and L2 traffic, not device memory.
// A block pass reads the block's E/n_blocks edges (12 bytes each: source,
// weight, destination) and its V/n_blocks vertices (8 bytes each): at
// R-MAT scale 18 and 32 blocks 1.5 MB, 0.45 us at 3.35 TB/s; on a Delaunay
// mesh of 2^18 points 0.6 MB, 0.2 us, and a mesh search takes tens of
// thousands of passes. But every edge also gathers its source's value
// from L2 at random, a 32-byte sector for 4 bytes, and a grid barrier
// over 132 CTAs costs about 1 us however little the pass does.
//
// Design: one cooperative launch, one block of 512 threads an SM, every
// thread walking the same sweeps, blocks and passes, so every thread takes
// the same branches; ONE grid barrier a block pass (GridSync below: a
// ring of three counters; each CTA adds, with release semantics, 1 and
// its "lowered" bit in the high half, and its thread 0 spins with acquire
// loads). Cross-CTA data is read with __ldcg (L2, never a stale L1 line).
// The kernels count the grid barriers they pass and report them, with the
// grid's CTAs and its cluster size, beside the sweeps (run_facts).
// - min-plus, the commit deferred one pass: three scratch vectors R[0..2]
//   over V. Pass k (k counts the passes of blocks with edges) reads every
//   distance as min(d[x], R[(k-1)%3][x]), the value after pass k-1; folds
//   each run of equal destinations in a warp tile of 32 CSC slots onto its
//   first lane by a segmented shuffle min and sends one atomicMin (on the
//   int bits of a non-negative float: exact and order-free) into
//   R[k%3][v], only where it beats that value, which is exactly "the pass
//   lowered v"; meanwhile it commits R[(k-1)%3] into d for pass k-1's
//   block (a reader sees the same min before and after) and clears
//   R[(k+1)%3] for pass k-2's block, which nobody reads in pass k. An
//   edgeless block counts its pass and leaves the pending commit pending;
//   the last one is done before the kernel ends. A warp takes one tile at
//   a time, and a block that repeats keeps the warp's first tile in
//   registers.
// - PageRank, in edge tiles: a warp takes 32 consecutive CSC slots
//   (kPrTiles tiles' loads in flight at once), forms
//   q[u] * w with q = p * iw kept beside p (one gather an edge, the same
//   product as p[u] * iw[u]) and folds each run of equal destination by a
//   fixed segmented shuffle tree. A run that is whole in the tile gives
//   its vertex its new rank at once. A run that crosses tiles leaves its
//   partial, tagged with the pass, in its tile's slot (the first run's or
//   the last run's); once the warp has published all its tiles, the warp
//   that holds the vertex's last tile waits for the tags, adds the
//   partials in a fixed order (lane l takes tiles t_a + l, t_a + l + 32,
//   ..., then a fixed shuffle tree, then its own) and writes the rank: the
//   finisher is fixed by the plan, never by arrival, and no wait closes a
//   cycle (a warp waits only on tiles of lower index, all published before
//   any of their owners waits). New ranks and their q go to staging
//   vectors chosen by pass parity, never to p and q; in the next pass
//   readers of the previous block read the staging vectors while they are
//   copied into p and q, so the block stays Jacobi with no barrier between
//   its sums and its update. Vertices without in-edges take base in a
//   vertex loop (only in blocks that have any). Each CTA sums its dangling
//   change and maxes its change in a fixed order into its slot; in the
//   next pass warp 0 of every CTA folds the slots in slot order (the same
//   bits everywhere) and hands dsum and err to its other warps through
//   shared memory, so the barrier carries no fold.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (probes/pull.py
// --async, this design against the two-barrier design before it, in one
// call; device ms, then device us a block pass): the 2^18 Delaunay mesh's
// SSSP 45.5-45.7 (2.23-2.24) against 73.5-73.7 (3.60-3.61); in RCM order
// 22.2-22.3 (1.90-1.91) against 38.55-38.59; its RCM BFS 10.4-11.6
// against 20.0; R-MAT 18 SSSP 1.565-1.567 (4.31) against 2.025, BFS 0.59
// against 0.76, PageRank to tol 1e-7 4.21 (6.92) against 6.78 (11.15), to
// 1e-9 8.54-8.58 against 13.82. A grid barrier alone costs 1.0 us; two of
// them were 2.6 us of the 3.3-3.7 us mesh pass before. One thread-block
// cluster of 16 CTAs (hardware cluster barrier, 0.79 us alone) was
// 2.1-3.3x slower on every case: it holds an eighth of the SMs. An L2
// prefetch of the next block cost 3-5%; two tiles a warp at a time cost
// min-plus 4-9% and saved PageRank 3%.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kPrTiles = 2;    // PageRank's tiles a warp holds at once
constexpr int kSlotRegs = 5;   // barrier slots a lane reads: grid <= 160
constexpr int kMaxGrid = 32 * kSlotRegs;
constexpr int kVtx = 4;        // vertices a thread keeps in flight
constexpr int kFinLoads = 8;   // partials a finishing lane keeps in flight

__device__ __forceinline__ unsigned ld_acquire32(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed64(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed64(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// The slots of one barrier as a lane holds them: slots l, l + 32, ...
struct SlotRegs {
  float2 v[kSlotRegs];
};

// (sum of .x, max of .y) of a barrier's slots, the same bits in every warp
// of the grid: each lane adds its slots in turn, then a fixed shuffle tree.
__device__ __forceinline__ float2 fold_slots(const SlotRegs& r) {
  float s = 0.0f, m = 0.0f;
#pragma unroll
  for (int i = 0; i < kSlotRegs; ++i) {
    s += r.v[i].x;
    m = fmaxf(m, r.v[i].y);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(kAll, s, off);
    m = fmaxf(m, __shfl_xor_sync(kAll, m, off));
  }
  return make_float2(s, m);
}

// The grid's one barrier a pass: a ring of three arrival counters. CTA c
// stores its slot (bank epoch & 1), then adds with release semantics 1
// (and 1 << 16 if one of its threads raised `flag`) to counter epoch % 3;
// its thread 0 spins with acquire loads until all gridDim.x CTAs are in,
// and the block's barrier hands that on to its other threads. CTA 0
// clears counter (epoch + 1) % 3 before it arrives: the last spin on it
// ended before barrier epoch - 1 completed. A bank is written again two
// barriers later, after every reader is done with it.
struct GridSync {
  static constexpr int kThreads = 512;
  unsigned* count;  // u32[3]
  float2* slots;    // float2[2 * gridDim.x]
  long long n = 0;  // grid barriers this thread has passed

  // Clears the counters, then one cooperative grid barrier.
  __device__ void start() {
    if (blockIdx.x == 0 && threadIdx.x < 3) count[threadIdx.x] = 0u;
    cg::this_grid().sync();
    ++n;
  }

  // Every thread of the grid calls it; returns the OR of `flag` over the
  // grid. With kSlots, CTA c's `mine` lands in its slot.
  template <bool kSlots>
  __device__ int arrive_wait(unsigned epoch, int flag, float2 mine) {
    __shared__ unsigned word;
    const int G = gridDim.x;
    const int f = __syncthreads_or(flag);
    if (threadIdx.x == 0) {
      unsigned* cnt = count + epoch % 3u;
      if (kSlots) slots[static_cast<int>(epoch & 1u) * G + blockIdx.x] = mine;
      if (blockIdx.x == 0) count[(epoch + 1u) % 3u] = 0u;
      red_release(cnt, f ? 0x10001u : 1u);
      unsigned w;
      do {
        w = ld_acquire32(cnt);
      } while (static_cast<int>(w & 0xffffu) < G);
      word = w;
    }
    __syncthreads();
    ++n;
    return (word >> 16) != 0u;
  }

  // The slots of barrier `epoch`, as the calling lane holds them.
  __device__ SlotRegs load_slots(unsigned epoch) const {
    const int G = gridDim.x;
    const float2* bank = slots + static_cast<int>(epoch & 1u) * G;
    const int lane = threadIdx.x & 31;
    SlotRegs r;
#pragma unroll
    for (int i = 0; i < kSlotRegs; ++i) {
      const int g = lane + 32 * i;
      r.v[i] = g < G ? __ldcg(bank + g) : make_float2(0.0f, 0.0f);
    }
    return r;
  }
};

// What the launch ran, counted on the card (three words): the grid
// barriers one thread passed, the CTAs of the grid and of its cluster.
__device__ __forceinline__ void run_facts(const GridSync& sync, long long* out) {
  unsigned cluster_ctas;
  asm("mov.u32 %0, %%cluster_nctarank;" : "=r"(cluster_ctas));
  out[0] = sync.n;
  out[1] = gridDim.x;
  out[2] = cluster_ctas;
}

struct MinArgs {
  const int* rows;      // csc_rows int32[n_edges]: source of each slot
  const float* vals;    // f32[n_edges]: weight of each slot
  const int* dst;       // csc_dst int32[n_edges]: destination, ascending
  const int* v_starts;  // int32[n_blocks + 1]
  const int* e_starts;  // int32[n_blocks]
  const float* dist0;   // f32[n_vertices]
  float* dist;          // f32[n_vertices], written whole
  float* relaxed;       // f32[3 * n_vertices] scratch: R[0..2]
  unsigned* count;      // u32[3] scratch
  float2* slots;        // float2[2 * grid] scratch
  long long* out;       // int64[5]: sweeps, block passes, then run_facts'
  long long max_sweeps;
  int n_vertices;
  int n_edges;
  int n_blocks;
};

struct PrArgs {
  const int* rows;         // csc_rows int32[n_edges]
  const float* vals;       // f32[n_edges], alpha folded in
  const int* dst;          // csc_dst int32[n_edges], ascending
  const int* offsets;      // csc offsets int32[n_vertices + 1]
  const int* v_starts;     // int32[n_blocks + 1]
  const int* e_starts;     // int32[n_blocks]
  const int* zero_in;      // int32[n_blocks]: vertices without in-edges
  const float* iweights;   // f32[n_vertices]: 1 / out-weight, 0 if dangling
  const unsigned char* dangling;  // bool[n_vertices]
  const float* p0;         // f32[n_vertices]
  float* p;                // f32[n_vertices], written whole
  unsigned long long* part;  // u64[2 * n_tiles] scratch: tagged partials
  float* q;                // f32[n_vertices] scratch: p * iweights
  float* stage;            // f32[4 * n_vertices] scratch: ranks and
                           // their q by pass parity
  unsigned* count;         // u32[3] scratch
  float2* slots;           // float2[2 * grid] scratch
  long long* out;          // int64[5]: sweeps, block passes, then run_facts'
  long long max_sweeps;
  float alpha;
  float one_minus_alpha;
  float tol;
  int n_vertices;
  int n_edges;
  int n_blocks;
  int n_tiles;
};

// (sum of s, max of m) over the calling block, in a fixed order, to every
// thread. `scratch` is 64 floats of shared memory; every thread calls it.
__device__ __forceinline__ float2 block_sum_max(float s, float m, float* scratch) {
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(kAll, s, off);
    m = fmaxf(m, __shfl_down_sync(kAll, m, off));
  }
  if ((threadIdx.x & 31) == 0) {
    scratch[threadIdx.x >> 5] = s;
    scratch[32 + (threadIdx.x >> 5)] = m;
  }
  __syncthreads();
  float2 t = make_float2(0.0f, 0.0f);
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    t.x += scratch[w];
    t.y = fmaxf(t.y, scratch[32 + w]);
  }
  __syncthreads();  // scratch may be written again after this
  return t;
}

__global__ void __launch_bounds__(GridSync::kThreads, 1) sweep_min(const MinArgs a) {
  GridSync sync{a.count, a.slots};
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int n_threads = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = tid >> 5, n_warps = n_threads >> 5;
  const int V = a.n_vertices;
  const float inf = __int_as_float(0x7f800000);
  for (int v = tid; v < V; v += n_threads) {
    a.dist[v] = a.dist0[v];
    a.relaxed[v] = inf;
    a.relaxed[V + v] = inf;
    a.relaxed[2 * V + v] = inf;
  }
  sync.start();

  long long sweeps = 0, passes = 0;
  unsigned epoch = 0;    // passes of blocks with edges so far
  int pv0 = 0, pv1 = 0;  // the last of them: its R waits to be committed
  int qv0 = 0, qv1 = 0;  // the one before: its R is cleared next pass
  int cached = -1;       // the block whose first tile a warp's cs/ck/cw hold
  int cs = -1, ck = -1;
  float cw = 0.0f;
  bool changed = true;
  while (changed && sweeps < a.max_sweeps) {
    const bool forward = (sweeps & 1) == 0;
    changed = false;
    for (int i = 0; i < a.n_blocks; ++i) {
      const int b = forward ? i : a.n_blocks - 1 - i;
      const int v0 = __ldg(a.v_starts + b), v1 = __ldg(a.v_starts + b + 1);
      const int e0 = __ldg(a.e_starts + b);
      const int e1 = b + 1 < a.n_blocks ? __ldg(a.e_starts + b + 1) : a.n_edges;
      if (e1 <= e0) {  // no in-edge: one pass that lowers nothing
        ++passes;
        continue;
      }
      const int base0 = e0 & ~31;  // tiles on 128-byte lines
      const int n_t = (e1 - base0 + 31) >> 5;
      bool again;
      do {
        const unsigned k = ++epoch;
        float* cur_r = a.relaxed + static_cast<size_t>(k % 3u) * V;
        const float* prev_r = a.relaxed + static_cast<size_t>((k + 2u) % 3u) * V;
        float* next_r = a.relaxed + static_cast<size_t>((k + 1u) % 3u) * V;
        // (c) pass k-1's first kVtx values of this thread to commit, in
        // flight with the tiles' loads
        float cx[kVtx];
#pragma unroll
        for (int j = 0; j < kVtx; ++j) {
          const int v = pv0 + tid + j * n_threads;
          cx[j] = v < pv1 && GR_IN_RANGE(v, V) ? __ldcg(prev_r + v) : inf;
        }
        // (a, b) the candidates of the warp's tiles; a block's repeated
        // pass takes the warp's first tile from registers
        int lowered = 0;
        const bool reuse = b == cached;
        for (int t = warp; t < n_t; t += n_warps) {  // warp-uniform
          int s = -1, key = -1;
          float w = 0.0f;
          if (t == warp && reuse) {
            s = cs;
            key = ck;
            w = cw;
          } else {
            const int e = base0 + 32 * t + lane;
            if (e >= e0 && e < e1 && GR_IN_RANGE(e, a.n_edges)) {
              const int ss = __ldg(a.rows + e), kk = __ldg(a.dst + e);
              if (GR_IN_RANGE(ss, V) && GR_IN_RANGE(kk, V)) {
                s = ss;
                key = kk;
                w = __ldg(a.vals + e);
              }
            }
            if (t == warp) {
              cs = s;
              ck = key;
              cw = w;
            }
          }
          float cand = inf, cur = inf;
          if (key >= 0) {
            float ds = __ldcg(a.dist + s);
            if (s >= pv0 && s < pv1) ds = fminf(ds, __ldcg(prev_r + s));
            float dk = __ldcg(a.dist + key);
            if (key >= pv0 && key < pv1) dk = fminf(dk, __ldcg(prev_r + key));
            cand = ds + w;
            cur = dk;
          }
          // lane l ends with the min over [l, end of its run]: runs are
          // contiguous, so an equal key `off` lanes on is in the same run
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const float c = __shfl_down_sync(kAll, cand, off);
            const int kk = __shfl_down_sync(kAll, key, off);
            if (lane + off < 32 && kk == key) cand = fminf(cand, c);
          }
          const int prev = __shfl_up_sync(kAll, key, 1);
          if (key >= 0 && (lane == 0 || prev != key) && cand < cur) {
            gr::atomic_min_float(cur_r + key, cand);
            lowered = 1;
          }
        }
        cached = b;
        // (c) commit pass k-1 (x < d[v]: only lower values land in R);
        // (d) clear pass k-2's R, which nobody reads in this pass
#pragma unroll
        for (int j = 0; j < kVtx; ++j)
          if (cx[j] != inf) a.dist[pv0 + tid + j * n_threads] = cx[j];
        for (int v = pv0 + tid + kVtx * n_threads; v < pv1; v += n_threads) {
          if (!GR_IN_RANGE(v, V)) continue;
          const float x = __ldcg(prev_r + v);
          if (x != inf) a.dist[v] = x;
        }
        for (int v = qv0 + tid; v < qv1; v += n_threads)
          if (GR_IN_RANGE(v, V)) next_r[v] = inf;
        again = sync.arrive_wait<false>(k, lowered, make_float2(0.0f, 0.0f)) != 0;
        qv0 = pv0;
        qv1 = pv1;
        pv0 = v0;
        pv1 = v1;
        ++passes;
        changed |= again;
      } while (again);
    }
    ++sweeps;
  }
  // the last pass's lowered values
  const float* last_r = a.relaxed + static_cast<size_t>(epoch % 3u) * V;
  for (int v = pv0 + tid; v < pv1; v += n_threads) {
    if (!GR_IN_RANGE(v, V)) continue;
    const float x = __ldcg(last_r + v);
    if (x != inf) a.dist[v] = x;
  }
  if (tid == 0) {
    a.out[0] = sweeps;
    a.out[1] = passes;
    run_facts(sync, a.out + 2);
  }
}

__global__ void __launch_bounds__(GridSync::kThreads, 1) sweep_pr(const PrArgs a) {
  __shared__ float red[64];
  __shared__ float2 s_fold;  // the last barrier's slots folded by warp 0
  __shared__ unsigned s_tag;  // the pass whose slots s_fold holds
  GridSync sync{a.count, a.slots};
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int n_threads = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = tid >> 5, n_warps = n_threads >> 5;
  const bool warp0 = threadIdx.x < 32;
  const int V = a.n_vertices;
  const float inf = __int_as_float(0x7f800000);
  if (threadIdx.x == 0) s_tag = 0u;
  // barrier e's slots folded, to every thread of the block: warp 0 reads
  // them (one warp a CTA, so the slots' lines are not a hot spot)
  auto cta_fold = [&](unsigned e) {
    if (warp0) {
      const float2 t = fold_slots(sync.load_slots(e));
      if (lane == 0) s_fold = t;
    }
    __syncthreads();
    const float2 t = s_fold;
    __syncthreads();
    return t;
  };

  // p = p0, the tags cleared, and the dangling mass slot by slot
  float mine = 0.0f;
  for (int v = tid; v < V; v += n_threads) {
    const float x = a.p0[v];
    a.p[v] = x;
    a.q[v] = x * a.iweights[v];
    if (a.dangling[v]) mine += a.alpha * x;
  }
  for (int q = tid; q < 2 * a.n_tiles; q += n_threads) a.part[q] = 0ull;
  sync.start();
  unsigned epoch = 1;
  sync.arrive_wait<true>(epoch, 0, block_sum_max(mine, 0.0f, red));
  float dsum = cta_fold(epoch).x;

  long long sweeps = 0, passes = 0;
  float err = inf;
  int pv0 = 0, pv1 = 0;  // the last pass's block: its ranks in stage[epoch & 1]
  bool pending = false;  // the last pass's slots not yet folded into dsum, err
  while (err >= a.tol && sweeps < a.max_sweeps) {
    const bool forward = (sweeps & 1) == 0;
    err = 0.0f;
    for (int i = 0; i < a.n_blocks; ++i) {
      const int b = forward ? i : a.n_blocks - 1 - i;
      const int v0 = __ldg(a.v_starts + b), v1 = __ldg(a.v_starts + b + 1);
      if (v1 <= v0) continue;  // no vertex: the pass changes nothing
      const int e0 = __ldg(a.e_starts + b);
      const int e1 = b + 1 < a.n_blocks ? __ldg(a.e_starts + b + 1) : a.n_edges;
      const int base0 = e0 & ~31;
      const int n_t = (e1 - base0 + 31) >> 5;
      const unsigned k = ++epoch;
      float* st_new = a.stage + static_cast<size_t>(k & 1u) * V;
      const float* st_old = a.stage + static_cast<size_t>((k - 1u) & 1u) * V;
      float* qst_new = st_new + 2 * static_cast<size_t>(V);
      const float* qst_old = st_old + 2 * static_cast<size_t>(V);
      // the last pass's slots (warp 0) and this thread's first kVtx ranks
      // to copy, in flight with the tiles' loads
      SlotRegs prev_slots;
      if (warp0 && pending) prev_slots = sync.load_slots(k - 1u);
      float cx[kVtx], cq[kVtx];
#pragma unroll
      for (int j = 0; j < kVtx; ++j) {
        const int v = pv0 + tid + j * n_threads;
        const bool in = v < pv1 && GR_IN_RANGE(v, V);
        cx[j] = in ? __ldcg(st_old + v) : 0.0f;
        cq[j] = in ? __ldcg(qst_old + v) : 0.0f;
      }
      float base = 0.0f;  // (1 - alpha + dsum) / V, once dsum is folded
      // warp 0 folds the last pass's slots and hands them on through
      // shared memory; the other warps wait for the tag, not a barrier
      auto fold = [&]() {
        if (pending) {
          float2 t;
          if (warp0) {
            t = fold_slots(prev_slots);
            if (lane == 0) {
              s_fold = t;
              __threadfence_block();
              *reinterpret_cast<volatile unsigned*>(&s_tag) = k;
            }
          } else {
            while (*reinterpret_cast<volatile unsigned*>(&s_tag) != k) {
            }
            __threadfence_block();
            const volatile float* f = reinterpret_cast<volatile float*>(&s_fold);
            t = make_float2(f[0], f[1]);
          }
          dsum = dsum + a.alpha * t.x;
          err = fmaxf(err, t.y);
          pending = false;
        }
        base = (a.one_minus_alpha + dsum) / static_cast<float>(V);
      };
      // the rank of x before this pass
      auto rank = [&](int x) {
        return x >= pv0 && x < pv1 ? __ldcg(st_old + x) : __ldcg(a.p + x);
      };
      // p[x] * iw[x] before this pass: one gather an edge, not two
      auto qrank = [&](int x) {
        return x >= pv0 && x < pv1 ? __ldcg(qst_old + x) : __ldcg(a.q + x);
      };
      float dd = 0.0f, de = 0.0f;
      auto finish = [&](int v, float s, float old, bool dang, float iw) {
        const float nw = base + s;
        st_new[v] = nw;
        qst_new[v] = nw * iw;
        const float d = nw - old;
        if (dang) dd += d;
        de = fmaxf(de, fabsf(d));
      };
      bool folded = false;
      // warp tiles of 32 CSC slots, kPrTiles at a time, in increasing order
      for (int r0 = 0; warp + r0 * n_warps < n_t; r0 += kPrTiles) {  // warp-uniform
        int key[kPrTiles], u[kPrTiles], before[kPrTiles], after[kPrTiles], first[kPrTiles];
        float w[kPrTiles], term[kPrTiles], old[kPrTiles], iwk[kPrTiles];
        bool dang[kPrTiles];
#pragma unroll
        for (int r = 0; r < kPrTiles; ++r) {
          const int tb = base0 + 32 * (warp + (r0 + r) * n_warps);
          const int e = tb + lane;
          key[r] = u[r] = before[r] = after[r] = -1;
          first[r] = 0;
          w[r] = 0.0f;
          if (e >= e0 && e < e1 && GR_IN_RANGE(e, a.n_edges)) {
            const int uu = __ldg(a.rows + e), kk = __ldg(a.dst + e);
            if (GR_IN_RANGE(uu, V) && GR_IN_RANGE(kk, V)) {
              u[r] = uu;
              key[r] = kk;
              w[r] = __ldg(a.vals + e);
            }
          }
          if (lane == 0 && tb - 1 >= e0 && tb - 1 < e1 && GR_IN_RANGE(tb - 1, a.n_edges))
            before[r] = __ldg(a.dst + tb - 1);
          if (lane == 31 && tb + 32 < e1 && GR_IN_RANGE(tb + 32, a.n_edges))
            after[r] = __ldg(a.dst + tb + 32);
        }
#pragma unroll
        for (int r = 0; r < kPrTiles; ++r) {
          term[r] = 0.0f;
          old[r] = 0.0f;
          iwk[r] = 0.0f;
          dang[r] = false;
          if (key[r] >= 0) {
            term[r] = qrank(u[r]) * w[r];
            old[r] = rank(key[r]);
            iwk[r] = __ldg(a.iweights + key[r]);
            dang[r] = a.dangling[key[r]] != 0;
            if (lane == 0) first[r] = __ldg(a.offsets + key[r]);
          }
        }
        if (!folded) {
          fold();
          folded = true;
        }
        // every tile's runs folded and its partials published before any
        // wait, so a wait never stands behind another
        bool fin[kPrTiles];
        float own[kPrTiles];
#pragma unroll
        for (int r = 0; r < kPrTiles; ++r) {
          const int t = warp + (r0 + r) * n_warps;
          // lane l ends with the sum over [l, end of its run], a fixed tree
          float x = term[r];
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const float c = __shfl_down_sync(kAll, x, off);
            const int kk = __shfl_down_sync(kAll, key[r], off);
            if (lane + off < 32 && kk == key[r]) x += c;
          }
          const int prev = __shfl_up_sync(kAll, key[r], 1);
          const int key31 = __shfl_sync(kAll, key[r], 31);
          const int after31 = __shfl_sync(kAll, after[r], 31);
          const bool head = key[r] >= 0 && (lane == 0 || prev != key[r]);
          const bool cont_before = head && lane == 0 && before[r] == key[r];
          const bool cont_after = head && key[r] == key31 && after31 == key[r];
          const unsigned long long tag =
              (static_cast<unsigned long long>(k) << 32) | __float_as_uint(x);
          if (cont_before && cont_after) {  // a middle tile: the first run's slot
            if (GR_IN_RANGE(2 * t, 2 * a.n_tiles)) st_relaxed64(a.part + 2 * t, tag);
          } else if (cont_after) {  // the vertex's first tile: the last run's slot
            if (GR_IN_RANGE(2 * t + 1, 2 * a.n_tiles)) st_relaxed64(a.part + 2 * t + 1, tag);
          } else if (head && !cont_before) {
            finish(key[r], x, old[r], dang[r], iwk[r]);  // whole in this tile
          }
          fin[r] = __shfl_sync(kAll, cont_before && !cont_after ? 1 : 0, 0) != 0;
          own[r] = x;
        }
#pragma unroll
        for (int r = 0; r < kPrTiles; ++r) {
          if (!fin[r]) continue;  // warp-uniform
          // the vertex's last tile: add the earlier tiles' partials, lane l
          // tiles ta + l, ta + l + 32, ... in turn, kFinLoads in flight
          const int t = warp + (r0 + r) * n_warps;
          const int ta = (__shfl_sync(kAll, first[r], 0) - base0) >> 5;
          float sum = 0.0f;
          for (int q0 = ta + lane; q0 < t; q0 += 32 * kFinLoads) {
            unsigned long long y[kFinLoads];
#pragma unroll
            for (int j = 0; j < kFinLoads; ++j) {
              const int q = q0 + 32 * j;
              const int slot = 2 * q + (q == ta ? 1 : 0);
              y[j] = q < t && GR_IN_RANGE(slot, 2 * a.n_tiles)
                         ? ld_relaxed64(a.part + slot)
                         : static_cast<unsigned long long>(k) << 32;
            }
            // the ones not yet tagged with this pass, read again together
            bool ready = false;
            while (!ready) {
              ready = true;
#pragma unroll
              for (int j = 0; j < kFinLoads; ++j) {
                if (static_cast<unsigned>(y[j] >> 32) == k) continue;
                ready = false;
                const int q = q0 + 32 * j;
                y[j] = ld_relaxed64(a.part + 2 * q + (q == ta ? 1 : 0));
              }
            }
#pragma unroll
            for (int j = 0; j < kFinLoads; ++j)
              if (q0 + 32 * j < t) sum += __uint_as_float(static_cast<unsigned>(y[j]));
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kAll, sum, off);
          if (lane == 0) finish(key[r], sum + own[r], old[r], dang[r], iwk[r]);
        }
      }
      if (!folded) fold();
      // vertices without in-edges take base, kVtx a thread in flight
      if (__ldg(a.zero_in + b) > 0) {
        for (int v = v0 + tid; v < v1; v += kVtx * n_threads) {
          bool zero[kVtx];
#pragma unroll
          for (int j = 0; j < kVtx; ++j) {
            const int x = v + j * n_threads;
            zero[j] = x < v1 && GR_IN_RANGE(x + 1, V + 1) &&
                      __ldg(a.offsets + x) == __ldg(a.offsets + x + 1);
          }
          float was[kVtx], iw[kVtx];
          bool dang[kVtx];
#pragma unroll
          for (int j = 0; j < kVtx; ++j) {
            was[j] = zero[j] ? rank(v + j * n_threads) : 0.0f;
            iw[j] = zero[j] ? __ldg(a.iweights + v + j * n_threads) : 0.0f;
            dang[j] = zero[j] && a.dangling[v + j * n_threads] != 0;
          }
#pragma unroll
          for (int j = 0; j < kVtx; ++j)
            if (zero[j]) finish(v + j * n_threads, 0.0f, was[j], dang[j], iw[j]);
        }
      }
      // the last pass's ranks into p
#pragma unroll
      for (int j = 0; j < kVtx; ++j) {
        const int v = pv0 + tid + j * n_threads;
        if (v < pv1 && GR_IN_RANGE(v, V)) {
          a.p[v] = cx[j];
          a.q[v] = cq[j];
        }
      }
      for (int v = pv0 + tid + kVtx * n_threads; v < pv1; v += n_threads) {
        if (!GR_IN_RANGE(v, V)) continue;
        a.p[v] = __ldcg(st_old + v);
        a.q[v] = __ldcg(qst_old + v);
      }
      sync.arrive_wait<true>(k, 0, block_sum_max(dd, de, red));
      ++passes;
      pending = true;
      pv0 = v0;
      pv1 = v1;
    }
    if (pending) {  // the sweep's last pass decides whether another follows
      const float2 t = cta_fold(epoch);
      dsum = dsum + a.alpha * t.x;
      err = fmaxf(err, t.y);
      pending = false;
    }
    ++sweeps;
  }
  // the last pass's ranks
  const float* last = a.stage + static_cast<size_t>(epoch & 1u) * V;
  for (int v = pv0 + tid; v < pv1; v += n_threads)
    if (GR_IN_RANGE(v, V)) a.p[v] = __ldcg(last + v);
  if (tid == 0) {
    a.out[0] = sweeps;
    a.out[1] = passes;
    run_facts(sync, a.out + 2);
  }
}

// Launches `kernel` cooperatively, one block an SM at most (no more than
// the co-resident blocks, max_grid and kMaxGrid); cudaErrorNotSupported
// where the device has no cooperative launch.
template <typename Kernel>
cudaError_t launch(Kernel kernel, void** params, int max_grid, cudaStream_t s) {
  static int grid_blocks = -1;  // one card per process
  if (grid_blocks < 0) {
    int dev = 0, sms = 0;
    const int coresident = gr::coresident_blocks(kernel, GridSync::kThreads);
    grid_blocks = 0;
    if (coresident > 0 && cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ==
            cudaSuccess)
      grid_blocks = coresident < sms ? coresident : sms;
    if (grid_blocks > kMaxGrid) grid_blocks = kMaxGrid;
  }
  if (grid_blocks == 0) return cudaErrorNotSupported;
  const int blocks = grid_blocks < max_grid ? grid_blocks : max_grid;
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                     dim3(blocks), dim3(GridSync::kThreads),
                                     params, 0, s);
}

}  // namespace

// dist: f32[n_vertices], written whole. scratch (nothing in it needs to be
// set): float2[2 * max_grid], u32[4], then f32[3 * n_vertices].
// out: int64[5] = {sweeps, block passes, grid barriers, CTAs, CTAs a
// cluster}. Returns cudaErrorNotSupported where the device takes no such
// launch.
extern "C" int gr_gs_sweep_min(const void* rows, const void* vals,
                               const void* dst, const void* v_starts,
                               const void* e_starts, const void* dist0,
                               void* dist, void* scratch, void* out,
                               int n_vertices, int n_edges, int n_blocks,
                               long long max_sweeps, int max_grid,
                               void* stream) {
  if (n_blocks < 1 || max_grid < 1) return cudaErrorInvalidValue;
  MinArgs a{};
  a.rows = static_cast<const int*>(rows);
  a.vals = static_cast<const float*>(vals);
  a.dst = static_cast<const int*>(dst);
  a.v_starts = static_cast<const int*>(v_starts);
  a.e_starts = static_cast<const int*>(e_starts);
  a.dist0 = static_cast<const float*>(dist0);
  a.dist = static_cast<float*>(dist);
  a.slots = static_cast<float2*>(scratch);
  a.count = reinterpret_cast<unsigned*>(a.slots + 2 * max_grid);
  a.relaxed = reinterpret_cast<float*>(a.count + 4);
  a.out = static_cast<long long*>(out);
  a.max_sweeps = max_sweeps;
  a.n_vertices = n_vertices;
  a.n_edges = n_edges;
  a.n_blocks = n_blocks;
  void* params[] = {&a};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch(sweep_min, params, max_grid, s);
  if (err != cudaSuccess) return err;
  return gr::finish(s);
}

// p: f32[n_vertices], written whole. offsets: the csc offsets; zero_in:
// each block's vertices without in-edges. scratch (nothing in it needs to
// be set): u64[2 * n_tiles], float2[2 * max_grid], u32[4], then
// f32[5 * n_vertices]; n_tiles >= the warp tiles of any block, (n_edges +
// 62) / 32 + 1 will do. out: int64[5] = {sweeps, block passes, grid
// barriers, CTAs, CTAs a cluster}. Returns cudaErrorNotSupported where the
// device takes no such launch.
extern "C" int gr_gs_sweep_pr(const void* rows, const void* vals,
                              const void* dst, const void* offsets,
                              const void* v_starts, const void* e_starts,
                              const void* zero_in, const void* iweights,
                              const void* dangling,
                              const void* p0, void* p, void* scratch,
                              void* out, int n_vertices, int n_edges,
                              int n_blocks, int n_tiles, long long max_sweeps,
                              float alpha, float one_minus_alpha, float tol,
                              int max_grid, void* stream) {
  if (n_blocks < 1 || max_grid < 1 || n_vertices < 1 || n_tiles < 1)
    return cudaErrorInvalidValue;
  PrArgs a{};
  a.rows = static_cast<const int*>(rows);
  a.vals = static_cast<const float*>(vals);
  a.dst = static_cast<const int*>(dst);
  a.offsets = static_cast<const int*>(offsets);
  a.v_starts = static_cast<const int*>(v_starts);
  a.e_starts = static_cast<const int*>(e_starts);
  a.zero_in = static_cast<const int*>(zero_in);
  a.iweights = static_cast<const float*>(iweights);
  a.dangling = static_cast<const unsigned char*>(dangling);
  a.p0 = static_cast<const float*>(p0);
  a.p = static_cast<float*>(p);
  a.part = static_cast<unsigned long long*>(scratch);
  a.slots = reinterpret_cast<float2*>(a.part + 2 * static_cast<size_t>(n_tiles));
  a.count = reinterpret_cast<unsigned*>(a.slots + 2 * max_grid);
  a.q = reinterpret_cast<float*>(a.count + 4);
  a.stage = a.q + n_vertices;
  a.out = static_cast<long long*>(out);
  a.max_sweeps = max_sweeps;
  a.alpha = alpha;
  a.one_minus_alpha = one_minus_alpha;
  a.tol = tol;
  a.n_vertices = n_vertices;
  a.n_edges = n_edges;
  a.n_blocks = n_blocks;
  a.n_tiles = n_tiles;
  void* params[] = {&a};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch(sweep_pr, params, max_grid, s);
  if (err != cudaSuccess) return err;
  return gr::finish(s);
}


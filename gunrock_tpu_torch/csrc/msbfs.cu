// Bit-parallel multi-source BFS (Then et al., "The More the Merrier:
// Efficient Multi-Source Graph Traversal", VLDB 2015): K searches share a
// level as bits, search k being bit k % 32 of word k / 32 of a vertex.
//
// Replaces no TPU kernel. The JAX package's msbfs_kernel runs its searches
// through B4, the bucketed SpMM over the unit pull layout
// (gunrock_tpu/ops/pallas/spmm.py:85), with the frontier a float32 [V, K]
// one-hot; that kernel stays, and still serves BC, batch PageRank, PPR and
// SpMV. Here the frontier is K bits a vertex: at K = 32 and 2^20 vertices a
// 4 MB word array in place of a 128 MB float one, and a level one pass.
//
// Contract of a level L (gr_msbfs_pull). front, seen and next are
// uint32[V, nw] (nw = ceil(K / 32)), bits at and past K zero. aux holds
// three slots of nw + ceil(V / 32) words: a slot's live words (the OR of a
// frontier's words: the searches it holds) and its frontier bitmap (bit v
// % 32 of word v / 32: whether v's frontier row is not zero). Level L reads
// slot L % 3, ORs the next frontier into slot (L + 1) % 3 (zero before)
// and zeroes slot (L + 2) % 3 for level L + 1. For each vertex v and word
// w whose unseen live bits need = ~seen[v, w] & kmask(w) & live[w] are not
// zero:
//   acc        = OR of front[u, w] over v's in-neighbours u, the slots
//                csc_offsets[v] .. csc_offsets[v + 1] of csc_rows;
//   next[v, w] = acc & need;  seen[v, w] |= next[v, w];
//   dist[v, k] = L + 1 for each bit k of word w set in next[v, w].
// A search not in live has no frontier vertex, so it gains no vertex at L:
// leaving it out of need changes no result, and keeps a search that has
// ended (its source in a small component) from stopping every early exit.
// Every other word of next is 0: next is written whole, so it needs no
// memset, and the caller swaps front and next between levels. Counters,
// uint64[3]: counts[(L + 1) & 1] gets the vertices whose next row is not
// zero (the next level's frontier) and counts[L & 1], which the host read
// before this launch, is zeroed for level L + 1; counts[2] gets the slots
// the level needed: for each scanned (v, w), the slots of v's run up to
// and including the one at which acc covers need, or the whole run where
// it never does. gr_msbfs_start writes the start: the sources' bits in
// front, seen and aux slot 0 (zeroed by the caller), dist[src[k], k] = 0,
// counts[0] the distinct source vertices, counts[1] and counts[2] zero.
//
// What bounds it on this card: csc_rows, 126 MB at a scale-20 Kronecker
// graph, streamed once at most, and one gather a slot from the frontier:
// 0.04 ms of DRAM, but ~1 GB of 32-byte L2 sectors for a level that reads
// every slot (the 4 MB word array stays in L2, not in L1). The design
// reads fewer:
//  - Early exit. A vertex whose live searches have all reached it costs
//    one 4-byte read of seen (and its offsets). A scan stops at the slot
//    where acc covers need; on a degree-sorted graph a run starts at the
//    hubs, which every search reaches within two levels.
//  - The frontier bitmap, 128 KB at 2^20 vertices, stays in L1: a slot
//    whose source is off the frontier costs an L1 hit, not an L2 sector.
//    The first levels, which scan nearly every slot from a frontier of a
//    few hundred vertices, gather almost nothing from L2.
//  - Work split by run length, as csrc/predecessors.cu splits it. Runs
//    blocks (blockIdx >= hub_blocks) take 512 consecutive vertices, a warp
//    32 of them (one bitmap word): a run of at most kLaneRun slots is
//    scanned by its own lane, kLaneLoads slots in flight; a run of up to
//    kBlockRun slots by the whole warp, strides OR-reduced with
//    __reduce_or_sync: a first one of 32 x kWarpLoads slots, where an early
//    exit mostly falls, then longer ones, so that a warp of long runs that
//    never covers (the first levels) waits on fewer round trips. Hub blocks (one an SM) own the
//    longer runs: block b checks vertices b, b + hub_blocks, ... (the hubs
//    a degree sort puts first spread one a block), lists those with a
//    word to scan and scans each in rounds of kThreads x kBlockLoads
//    slots, the block's OR reduced each round.
//  - The covering stride or round is scanned again in slot order, by an
//    inclusive OR scan over the lanes (and, in a hub block, over the
//    warps), so that counts[2] is exact; the prefix OR only grows, so the
//    first covering slot is the count of lanes that do not cover.
//  - csc_rows streamed past L2 (__ldcs); the bitmap and front through the
//    read-only path (__ldg).
//  - dist written a row at a time: lane k of a warp stores column 32 w + k
//    where bit k is set, one coalesced 128-byte row per vertex and word
//    that gained searches.
//  - One atomic a block and counter or live word, one a warp and bitmap
//    word; one launch, no host sync, no allocation.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;      // threads a block, in both roles
constexpr int kWarps = kThreads / 32;
constexpr int kLaneRun = 32;       // runs up to this many slots: one lane
constexpr int kBlockRun = 2048;    // runs over this many slots: one block
constexpr int kLaneLoads = 8;      // slots a lane scan has in flight at first
constexpr int kLaneLoadsAfter = 8;  // and after
constexpr int kWarpLoads = 4;      // a lane's slots in a warp's first stride (128)
constexpr int kWarpLoadsAfter = 16;  // and in each later one (512)
constexpr int kBlockLoads = 8;     // a thread's slots in a block round (4096)
constexpr int kChecks = 4;         // vertices a hub-block thread checks at once
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const int* offsets;          // int32[n_vertices + 1], the CSC runs
  const int* rows;             // int32[n_slots], each slot's source
  const unsigned* front;       // uint32[n_vertices, n_words], level L's frontier
  unsigned* seen;              // uint32[n_vertices, n_words], updated in place
  unsigned* next;              // uint32[n_vertices, n_words], written whole
  const unsigned* live;        // aux slot L % 3: live words, then bitmap
  unsigned* live_next;         // aux slot (L + 1) % 3, ORed into
  unsigned* live_clear;        // aux slot (L + 2) % 3, zeroed
  int* dist;                   // int32[n_vertices, n_searches]
  unsigned long long* counts;  // uint64[3]
  int n_vertices;
  int n_slots;
  int n_words;
  int n_searches;
  int level;
  int hub_blocks;              // 0 where no run can be longer than kBlockRun
};

// The bits of word w that hold searches: all 32 but in the last word.
__device__ __forceinline__ unsigned word_mask(int n_searches, int w) {
  const int bits = n_searches - 32 * w;
  return bits >= 32 ? kFull : (1u << bits) - 1u;
}

// N slots of a run, `step` apart from s0, and their sources' words w: 0
// for a slot at or past `end` and for a source off the frontier bitmap.
// Each stage's loads are issued before the next stage's first use.
template <int N>
struct Words {
  unsigned f[N];

  __device__ __forceinline__ void load(const Args& a, long s0, long step,
                                       long end, int w) {
    const unsigned* bitmap = a.live + a.n_words;
    int u[N];
    unsigned b[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const long s = s0 + j * step;
      u[j] = s < end && GR_IN_RANGE(s, a.n_slots) ? __ldcs(a.rows + s) : -1;
    }
#pragma unroll
    for (int j = 0; j < N; ++j)
      b[j] = u[j] >= 0 && GR_IN_RANGE(u[j], a.n_vertices)
                 ? __ldg(bitmap + (u[j] >> 5)) >> (u[j] & 31)
                 : 0u;
#pragma unroll
    for (int j = 0; j < N; ++j)
      f[j] = b[j] & 1u ? __ldg(a.front + static_cast<long>(u[j]) * a.n_words + w)
                       : 0u;
  }
};

__device__ __forceinline__ unsigned inclusive_or(unsigned x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x |= y;
  }
  return x;
}

// The OR of `v` over the block, to every thread; `red`: kWarps words of
// shared memory. Every thread must call it.
__device__ __forceinline__ unsigned block_or(unsigned v, unsigned* red) {
  v = __reduce_or_sync(kFull, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned all = 0u;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) all |= red[i];
  __syncthreads();  // red is written again by the next call
  return all;
}

// kLaneLoads or kLaneLoadsAfter (N) slots of a lane's scan from s0: true
// where one of them covers `need`, `used` then adding the slots up to it;
// else s0 moves past them.
template <int N>
__device__ __forceinline__ bool lane_step(const Args& a, long& s0, long beg,
                                          long end, int w, unsigned need,
                                          unsigned& acc,
                                          unsigned long long& used) {
  Words<N> x;
  x.load(a, s0, 1, end, w);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    acc |= x.f[j];
    if ((acc & need) == need) {
      used += s0 - beg + j + 1;
      return true;
    }
  }
  s0 += N;
  return false;
}

// A short run [beg, end) scanned by one lane for the bits `need`: the OR
// of its sources' words, up to the slot that covers `need`. Adds the slots
// up to it (the run where none does) to `used`.
__device__ unsigned scan_lane(const Args& a, long beg, long end, int w,
                              unsigned need, unsigned long long& used) {
  unsigned acc = 0u;
  long s0 = beg;
  if (s0 < end && lane_step<kLaneLoads>(a, s0, beg, end, w, need, acc, used))
    return acc;
  while (s0 < end)
    if (lane_step<kLaneLoadsAfter>(a, s0, beg, end, w, need, acc, used))
      return acc;
  used += end - beg;
  return acc;
}

// One stride of a warp's scan from s0, N slots a lane: slot s0 + 32 j +
// lane is lane's j-th. True where the stride covers `need`, `used` then
// set to the slots up to its covering slot, found in slot order; else s0
// moves past it. The same in every lane.
template <int N>
__device__ __forceinline__ bool warp_step(const Args& a, long& s0, long beg,
                                          long end, int w, unsigned need,
                                          int lane, unsigned& acc,
                                          long& used) {
  Words<N> x;
  x.load(a, s0 + lane, 32, end, w);
  unsigned mine = 0u;
#pragma unroll
  for (int j = 0; j < N; ++j) mine |= x.f[j];
  const unsigned all = acc | __reduce_or_sync(kFull, mine);
  if ((all & need) != need) {
    acc = all;
    s0 += 32 * N;
    return false;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const unsigned p = acc | inclusive_or(x.f[j], lane);
    const unsigned cover = __ballot_sync(kFull, (p & need) == need);
    if (cover) {
      used = s0 - beg + 32 * j + (32 - __popc(cover)) + 1;
      break;
    }
    acc = __shfl_sync(kFull, p, 31);
  }
  acc = all;
  return true;
}

// A run [beg, end) scanned by the whole warp (every lane calls it with the
// same run): a first stride of 32 x kWarpLoads slots, then strides of 32 x
// kWarpLoadsAfter. Returns the same to every lane, and sets `used`
// likewise.
__device__ unsigned scan_warp(const Args& a, long beg, long end, int w,
                              unsigned need, int lane, long& used) {
  unsigned acc = 0u;
  long s0 = beg;
  if (warp_step<kWarpLoads>(a, s0, beg, end, w, need, lane, acc, used))
    return acc;
  while (s0 < end)
    if (warp_step<kWarpLoadsAfter>(a, s0, beg, end, w, need, lane, acc, used))
      return acc;
  used = end - beg;
  return acc;
}

// A long run [beg, end) scanned by the whole block (every thread calls it
// with the same run), in rounds of kThreads x kBlockLoads slots; slot s0 +
// kThreads j + threadIdx.x is the thread's j-th. `red`: kWarps words of
// shared memory. Returns the same to every thread, and sets `used`
// likewise.
__device__ unsigned scan_block(const Args& a, long beg, long end, int w,
                               unsigned need, unsigned* red, long& used) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned acc = 0u;
  for (long s0 = beg; s0 < end; s0 += kThreads * kBlockLoads) {
    Words<kBlockLoads> x;
    x.load(a, s0 + threadIdx.x, kThreads, end, w);
    unsigned mine = 0u;
#pragma unroll
    for (int j = 0; j < kBlockLoads; ++j) mine |= x.f[j];
    const unsigned all = acc | block_or(mine, red);
    if ((all & need) != need) {
      acc = all;
      continue;
    }
    // this round covers: find its covering slot in slot order
#pragma unroll
    for (int j = 0; j < kBlockLoads; ++j) {
      const unsigned p = inclusive_or(x.f[j], lane);
      if (lane == 31) red[warp] = p;
      __syncthreads();
      unsigned before = acc, total = acc;
      for (int i = 0; i < kWarps; ++i) {
        if (i < warp) before |= red[i];
        total |= red[i];
      }
      // also the barrier before red is written again
      const int cover = __syncthreads_count(((before | p) & need) == need);
      if (cover) {
        used = s0 - beg + static_cast<long>(kThreads) * j + (kThreads - cover) + 1;
        return all;
      }
      acc = total;
    }
  }
  used = end - beg;
  return acc;
}

// Lane k of the calling warp writes dist[v, 32 w + k] = level + 1 where bit
// k of `bits` is set.
__device__ __forceinline__ void write_row(const Args& a, long v, int w,
                                          unsigned bits, int lane) {
  if ((bits >> lane) & 1u) {
    const long i = v * a.n_searches + 32 * w + lane;
    if (GR_IN_RANGE(i, static_cast<long>(a.n_vertices) * a.n_searches))
      a.dist[i] = a.level + 1;
  }
}

// Adds the block's `found` and `used` to the counters, one atomic each.
// Every thread of the block must call it.
__device__ void add_counts(const Args& a, unsigned found,
                           unsigned long long used) {
  __shared__ unsigned long long sum[2];
  if (threadIdx.x == 0) sum[0] = sum[1] = 0ull;
  __syncthreads();
  found = __reduce_add_sync(kFull, found);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    used += __shfl_down_sync(kFull, used, off);
  if ((threadIdx.x & 31) == 0) {
    if (found) atomicAdd(&sum[0], static_cast<unsigned long long>(found));
    if (used) atomicAdd(&sum[1], used);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (sum[0]) atomicAdd(a.counts + ((a.level + 1) & 1), sum[0]);
    if (sum[1]) atomicAdd(a.counts + 2, sum[1]);
  }
}

__device__ void hub_role(const Args& a) {
  __shared__ int list[kThreads * kChecks];
  __shared__ int count;
  __shared__ unsigned red[kWarps];
  const int lane = threadIdx.x & 31;
  const long stride = a.hub_blocks;
  unsigned found = 0u;            // thread 0's
  unsigned long long used = 0ull;  // thread 0's
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
    // a long run is listed where a word of it needs a scan; where none
    // does, its next row is written here, so that a level that scans
    // nothing costs a hub block no pass over its hubs
#pragma unroll
    for (int k = 0; k < kChecks; ++k) {
      if (end[k] - static_cast<long>(beg[k]) <= kBlockRun) continue;
      bool scan = false;
      for (int w = 0; w < a.n_words; ++w)
        scan = scan || (~a.seen[v[k] * a.n_words + w] &
                        word_mask(a.n_searches, w) & __ldg(a.live + w)) != 0u;
      if (scan)
        list[atomicAdd(&count, 1)] = static_cast<int>(v[k]);
      else
        for (int w = 0; w < a.n_words; ++w) a.next[v[k] * a.n_words + w] = 0u;
    }
    __syncthreads();
    const int n = count;
    for (int h = 0; h < n; ++h) {  // block-uniform
      const long hub = list[h];
      const long b = __ldg(a.offsets + hub), e = __ldg(a.offsets + hub + 1);
      unsigned any = 0u;
      for (int w = 0; w < a.n_words; ++w) {
        const long i = hub * a.n_words + w;
        const unsigned s = a.seen[i];
        const unsigned need = ~s & word_mask(a.n_searches, w) & __ldg(a.live + w);
        unsigned got = 0u;
        if (need) {
          long u = 0;
          got = scan_block(a, b, e, w, need, red, u) & need;
          used += threadIdx.x == 0 ? u : 0;
        }
        __syncthreads();  // every thread has read seen[i]
        if (threadIdx.x == 0) {
          a.next[i] = got;
          if (got) {
            a.seen[i] = s | got;
            atomicOr(a.live_next + w, got);
          }
        }
        if (threadIdx.x < 32) write_row(a, hub, w, got, lane);
        any |= got;
      }
      if (threadIdx.x == 0 && any) {
        ++found;
        atomicOr(a.live_next + a.n_words + (hub >> 5), 1u << (hub & 31));
      }
    }
    __syncthreads();  // count and list are written again in the next pass
  }
  add_counts(a, found, used);
}

__device__ void runs_role(const Args& a, long block) {
  __shared__ unsigned red[kWarps];
  const int lane = threadIdx.x & 31;
  const long v = block * kThreads + threadIdx.x;
  const bool real = v < a.n_vertices && GR_IN_RANGE(v + 1, a.n_vertices + 1L);
  const int beg = real ? __ldg(a.offsets + v) : 0;
  const int end = real ? __ldg(a.offsets + v + 1) : 0;
  const long len = end - static_cast<long>(beg);
  // runs longer than kBlockRun are the hub blocks'
  const bool mine = real && len <= kBlockRun;
  const bool short_run = len <= kLaneRun;
  unsigned any = 0u;
  unsigned long long used = 0ull;
  for (int w = 0; w < a.n_words; ++w) {  // block-uniform
    const long i = v * a.n_words + w;
    // seen is loaded beside the offsets, not after them
    const bool at = real && GR_IN_RANGE(i, static_cast<long>(a.n_vertices) * a.n_words);
    const unsigned s = at ? a.seen[i] : kFull;
    const unsigned need = at && mine
                              ? ~s & word_mask(a.n_searches, w) & __ldg(a.live + w)
                              : 0u;
    unsigned got = 0u;
    if (need && short_run) got = scan_lane(a, beg, end, w, need, used) & need;
    unsigned todo = __ballot_sync(kFull, need && !short_run);
    while (todo) {  // warp-uniform: one run at a time, the whole warp on it
      const int src = __ffs(todo) - 1;
      todo &= todo - 1u;
      const unsigned q = __shfl_sync(kFull, need, src);
      const long vq = __shfl_sync(kFull, v, src);
      long u = 0;
      const unsigned g = scan_warp(a, __shfl_sync(kFull, beg, src),
                                   __shfl_sync(kFull, end, src), w, q, lane,
                                   u) & q;
      if (lane == src) got = g;
      used += lane == 0 ? u : 0;
      write_row(a, vq, w, g, lane);
    }
    // the rows the lanes found, one vertex at a time
    unsigned rows = __ballot_sync(kFull, got != 0u && short_run);
    while (rows) {
      const int src = __ffs(rows) - 1;
      rows &= rows - 1u;
      write_row(a, __shfl_sync(kFull, v, src), w,
                __shfl_sync(kFull, got, src), lane);
    }
    if (at && mine) {
      a.next[i] = got;
      if (got) a.seen[i] = s | got;
    }
    any |= got;
    const unsigned all = block_or(got, red);
    if (threadIdx.x == 0 && all) atomicOr(a.live_next + w, all);
  }
  // this warp's bitmap word: its 32 vertices (a hub's bit is its block's)
  const unsigned bits = __ballot_sync(kFull, any != 0u);
  const long word = (v - lane) >> 5;
  if (lane == 0 && v < a.n_vertices) {
    if (bits) atomicOr(a.live_next + a.n_words + word, bits);
    a.live_clear[a.n_words + word] = 0u;
  }
  add_counts(a, any != 0u ? 1u : 0u, used);
}

__global__ void __launch_bounds__(kThreads, 2) msbfs_pull(const Args a) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.counts[a.level & 1] = 0ull;
    for (int w = 0; w < a.n_words; ++w) a.live_clear[w] = 0u;
  }
  if (blockIdx.x < a.hub_blocks)
    hub_role(a);
  else
    runs_role(a, static_cast<long>(blockIdx.x) - a.hub_blocks);
}

// One block: the sources' bits, their zero distances and the counters.
__global__ void __launch_bounds__(kThreads) msbfs_start(
    const long long* src, int n_searches, int n_vertices, int n_words,
    unsigned* front, unsigned* seen, unsigned* aux, int* dist,
    unsigned long long* counts) {
  __shared__ unsigned red[kWarps];
  for (int k = threadIdx.x; k < n_searches; k += kThreads) {
    const long long v = src[k];
    // a source outside [0, n_vertices) starts no search (and is a fault
    // in the checked build)
    if (!GR_IN_RANGE(v, n_vertices) || v < 0 || v >= n_vertices) continue;
    const long i = v * n_words + k / 32;
    const unsigned bit = 1u << (k & 31);
    atomicOr(front + i, bit);
    atomicOr(seen + i, bit);
    atomicOr(aux + k / 32, bit);
    atomicOr(aux + n_words + (v >> 5), 1u << (v & 31));
    dist[v * n_searches + k] = 0;
  }
  __syncthreads();
  // a source vertex counts once: for the lowest search its row holds,
  // whose word is at or before word k / 32
  unsigned found = 0u;
  for (int k = threadIdx.x; k < n_searches; k += kThreads) {
    const long long v = src[k];
    if (v < 0 || v >= n_vertices) continue;
    for (int w = 0; w <= k / 32; ++w) {
      const unsigned x = __ldcg(front + v * n_words + w);  // past L1
      if (x) {
        found += 32 * w + __ffs(x) - 1 == k ? 1u : 0u;
        break;
      }
    }
  }
  found = __reduce_add_sync(kFull, found);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = found;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long n = 0ull;
    for (int i = 0; i < kWarps; ++i) n += red[i];
    counts[0] = n;
    counts[1] = 0ull;
    counts[2] = 0ull;
  }
}

}  // namespace

// src: int64[n_searches], the sources; front, seen: uint32[n_vertices,
// n_words], zero; aux: uint32[3, n_words + ceil(n_vertices / 32)], zero;
// dist: int32[n_vertices, n_searches], UNREACHED; counts: uint64[3],
// written whole. One block.
extern "C" int gr_msbfs_start(const void* src, int n_searches, int n_vertices,
                              int n_words, void* front, void* seen, void* aux,
                              void* dist, void* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_searches < 0 || n_vertices < 0 || n_words < 1 ||
      32L * n_words < n_searches)
    return cudaErrorInvalidValue;
  msbfs_start<<<1, kThreads, 0, s>>>(
      static_cast<const long long*>(src), n_searches, n_vertices, n_words,
      static_cast<unsigned*>(front), static_cast<unsigned*>(seen),
      static_cast<unsigned*>(aux), static_cast<int*>(dist),
      static_cast<unsigned long long*>(counts));
  return gr::finish(s);
}

// One level, `level` (see the contract above). offsets: int32[n_vertices +
// 1] and rows: int32[n_slots], the CSC; front: uint32[n_vertices,
// n_words]; seen: the same, updated in place; next: the same, written
// whole, not front; aux: uint32[3, n_words + ceil(n_vertices / 32)]; dist:
// int32[n_vertices, n_searches]; counts: uint64[3]. sms: the card's
// multiprocessors (the hub blocks' count).
extern "C" int gr_msbfs_pull(const void* offsets, const void* rows,
                             const void* front, void* seen, void* next,
                             void* aux, void* dist, void* counts,
                             int n_vertices, int n_slots, int n_words,
                             int n_searches, int level, int sms,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_vertices < 0 || n_slots < 0 || n_words < 1 || n_searches < 0 ||
      32L * n_words < n_searches || level < 0 || sms < 1)
    return cudaErrorInvalidValue;
  if (n_vertices == 0) return cudaSuccess;
  const long slot = n_words + (n_vertices + 31L) / 32;  // aux words a slot
  unsigned* base = static_cast<unsigned*>(aux);
  Args a{};
  a.offsets = static_cast<const int*>(offsets);
  a.rows = static_cast<const int*>(rows);
  a.front = static_cast<const unsigned*>(front);
  a.seen = static_cast<unsigned*>(seen);
  a.next = static_cast<unsigned*>(next);
  a.live = base + (level % 3) * slot;
  a.live_next = base + ((level + 1) % 3) * slot;
  a.live_clear = base + ((level + 2) % 3) * slot;
  a.dist = static_cast<int*>(dist);
  a.counts = static_cast<unsigned long long*>(counts);
  a.n_vertices = n_vertices;
  a.n_slots = n_slots;
  a.n_words = n_words;
  a.n_searches = n_searches;
  a.level = level;
  // a run longer than kBlockRun needs more slots than that in the graph
  a.hub_blocks = n_slots > kBlockRun ? (n_vertices < sms ? n_vertices : sms) : 0;
  const long runs = (n_vertices + kThreads - 1L) / kThreads;
  msbfs_pull<<<static_cast<unsigned>(a.hub_blocks + runs), kThreads, 0, s>>>(a);
  return gr::finish(s);
}

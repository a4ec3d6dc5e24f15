// Active-chunk plan for the frontier-sparse passes, in one launch.
//
// Replaces: gunrock_tpu/ops/pallas/chunkplan.py::chunk_activity
// (_make_plan_kernel) together with the XLA word packing and the stable
// lax.sort compaction around it in
// gunrock_tpu/ops/pallas/semiring.py::_sparse_chunk_select.
//
// Contract, per chunk i:
//   ch_act[i] = (act_words[chunk_cb[i]] & src_bits[i]) != 0
//               [& (om_words[chunk_rb[i]] & dst_bits[i]) != 0]
// where bit b of word w is set iff sub-block b (W/32 vertices) of window w
// holds a vertex of the mask. A null `active` means every source is
// active: the first test becomes src_bits[i] != 0. With a queue, its first
// *count entries are the active chunk ids in ascending order.
//
// What bounds it on this card: launch latency. At R-MAT scale 18 (W=2048,
// 20,548 chunks) it reads two bool[V] masks (0.5 MB) and four
// int32[n_chunks] metadata arrays (0.3 MB) and writes the chunk mask
// (and queue) (0.1 MB): 0.3 us of memory traffic at 3.35 TB/s, against a
// few microseconds for any launch.
//
// Design: one cooperative launch (grid <= the co-resident blocks), no
// memset and no global atomic.
// 1. Pack: a block owns a window at a time. Each thread ORs the sub-block
//    bits of the window's vertices it reads (coalesced, four bytes at a
//    time where the mask is 4-byte aligned), a warp ORs its lanes'
//    (__reduce_or_sync), and thread 0 ORs the warps' from shared memory
//    and writes the whole word.
// 2. grid.sync(), then test: block b owns the contiguous chunk range
//    [b*per, (b+1)*per) and writes ch_act for it.
// 3. With a queue: each block writes its active count, grid.sync(), adds
//    the counts of the blocks before it, and writes its range's active ids
//    at that offset with a block scan (ballots and per-warp counts in
//    shared memory), so the queue is ascending; the last block writes
//    *count. No word is accumulated, so nothing needs zeroing first.
// A grid.sync is taken only where a mask was packed or a queue asked for
// (the condition is the same for every block). The earlier design took
// three device operations (a memset of the words, a pack with one global
// atomicOr per warp, a test with a warp-aggregated append to an unordered
// queue) for the same work.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = gr::kThreads / 32;

struct Args {
  const unsigned char* active;    // bool[n_vertices] or null (all active)
  const unsigned char* out_mask;  // bool[n_vertices] or null
  const int* chunk_cb;
  const int* chunk_rb;
  const unsigned* src_bits;
  const unsigned* dst_bits;
  unsigned* act_words;  // [n_col_blocks]
  unsigned* om_words;   // [n_row_blocks]
  int* block_counts;    // [gridDim.x], with a queue
  int* count;           // [1], with a queue
  int* queue;           // [n_chunks] or null
  unsigned char* ch_act;  // [n_chunks]
  long n_vertices;
  int window;
  int n_chunks;
  int n_col_blocks;
  int n_row_blocks;
  int vec4;  // both masks are 4-byte aligned
};

// The word of window w of `mask`: bit b set iff sub-block b holds a vertex
// of it. Every thread of the block calls it; `warp_bits` is kWarps words
// of shared memory, free again when it returns.
__device__ unsigned pack_window(const unsigned char* __restrict__ mask,
                                long n_vertices, int window, long w,
                                bool vec4, unsigned* warp_bits) {
  const int sub = window / 32;
  const long base = w * window;
  unsigned bits = 0u;
  if (vec4 && base + window <= n_vertices) {
    const unsigned* m4 = reinterpret_cast<const unsigned*>(mask + base);
    for (int i = threadIdx.x; i < window / 4; i += blockDim.x) {
      const unsigned q = m4[i];
      if (q == 0u) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if ((q >> (8 * j)) & 0xffu) bits |= 1u << ((4 * i + j) / sub);
    }
  } else {
    for (int i = threadIdx.x; i < window; i += blockDim.x)
      if (base + i < n_vertices && mask[base + i]) bits |= 1u << (i / sub);
  }
  bits = __reduce_or_sync(0xffffffffu, bits);
  if ((threadIdx.x & 31) == 0) warp_bits[threadIdx.x >> 5] = bits;
  __syncthreads();
  unsigned word = 0u;
  if (threadIdx.x == 0)
    for (int k = 0; k < kWarps; ++k) word |= warp_bits[k];
  __syncthreads();  // warp_bits is written again by the next window
  return word;
}

// One chunk's metadata, loaded before the words are packed.
struct Meta {
  unsigned sb, db;
  int cb, rb;
};

__device__ __forceinline__ Meta load_meta(const Args& a, int i) {
  Meta m{a.src_bits[i], 0u, 0, 0};
  if (a.active != nullptr) m.cb = a.chunk_cb[i];
  if (a.out_mask != nullptr) {
    m.rb = a.chunk_rb[i];
    m.db = a.dst_bits[i];
  }
  return m;
}

__device__ __forceinline__ bool chunk_active(const Args& a, const Meta& m) {
  bool act = m.sb != 0u;
  if (a.active != nullptr)
    act = GR_IN_RANGE(m.cb, a.n_col_blocks) && (a.act_words[m.cb] & m.sb) != 0u;
  if (act && a.out_mask != nullptr)
    act = GR_IN_RANGE(m.rb, a.n_row_blocks) && (a.om_words[m.rb] & m.db) != 0u;
  return act;
}

__global__ void __launch_bounds__(gr::kThreads) chunk_plan(const Args a) {
  __shared__ unsigned warp_bits[kWarps];
  __shared__ int warp_n[kWarps];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // this block's chunk range; the first chunk's metadata is loaded now, so
  // that its latency overlaps the packing
  const int per = (a.n_chunks + gridDim.x - 1) / gridDim.x;
  const int lo = min(a.n_chunks, static_cast<int>(blockIdx.x) * per);
  const int hi = min(a.n_chunks, lo + per);
  Meta first{};
  if (lo + static_cast<int>(threadIdx.x) < hi) first = load_meta(a, lo + threadIdx.x);

  // 1. the words: windows of `active`, then of `out_mask`
  const long n_act = a.active != nullptr ? a.n_col_blocks : 0;
  const long n_om = a.out_mask != nullptr ? a.n_row_blocks : 0;
  for (long job = blockIdx.x; job < n_act + n_om; job += gridDim.x) {
    const bool is_act = job < n_act;
    const long w = is_act ? job : job - n_act;
    const unsigned word =
        pack_window(is_act ? a.active : a.out_mask, a.n_vertices, a.window, w,
                    a.vec4 != 0, warp_bits);
    if (threadIdx.x == 0) (is_act ? a.act_words : a.om_words)[w] = word;
  }
  if (n_act + n_om > 0) grid.sync();

  // 2. the test over this block's range
  int mine = 0;
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const bool act =
        chunk_active(a, i == lo + static_cast<int>(threadIdx.x) ? first : load_meta(a, i));
    a.ch_act[i] = act;
    mine += act;
  }
  if (a.queue == nullptr) return;

  // 3. the ascending queue
  for (int off = 16; off > 0; off >>= 1)
    mine += __shfl_down_sync(0xffffffffu, mine, off);
  if (lane == 0) warp_n[warp] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int k = 0; k < kWarps; ++k) n += warp_n[k];
    a.block_counts[blockIdx.x] = n;
  }
  grid.sync();
  __shared__ int base;
  if (threadIdx.x == 0) {
    int n = 0;
    for (int b = 0; b < static_cast<int>(blockIdx.x); ++b) n += a.block_counts[b];
    base = n;
  }
  __syncthreads();
  // tiles of blockDim chunks; the loop bound is uniform over the block
  for (int t0 = lo; t0 < hi; t0 += blockDim.x) {
    const int i = t0 + threadIdx.x;
    const bool act = i < hi && a.ch_act[i];
    const unsigned ballot = __ballot_sync(0xffffffffu, act);
    if (lane == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();
    int at = base + __popc(ballot & ((1u << lane) - 1u));
    for (int k = 0; k < warp; ++k) at += warp_n[k];
    if (act && GR_IN_RANGE(at, a.n_chunks)) a.queue[at] = i;
    __syncthreads();  // every thread has read warp_n and base
    if (threadIdx.x == 0)
      for (int k = 0; k < kWarps; ++k) base += warp_n[k];
    __syncthreads();
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) *a.count = base;
}

}  // namespace

// words: int32 scratch of 1 + n_col_blocks + n_row_blocks + max_blocks,
// laid out as [count | act_words | om_words | block counts]; nothing in it
// needs to be set. active and out_mask may be null; queue may be null (no
// queue, no count). The grid is at most max_blocks blocks. Returns
// cudaErrorNotSupported where the device has no cooperative launch.
extern "C" int gr_chunk_activity(const void* active, const void* out_mask,
                                 long n_vertices, int window, int n_col_blocks,
                                 int n_row_blocks, const void* chunk_cb,
                                 const void* chunk_rb, const void* src_bits,
                                 const void* dst_bits, int n_chunks,
                                 void* words, int max_blocks, void* ch_act,
                                 void* queue, void* stream) {
  static int coresident = -1;  // one card per process
  if (coresident < 0) coresident = gr::coresident_blocks(chunk_plan, gr::kThreads);
  if (coresident == 0) return cudaErrorNotSupported;
  if (window % 32 != 0 || max_blocks < 1) return cudaErrorInvalidValue;
  Args a{};
  a.active = static_cast<const unsigned char*>(active);
  a.out_mask = static_cast<const unsigned char*>(out_mask);
  a.chunk_cb = static_cast<const int*>(chunk_cb);
  a.chunk_rb = static_cast<const int*>(chunk_rb);
  a.src_bits = static_cast<const unsigned*>(src_bits);
  a.dst_bits = static_cast<const unsigned*>(dst_bits);
  int* w = static_cast<int*>(words);
  a.count = w;
  a.act_words = reinterpret_cast<unsigned*>(w + 1);
  a.om_words = a.act_words + n_col_blocks;
  a.block_counts = reinterpret_cast<int*>(a.om_words + n_row_blocks);
  a.queue = static_cast<int*>(queue);
  a.ch_act = static_cast<unsigned char*>(ch_act);
  a.n_vertices = n_vertices;
  a.window = window;
  a.n_chunks = n_chunks;
  a.n_col_blocks = n_col_blocks;
  a.n_row_blocks = n_row_blocks;
  a.vec4 = reinterpret_cast<unsigned long long>(active) % 4 == 0 &&
           reinterpret_cast<unsigned long long>(out_mask) % 4 == 0;
  // enough blocks for one chunk a thread and one window a block
  long want = (n_chunks + gr::kThreads - 1) / gr::kThreads;
  const long jobs = (active ? n_col_blocks : 0) + (out_mask ? n_row_blocks : 0);
  if (jobs > want) want = jobs;
  int blocks = static_cast<int>(want < 1 ? 1 : want);
  if (blocks > coresident) blocks = coresident;
  if (blocks > max_blocks) blocks = max_blocks;
  void* params[] = {&a};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(chunk_plan), dim3(blocks), dim3(gr::kThreads),
      params, 0, s);
  if (err != cudaSuccess) return err;
  return gr::finish(s);
}

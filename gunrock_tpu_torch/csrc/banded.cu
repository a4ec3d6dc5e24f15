// Banded gather: out[t] = table[idx[t]] where each block of `block_t`
// consecutive indices stays inside a bounded window of the table.
//
// Replaces gunrock_tpu/ops/pallas/banded.py::banded_gather (kernel body
// _make_banded_kernel: one double-buffered DMA of the block's window into
// VMEM, then a select tree of one-vreg dynamic gathers over its rows).
//
// Contract: with lo_g = block_lo[t / block_t] * 128 and span = span_rows *
// 128,
//   out[t] = table[lo_g + clamp(idx[t] - lo_g, 0, span - 1)].
// An index inside its block's window gives table[idx[t]]; one outside
// gives the clamped element, the same one the TPU kernel returns, and
// never reads outside the window. The caller keeps every window inside
// the table: block_lo[g] + span_rows <= n_rows (pad_table, and a sink
// window for unused tail indices). A block whose window does not fit
// writes nothing.
//
// What bounds it on this card: bytes. 4 B of idx read and 4 B of out
// written per element, plus the table once (the windows of neighbouring
// blocks overlap; the table of a triangle-counting slab, 15 MB, stays in
// the 50 MB L2). For the real R-MAT 18 slab, 40.9M positions, that is
// 335.7 MB: 0.1002 ms at 3.35 TB/s. No arithmetic worth counting. The
// gathers cost L2 sectors, not DRAM bytes: a slab's wedges read rising
// positions, so a warp's gathers share sectors; random positions in a
// wide window (a synthetic slab of span_rows 120 or 200) pull a 32-byte
// sector each and make the gather bound by L2, not by this bound.
//
// Design: a persistent grid that keeps bytes in flight. Each thread
// block (kBandThreads threads; as many blocks as the SMs hold at once)
// walks the index blocks g = blockIdx.x, += gridDim.x. A thread first
// loads kVecs 16-byte vectors of its block's idx (32 B a thread in
// flight, 4x the one 4-byte load of a thread a step before), with
// block_lo[g] beside them, then gathers their elements from the table
// through the read-only path (__ldg: the window's lines stay in L1 and L2
// for the block's other threads) and stores 16 bytes at a time. idx is
// read and out written with the streaming hints (__ldcs, __stcs: evict
// first), so that the two streams do not push the table out of L2. When
// idx or out is not 16-byte aligned (a view at an odd offset), or block_t
// is no multiple of 4, the launcher takes the scalar instance of the same
// template: one int a load, the same walk. kBandThreads and kVecs were
// chosen on the card among 128 x 4, 256 x 2, 512 x 1 and 64 x 8; a
// two-stage ring of bulk (TMA) copies of each block's idx tile and window
// into shared memory was slower on the real slab (PERF.md, B10).

#include "common.cuh"

namespace {

constexpr int kBandThreads = 256;  // threads a block
constexpr int kVecs = 2;           // vectors of idx a thread loads at once
constexpr int kVecWidth = 4;       // ints a vector (16 bytes)

template <bool kVec>
struct Lanes;
template <>
struct Lanes<true> {
  using V = int4;
  static constexpr int kWidth = kVecWidth;
};
template <>
struct Lanes<false> {
  using V = int;
  static constexpr int kWidth = 1;
};

// The element of the window `win` (span ints from table position lo) that
// index x reads: clamped into the window.
__device__ __forceinline__ int take(const int* __restrict__ win, long lo,
                                    int span, int x) {
  long local = static_cast<long>(x) - lo;
  local = local < 0 ? 0 : (local > span - 1 ? span - 1 : local);
  return __ldg(win + local);
}

__device__ __forceinline__ int4 take(const int* __restrict__ win, long lo,
                                     int span, int4 x) {
  return make_int4(take(win, lo, span, x.x), take(win, lo, span, x.y),
                   take(win, lo, span, x.z), take(win, lo, span, x.w));
}

template <bool kVec>
__global__ void __launch_bounds__(kBandThreads)
    banded_gather(const int* __restrict__ table, long n_table,
                  const int* __restrict__ idx, const int* __restrict__ block_lo,
                  int* __restrict__ out, long n_idx, long n_blocks,
                  int block_t, int span) {
  using V = typename Lanes<kVec>::V;
  constexpr int kWidth = Lanes<kVec>::kWidth;
  const int n_items = block_t / kWidth;  // loads of one block
  for (long g = blockIdx.x; g < n_blocks; g += gridDim.x) {
    const long base = g * block_t;
    const V* src = reinterpret_cast<const V*>(idx + base);
    V* dst = reinterpret_cast<V*>(out + base);
    for (int i0 = threadIdx.x; i0 < n_items; i0 += kVecs * kBandThreads) {
      // every load of idx, and the window's start, before any gather
      V x[kVecs];
      bool ok[kVecs];
#pragma unroll
      for (int u = 0; u < kVecs; ++u) {
        const int i = i0 + u * kBandThreads;
        ok[u] = i < n_items &&
                GR_IN_RANGE(base + static_cast<long>(i + 1) * kWidth - 1, n_idx);
        if (ok[u]) x[u] = __ldcs(src + i);
      }
      const long lo = static_cast<long>(__ldg(block_lo + g)) * 128;
      // the whole window must lie inside the table
      if (!(GR_IN_RANGE(lo, n_table) && GR_IN_RANGE(lo + span - 1, n_table)))
        break;
      const int* win = table + lo;
#pragma unroll
      for (int u = 0; u < kVecs; ++u)
        if (ok[u]) __stcs(dst + i0 + u * kBandThreads, take(win, lo, span, x[u]));
    }
  }
}

template <bool kVec>
void launch(const int* tab, long n_table, const int* ix, const int* lo,
            int* o, long n_idx, long n_blocks, int block_t, int span,
            cudaStream_t s) {
  // as many blocks as the SMs hold at once
  const int held = gr::coresident_blocks(banded_gather<kVec>, kBandThreads);
  const long fill = held > 0 ? held : 1;
  const unsigned grid = static_cast<unsigned>(n_blocks < fill ? n_blocks : fill);
  banded_gather<kVec><<<grid, kBandThreads, 0, s>>>(tab, n_table, ix, lo, o,
                                                   n_idx, n_blocks, block_t,
                                                   span);
}

}  // namespace

// table: int[n_rows * 128]. idx, out: int[n_idx], n_idx a multiple of
// block_t. block_lo: int[n_idx / block_t], the window's first row of each
// block.
extern "C" int gr_banded_gather(const void* table, int n_rows, const void* idx,
                                const void* block_lo, void* out, long n_idx,
                                int block_t, int span_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_t <= 0 || n_idx % block_t != 0 || span_rows <= 0)
    return cudaErrorInvalidValue;
  const long n_blocks = n_idx / block_t;
  if (n_blocks == 0) return cudaSuccess;
  if (n_blocks > 2147483647L) return cudaErrorInvalidValue;
  const int span = span_rows * 128;
  const long n_table = static_cast<long>(n_rows) * 128;
  const int* tab = static_cast<const int*>(table);
  const int* ix = static_cast<const int*>(idx);
  const int* lo = static_cast<const int*>(block_lo);
  int* o = static_cast<int*>(out);
  if (block_t % kVecWidth == 0 && gr::aligned16(ix) && gr::aligned16(o))
    launch<true>(tab, n_table, ix, lo, o, n_idx, n_blocks, block_t, span, s);
  else
    launch<false>(tab, n_table, ix, lo, o, n_idx, n_blocks, block_t, span, s);
  return gr::finish(s);
}

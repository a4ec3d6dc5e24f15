// Boruvka min-cut pass: per row, the least rank over the edges whose two
// endpoints lie in different components.
//
// Replaces: gunrock_tpu/ops/pallas/mst_min.py::bucketed_min_rank_cut
// (_make_mst_min_kernel: two dynamic-gather select trees fetch root[col]
// and root[row] from the col and row windows of one f32 roots array, then
// a one-hot min scatter per 128-lane tile; ranks and roots ride as f32,
// exact below 2^24, and padding columns read a -1 root).
//
// Contract: over the layout of the doubled canonical edge set (each
// undirected edge once from either endpoint), with ranks[e] the edge's
// position in the (weight, id) order, for every real slot e of every chunk
//   if root[cb*W + col_local[e]] != root[rb*W + row_local[e]]:
//       y[rb*W + row_local[e]] = min(y[...], ranks[e])
// and every other entry of y is the sentinel NO_CUT = 2^30 ("no cut
// edge"): y is written whole. Ranks and roots are int32 and the reduction
// is an int min: the f32 ride is a TPU constraint, and int32 keeps the
// pass exact up to 2^30 edges. Padding slots carry row_local == W and are
// skipped before any other load, which replaces the -1 root of the TPU
// kernel's padded window.
//
// What bounds it on this card: bytes. Each slot reads 12 B (row, col,
// rank) and gathers one 4 B root (L1/L2 resident); y and the roots are
// V-sized. At R-MAT scale 18 (doubled canonical set, ~7.6M slots) that is
// ~94 MB: ~28 us at 3.35 TB/s. Late rounds have fewer cut edges, but every
// round reads every slot: a dense pass with no chunk queue.
//
// Design: the span kernels of the semiring pull (semiring.cu), with int
// windows. The layout's span table cuts each row block's chunk range into
// spans of at most P chunks (layout.py::span_table; P = 32 at C = 256).
// 1. cut_spans, one block per span: it loads its row block's W roots into
//    shared memory once and fills a window of W ints with NO_CUT, then
//    walks the span's slots four at a time per thread (16-byte loads of
//    row, col and rank; scalar loads where C % 4 != 0), gathers the
//    column's root, compares it with the row's from shared memory, and
//    sends a cut edge's rank that beats the window's value to a native
//    shared int atomicMin (the window only decreases, so a rank that does
//    not beat the value read cannot win later; a bucket's slots come in
//    rank order, so after a row's first cut edge most are not sent). The
//    window goes out with plain stores into partial[span] only where a
//    rank was sent, with touched[span] written on every call.
// 2. cut_combine, one block of 16 warps per (row block, strip of 512
//    entries): gr::reduce_span_strip takes the int min of the block's
//    touched partials and writes every entry of the strip, NO_CUT where no
//    span touched it.
// So no cut edge leaves the SM as an atomic. The earlier design walked
// the chunks in row-block order with a persistent grid and sent one
// global atomicMin per cut edge that beat the value it read (every real
// slot in Boruvka's first round), with row block 0 owning ~29% of the
// chunks, so most atomics landed on the same 8 KB of y; each slot
// gathered two roots, and the caller filled y first.

#include "common.cuh"

namespace {

constexpr int kNoCut = 1 << 30;

struct Args {
  const int* span_first_chunk;  // int[n_spans + 1]
  const int* rb_first_span;     // int[n_row_blocks + 1]
  const int* chunk_rb;
  const int* chunk_cb;
  const int* row;
  const int* col;
  const int* ranks;  // int[n_chunks * chunk], slot order
  const int* roots;  // int[n_vertices]
  int* y;            // int[n_row_blocks * window], written whole
  int* partial;      // int[n_spans * window]
  int* touched;      // int[n_spans]
  int n_spans;
  int n_chunks;
  int window;
  int chunk;
  int n_vertices;
};

// One real or padding slot: row r (window-local), col c, rank k.
__device__ __forceinline__ void visit(const Args& a, int* win,
                                      const int* row_roots, long cbase, int r,
                                      int c, int k, bool& sent) {
  if (r == a.window) return;  // padding slot
  const long ci = cbase + c;
  if (!GR_IN_RANGE(ci, a.n_vertices) || !GR_IN_RANGE(r, a.window)) return;
  if (__ldg(a.roots + ci) == row_roots[r]) return;  // not a cut edge
  if (k < win[r]) {
    atomicMin(win + r, k);
    sent = true;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(gr::kThreads) cut_spans(const Args a) {
  extern __shared__ int4 smem4[];
  int* win = reinterpret_cast<int*>(smem4);  // W ints: the least cut rank
  int* row_roots = win + a.window;           // W ints: the row block's roots
  __shared__ int any_sent;
  const int span = blockIdx.x;
  const int first = a.span_first_chunk[span];
  const int last = a.span_first_chunk[span + 1];
  // uniform over the block, so a bad span leaves before any barrier
  if (!GR_IN_RANGE(first, a.n_chunks) ||
      !GR_IN_RANGE(last - first - 1, a.n_chunks - first))
    return;
  // a span lies in one row block; rows past V belong to no real slot
  const long rbase = static_cast<long>(a.chunk_rb[first]) * a.window;
  for (int i = threadIdx.x; i < a.window; i += blockDim.x) {
    win[i] = kNoCut;
    row_roots[i] = rbase + i < a.n_vertices ? a.roots[rbase + i] : -1;
  }
  if (threadIdx.x == 0) any_sent = 0;
  __syncthreads();
  constexpr int kPer = kVec ? 4 : 1;
  bool sent = false;
  const long s0 = static_cast<long>(first) * a.chunk;
  const int n_slots = (last - first) * a.chunk;
  for (int o = threadIdx.x * kPer; o < n_slots; o += blockDim.x * kPer) {
    const long s = s0 + o;
    const long cbase = static_cast<long>(a.chunk_cb[first + o / a.chunk]) * a.window;
    if constexpr (kVec) {  // four slots of one chunk (kPer divides C)
      const int4 r = *reinterpret_cast<const int4*>(a.row + s);
      if (r.x == a.window && r.y == a.window && r.z == a.window &&
          r.w == a.window)
        continue;  // four padding slots (a chunk's tail): no more loads
      const int4 c = *reinterpret_cast<const int4*>(a.col + s);
      const int4 k = *reinterpret_cast<const int4*>(a.ranks + s);
      visit(a, win, row_roots, cbase, r.x, c.x, k.x, sent);
      visit(a, win, row_roots, cbase, r.y, c.y, k.y, sent);
      visit(a, win, row_roots, cbase, r.z, c.z, k.z, sent);
      visit(a, win, row_roots, cbase, r.w, c.w, k.w, sent);
    } else {
      const int r = a.row[s];
      if (r == a.window) continue;
      visit(a, win, row_roots, cbase, r, a.col[s], a.ranks[s], sent);
    }
  }
  if (sent) any_sent = 1;  // every writer stores the same 1
  __syncthreads();
  if (any_sent) {
    int4* out = reinterpret_cast<int4*>(a.partial + static_cast<long>(span) * a.window);
    for (int i = threadIdx.x; i < a.window / 4; i += blockDim.x) out[i] = smem4[i];
  }
  if (threadIdx.x == 0) a.touched[span] = any_sent;
}

struct Min4 {
  static __device__ __forceinline__ int4 apply(int4 a, int4 b) {
    return make_int4(min(a.x, b.x), min(a.y, b.y), min(a.z, b.z),
                     min(a.w, b.w));
  }
};

// y's entries [strip*512, strip*512 + 512) of row block rb = blockIdx.x.
__global__ void __launch_bounds__(gr::kReduceWarps * 32) cut_combine(const Args a) {
  const int rb = blockIdx.x;
  gr::reduce_span_strip<Min4>(a.partial, a.touched, a.rb_first_span[rb],
                              a.rb_first_span[rb + 1], a.n_spans, a.window,
                              blockIdx.y * gr::kStrip, kNoCut,
                              a.y + static_cast<long>(rb) * a.window);
}

}  // namespace

// ranks: int32[n_chunks * chunk] in slot order. roots: int32[n_vertices].
// y: int32[n_row_blocks * window], written whole. scratch: int32[n_spans *
// (window + 1)], the partial windows and then the touched flags. window
// must be a multiple of 4 (the layout's is of 32), and two windows of ints
// must fit in one block's shared memory.
extern "C" int gr_min_rank_cut(int n_spans, const void* span_first_chunk,
                               const void* rb_first_span, int n_chunks,
                               const void* chunk_rb, const void* chunk_cb,
                               const void* row_local, const void* col_local,
                               const void* ranks, const void* roots, void* y,
                               void* scratch, int window, int chunk,
                               int n_vertices, int n_row_blocks,
                               void* stream) {
  if (window % 4 != 0) return cudaErrorInvalidValue;
  Args a{};
  a.span_first_chunk = static_cast<const int*>(span_first_chunk);
  a.rb_first_span = static_cast<const int*>(rb_first_span);
  a.chunk_rb = static_cast<const int*>(chunk_rb);
  a.chunk_cb = static_cast<const int*>(chunk_cb);
  a.row = static_cast<const int*>(row_local);
  a.col = static_cast<const int*>(col_local);
  a.ranks = static_cast<const int*>(ranks);
  a.roots = static_cast<const int*>(roots);
  a.y = static_cast<int*>(y);
  a.partial = static_cast<int*>(scratch);
  a.touched = a.partial + static_cast<long>(n_spans) * window;
  a.n_spans = n_spans;
  a.n_chunks = n_chunks;
  a.window = window;
  a.chunk = chunk;
  a.n_vertices = n_vertices;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_spans > 0) {
    const bool vec = chunk % 4 == 0 && gr::aligned16(row_local) &&
                     gr::aligned16(col_local) && gr::aligned16(ranks);
    void (*kernel)(Args) = vec ? cut_spans<true> : cut_spans<false>;
    const int smem = 2 * static_cast<int>(sizeof(int)) * window;
    if (smem > 48 * 1024) {  // above 48 KB only when asked for
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
    kernel<<<n_spans, gr::kThreads, smem, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n_row_blocks, (window + gr::kStrip - 1) / gr::kStrip);
  cut_combine<<<grid, gr::kReduceWarps * 32, 0, s>>>(a);
  return gr::finish(s);
}

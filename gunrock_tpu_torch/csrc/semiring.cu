// Semiring pull over the bucketed chunk layout: the frontier-sparse pass,
// the dense pass with its two floor modes, and the fused max/min pass.
//
// Replaces:
// - gunrock_tpu/ops/pallas/semiring.py::bucketed_semiring_spmv_sparse
//   (kernel body _make_sparse_kernel, v5: dynamic-gather x, MXU one-hot
//   scatter, launched through _tail_grid_dispatch);
// - gunrock_tpu/ops/pallas/semiring.py::bucketed_semiring_spmv (kernel
//   bodies _make_kernel_v1..v5, one contract: every chunk of the grid in
//   order, first-visit init of each row window, rb_occupied mask after);
// - gunrock_tpu/ops/pallas/semiring.py::bucketed_semiring_spmv_sparse_minmax
//   (kernel body _sparse_minmax_kernel: one windowed one-hot gather feeding
//   a max-reduce and a positives-only min-reduce, for coloring's paired
//   neighbour scans);
// - benchmarks/probe_v5_floor.py::run_variant (the pallas_call at :115,
//   variants `dma` and `gather`): the floor modes of the dense pass below.
//
// Contract: for every chunk that ch_act selects (sparse: the active chunks
// from chunkplan.cu) or every chunk 0..n_chunks-1 (dense), and every real
// slot e of it,
//   y[rb*W + row_local[e]] (+)= msg(x[cb*W + col_local[e]], values[e]),
// and every other entry of y is the semiring identity: y is written whole.
// Padding slots carry row_local == W and are skipped before any load of x.
//   plus_times: msg = val * x (x when unit), reduced by addition
//   max_times:  msg = val * x, reduced by max; identity 0
//   min_plus:   msg = min(val + x, BIG) (min(x, BIG) when unit: the
//               value-free form is the (x)-identity, not weight 1)
//
// The fused max/min pass (semiring tag kMaxMin, sparse and valued only)
// reduces each positive message m = val * x twice over the active chunks:
// max into ymax (identity 0) and min into ymin (identity BIG, which a row
// with no positive message keeps: BIG, not inf). It needs x >= 0 and
// values >= 0, so m > 0 picks the real messages and both reductions can
// order the floats by their int bits.
//
// What bounds it on this card: bytes. Each slot reads 8 B of row/col
// metadata (12 B valued) and gathers 4 B of x from one window (L1/L2
// resident). A full pass at R-MAT scale 18 moves ~44 MB unit at
// W=2048/C=256 (20,548 chunks) and ~68 MB valued at W=4096/C=1024 (5,359
// chunks): 13-20 us at 3.35 TB/s. The max/min pass over the symmetrized
// R-MAT 18 coloring layout reads 12 B per slot over ~7.8M slots plus x and
// writes two f32[V]: ~97 MB, ~29 us on a full frontier.
//
// Design of all three: spans. Chunks are sorted by row
// block, and the layout cuts each row block's chunk range into spans of at
// most P chunks (layout.py::span_table; P = 32 at C = 256). Two launches:
// 1. span_pass, one block per span. It fills a window of W floats in
//    dynamic shared memory with the identity, walks the span's slots four
//    at a time per thread (16-byte loads of row, col and values; chunk
//    bases are 1 KB aligned; scalar loads where C % 4 != 0), skips a chunk
//    whose ch_act byte is 0 in the sparse pass (a span with none active
//    leaves before it fills its window), and reduces each message
//    into the window with a shared-memory atomic (f32 add; int max on the
//    bits for max_times; gr::atomic_min_float for min_plus). Messages that
//    cannot change y are not sent: 0 for plus_times (x + 0 == x), <= 0 for
//    max_times (identity 0), >= BIG for min_plus. Then the window goes out
//    with plain coalesced stores into partial[span], with touched[span] =
//    whether any message was sent (written on every call: no memset).
//    kMaxMin keeps two windows, max then min, and its partials are every
//    span's max window, then every span's min window. Its layout
//    (coloring's symmetrized push layout) keeps a chunk's slots in source
//    order, so a hub's row comes in runs: 43% of the 7,878,410 real slots
//    at R-MAT 18 lie in runs of one row of 2 or more within 32 slots, 30%
//    in runs of 8 or more, 13% fill all 32 (mean run 1.6; the pull
//    layouts' is 1.0). Shared atomics on one word serialize, so a warp
//    first folds each run of equal rows on consecutive lanes (for each of
//    a lane's four slots) with a segmented max/min by shuffle, and the
//    run's last lane sends one atomic pair.
// 2. reduce_spans, one block of 16 warps per (row block, strip of 512
//    entries[, window]): each warp combines the touched partials of every
//    16th span of the block, eight 16-byte loads in flight per lane (row
//    block 0 holds 189 spans at R-MAT 18, so the chain of loads, not the
//    bytes, sets this pass's time), the block combines its warps in order,
//    and all entries of the strip are written; the identity where no span
//    touched the block. kMaxMin's windows are blockIdx.z = 0 (max, into
//    ymax) and 1 (min, into ymin).
// So no message leaves the SM as an atomic. The first design sent one
// global atomic per real slot (3,939,205 at R-MAT 18) straight into y:
// 0.219 ms of device time for B3's valued pass at W=2048/C=256, 78% of it
// the scatter (the floor split on an H100 80GB HBM3 at 700 W), because
// the degree-sorted graph puts 29% of the chunks in row block 0, the
// chunks are walked in row-block order, and atomics on one address
// serialize. Combining a chunk's messages per row first would not help: a
// 256-slot chunk holds its slots in source order and hits ~252 distinct
// rows. Float sums still land in any order within a window (shared
// atomics), so plus_times is not bit-reproducible; min and max are. On the
// same card (probes/pull.py, R-MAT 18) the two passes take 0.043 ms of
// device time for B3's valued pass at W=2048/C=256 and 0.048 at
// W=4096/C=1024, 0.038 for B1 on a full frontier (0.048 with its chunk
// plan); of the span lengths 8, 16 and 32, P = 32 at C = 256 and P = 8 at
// C = 1024 were the fastest.
//
// Floor modes (gr_spmv_dense_floor): the dense plus_times pass with the
// same spans, loop and loads, less the reduction into the window (kGather)
// or less the gather too (kStream), so that the times of the three differ
// by the gather and the scatter alone. Contract of the TPU probe: per row
// block rb, y[rb*W + r] = 1e-30 * sum over the chunks of rb of t, for
// every r of the block, with t = sum of val * x[col] (kGather) or sum of
// val (kStream) over the chunk's real slots; blocks no chunk reaches are
// 0. kStream keeps the row and col loads by handing both to an empty asm
// (the TPU probe folds them in at weight 0). Each span block sums its
// slots' t and stores it in t_span[span]; a second pass (floor_fill, one
// block per row block) sums the t of the block's spans and writes all W
// entries of y. No atomics: with one atomicAdd per warp into its row
// block instead, the stream mode took as long as the full pass.

#include "common.cuh"

namespace {

enum Semiring { kPlusTimes = 0, kMinPlus = 1, kMaxTimes = 2, kMaxMin = 3 };
enum Mode { kFull = 0, kGather = 1, kStream = 2 };

struct Args {
  const int* span_first_chunk;  // int[n_spans + 1]
  const int* rb_first_span;     // int[n_row_blocks + 1]
  const unsigned char* ch_act;  // sparse pass: bool[n_chunks]; else null
  const int* chunk_cb;
  const int* row;
  const int* col;
  const float* val;  // null for a unit pass
  const float* x;
  float* y;        // float[n_row_blocks * window], written whole (kMaxMin: ymax)
  float* ymin;     // kMaxMin: float[n_row_blocks * window], written whole
  float* partial;  // float[n_windows * n_spans * window]
  int* touched;    // int[n_spans]
  float* t_span;   // floor modes: float[n_spans]
  int n_spans;
  int n_chunks;
  int n_row_blocks;
  int window;
  int chunk;
  long n_x;  // length of x (n_vertices)
};

// Windows a span keeps in shared memory: kMaxMin's max and min, else one.
template <int kSemiring>
constexpr int kWindows = kSemiring == kMaxMin ? 2 : 1;

// The identity of window h (kMaxMin: 0 the max window, 1 the min window).
template <int kSemiring>
__device__ __forceinline__ float identity(int h = 0) {
  return kSemiring == kMinPlus || (kSemiring == kMaxMin && h == 1) ? gr::kBig
                                                                   : 0.0f;
}

template <int kSemiring>
__device__ __forceinline__ float combine(float a, float b) {
  if (kSemiring == kPlusTimes) return a + b;
  return kSemiring == kMaxTimes ? fmaxf(a, b) : fminf(a, b);
}

template <int kSemiring>
__device__ __forceinline__ float4 combine4(float4 a, float4 b) {
  return make_float4(combine<kSemiring>(a.x, b.x), combine<kSemiring>(a.y, b.y),
                     combine<kSemiring>(a.z, b.z), combine<kSemiring>(a.w, b.w));
}

// One slot: row r (window-local), col c, value v. kFull reduces its
// message into the shared window and sets `sent` (kMaxMin: hands a
// positive message to max_min_runs as key = r, m); the floor modes add to
// the thread's share t of the span's sum instead.
template <int kSemiring, bool kUnit, int kMode>
__device__ __forceinline__ void visit(const Args& a, float* win, long xbase,
                                      int r, int c, float v, float& t,
                                      bool& sent, int& key, float& m) {
  if (r == a.window) return;  // padding slot
  const long xi = xbase + c;
  if (!GR_IN_RANGE(xi, a.n_x) || !GR_IN_RANGE(r, a.window)) return;
  if (kMode == kStream) {
    asm volatile("" ::"r"(r), "r"(c));  // keep both loads
    t += v;
    return;
  }
  const float xv = __ldg(a.x + xi);  // read-only: x is reused by every span
  if (kMode == kGather) {
    t += v * xv;
    return;
  }
  if (kSemiring == kPlusTimes) {
    const float msg = kUnit ? xv : v * xv;
    if (msg != 0.0f) {
      atomicAdd(win + r, msg);
      sent = true;
    }
  } else if (kSemiring == kMaxTimes) {
    const float msg = kUnit ? xv : v * xv;
    if (msg > 0.0f) {  // positive floats order like their int bit patterns
      atomicMax(reinterpret_cast<int*>(win + r), __float_as_int(msg));
      sent = true;
    }
  } else if (kSemiring == kMaxMin) {
    const float msg = kUnit ? xv : v * xv;
    if (msg > 0.0f) {
      key = r;
      m = msg;
    }
  } else {
    const float msg = fminf(kUnit ? xv : v + xv, gr::kBig);
    if (msg < gr::kBig) {
      gr::atomic_min_float(win + r, msg);
      sent = true;
    }
  }
}

// kMaxMin: reduces the calling warp's messages (key: the row, < 0 for
// none; m > 0) into the max window win[0, W) and the min window win[W,
// 2W): a segmented max/min by shuffle folds each run of equal keys on
// consecutive lanes, and the run's last lane sends one atomic pair on the
// int bits (positive floats order like them). A warp with no message
// leaves at once, and a lane with none is a run of its own, so a warp
// whose messages hit distinct rows skips the fold. All 32 lanes must call
// it.
__device__ __forceinline__ void max_min_runs(float* win, int window, int key,
                                             float m, bool& sent) {
  constexpr unsigned kAll = 0xffffffffu;
  if (__ballot_sync(kAll, key >= 0) == 0u) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int prev = __shfl_up_sync(kAll, key, 1);
  const unsigned heads =
      __ballot_sync(kAll, lane == 0 || prev != key || key < 0);
  float hi = m, lo = m;
  if (heads != kAll) {  // warp-uniform: a run spans lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up_hi = __shfl_up_sync(kAll, hi, off);
      const float up_lo = __shfl_up_sync(kAll, lo, off);
      // lane - off is in this lane's run iff no run starts in (lane - off, lane]
      if (lane >= off && ((heads >> (lane - off + 1)) & ((1u << off) - 1u)) == 0u) {
        hi = fmaxf(hi, up_hi);
        lo = fminf(lo, up_lo);
      }
    }
  }
  const bool tail = lane == 31 || ((heads >> (lane + 1)) & 1u);
  if (tail && key >= 0) {
    atomicMax(reinterpret_cast<int*>(win + key), __float_as_int(hi));
    atomicMin(reinterpret_cast<int*>(win + window + key), __float_as_int(lo));
    sent = true;
  }
}

// The kPer slots from slot o of the span (one chunk: kPer divides C):
// visit each, unless the chunk is inactive (sparse) or all kPer are
// padding. kMaxMin's messages go to key/m, one per slot.
template <int kSemiring, bool kUnit, bool kSparse, int kMode, bool kVec>
__device__ __forceinline__ void visit_slots(const Args& a, float* win,
                                            int first, long s0, int o,
                                            float& t, bool& sent, int* key,
                                            float* m) {
  constexpr bool kLoadVal = !kUnit || kMode != kFull;
  const int ch = first + o / a.chunk;
  if (kSparse && !a.ch_act[ch]) return;
  const long xbase = static_cast<long>(a.chunk_cb[ch]) * a.window;
  const long s = s0 + o;
  if constexpr (kVec) {
    const int4 r = *reinterpret_cast<const int4*>(a.row + s);
    if (r.x == a.window && r.y == a.window && r.z == a.window &&
        r.w == a.window)
      return;  // four padding slots (a chunk's tail): no more loads
    const int4 c = *reinterpret_cast<const int4*>(a.col + s);
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (kLoadVal) v = *reinterpret_cast<const float4*>(a.val + s);
    visit<kSemiring, kUnit, kMode>(a, win, xbase, r.x, c.x, v.x, t, sent, key[0], m[0]);
    visit<kSemiring, kUnit, kMode>(a, win, xbase, r.y, c.y, v.y, t, sent, key[1], m[1]);
    visit<kSemiring, kUnit, kMode>(a, win, xbase, r.z, c.z, v.z, t, sent, key[2], m[2]);
    visit<kSemiring, kUnit, kMode>(a, win, xbase, r.w, c.w, v.w, t, sent, key[3], m[3]);
  } else {
    const int r = a.row[s];
    if (r == a.window) return;
    const float v = kLoadVal ? a.val[s] : 0.0f;
    visit<kSemiring, kUnit, kMode>(a, win, xbase, r, a.col[s], v, t, sent, key[0], m[0]);
  }
}

template <int kSemiring, bool kUnit, bool kSparse, int kMode, bool kVec>
__global__ void __launch_bounds__(gr::kThreads) span_pass(const Args a) {
  extern __shared__ float4 win4[];  // kFull: the row block's window(s), W floats each
  float* win = reinterpret_cast<float*>(win4);
  __shared__ float warp_t[32];  // floor modes: the block's sum
  __shared__ int any_sent;
  constexpr int kWin = kWindows<kSemiring>;
  const int span = blockIdx.x;
  const int first = a.span_first_chunk[span];
  const int last = a.span_first_chunk[span + 1];
  // uniform over the block, so a bad span leaves before any barrier
  if (!GR_IN_RANGE(first, a.n_chunks) ||
      !GR_IN_RANGE(last - first - 1, a.n_chunks - first))
    return;
  if (kSparse) {  // a span with no active chunk leaves at once
    bool act = false;
    for (int i = threadIdx.x; i < last - first; i += blockDim.x)
      act = act || a.ch_act[first + i] != 0;
    if (!__syncthreads_or(act)) {
      if (threadIdx.x == 0) a.touched[span] = 0;
      return;
    }
  }
  const int W4 = a.window / 4;
  if (kMode == kFull) {
#pragma unroll
    for (int h = 0; h < kWin; ++h) {
      const float e = identity<kSemiring>(h);
      for (int i = threadIdx.x; i < W4; i += blockDim.x)
        win4[h * W4 + i] = make_float4(e, e, e, e);
    }
    if (threadIdx.x == 0) any_sent = 0;
    __syncthreads();
  }
  constexpr int kPer = kVec ? 4 : 1;
  float t = 0.0f;
  bool sent = false;
  const long s0 = static_cast<long>(first) * a.chunk;
  const int n_slots = (last - first) * a.chunk;
  const int lane = threadIdx.x & 31;
  for (int o0 = (threadIdx.x - lane) * kPer; o0 < n_slots;
       o0 += blockDim.x * kPer) {  // warp-uniform, for max_min_runs
    int key[kPer];
    float m[kPer];
#pragma unroll
    for (int p = 0; p < kPer; ++p) key[p] = -1, m[p] = 0.0f;
    const int o = o0 + lane * kPer;
    if (o < n_slots)
      visit_slots<kSemiring, kUnit, kSparse, kMode, kVec>(a, win, first, s0, o,
                                                          t, sent, key, m);
    if (kSemiring == kMaxMin && kMode == kFull) {
#pragma unroll
      for (int p = 0; p < kPer; ++p) max_min_runs(win, a.window, key[p], m[p], sent);
    }
  }
  if (kMode != kFull) {  // every thread gets here: the bounds are uniform
    t = gr::block_sum(t, warp_t);
    if (threadIdx.x == 0) a.t_span[span] = t;
    return;
  }
  if (sent) any_sent = 1;  // every writer stores the same 1
  __syncthreads();
  if (any_sent) {
#pragma unroll
    for (int h = 0; h < kWin; ++h) {
      float4* out = reinterpret_cast<float4*>(
          a.partial + (static_cast<long>(h) * a.n_spans + span) * a.window);
      for (int i = threadIdx.x; i < W4; i += blockDim.x) out[i] = win4[h * W4 + i];
    }
  }
  if (threadIdx.x == 0) a.touched[span] = any_sent;
}

// y's entries [strip*512, strip*512 + 512) of row block rb = blockIdx.x:
// the touched partials of rb's spans combined (gr::reduce_span_strip), the
// identity if none. kMaxMin: window h = blockIdx.z, the max windows into
// y (ymax), the min windows into ymin.
template <int kSemiring>
struct Combine {
  static __device__ __forceinline__ float4 apply(float4 a, float4 b) {
    return combine4<kSemiring>(a, b);
  }
};

template <>
struct Combine<kMaxMin> {
  static __device__ __forceinline__ float4 apply(float4 a, float4 b) {
    return blockIdx.z == 0 ? combine4<kMaxTimes>(a, b) : combine4<kMinPlus>(a, b);
  }
};

template <int kSemiring>
__global__ void __launch_bounds__(gr::kReduceWarps * 32) reduce_spans(const Args a) {
  const int rb = blockIdx.x, h = blockIdx.z;
  float* y = h == 0 ? a.y : a.ymin;
  gr::reduce_span_strip<Combine<kSemiring>>(
      a.partial + static_cast<long>(h) * a.n_spans * a.window, a.touched,
      a.rb_first_span[rb], a.rb_first_span[rb + 1], a.n_spans, a.window,
      blockIdx.y * gr::kStrip, identity<kSemiring>(h),
      y + static_cast<long>(rb) * a.window);
}

// Floor modes' second pass, one block per row block rb: the sum of t_span
// over rb's spans, times 1e-30, into all W entries of y's block rb; 0
// where no chunk reaches rb.
__global__ void floor_fill(const Args a) {
  __shared__ float warp_t[32];
  const int rb = blockIdx.x;
  const int lo = a.rb_first_span[rb], hi = a.rb_first_span[rb + 1];
  float t = 0.0f;
  for (int s = lo + threadIdx.x; s < hi; s += blockDim.x)
    if (GR_IN_RANGE(s, a.n_spans)) t += a.t_span[s];
  const float v = gr::block_sum(t, warp_t) * 1e-30f;  // in every thread
  float* yb = a.y + static_cast<long>(rb) * a.window;
  for (int r = threadIdx.x; r < a.window; r += blockDim.x) yb[r] = v;
}

// The span pass, with 16-byte loads where C and the arrays allow them.
template <int kSemiring, bool kUnit, bool kSparse, int kMode>
int launch_spans(const Args& a, cudaStream_t s) {
  if (a.n_spans <= 0) return cudaSuccess;
  const bool vec = a.chunk % 4 == 0 && gr::aligned16(a.row) &&
                   gr::aligned16(a.col) && gr::aligned16(a.val);
  void (*kernel)(Args) = vec ? span_pass<kSemiring, kUnit, kSparse, kMode, true>
                             : span_pass<kSemiring, kUnit, kSparse, kMode, false>;
  const int smem = kMode == kFull
                       ? static_cast<int>(sizeof(float)) * a.window * kWindows<kSemiring>
                       : 0;
  if (smem > 48 * 1024) {  // above 48 KB only when asked for
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<a.n_spans, gr::kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <int kSemiring, bool kUnit, bool kSparse>
int pull(const Args& a, cudaStream_t s) {
  const int err = launch_spans<kSemiring, kUnit, kSparse, kFull>(a, s);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.n_row_blocks, (a.window + gr::kStrip - 1) / gr::kStrip,
                  kWindows<kSemiring>);
  reduce_spans<kSemiring><<<grid, gr::kReduceWarps * 32, 0, s>>>(a);
  return gr::finish(s);
}

template <bool kSparse>
int dispatch(int semiring, int unit, cudaStream_t s, const Args& a) {
  switch (semiring * 2 + (unit ? 1 : 0)) {
    case kPlusTimes * 2: return pull<kPlusTimes, false, kSparse>(a, s);
    case kPlusTimes * 2 + 1: return pull<kPlusTimes, true, kSparse>(a, s);
    case kMinPlus * 2: return pull<kMinPlus, false, kSparse>(a, s);
    case kMinPlus * 2 + 1: return pull<kMinPlus, true, kSparse>(a, s);
    case kMaxTimes * 2: return pull<kMaxTimes, false, kSparse>(a, s);
    case kMaxTimes * 2 + 1: return pull<kMaxTimes, true, kSparse>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

Args make_args(int n_spans, const void* span_first_chunk,
               const void* rb_first_span, int n_chunks, const void* chunk_cb,
               const void* row_local, const void* col_local,
               const void* values, const void* x, void* y, int window,
               int chunk, int n_vertices, int n_row_blocks) {
  Args a{};
  a.span_first_chunk = static_cast<const int*>(span_first_chunk);
  a.rb_first_span = static_cast<const int*>(rb_first_span);
  a.chunk_cb = static_cast<const int*>(chunk_cb);
  a.row = static_cast<const int*>(row_local);
  a.col = static_cast<const int*>(col_local);
  a.val = static_cast<const float*>(values);
  a.x = static_cast<const float*>(x);
  a.y = static_cast<float*>(y);
  a.n_spans = n_spans;
  a.n_chunks = n_chunks;
  a.n_row_blocks = n_row_blocks;
  a.window = window;
  a.chunk = chunk;
  a.n_x = n_vertices;
  return a;
}

}  // namespace

// The sparse (ch_act: bool[n_chunks] from chunk_activity) or dense (ch_act
// null) pull. semiring: 0 plus_times, 1 min_plus, 2 max_times, 3 the fused
// max/min pass (sparse and valued only). values may be null when unit. x:
// float[n_vertices]. y: float[n_row_blocks * window], written whole; for
// the max/min pass float[2 * n_row_blocks * window], ymax then ymin.
// scratch: float[n_spans * (n_windows * window + 1)], the partial windows
// (two for max/min) and then the touched flags. window must be a multiple
// of 4 (the layout's is of 32).
extern "C" int gr_spmv_pull(int semiring, int unit, const void* ch_act,
                            int n_spans, const void* span_first_chunk,
                            const void* rb_first_span, int n_chunks,
                            const void* chunk_cb, const void* row_local,
                            const void* col_local, const void* values,
                            const void* x, void* y, void* scratch,
                            int window, int chunk,
                            int n_vertices, int n_row_blocks, void* stream) {
  if (window % 4 != 0) return cudaErrorInvalidValue;
  Args a = make_args(n_spans, span_first_chunk, rb_first_span, n_chunks,
                     chunk_cb, row_local, col_local, values, x, y,
                     window, chunk, n_vertices, n_row_blocks);
  a.ch_act = static_cast<const unsigned char*>(ch_act);
  a.partial = static_cast<float*>(scratch);
  const long n_win = semiring == kMaxMin ? 2 : 1;
  a.touched = reinterpret_cast<int*>(a.partial + n_win * n_spans * window);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (semiring == kMaxMin) {
    if (unit || ch_act == nullptr) return cudaErrorInvalidValue;
    a.ymin = a.y + static_cast<long>(n_row_blocks) * window;
    return pull<kMaxMin, false, true>(a, s);
  }
  return ch_act != nullptr ? dispatch<true>(semiring, unit, s, a)
                           : dispatch<false>(semiring, unit, s, a);
}

// A floor mode of the dense plus_times pass over valued chunks (mode 1:
// gather, 2: stream; see the top of the file). t_span: float[n_spans]
// scratch; y: float[n_row_blocks * window], written whole.
extern "C" int gr_spmv_dense_floor(int mode, int n_spans,
                                   const void* span_first_chunk,
                                   const void* rb_first_span, int n_chunks,
                                   const void* chunk_cb,
                                   const void* row_local,
                                   const void* col_local, const void* values,
                                   const void* x, void* t_span, void* y,
                                   int window, int chunk, int n_vertices,
                                   int n_row_blocks, void* stream) {
  Args a = make_args(n_spans, span_first_chunk, rb_first_span, n_chunks,
                     chunk_cb, row_local, col_local, values, x, y,
                     window, chunk, n_vertices, n_row_blocks);
  a.t_span = static_cast<float*>(t_span);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (mode == kGather)
    err = launch_spans<kPlusTimes, false, false, kGather>(a, s);
  else if (mode == kStream)
    err = launch_spans<kPlusTimes, false, false, kStream>(a, s);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  floor_fill<<<n_row_blocks, gr::kThreads, 0, s>>>(a);
  return gr::finish(s);
}

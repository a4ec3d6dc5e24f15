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
// The fused max/min pass (minmax_pull) walks the queued chunks and sends
// each positive message m = val * x twice: an atomic max into ymax
// (identity 0) and an atomic min into ymin (identity BIG, which a row with
// no positive message keeps: BIG, not inf). It needs x >= 0 and values >=
// 0, so m > 0 picks the real messages and both atomics can order the
// floats by their int bits.
//
// What bounds it on this card: bytes. Each slot reads 8 B of row/col
// metadata (12 B valued) and gathers 4 B of x from one window (L1/L2
// resident). A full pass at R-MAT scale 18 moves ~44 MB unit at
// W=2048/C=256 (20,548 chunks) and ~68 MB valued at W=4096/C=1024 (5,359
// chunks): 13-20 us at 3.35 TB/s. The max/min pass over the symmetrized
// R-MAT 18 coloring layout reads 12 B per slot over ~7.8M slots plus x and
// writes two f32[V]: ~97 MB, ~29 us on a full frontier.
//
// Design of the sparse and dense passes: spans. Chunks are sorted by row
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
// 2. reduce_spans, one block of 16 warps per (row block, strip of 512
//    entries): each warp combines the touched partials of every 16th span
//    of the block, eight 16-byte loads in flight per lane (row block 0
//    holds 189 spans at R-MAT 18, so the chain of loads, not the bytes,
//    sets this pass's time), the block combines its warps in order, and
//    all entries of the strip are written; the identity where no span
//    touched the block.
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

enum Semiring { kPlusTimes = 0, kMinPlus = 1, kMaxTimes = 2 };
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
  float* y;        // float[n_row_blocks * window], written whole
  float* partial;  // float[n_spans * window]
  int* touched;    // int[n_spans]
  float* t_span;   // floor modes: float[n_spans]
  int n_spans;
  int n_chunks;
  int n_row_blocks;
  int window;
  int chunk;
  long n_x;  // length of x (n_vertices)
};

template <int kSemiring>
__device__ __forceinline__ float identity() {
  return kSemiring == kMinPlus ? gr::kBig : 0.0f;
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
// message into the shared window and sets `sent`; the floor modes add to
// the thread's share t of the span's sum instead.
template <int kSemiring, bool kUnit, int kMode>
__device__ __forceinline__ void visit(const Args& a, float* win, long xbase,
                                      int r, int c, float v, float& t,
                                      bool& sent) {
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
    const float m = kUnit ? xv : v * xv;
    if (m != 0.0f) {
      atomicAdd(win + r, m);
      sent = true;
    }
  } else if (kSemiring == kMaxTimes) {
    const float m = kUnit ? xv : v * xv;
    if (m > 0.0f) {  // positive floats order like their int bit patterns
      atomicMax(reinterpret_cast<int*>(win + r), __float_as_int(m));
      sent = true;
    }
  } else {
    const float m = fminf(kUnit ? xv : v + xv, gr::kBig);
    if (m < gr::kBig) {
      gr::atomic_min_float(win + r, m);
      sent = true;
    }
  }
}

template <int kSemiring, bool kUnit, bool kSparse, int kMode, bool kVec>
__global__ void __launch_bounds__(gr::kThreads) span_pass(const Args a) {
  extern __shared__ float4 win4[];  // kFull: the row block's window, W floats
  float* win = reinterpret_cast<float*>(win4);
  __shared__ float warp_t[32];  // floor modes: the block's sum
  __shared__ int any_sent;
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
    const float e = identity<kSemiring>();
    for (int i = threadIdx.x; i < W4; i += blockDim.x)
      win4[i] = make_float4(e, e, e, e);
    if (threadIdx.x == 0) any_sent = 0;
    __syncthreads();
  }
  constexpr bool kLoadVal = !kUnit || kMode != kFull;
  constexpr int kPer = kVec ? 4 : 1;
  float t = 0.0f;
  bool sent = false;
  const long s0 = static_cast<long>(first) * a.chunk;
  const int n_slots = (last - first) * a.chunk;
  for (int o = threadIdx.x * kPer; o < n_slots; o += blockDim.x * kPer) {
    const int ch = first + o / a.chunk;  // kPer divides C: one chunk
    if (kSparse && !a.ch_act[ch]) continue;
    const long xbase = static_cast<long>(a.chunk_cb[ch]) * a.window;
    const long s = s0 + o;
    if (kVec) {
      const int4 r = *reinterpret_cast<const int4*>(a.row + s);
      if (r.x == a.window && r.y == a.window && r.z == a.window &&
          r.w == a.window)
        continue;  // four padding slots (a chunk's tail): no more loads
      const int4 c = *reinterpret_cast<const int4*>(a.col + s);
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (kLoadVal) v = *reinterpret_cast<const float4*>(a.val + s);
      visit<kSemiring, kUnit, kMode>(a, win, xbase, r.x, c.x, v.x, t, sent);
      visit<kSemiring, kUnit, kMode>(a, win, xbase, r.y, c.y, v.y, t, sent);
      visit<kSemiring, kUnit, kMode>(a, win, xbase, r.z, c.z, v.z, t, sent);
      visit<kSemiring, kUnit, kMode>(a, win, xbase, r.w, c.w, v.w, t, sent);
    } else {
      const int r = a.row[s];
      if (r == a.window) continue;
      const float v = kLoadVal ? a.val[s] : 0.0f;
      visit<kSemiring, kUnit, kMode>(a, win, xbase, r, a.col[s], v, t, sent);
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
    float4* out = reinterpret_cast<float4*>(a.partial + static_cast<long>(span) * a.window);
    for (int i = threadIdx.x; i < W4; i += blockDim.x) out[i] = win4[i];
  }
  if (threadIdx.x == 0) a.touched[span] = any_sent;
}

// y's entries [strip*512, strip*512 + 512) of row block rb = blockIdx.x:
// the touched partials of rb's spans combined (gr::reduce_span_strip), the
// identity if none.
template <int kSemiring>
struct Combine {
  static __device__ __forceinline__ float4 apply(float4 a, float4 b) {
    return combine4<kSemiring>(a, b);
  }
};

template <int kSemiring>
__global__ void __launch_bounds__(gr::kReduceWarps * 32) reduce_spans(const Args a) {
  const int rb = blockIdx.x;
  gr::reduce_span_strip<Combine<kSemiring>>(
      a.partial, a.touched, a.rb_first_span[rb], a.rb_first_span[rb + 1],
      a.n_spans, a.window, blockIdx.y * gr::kStrip, identity<kSemiring>(),
      a.y + static_cast<long>(rb) * a.window);
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

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

// The span pass, with 16-byte loads where C and the arrays allow them.
template <int kSemiring, bool kUnit, bool kSparse, int kMode>
int launch_spans(const Args& a, cudaStream_t s) {
  if (a.n_spans <= 0) return cudaSuccess;
  const bool vec = a.chunk % 4 == 0 && aligned16(a.row) && aligned16(a.col) &&
                   aligned16(a.val);
  void (*kernel)(Args) = vec ? span_pass<kSemiring, kUnit, kSparse, kMode, true>
                             : span_pass<kSemiring, kUnit, kSparse, kMode, false>;
  const int smem = kMode == kFull ? static_cast<int>(sizeof(float)) * a.window : 0;
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
  const dim3 grid(a.n_row_blocks, (a.window + gr::kStrip - 1) / gr::kStrip);
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

// minmax_pull: ymax[row] = max m, ymin[row] = min m over the positive
// messages m = values * x of the queued chunks; ymax starts at 0, ymin at
// BIG.
__global__ void minmax_pull(const int* __restrict__ queue,
                            const int* __restrict__ count, int n_chunks,
                            const int* __restrict__ chunk_rb,
                            const int* __restrict__ chunk_cb,
                            const int* __restrict__ row_local,
                            const int* __restrict__ col_local,
                            const float* __restrict__ values,
                            const float* __restrict__ x,
                            float* __restrict__ ymax, float* __restrict__ ymin,
                            int window, int chunk, long n_x, long n_y) {
  const int n_work = *count;
  const long n_slots = static_cast<long>(n_chunks) * chunk;
  for (int q = blockIdx.x; q < n_work; q += gridDim.x) {
    const int ch = queue[q];
    if (!GR_IN_RANGE(ch, n_chunks)) continue;
    const long xbase = static_cast<long>(chunk_cb[ch]) * window;
    const long ybase = static_cast<long>(chunk_rb[ch]) * window;
    const long sbase = static_cast<long>(ch) * chunk;
    for (int s = threadIdx.x; s < chunk; s += blockDim.x) {
      if (!GR_IN_RANGE(sbase + s, n_slots)) continue;
      const int r = row_local[sbase + s];
      if (r == window) continue;  // padding slot
      const long xi = xbase + col_local[sbase + s];
      if (!GR_IN_RANGE(xi, n_x) || !GR_IN_RANGE(ybase + r, n_y)) continue;
      const float m = values[sbase + s] * x[xi];
      if (m > 0.0f) {  // positive floats order like their int bit patterns
        atomicMax(reinterpret_cast<int*>(ymax + ybase + r), __float_as_int(m));
        atomicMin(reinterpret_cast<int*>(ymin + ybase + r), __float_as_int(m));
      }
    }
  }
}

}  // namespace

// The sparse (ch_act: bool[n_chunks] from chunk_activity) or dense (ch_act
// null) pull. semiring: 0 plus_times, 1 min_plus, 2 max_times. values may
// be null when unit. x: float[n_vertices]. y: float[n_row_blocks *
// window], written whole. scratch: float[n_spans * (window + 1)], the
// partial windows and then the touched flags. window must be a multiple
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
  a.touched = reinterpret_cast<int*>(a.partial + static_cast<long>(n_spans) * window);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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

// The fused max/min pass over the queued chunks. ymax, ymin:
// float[n_row_blocks * window], already 0 and BIG.
extern "C" int gr_spmv_sparse_minmax(int blocks, const void* queue,
                                     const void* count, int n_chunks,
                                     const void* chunk_rb, const void* chunk_cb,
                                     const void* row_local,
                                     const void* col_local, const void* values,
                                     const void* x, void* ymax, void* ymin,
                                     int window, int chunk, int n_vertices,
                                     int n_row_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  minmax_pull<<<blocks, gr::kThreads, 0, s>>>(
      static_cast<const int*>(queue), static_cast<const int*>(count), n_chunks,
      static_cast<const int*>(chunk_rb), static_cast<const int*>(chunk_cb),
      static_cast<const int*>(row_local), static_cast<const int*>(col_local),
      static_cast<const float*>(values), static_cast<const float*>(x),
      static_cast<float*>(ymax), static_cast<float*>(ymin), window, chunk,
      n_vertices, static_cast<long>(n_row_blocks) * window);
  return gr::finish(s);
}

// Bucketed SpMM, Y = A . X over plus_times, for a dense multi-vector X:
// the dense pass and the frontier-sparse pass.
//
// Replaces:
// - gunrock_tpu/ops/pallas/spmm.py::bucketed_spmm (_make_kernel: per
//   chunk, a [C,W] one-hot bf16 matmul gathers X's window and a [W,C] one
//   matmul scatters the messages, with a hi/lo split for f32 inputs);
// - gunrock_tpu/ops/pallas/spmm.py::bucketed_spmm_sparse (_sparse_kernel:
//   the same per chunk, over the active chunks only, launched through
//   _tail_grid_dispatch; `exact` drops the hi/lo split).
//
// Contract: Y[rb*W + row_local[e], k] += values[e] * X[cb*W + col_local[e], k]
// for every real slot e and every column k, of every chunk (dense) or of
// every chunk that ch_act selects (sparse: the active chunks from
// chunkplan.cu); Y starts at 0, so rows no (active) chunk reaches stay 0
// and a caller can accumulate the result. Padding slots (row_local == W)
// are skipped. X may hold negative values (coloring's signed deltas).
// Zero messages are not added: Y starts at +0 and y + 0 == y; the
// multi-source BFS frontier and coloring's one-hot deltas (-1, 0, +1) are
// mostly 0. The test is m != 0, not m > 0.
//
// What bounds it on this card: bytes. At R-MAT scale 18 with K=32 the
// dense pass reads 12 B of metadata per slot (63 MB over 5.26M slots) and
// X once (33.5 MB), and writes Y (33.5 MB): ~130 MB, ~39 us at 3.35 TB/s.
// The 2*K flops per slot (0.34 GFLOP) are ~5 us at the 67 TFLOP/s f32
// rate. The sparse pass over coloring's symmetrized layout (7,878,410 real
// slots) on a full frontier moves ~160 MB, ~48 us; but each slot gathers a
// K-float row of X, 1 GB at K=32, which comes from the 50 MB L2 if X (33.5
// MB) stays there.
//
// Dense pass (spmm_dense): one block per chunk, threads laid over (slot, k)
// with k fastest, so neighbouring threads read neighbouring X[c, k] and
// add into neighbouring Y[r, k] with global atomics. All arithmetic is f32,
// which covers the TPU's `exact` (bf16-exact) mode as well.
//
// Sparse pass: spans, as the semiring pull's (semiring.cu), with K cut
// into tiles of Kt columns. Three kernels:
// 1. x_row_flags: one byte per row of X, whether it holds a nonzero and
//    whether it holds a value that is not finite, read once (33.5 MB at
//    K=32). A slot whose X row is all zero, or whose value is 0 over a
//    finite row, can send no message other than +-0, and is dropped before
//    its X row is read: half the slots of greedy coloring's layout (value
//    0), most rows of its later deltas, and most of SpGEMM's row-sparse X.
// 2. spmm_keep, one block per span of the layout's row span table: a span
//    with no active chunk (ch_act) leaves at once; else a warp loads the
//    row, col and value of 4 x 32 slots, all in flight together, and
//    appends the slots it keeps, as (row, X row, value), to the span's
//    list in scratch (at the span's own slot offset, in slot order within
//    each warp's 32 slots), so that the metadata is walked once and not
//    once per K tile.
// 3. spmm_spans, one block of 512 threads per (span, K tile), tiles of one
//    span next to each other. The block reduces the span's kept slots
//    into a W x Kt window in dynamic shared memory (Kt = 8 at W=2048: 64
//    KB, three blocks per SM): a warp loads 32 kept slots, and groups of
//    Kt lanes take runs of them by shuffle; lanes run over k, so a slot's
//    X row segment is one coalesced load, and the messages of one row add
//    up in a register (the layout keeps a chunk's slots in row order)
//    before a shared-memory atomic adds them into the window. Then the
//    block adds the window's nonzero entries into Y with global atomics
//    (float4 where K % 4 == 0), at most one per span and entry.
// So a message no longer leaves the SM as a global atomic. The first
// design, one thread per (slot, k) with an integer division and three
// metadata reloads per thread and one global atomic per nonzero message,
// took 1.09 ms of device time at K=32 on coloring's first round, where
// row block 0 owns 12,054 of the 36,028 chunks; 0.76 ms of it went to the
// per-(slot, k) metadata stream alone and 0.24 to the atomics (its floor
// split, on an NVIDIA H100 80GB HBM3 at 700 W). On the same card this
// design takes 0.34 ms there (probes/pull.py); walking the metadata once
// per K tile instead of keeping the slots took 0.45, Kt = 4 (more tiles)
// and Kt = 16 (128 KB, one block per SM) were slower. Float sums land in
// any order (atomics), so they are not bit-reproducible.

#include "common.cuh"

namespace {

constexpr int kSlotsPerLane = 4;  // spmm_spans: slots whose loads a lane has in flight

constexpr int kKeepThreads = 512;  // spmm_keep's threads per block
constexpr int kSpanThreads = 512;  // spmm_spans': three 64 KB windows an SM
constexpr unsigned char kRowNonzero = 1, kRowNonfinite = 2;

__global__ void spmm_dense(int n_chunks, const int* __restrict__ chunk_rb,
                           const int* __restrict__ chunk_cb,
                           const int* __restrict__ row_local,
                           const int* __restrict__ col_local,
                           const float* __restrict__ values,
                           const float* __restrict__ x, float* __restrict__ y,
                           int window, int chunk, int k, long n_x, long n_y) {
  const long n_slots = static_cast<long>(n_chunks) * chunk;
  const int total = chunk * k;
  for (int ch = blockIdx.x; ch < n_chunks; ch += gridDim.x) {
    const long xbase = static_cast<long>(chunk_cb[ch]) * window;
    const long ybase = static_cast<long>(chunk_rb[ch]) * window;
    const long sbase = static_cast<long>(ch) * chunk;
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      const int s = t / k;
      const int j = t - s * k;
      if (!GR_IN_RANGE(sbase + s, n_slots)) continue;
      const int r = row_local[sbase + s];
      if (r == window) continue;  // padding slot
      const long xi = xbase + col_local[sbase + s];
      if (!GR_IN_RANGE(xi, n_x) || !GR_IN_RANGE(ybase + r, n_y)) continue;
      const float m = values[sbase + s] * x[xi * k + j];
      if (m != 0.0f) atomicAdd(&y[(ybase + r) * k + j], m);
    }
  }
}

struct SpanArgs {
  const int* span_first_chunk;  // int[n_spans + 1]
  const unsigned char* ch_act;  // bool[n_chunks]
  const int* chunk_rb;
  const int* chunk_cb;
  const int* row;
  const int* col;
  const float* val;
  const float* x;                 // float[n_x, k]
  const unsigned char* xrow;      // uint8[n_x], from x_row_flags
  float* y;                       // float[n_y, k], zero on entry
  int* kept;    // int[n_spans]: kept slots of each span
  int* keep_r;  // int[n_chunks * chunk]: the kept slots' rows, then
  int* keep_x;  // their X rows and values, each span's at its own
  float* keep_v;  // slot offset
  int n_spans;
  int n_tiles;
  int n_chunks;
  int window;
  int chunk;
  int k;
  long n_x;
  long n_y;
};

// xrow[v] = kRowNonzero if row v of x holds an entry != 0 (NaN too), |
// kRowNonfinite if it holds an inf or NaN. A group of `lanes` lanes (a
// power of two up to 32) per row, each loading a float4 (kVec: K % 4 == 0)
// or a float at a time, so that a warp reads whole rows at once.
template <bool kVec>
__global__ void x_row_flags(const float* __restrict__ x, long n_x, int k,
                            int lanes, unsigned char* __restrict__ xrow) {
  constexpr int kPer = kVec ? 4 : 1;
  const int lane = threadIdx.x & 31;
  const int grp = lane / lanes, gl = lane % lanes;
  const int rows = 32 / lanes;  // rows a warp takes at once
  const unsigned mask = (lanes == 32 ? 0xffffffffu : (1u << lanes) - 1u)
                        << (grp * lanes);
  const long warp = (static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long n_warps = (static_cast<long>(gridDim.x) * blockDim.x) >> 5;
  for (long base = warp * rows; base < n_x; base += n_warps * rows) {  // warp-uniform
    const long v = base + grp;
    bool nz = false, nf = false;
    if (v < n_x) {
      for (int j = gl * kPer; j < k; j += lanes * kPer) {
        float e[kPer];
        if (kVec) {
          const float4 q = __ldg(reinterpret_cast<const float4*>(x + v * k + j));
          e[0] = q.x, e[1] = q.y, e[2] = q.z, e[3] = q.w;
        } else {
          e[0] = __ldg(x + v * k + j);
        }
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          nz = nz || e[i] != 0.0f;
          nf = nf || !isfinite(e[i]);
        }
      }
    }
    const unsigned bz = __ballot_sync(0xffffffffu, nz);
    const unsigned bf = __ballot_sync(0xffffffffu, nf);
    if (gl == 0 && v < n_x)
      xrow[v] = ((bz & mask) ? kRowNonzero : 0) | ((bf & mask) ? kRowNonfinite : 0);
  }
}

// Whether a slot of value v over an X row with flags f can send a message
// other than +-0: v * 0 is +-0 unless v is inf or NaN, and 0 * x is +-0
// unless x is.
__device__ __forceinline__ bool can_send(float v, unsigned char f) {
  return ((f & kRowNonzero) || !isfinite(v)) &&
         (v != 0.0f || (f & kRowNonfinite));
}

// The span's kept slots: every real slot of its active chunks that
// can_send keeps, as (row, X row, value) in keep_r/keep_x/keep_v from the
// span's first slot on, in slot order within each warp's 32 slots, and
// their number in kept[span]. One block per span; a span with no active
// chunk leaves at once.
__global__ void __launch_bounds__(kKeepThreads) spmm_keep(const SpanArgs a) {
  __shared__ int n_kept;
  const int span = blockIdx.x;
  const int first = a.span_first_chunk[span];
  const int last = a.span_first_chunk[span + 1];
  // uniform over the block, so a bad span leaves before any barrier
  if (!GR_IN_RANGE(first, a.n_chunks) ||
      !GR_IN_RANGE(last - first - 1, a.n_chunks - first)) {
    if (threadIdx.x == 0) a.kept[span] = 0;
    return;
  }
  bool act = false;  // a span with no active chunk leaves at once
  for (int i = threadIdx.x; i < last - first; i += blockDim.x)
    act = act || a.ch_act[first + i] != 0;
  if (threadIdx.x == 0) n_kept = 0;
  if (!__syncthreads_or(act)) {
    if (threadIdx.x == 0) a.kept[span] = 0;
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const long s0 = static_cast<long>(first) * a.chunk;
  const int n_slots = (last - first) * a.chunk;
  constexpr int kStep = 32 * kSlotsPerLane;
  for (int base = warp * kStep; base < n_slots;
       base += (kKeepThreads / 32) * kStep) {  // warp-uniform
    // the metadata of 32 * kSlotsPerLane slots, lane + 32 j for lane's j-th
    int r[kSlotsPerLane], xi[kSlotsPerLane];
    float v[kSlotsPerLane];
    bool work[kSlotsPerLane];
#pragma unroll
    for (int j = 0; j < kSlotsPerLane; ++j) {
      const int o = base + 32 * j + lane;
      const int ch = first + (o < n_slots ? o : 0) / a.chunk;
      const bool on = o < n_slots && a.ch_act[ch];  // no loads off it
      r[j] = on ? a.row[s0 + o] : a.window;
      const int c = on ? a.col[s0 + o] : 0;
      v[j] = on ? a.val[s0 + o] : 0.0f;
      const long xl = static_cast<long>(on ? a.chunk_cb[ch] : 0) * a.window + c;
      work[j] = r[j] != a.window && GR_IN_RANGE(xl, a.n_x) &&
                GR_IN_RANGE(r[j], a.window);
      xi[j] = work[j] ? static_cast<int>(xl) : 0;
    }
#pragma unroll
    for (int j = 0; j < kSlotsPerLane; ++j)
      work[j] = work[j] && can_send(v[j], a.xrow[xi[j]]);
#pragma unroll
    for (int j = 0; j < kSlotsPerLane; ++j) {
      const unsigned todo = __ballot_sync(0xffffffffu, work[j]);
      if (todo == 0u) continue;  // warp-uniform
      int at = 0;
      if (lane == 0) at = atomicAdd(&n_kept, __popc(todo));
      at = __shfl_sync(0xffffffffu, at, 0) + __popc(todo & lanes_below);
      if (work[j] && GR_IN_RANGE(at, n_slots)) {
        a.keep_r[s0 + at] = r[j];
        a.keep_x[s0 + at] = xi[j];
        a.keep_v[s0 + at] = v[j];
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) a.kept[span] = n_kept;
}

// Y's K tile k0 = (blockIdx.x % n_tiles) * Kt over the kept slots of span
// blockIdx.x / n_tiles: a warp loads 32 kept slots at a time, groups of Kt
// lanes take runs of them by shuffle, lanes over k.
template <int kKt>
__global__ void __launch_bounds__(kSpanThreads) spmm_spans(const SpanArgs a) {
  extern __shared__ float4 win4[];  // W rows x kKt columns of the K tile
  float* win = reinterpret_cast<float*>(win4);
  __shared__ int any_sent;
  const int span = blockIdx.x / a.n_tiles;
  const int k0 = (blockIdx.x - span * a.n_tiles) * kKt;
  const int first = a.span_first_chunk[span];
  const int last = a.span_first_chunk[span + 1];
  const int n = a.kept[span];
  // uniform over the block, so a bad span leaves before any barrier; a
  // span that keeps no slot leaves at once
  if (n == 0 || !GR_IN_RANGE(first, a.n_chunks) ||
      !GR_IN_RANGE(n - 1, (last - first) * a.chunk))
    return;
  const int n_win = a.window * kKt;  // W % 4 == 0: whole float4s
  for (int i = threadIdx.x; i < n_win / 4; i += blockDim.x)
    win4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (threadIdx.x == 0) any_sent = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kGroups = 32 / kKt;  // kept slots a warp takes at once
  const int grp = lane / kKt, kk = lane % kKt;
  const bool k_ok = k0 + kk < a.k;
  bool sent = false;
  const long s0 = static_cast<long>(first) * a.chunk;
  for (int base = warp * 32; base < n; base += kSpanThreads) {  // warp-uniform
    const int e = base + lane;
    const int r = e < n ? a.keep_r[s0 + e] : 0;
    const int xi = e < n ? a.keep_x[s0 + e] : 0;
    const float v = e < n ? a.keep_v[s0 + e] : 0.0f;
    const int m = n - base < 32 ? n - base : 32;
    // group grp takes kept slots grp * per ... in order (per * kGroups
    // <= 32); messages of one row add up in a register first
    const int per = (m + kGroups - 1) / kGroups;
    int run = -1;
    float acc = 0.0f;
#pragma unroll 4
    for (int t = 0; t < per; ++t) {  // warp-uniform
      const int src = grp * per + t;
      const int rs = __shfl_sync(0xffffffffu, r, src);
      const int xs = __shfl_sync(0xffffffffu, xi, src);
      const float vs = __shfl_sync(0xffffffffu, v, src);
      if (src < m && k_ok && GR_IN_RANGE(rs, a.window) &&
          GR_IN_RANGE(xs, a.n_x)) {
        const float msg = vs * __ldg(a.x + static_cast<long>(xs) * a.k + k0 + kk);
        if (rs != run) {
          if (acc != 0.0f) {
            atomicAdd(win + run * kKt + kk, acc);
            sent = true;
          }
          run = rs;
          acc = 0.0f;
        }
        acc += msg;
      }
    }
    if (acc != 0.0f) {
      atomicAdd(win + run * kKt + kk, acc);
      sent = true;
    }
  }
  if (sent) any_sent = 1;  // every writer stores the same 1
  __syncthreads();
  if (!any_sent) return;

  // the window's nonzero entries into Y: one atomic per entry and span
  const long ybase = static_cast<long>(a.chunk_rb[first]) * a.window;
  if (kKt % 4 == 0 && a.k % 4 == 0) {  // 16-byte aligned rows of Y
    for (int i = threadIdx.x; i < n_win / 4; i += blockDim.x) {
      const float4 w = win4[i];
      if (w.x == 0.0f && w.y == 0.0f && w.z == 0.0f && w.w == 0.0f) continue;
      const int r = 4 * i / kKt, c = 4 * i % kKt;
      const long yr = ybase + r;
      if (!GR_IN_RANGE(yr, a.n_y) || k0 + c >= a.k) continue;
      atomicAdd(reinterpret_cast<float4*>(a.y + yr * a.k + k0 + c), w);
    }
  } else {
    for (int i = threadIdx.x; i < n_win; i += blockDim.x) {
      const float w = win[i];
      if (w == 0.0f) continue;
      const int r = i / kKt, c = i % kKt;
      const long yr = ybase + r;
      if (!GR_IN_RANGE(yr, a.n_y) || k0 + c >= a.k) continue;
      atomicAdd(a.y + yr * a.k + k0 + c, w);
    }
  }
}

template <int kKt>
int launch_spans(const SpanArgs& a, cudaStream_t s) {
  const int smem = static_cast<int>(sizeof(float)) * a.window * kKt;
  if (smem > 48 * 1024) {  // above 48 KB only when asked for
    const cudaError_t err = cudaFuncSetAttribute(
        spmm_spans<kKt>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  spmm_keep<<<a.n_spans, kKeepThreads, 0, s>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  spmm_spans<kKt><<<a.n_spans * a.n_tiles, kSpanThreads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The dense pass over all n_chunks chunks, one block per chunk. x:
// float[n_vertices, k]. y: float[n_row_blocks * window, k], already zero.
extern "C" int gr_spmm(int n_chunks, const void* chunk_rb, const void* chunk_cb,
                       const void* row_local, const void* col_local,
                       const void* values, const void* x, void* y, int window,
                       int chunk, int k, int n_vertices, int n_row_blocks,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  spmm_dense<<<n_chunks, gr::kThreads, 0, s>>>(
      n_chunks, static_cast<const int*>(chunk_rb),
      static_cast<const int*>(chunk_cb), static_cast<const int*>(row_local),
      static_cast<const int*>(col_local), static_cast<const float*>(values),
      static_cast<const float*>(x), static_cast<float*>(y), window, chunk, k,
      n_vertices, static_cast<long>(n_row_blocks) * window);
  return gr::finish(s);
}

// The sparse pass over the chunks ch_act (bool[n_chunks]) selects, on the
// span table (span_first_chunk, n_spans), in K tiles of k_tile columns
// (1, 2, 4, 8, 16 or 32; window * k_tile floats of shared memory). x:
// float[n_vertices, k]; xrow: uint8[n_vertices] scratch; scratch:
// int[n_spans + 3 * n_chunks * chunk], the kept slots; y:
// float[n_row_blocks * window, k], already zero. window must be a multiple
// of 4.
extern "C" int gr_spmm_spans(int k_tile, int n_spans,
                             const void* span_first_chunk, const void* ch_act,
                             int n_chunks, const void* chunk_rb,
                             const void* chunk_cb, const void* row_local,
                             const void* col_local, const void* values,
                             const void* x, void* xrow, void* scratch,
                             void* y, int window, int chunk, int k,
                             int n_vertices, int n_row_blocks, void* stream) {
  if (window % 4 != 0 || k < 1 || k_tile < 1 || k_tile > 32 ||
      (k_tile & (k_tile - 1)) != 0)
    return cudaErrorInvalidValue;
  SpanArgs a{};
  a.span_first_chunk = static_cast<const int*>(span_first_chunk);
  a.ch_act = static_cast<const unsigned char*>(ch_act);
  a.chunk_rb = static_cast<const int*>(chunk_rb);
  a.chunk_cb = static_cast<const int*>(chunk_cb);
  a.row = static_cast<const int*>(row_local);
  a.col = static_cast<const int*>(col_local);
  a.val = static_cast<const float*>(values);
  a.x = static_cast<const float*>(x);
  a.xrow = static_cast<const unsigned char*>(xrow);
  a.y = static_cast<float*>(y);
  const long n_slots = static_cast<long>(n_chunks) * chunk;
  a.kept = static_cast<int*>(scratch);
  a.keep_r = a.kept + n_spans;
  a.keep_x = a.keep_r + n_slots;
  a.keep_v = reinterpret_cast<float*>(a.keep_x + n_slots);
  a.n_spans = n_spans;
  a.n_tiles = (k + k_tile - 1) / k_tile;
  a.n_chunks = n_chunks;
  a.window = window;
  a.chunk = chunk;
  a.k = k;
  a.n_x = n_vertices;
  a.n_y = static_cast<long>(n_row_blocks) * window;
  if (static_cast<long>(n_spans) * a.n_tiles > 0x7fffffffL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = k % 4 == 0 && reinterpret_cast<unsigned long long>(x) % 16 == 0;
  int lanes = 1;  // lanes per row of x: enough for one load each, <= 32
  while (lanes < 32 && lanes * (vec ? 4 : 1) < k) lanes *= 2;
  const int flag_blocks = gr::grid_for((n_vertices * 32L + 31) / (32 / lanes), 1 << 16);
  if (vec)
    x_row_flags<true><<<flag_blocks, gr::kThreads, 0, s>>>(
        a.x, a.n_x, k, lanes, static_cast<unsigned char*>(xrow));
  else
    x_row_flags<false><<<flag_blocks, gr::kThreads, 0, s>>>(
        a.x, a.n_x, k, lanes, static_cast<unsigned char*>(xrow));
  int err = cudaGetLastError();
  if (err == cudaSuccess && n_spans > 0) {
    switch (k_tile) {
      case 1: err = launch_spans<1>(a, s); break;
      case 2: err = launch_spans<2>(a, s); break;
      case 4: err = launch_spans<4>(a, s); break;
      case 8: err = launch_spans<8>(a, s); break;
      case 16: err = launch_spans<16>(a, s); break;
      case 32: err = launch_spans<32>(a, s); break;
      default: err = cudaErrorInvalidValue;
    }
  }
  return err != cudaSuccess ? err : gr::finish(s);
}

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
// Design of both passes: spans, as the semiring pull's (semiring.cu),
// each span's row window cut into tiles of rows and X's columns; the dense
// pass is the sparse pass with every chunk active (kDense: no chunk plan,
// no ch_act read, no span leaves early). All arithmetic is f32, which
// covers the TPU's `exact` (bf16-exact) mode as well. Three kernels:
// 1. x_row_flags: one byte per row of X, whether it holds a nonzero and
//    whether it holds a value that is not finite, read once (33.5 MB at
//    K=32). A slot whose X row is all zero, or whose value is 0 over a
//    finite row, can send no message other than +-0, and is dropped before
//    its X row is read: half the slots of greedy coloring's layout (value
//    0), most rows of its later deltas, and most of SpGEMM's row-sparse X.
// 2. spmm_keep, one block per span of the layout's row span table: a span
//    with no active chunk (ch_act) leaves at once; else a warp loads the
//    row, col and value of 4 x 32 slots, all in flight together. In the
//    dense pass the block counting-sorts the slots it keeps by row: it
//    counts each row's slots in shared memory (int atomics, native), scans
//    the counts into places, walks the metadata again (from L2) to place
//    each kept slot, as (row, X row, value), in a list staged in shared
//    memory, and writes the list out whole at the span's own slot offset,
//    with the offsets of its row tiles. The frontier-sparse pass appends
//    the slots it keeps as they come (in slot order within each warp's 32
//    slots): coloring's one-hot X sends to one column of a slot, so its
//    few window atomics do not pay for the sort.
// 3. spmm_spans, one block of 512 threads per (span, row tile, K tile),
//    the tiles of one span next to each other. A tile is row_tile rows x
//    Kt columns of the window in dynamic shared memory, 64 KB (three
//    blocks per SM). Over the dense pass's sorted list Kt = the K columns
//    up to 32 and row_tile = 16384 / Kt rows: 512 x 32 at K=32, the whole
//    window (2048 rows) at K <= 8. Over the frontier-sparse pass's list a
//    tile holds the whole window and Kt is halved until it fits (8 at
//    W=2048). The block takes its row tile's part of the list: a warp
//    loads 32 kept slots, groups of Kt / 4 lanes take runs of them by shuffle, each lane
//    four columns with one 16-byte load of X (one column a lane where K %
//    4 != 0), the messages of one row add up in registers before
//    shared-memory atomics add them into the tile. Then the block adds the
//    tile's nonzero entries into Y with global atomics (float4 where K % 4
//    == 0), at most one per tile entry. With `walk` (kWalk; one row tile)
//    there is no keep pass: the tile pass loads the span's metadata itself
//    as the keep pass does, and each warp packs the slots of its 32 that
//    can send, in slot order, before the same reduction.
// So a message no longer leaves the SM as a global atomic. Why rows are
// sorted and tiled: a shared-memory float atomicAdd compiles to a
// compare-and-swap loop on this card (LDS, FADD, ATOMS.CAST.SPIN in the
// SASS), and the pull layout hits ~252 distinct rows in a chunk, so an
// unsorted list sends one such loop per slot and column; and with K tiles
// of 8 columns over the whole window each slot was walked once per K tile.
// The first design of both passes, one thread per (slot, k) with an
// integer division and three metadata reloads per thread and one global
// atomic per nonzero message, took 1.09 ms of device time at K=32 on
// coloring's first round, where row block 0 owns 12,054 of the 36,028
// chunks; 0.76 ms of it went to the per-(slot, k) metadata stream alone
// and 0.24 to the atomics (its floor split, on an NVIDIA H100 80GB HBM3 at
// 700 W). Float sums land in any order (atomics), so they are not
// bit-reproducible.

#include "common.cuh"

namespace {

constexpr int kSlotsPerLane = 4;  // slots whose loads a lane has in flight

constexpr int kKeepThreads = 512;  // spmm_keep's threads per block
constexpr int kSpanThreads = 512;  // spmm_spans': three 64 KB windows an SM
constexpr unsigned char kRowNonzero = 1, kRowNonfinite = 2;

struct SpanArgs {
  const int* span_first_chunk;  // int[n_spans + 1]
  const unsigned char* ch_act;  // bool[n_chunks]; null in the dense pass
  const int* chunk_rb;
  const int* chunk_cb;
  const int* row;
  const int* col;
  const float* val;
  const float* x;                 // float[n_x, k]
  const unsigned char* xrow;      // uint8[n_x], from x_row_flags
  float* y;                       // float[n_y, k], zero on entry
  // keep pass: each span's kept slots sorted by row, and where each row
  // tile's start in that list: tile_off[span * (n_rtiles + 1) + t], t =
  // 0..n_rtiles (the last is the span's number of kept slots)
  int* tile_off;
  int* keep_r;    // int[n_chunks * chunk]: the kept slots' rows, then
  int* keep_x;    // their X rows and values, each span's at its own
  float* keep_v;  // slot offset
  int n_spans;
  int n_tiles;   // K tiles of k_tile columns
  int n_rtiles;  // row tiles of row_tile rows (the window's W rows)
  int row_tile;
  int span_slots;  // the most slots of a span (the keep pass stages them)
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

// Whether the span [first, last) holds an active chunk (every span does in
// the dense pass): the same answer in every thread, after a barrier that
// every thread must reach.
template <bool kDense>
__device__ __forceinline__ bool span_active(const SpanArgs& a, int first,
                                            int last) {
  bool act = kDense;
  if (!kDense)
    for (int i = threadIdx.x; i < last - first; i += blockDim.x)
      act = act || a.ch_act[first + i] != 0;
  return __syncthreads_or(act);
}

// The metadata of 32 * kSlotsPerLane slots of the span from slot `base`,
// lane + 32 j for the lane's j-th, all loads in flight together: row r, X
// row xi and value v, and whether the slot can send (a real slot of an
// active chunk that can_send keeps). Called by whole warps.
template <bool kDense>
__device__ __forceinline__ void load_slots(const SpanArgs& a, int first,
                                           long s0, int n_slots, int base,
                                           int (&r)[kSlotsPerLane],
                                           int (&xi)[kSlotsPerLane],
                                           float (&v)[kSlotsPerLane],
                                           bool (&work)[kSlotsPerLane]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kSlotsPerLane; ++j) {
    const int o = base + 32 * j + lane;
    const int ch = first + (o < n_slots ? o : 0) / a.chunk;
    const bool on = o < n_slots && (kDense || a.ch_act[ch]);  // no loads off it
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
}

// The exclusive prefix sum of v over the calling block (whole warps, at
// most 1024 threads) and, in *total, the block's sum. warp_sums: 32 ints
// of shared memory. Every thread must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += up;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  *total = warp_sums[n_warps - 1];
  const int before = warp > 0 ? warp_sums[warp - 1] : 0;
  __syncthreads();  // warp_sums may be written again after this
  return before + incl - v;
}

// The span's kept slots, every slot that load_slots says can send, as
// (row, X row, value) in keep_r/keep_x/keep_v from the span's first slot
// on, and the offsets of its row tiles in tile_off. kSort: sorted by row,
// by a counting sort over the W rows in shared memory (count, scan,
// place; within a row in any order) into a list staged in shared memory,
// then written out whole; the metadata is walked twice, the second time
// from L2. Else (one row tile) appended as they come, in slot order within
// each warp's 32 slots. One block per span; a span with no active chunk
// leaves at once.
template <bool kDense, bool kSort>
__global__ void __launch_bounds__(kKeepThreads) spmm_keep(const SpanArgs a) {
  // kSort: W counts of rows (then their next places), then the staged
  // list's rows, X rows and values, span_slots each
  extern __shared__ int keep_smem[];
  __shared__ int warp_sums[32];
  __shared__ int n_kept;
  int* at_row = keep_smem;
  int* st_r = at_row + a.window;
  int* st_x = st_r + a.span_slots;
  float* st_v = reinterpret_cast<float*>(st_x + a.span_slots);
  const int span = blockIdx.x;
  const int first = a.span_first_chunk[span];
  const int last = a.span_first_chunk[span + 1];
  int* off = a.tile_off + static_cast<long>(span) * (a.n_rtiles + 1);
  // uniform over the block, so a bad span leaves before any barrier
  if (!GR_IN_RANGE(first, a.n_chunks) ||
      !GR_IN_RANGE(last - first - 1, a.n_chunks - first) ||
      (kSort && !GR_IN_RANGE((last - first) * a.chunk - 1, a.span_slots))) {
    for (int t = threadIdx.x; t <= a.n_rtiles; t += blockDim.x) off[t] = 0;
    return;
  }
  if (kSort)
    for (int i = threadIdx.x; i < a.window; i += blockDim.x) at_row[i] = 0;
  if (threadIdx.x == 0) n_kept = 0;
  if (!span_active<kDense>(a, first, last)) {  // its barrier orders the zeros
    for (int t = threadIdx.x; t <= a.n_rtiles; t += blockDim.x) off[t] = 0;
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long s0 = static_cast<long>(first) * a.chunk;
  const int n_slots = (last - first) * a.chunk;
  constexpr int kStep = 32 * kSlotsPerLane;
  for (int base = warp * kStep; base < n_slots;
       base += (kKeepThreads / 32) * kStep) {  // warp-uniform
    int r[kSlotsPerLane], xi[kSlotsPerLane];
    float v[kSlotsPerLane];
    bool work[kSlotsPerLane];
    load_slots<kDense>(a, first, s0, n_slots, base, r, xi, v, work);
#pragma unroll
    for (int j = 0; j < kSlotsPerLane; ++j) {
      if (kSort) {
        if (work[j]) atomicAdd(at_row + r[j], 1);
        continue;
      }
      const unsigned todo = __ballot_sync(0xffffffffu, work[j]);
      if (todo == 0u) continue;  // warp-uniform
      int at = 0;
      if (lane == 0) at = atomicAdd(&n_kept, __popc(todo));
      at = __shfl_sync(0xffffffffu, at, 0) + __popc(todo & ((1u << lane) - 1u));
      if (work[j] && GR_IN_RANGE(at, n_slots)) {
        a.keep_r[s0 + at] = r[j];
        a.keep_x[s0 + at] = xi[j];
        a.keep_v[s0 + at] = v[j];
      }
    }
  }
  __syncthreads();
  if constexpr (!kSort) {
    if (threadIdx.x == 0) off[0] = 0, off[1] = n_kept;
    return;
  }
  // each thread scans a run of rows: their first places in the sorted list
  const int per = (a.window + blockDim.x - 1) / blockDim.x;
  const int b0 = threadIdx.x * per;
  int sum = 0;
  for (int i = 0; i < per && b0 + i < a.window; ++i) sum += at_row[b0 + i];
  int total;
  int place = block_exclusive_scan(sum, warp_sums, &total);
  for (int i = 0; i < per && b0 + i < a.window; ++i) {
    const int c = at_row[b0 + i];
    at_row[b0 + i] = place;
    place += c;
  }
  __syncthreads();
  for (int t = threadIdx.x; t <= a.n_rtiles; t += blockDim.x)
    off[t] = t < a.n_rtiles ? at_row[t * a.row_tile] : total;
  __syncthreads();  // before at_row moves on
  for (int base = warp * kStep; base < n_slots;
       base += (kKeepThreads / 32) * kStep) {  // warp-uniform
    int r[kSlotsPerLane], xi[kSlotsPerLane];
    float v[kSlotsPerLane];
    bool work[kSlotsPerLane];
    load_slots<kDense>(a, first, s0, n_slots, base, r, xi, v, work);
#pragma unroll
    for (int j = 0; j < kSlotsPerLane; ++j) {
      if (!work[j]) continue;
      const int at = atomicAdd(at_row + r[j], 1);
      if (GR_IN_RANGE(at, n_slots)) {
        st_r[at] = r[j];
        st_x[at] = xi[j];
        st_v[at] = v[j];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    a.keep_r[s0 + i] = st_r[i];
    a.keep_x[s0 + i] = st_x[i];
    a.keep_v[s0 + i] = st_v[i];
  }
}

// Adds the messages of m <= 32 slots, lane e holding slot e's (row r, X
// row xi, value v), into the window of rows r0... and the K tile k0:
// groups of lanes take runs of the slots by shuffle, each lane kPer of the tile's columns (kPer = 4:
// one 16-byte load of X, where K % 4 == 0 and Kt >= 4; else 1), so that a
// slot's X row segment is one coalesced load; the messages of one row add
// up in registers (the keep pass sorts a span's slots by row) before
// shared-memory atomics add them into the window, each group starting at
// another of its four columns so that the groups' atomics spread over the
// banks. Called by whole warps, m warp-uniform.
template <int kKt, int kPer>
__device__ __forceinline__ void add_slots(const SpanArgs& a, float* win,
                                          int r0, int k0, int r, int xi,
                                          float v, int m, bool& sent) {
  constexpr int kLanes = kKt / kPer;   // lanes per slot
  constexpr int kGroups = 32 / kLanes;  // slots a warp takes at once
  const int lane = threadIdx.x & 31;
  const int grp = lane / kLanes, c0 = (lane % kLanes) * kPer;
  const bool k_ok = k0 + c0 < a.k;  // kPer = 4: K % 4 == 0, all four or none
  // group grp takes slots grp * per ... in order (per * kGroups <= 32)
  const int per = (m + kGroups - 1) / kGroups;
  int run = -1;
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.0f;
  auto flush = [&]() {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = (j + grp) % kPer;
      float val = acc[0];
#pragma unroll
      for (int q = 1; q < kPer; ++q) val = i == q ? acc[q] : val;  // no local memory
      if (val != 0.0f) {
        atomicAdd(win + run * kKt + c0 + i, val);
        sent = true;
      }
    }
  };
#pragma unroll 4
  for (int t = 0; t < per; ++t) {  // warp-uniform
    const int src = grp * per + t;
    const int rs = __shfl_sync(0xffffffffu, r, src) - r0;
    const int xs = __shfl_sync(0xffffffffu, xi, src);
    const float vs = __shfl_sync(0xffffffffu, v, src);
    if (src < m && k_ok && GR_IN_RANGE(rs, a.row_tile) &&
        GR_IN_RANGE(xs, a.n_x)) {
      const float* xp = a.x + static_cast<long>(xs) * a.k + k0 + c0;
      float xv[kPer];
      if constexpr (kPer == 4) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(xp));
        xv[0] = q.x, xv[1] = q.y, xv[2] = q.z, xv[3] = q.w;
      } else {
        xv[0] = __ldg(xp);
      }
      if (rs != run) {
        if (run >= 0) flush();
        run = rs;
#pragma unroll
        for (int i = 0; i < kPer; ++i) acc[i] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] += vs * xv[i];
    }
  }
  if (run >= 0) flush();
}

// One tile of Y: rows r0 = rt * row_tile ... of the span's row block and
// columns k0 = kt * Kt ..., for blockIdx.x = (span * n_rtiles + rt) *
// n_tiles + kt. kWalk (one row tile): the block walks the span's metadata
// itself (load_slots), and each warp packs the slots that can send of its
// 32 before add_slots; else it takes the row tile's part of the keep
// pass's sorted list, 32 kept slots a warp at a time.
template <int kKt, int kPer, bool kDense, bool kWalk>
__global__ void __launch_bounds__(kSpanThreads) spmm_spans(const SpanArgs a) {
  extern __shared__ float4 win4[];  // row_tile rows x kKt columns
  float* win = reinterpret_cast<float*>(win4);
  __shared__ int any_sent;
  // kWalk: each warp's packed slots (row, X row, value bits)
  __shared__ int packed[kWalk ? kSpanThreads / 32 : 1][3][32];
  const int kt = blockIdx.x % a.n_tiles;
  const int rt = blockIdx.x / a.n_tiles % a.n_rtiles;
  const int span = blockIdx.x / a.n_tiles / a.n_rtiles;
  const int k0 = kt * kKt, r0 = rt * a.row_tile;
  const int first = a.span_first_chunk[span];
  const int last = a.span_first_chunk[span + 1];
  const int* off = a.tile_off + static_cast<long>(span) * (a.n_rtiles + 1);
  const int lo = kWalk ? 0 : off[rt];
  const int n = kWalk ? (last - first) * a.chunk : off[rt + 1] - lo;
  // uniform over the block, so a bad span leaves before any barrier; a
  // tile that keeps no slot leaves at once
  if (n <= 0 || !GR_IN_RANGE(first, a.n_chunks) ||
      !GR_IN_RANGE(last - first - 1, a.n_chunks - first) ||
      !GR_IN_RANGE(lo + n - 1, (last - first) * a.chunk))
    return;
  if (kWalk && !span_active<kDense>(a, first, last)) return;
  const int n_win = a.row_tile * kKt;  // row_tile % 4 == 0: whole float4s
  for (int i = threadIdx.x; i < n_win / 4; i += blockDim.x)
    win4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (threadIdx.x == 0) any_sent = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool sent = false;
  const long s0 = static_cast<long>(first) * a.chunk;
  if constexpr (kWalk) {
    const unsigned lanes_below = (1u << lane) - 1u;
    constexpr int kStep = 32 * kSlotsPerLane;
    for (int base = warp * kStep; base < n;
         base += (kSpanThreads / 32) * kStep) {  // warp-uniform
      int r[kSlotsPerLane], xi[kSlotsPerLane];
      float v[kSlotsPerLane];
      bool work[kSlotsPerLane];
      load_slots<kDense>(a, first, s0, n, base, r, xi, v, work);
#pragma unroll
      for (int j = 0; j < kSlotsPerLane; ++j) {
        const unsigned todo = __ballot_sync(0xffffffffu, work[j]);
        if (todo == 0u) continue;  // warp-uniform
        if (work[j]) {  // in slot order
          const int at = __popc(todo & lanes_below);
          packed[warp][0][at] = r[j];
          packed[warp][1][at] = xi[j];
          packed[warp][2][at] = __float_as_int(v[j]);
        }
        __syncwarp();
        add_slots<kKt, kPer>(a, win, r0, k0, packed[warp][0][lane],
                             packed[warp][1][lane],
                             __int_as_float(packed[warp][2][lane]), __popc(todo),
                             sent);
        __syncwarp();  // packed is written again after this
      }
    }
  } else {
    const long s = s0 + lo;
    for (int base = warp * 32; base < n; base += kSpanThreads) {  // warp-uniform
      const int e = base + lane;
      const int r = e < n ? a.keep_r[s + e] : 0;
      const int xi = e < n ? a.keep_x[s + e] : 0;
      const float v = e < n ? a.keep_v[s + e] : 0.0f;
      add_slots<kKt, kPer>(a, win, r0, k0, r, xi, v,
                           n - base < 32 ? n - base : 32, sent);
    }
  }
  if (sent) any_sent = 1;  // every writer stores the same 1
  __syncthreads();
  if (!any_sent) return;

  // the window's nonzero entries into Y: one atomic per entry and tile
  const long ybase = static_cast<long>(a.chunk_rb[first]) * a.window + r0;
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

template <int kKt, int kPer, bool kDense>
int launch_spans(const SpanArgs& a, bool walk, bool sort, cudaStream_t s) {
  void (*tiles)(SpanArgs) = walk ? spmm_spans<kKt, kPer, kDense, true>
                                 : spmm_spans<kKt, kPer, kDense, false>;
  const int smem = static_cast<int>(sizeof(float)) * a.row_tile * kKt;
  if (smem > 48 * 1024) {  // above 48 KB only when asked for
    const cudaError_t err = cudaFuncSetAttribute(
        tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  if (!walk) {
    void (*keep)(SpanArgs) = sort ? spmm_keep<kDense, true>
                                  : spmm_keep<kDense, false>;
    const int keep_smem =
        sort ? static_cast<int>(sizeof(int)) * (a.window + 3 * a.span_slots) : 0;
    if (keep_smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          keep, cudaFuncAttributeMaxDynamicSharedMemorySize, keep_smem);
      if (err != cudaSuccess) return err;
    }
    keep<<<a.n_spans, kKeepThreads, keep_smem, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  tiles<<<a.n_spans * a.n_rtiles * a.n_tiles, kSpanThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// The K tile's kernels, four columns a lane where X's rows allow 16-byte
// loads (vec) and the tile has four columns or more.
template <bool kDense>
int launch_tiles(int k_tile, bool vec, const SpanArgs& a, bool walk,
                 bool sort, cudaStream_t s) {
  switch (k_tile) {
    case 1: return launch_spans<1, 1, kDense>(a, walk, sort, s);
    case 2: return launch_spans<2, 1, kDense>(a, walk, sort, s);
    case 4: return vec ? launch_spans<4, 4, kDense>(a, walk, sort, s)
                       : launch_spans<4, 1, kDense>(a, walk, sort, s);
    case 8: return vec ? launch_spans<8, 4, kDense>(a, walk, sort, s)
                       : launch_spans<8, 1, kDense>(a, walk, sort, s);
    case 16: return vec ? launch_spans<16, 4, kDense>(a, walk, sort, s)
                        : launch_spans<16, 1, kDense>(a, walk, sort, s);
    case 32: return vec ? launch_spans<32, 4, kDense>(a, walk, sort, s)
                        : launch_spans<32, 1, kDense>(a, walk, sort, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The pass over the chunks ch_act (bool[n_chunks]) selects, or over every
// chunk (the dense pass: ch_act null), on the span table
// (span_first_chunk, n_spans), in tiles of row_tile rows (a multiple of 4;
// the window's W rows in ceil(W / row_tile) tiles) and k_tile columns (1,
// 2, 4, 8, 16 or 32): row_tile * k_tile floats of shared memory. walk !=
// 0 (one row tile only): the tile pass walks the metadata itself, no keep
// pass; else the keep pass lists the kept slots, sorted by row where sort
// != 0 (staging up to span_slots slots of a span, the most of any span,
// in 4 * (window + 3 * span_slots) bytes of shared memory), as they come
// (one row tile only) where not. x: float[n_vertices, k]; xrow: uint8[n_vertices] scratch;
// scratch: without walk, int[n_spans * (n_rtiles + 1) + 3 * n_chunks *
// chunk], the row tiles' offsets and the kept slots; y:
// float[n_row_blocks * window, k], already zero. window must be a
// multiple of 4.
extern "C" int gr_spmm_spans(int k_tile, int row_tile, int walk, int sort,
                             int span_slots, int n_spans,
                             const void* span_first_chunk, const void* ch_act,
                             int n_chunks, const void* chunk_rb,
                             const void* chunk_cb, const void* row_local,
                             const void* col_local, const void* values,
                             const void* x, void* xrow, void* scratch,
                             void* y, int window, int chunk, int k,
                             int n_vertices, int n_row_blocks, void* stream) {
  if (window % 4 != 0 || k < 1 || k_tile < 1 || k_tile > 32 ||
      (k_tile & (k_tile - 1)) != 0 || row_tile < 4 || row_tile % 4 != 0)
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
  a.span_slots = span_slots;
  a.row_tile = row_tile < window ? row_tile : window;
  a.n_rtiles = (window + a.row_tile - 1) / a.row_tile;
  if ((walk || !sort) && a.n_rtiles != 1) return cudaErrorInvalidValue;
  if (!walk) {
    const long n_slots = static_cast<long>(n_chunks) * chunk;
    a.tile_off = static_cast<int*>(scratch);
    a.keep_r = a.tile_off + static_cast<long>(n_spans) * (a.n_rtiles + 1);
    a.keep_x = a.keep_r + n_slots;
    a.keep_v = reinterpret_cast<float*>(a.keep_x + n_slots);
  }
  a.n_spans = n_spans;
  a.n_tiles = (k + k_tile - 1) / k_tile;
  a.n_chunks = n_chunks;
  a.window = window;
  a.chunk = chunk;
  a.k = k;
  a.n_x = n_vertices;
  a.n_y = static_cast<long>(n_row_blocks) * window;
  if (static_cast<long>(n_spans) * a.n_rtiles * a.n_tiles > 0x7fffffffL)
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
  if (err == cudaSuccess && n_spans > 0)
    err = ch_act == nullptr
              ? launch_tiles<true>(k_tile, vec, a, walk != 0, sort != 0, s)
              : launch_tiles<false>(k_tile, vec, a, walk != 0, sort != 0, s);
  return err != cudaSuccess ? err : gr::finish(s);
}

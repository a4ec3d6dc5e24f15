// Geolocation's Weiszfeld step over the bucketed chunk layout: the dense
// pass and the chunk-skipping pass, one template summing in a fixed order.
//
// Replaces:
// - gunrock_tpu/ops/pallas/geo_step.py::weiszfeld_step_sums (kernel body
//   _make_wstep_kernel: dynamic-gather of the iterate from the chunk's row
//   window, polynomial arcsin, four channels sharing one one-hot MXU
//   scatter with a bf16 hi/lo split);
// - gunrock_tpu/ops/pallas/geo_step.py::weiszfeld_step_sums_sparse
//   (_make_wstep_sparse_kernel: the same per chunk, over the chunks whose
//   row sub-blocks hold a vertex that still iterates, launched through
//   _tail_grid_dispatch).
//
// Contract: for every chunk (dense) or every chunk with ch_act set
// (sparse: the chunk plan of chunkplan.cu), and every real slot s of it
// with ok[s] > 0, with
//   r = chunk_rb * W + row_local[s],
//   d = haversine(mlat[s], mlon[s], y_lat[r], y_lon[r])   (degrees in, km
//       out, radius 6371, `a` clipped to [0, 1] before the root),
// if d != 0:
//   cnt[r] += 1, dinv[r] += 1 / max(d, 1e-30), wlat[r] += mlat[s] / d,
//   wlon[r] += mlon[s] / d.
// out = float[4, n_vertices] = (cnt, dinv, wlat, wlon), written whole:
// rows no (active) chunk reaches are 0. Padding slots carry row_local == W
// and are skipped before any load through the row.
//
// What bounds it on this card: bytes and the precise transcendentals. Per
// real slot it reads 4 B of row_local and 12 B of mlat/mlon/ok, and per
// labeled slot two 4 B iterate values of its row; it writes 16 B per
// vertex. At R-MAT scale 18 that is 3.94M slots * 16 B + 4.2 MB of output,
// ~67 MB, ~20 us at 3.35 TB/s. Each labeled slot also runs the precise
// sinf (twice), cosf (twice), sqrtf and asinf, ~200 machine operations.
//
// Design: two launches, and the order of every sum is fixed by the layout
// alone, so two calls on the same inputs give the same bits.
// 1. wstep_runs, chunk-parallel: a persistent grid; block b takes chunks
//    b, b + grid, ..., lists the active ones (a ballot over their ch_act
//    bytes) and walks them in tiles of blockDim slots, a slot a thread,
//    kBatch tiles' loads in flight together. A thread computes its slot's
//    four terms (0 where the slot does not count); a warp first packs its
//    labeled slots onto consecutive lanes, so that one haversine serves 32
//    of them where 10% of the slots are labeled. A run is a maximal
//    sequence of one row on consecutive slots of a tile: a warp sums it
//    with a segmented scan in a fixed tree (Hillis-Steele by shuffle), a
//    run crossing warps adds the tails of the warps before it, nearest
//    first, from shared memory, and the run's last slot stores the sums as
//    one float4 at its own slot index in run_sums. No atomic: every run
//    has its own slot. push_layout keeps each row's slots in one run per
//    chunk, so a run is a (row, chunk) pair there.
// 2. wstep_rows, row-parallel: row r adds the run sums at its run tails,
//    a static table built once per layout (ops/kernels/geo_step.py
//    run_table): each row's tail slots in slot order, i.e. in chunk
//    order, skipping the tails of inactive chunks. Rows are grouped by
//    their number of runs into groups of G = 1, 4 or 32 lanes a row: lane
//    j adds runs j, j + G, ... in order, then the G lanes combine by a
//    fixed shuffle tree, and lane 0 writes the row's four sums. Every row
//    is in one group, so out is written whole. The table lists the rows
//    in group order with their runs beside them, so that a row's id and
//    its range load together.
// On an H100 80GB HBM3 at 700 W (R-MAT 18, 10% labeled) this takes
// 0.107 ms dense and 0.027 ms a step over one geo run; the design it
// replaced, one global float atomic per term, 0.079 and 0.021, but summed
// in any order, so geo was not reproducible. The run pass is bound by
// its instructions (the scan and the warp tails are much of them), the
// row pass by the latency of its small blocks (7 us with no chunk
// active). A span design (a block per span of a row block's chunks into a
// shared window, then a combine over the spans) took 0.145 and 0.0435:
// a block walked its span's chunks one after another, and the
// chunk-skipping steps crowd their active chunks into a few row blocks.
//
// Arithmetic: the degrees-to-radians products use __fmul_rn so that the
// compiler cannot contract them into the subtraction that follows: two
// coordinates that round to the same radians give d == 0 exactly, here as
// in the plain version, and d != 0 decides `cnt`. No --use_fast_math:
// sinf, cosf and asinf are the precise ones (the TPU kernel's Cephes
// polynomial exists because its compiler has no arcsin). Slots with ok ==
// 0 (padding, unlabeled neighbours) do no arithmetic and add 0.

#include "common.cuh"

namespace {

constexpr float kRad = 0.017453292519943295f;  // pi / 180
constexpr float kTwoRadius = 2.0f * 6371.0f;   // km
constexpr int kWarps = gr::kThreads / 32;
constexpr int kBatch = 2;  // tiles whose loads a thread keeps in flight
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float haversine(float lat1, float lon1, float lat2,
                                           float lon2) {
  const float la1 = __fmul_rn(lat1, kRad), lo1 = __fmul_rn(lon1, kRad);
  const float la2 = __fmul_rn(lat2, kRad), lo2 = __fmul_rn(lon2, kRad);
  const float sdlat = sinf(__fmul_rn(__fsub_rn(la2, la1), 0.5f));
  const float sdlon = sinf(__fmul_rn(__fsub_rn(lo2, lo1), 0.5f));
  float a = sdlat * sdlat + cosf(la1) * cosf(la2) * sdlon * sdlon;
  a = fminf(fmaxf(a, 0.0f), 1.0f);
  return kTwoRadius * asinf(sqrtf(a));
}

struct Args {
  const unsigned char* ch_act;  // sparse: bool[n_chunks]; dense: null
  const int* chunk_rb;
  const int* row;
  const float* mlat;
  const float* mlon;
  const float* ok;
  const float* y_lat;
  const float* y_lon;
  float4* run_sums;       // [n_chunks * chunk], written at the run tails
  const int* group_rows;  // [n_vertices]: the rows of G = 1, then 4, then 32
  const int* run_start;   // [n_vertices + 1]: row group_rows[p]'s runs are
                          // tail_slot[run_start[p], run_start[p + 1])
  const int* tail_slot;   // [n_tails]: each run's last slot, by row, in
                          // chunk order
  float* out;             // float[4 * n_vertices], written whole
  int n_chunks;
  int chunk;
  int window;
  int n_tails;
  long n_vertices;
  int rows1, rows4;      // rows in the groups of 1 and 4 lanes
  int blocks1, blocks4;  // their blocks in wstep_rows
};

// The warp tails of one tile: the key (window row, -1 for none) and the
// scanned sums of each warp's last lane, whether that lane's run covers
// the whole warp, and each warp's first key.
struct Tails {
  int key[kWarps];
  int first[kWarps];
  int whole[kWarps];
  float v[kWarps][4];
};

// One tile's slot, loaded: slot o = t0 + threadIdx.x of a chunk.
struct Slot {
  int rl;   // row_local (W: padding or past the chunk)
  float ok, la, lo, yla, ylo;
};

// The slot's four terms (0 where it does not count) and its key (the
// window row, -1 for none), from its distance d where it is labeled.
__device__ __forceinline__ int terms(const Slot& q, int W, bool labeled,
                                     float d, float* v) {
  v[0] = v[1] = v[2] = v[3] = 0.0f;
  if (q.rl == W) return -1;  // padding slot
  if (labeled && d != 0.0f) {
    const float dinv = 1.0f / fmaxf(d, 1e-30f);
    v[0] = 1.0f;
    v[1] = dinv;
    v[2] = dinv * q.la;
    v[3] = dinv * q.lo;
  }
  return q.rl;
}

// The distances of the labeled slots among the calling warp's kBatch
// tiles. Labeled slots are sparse (10% of the vertices carry a label in
// the first outer iteration), and a warp with one labeled lane would run
// the haversine for all 32, so the warp first packs its labeled slots
// onto consecutive lanes (__fns names the lane of the n-th labeled one),
// runs one haversine per 32 of them, and hands each distance back to its
// slot's lane. labeled[b] is tile b's ballot. All 32 lanes must call it.
__device__ __forceinline__ void distances(const Slot* q,
                                          const unsigned* labeled, float* d) {
  const int lane = threadIdx.x & 31;
  int before[kBatch + 1];
  before[0] = 0;
#pragma unroll
  for (int b = 0; b < kBatch; ++b) before[b + 1] = before[b] + __popc(labeled[b]);
  const int total = before[kBatch];
  float got[kBatch];  // entry 32k + lane of the packed list, in got[k]
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    got[k] = 0.0f;
    if (32 * k >= total) continue;  // warp-uniform
    const int p = 32 * k + lane;
    int t = 0;
#pragma unroll
    for (int b = 1; b < kBatch; ++b)
      if (p >= before[b]) t = b;
    unsigned m = labeled[0];
#pragma unroll
    for (int b = 1; b < kBatch; ++b)
      if (t == b) m = labeled[b];
    const int src = p < total ? static_cast<int>(__fns(m, 0, p - before[t] + 1)) : 0;
    float la = 0.0f, lo = 0.0f, yla = 0.0f, ylo = 0.0f;
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const float x0 = __shfl_sync(kAll, q[b].la, src);
      const float x1 = __shfl_sync(kAll, q[b].lo, src);
      const float x2 = __shfl_sync(kAll, q[b].yla, src);
      const float x3 = __shfl_sync(kAll, q[b].ylo, src);
      if (t == b) la = x0, lo = x1, yla = x2, ylo = x3;
    }
    if (p < total) got[k] = haversine(la, lo, yla, ylo);
  }
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    const int pos = before[b] + __popc(labeled[b] & below);
    d[b] = 0.0f;
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (32 * k >= total) continue;  // warp-uniform
      const float x = __shfl_sync(kAll, got[k], pos & 31);
      if ((pos >> 5) == k) d[b] = x;
    }
  }
}

// Sums one tile's runs: each run of one key on consecutive lanes summed in
// a fixed tree (a segmented Hillis-Steele scan by shuffle), a run crossing
// warps completed from the warp tails before it, nearest first. Returns
// whether the calling thread holds its run's last slot (its v then holds
// the run's sums). One __syncthreads; the tails alternate between two
// buffers, so the next tile needs no second barrier. Every thread of the
// block calls it.
__device__ __forceinline__ bool run_tile(int key, float* v, Tails& t) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int prev = __shfl_up_sync(kAll, key, 1);
  const int next = __shfl_down_sync(kAll, key, 1);
  const unsigned heads = __ballot_sync(kAll, lane == 0 || prev != key);
  if (heads != kAll) {  // warp-uniform: a run spans lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      float up[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) up[c] = __shfl_up_sync(kAll, v[c], off);
      // lane - off is in this lane's run iff no run starts in (lane - off, lane]
      if (lane >= off &&
          ((heads >> (lane - off + 1)) & ((1u << off) - 1u)) == 0u) {
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = v[c] + up[c];
      }
    }
  }
  if (lane == 31) {
    t.key[warp] = key;
    t.whole[warp] = heads == 1u;
#pragma unroll
    for (int c = 0; c < 4; ++c) t.v[warp][c] = v[c];
  }
  if (lane == 0) t.first[warp] = key;
  __syncthreads();
  const int after = lane < 31 ? next : warp + 1 < kWarps ? t.first[warp + 1] : -1;
  if (key < 0 || after == key) return false;  // not the last slot of its run
  // a run that starts at lane 0 may continue from the warps before
  if ((heads & (lane == 31 ? kAll : (2u << lane) - 1u)) == 1u) {
    for (int w = warp - 1; w >= 0 && t.key[w] == key; --w) {
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = v[c] + t.v[w][c];
      if (!t.whole[w]) break;
    }
  }
  return true;
}

template <bool kSparse>
__global__ void __launch_bounds__(gr::kThreads) wstep_runs(const Args a) {
  __shared__ Tails tails[2];
  __shared__ int list[gr::kThreads];  // this round's active chunks
  __shared__ int warp_n[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = a.window;
  const long round = static_cast<long>(gridDim.x) * blockDim.x;
  int buf = 0;
  // rounds of blockDim chunks: b, b + grid, ..., b + (blockDim - 1) grid
  for (long r0 = blockIdx.x; r0 < a.n_chunks; r0 += round) {
    const long mine = r0 + static_cast<long>(threadIdx.x) * gridDim.x;
    const bool act = mine < a.n_chunks && (!kSparse || a.ch_act[mine]);
    const unsigned ballot = __ballot_sync(kAll, act);
    if (lane == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();
    int at = __popc(ballot & ((1u << lane) - 1u)), n = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) at += warp_n[w];
      n += warp_n[w];
    }
    if (act) list[at] = static_cast<int>(mine);  // ascending
    __syncthreads();
    // the listed chunks' tiles, kBatch at a time: loads, then the rows'
    // iterates, then the arithmetic
    int k = 0, t0 = 0;  // the next tile: slots t0.. of chunk list[k]
    while (k < n) {  // uniform over the block
      Slot q[kBatch];
      long slot[kBatch];
      bool has[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        has[b] = k < n;
        q[b].rl = W;
        q[b].ok = q[b].la = q[b].lo = q[b].yla = q[b].ylo = 0.0f;
        slot[b] = -1;
        if (has[b]) {
          const int ch = list[k];
          const int o = t0 + threadIdx.x;
          if (o < a.chunk) {
            const long s = static_cast<long>(ch) * a.chunk + o;
            slot[b] = s;
            q[b].rl = a.row[s];
            q[b].ok = a.ok[s];
            const long r = static_cast<long>(a.chunk_rb[ch]) * W + q[b].rl;
            if (q[b].rl != W && q[b].ok > 0.0f && GR_IN_RANGE(q[b].rl, W) &&
                GR_IN_RANGE(r, a.n_vertices)) {  // a labeled slot's coordinates
              q[b].la = a.mlat[s];
              q[b].lo = a.mlon[s];
              q[b].yla = a.y_lat[r];
              q[b].ylo = a.y_lon[r];
            } else {
              q[b].ok = 0.0f;
            }
          }
          t0 += blockDim.x;
          if (t0 >= a.chunk) t0 = 0, ++k;
        }
      }
      unsigned labeled[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        labeled[b] = __ballot_sync(kAll, q[b].rl != W && q[b].ok > 0.0f);
      float d[kBatch];
      distances(q, labeled, d);
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (!has[b]) break;  // uniform
        float v[4];
        const int key = terms(q[b], W, (labeled[b] >> lane) & 1u, d[b], v);
        if (run_tile(key, v, tails[buf]) &&
            GR_IN_RANGE(slot[b], static_cast<long>(a.n_chunks) * a.chunk))
          a.run_sums[slot[b]] = make_float4(v[0], v[1], v[2], v[3]);
        buf ^= 1;
      }
    }
    __syncthreads();  // list and warp_n are written again next round
  }
}

// Row r's four sums: its run tails' sums in chunk order (lane j of its G
// lanes adds runs j, j + G, ...; then a fixed shuffle tree), the tails of
// inactive chunks skipped. Blocks [0, blocks1) take the rows of one lane,
// then [blocks1, blocks1 + blocks4) those of 4, then those of 32.
template <bool kSparse>
__global__ void __launch_bounds__(gr::kThreads) wstep_rows(const Args a) {
  int g, first, n, block = blockIdx.x;
  if (block < a.blocks1) {
    g = 1, first = 0, n = a.rows1;
  } else if ((block -= a.blocks1) < a.blocks4) {
    g = 4, first = a.rows1, n = a.rows4;
  } else {
    block -= a.blocks4;
    g = 32, first = a.rows1 + a.rows4;
    n = static_cast<int>(a.n_vertices) - first;
  }
  const int idx = (block * blockDim.x + threadIdx.x) / g;
  const int j = threadIdx.x % g;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int r = -1;
  const int p = first + idx;
  if (idx < n && GR_IN_RANGE(p, a.n_vertices)) {
    r = a.group_rows[p];
    if (!GR_IN_RANGE(r, a.n_vertices)) r = -1;
  }
  if (r >= 0) {
    const int hi = a.run_start[p + 1];
#pragma unroll 4
    for (int i = a.run_start[p] + j; i < hi; i += g) {
      if (!GR_IN_RANGE(i, a.n_tails)) break;
      const int s = a.tail_slot[i];
      if (!GR_IN_RANGE(s, static_cast<long>(a.n_chunks) * a.chunk)) continue;
      if (kSparse && !a.ch_act[s / a.chunk]) continue;
      const float4 x = a.run_sums[s];
      acc = make_float4(acc.x + x.x, acc.y + x.y, acc.z + x.z, acc.w + x.w);
    }
  }
  for (int off = g / 2; off > 0; off >>= 1) {  // uniform: g is the block's
    const float4 x = make_float4(__shfl_down_sync(kAll, acc.x, off, g),
                                 __shfl_down_sync(kAll, acc.y, off, g),
                                 __shfl_down_sync(kAll, acc.z, off, g),
                                 __shfl_down_sync(kAll, acc.w, off, g));
    acc = make_float4(acc.x + x.x, acc.y + x.y, acc.z + x.z, acc.w + x.w);
  }
  if (r >= 0 && j == 0) {
    a.out[r] = acc.x;
    a.out[a.n_vertices + r] = acc.y;
    a.out[2 * a.n_vertices + r] = acc.z;
    a.out[3 * a.n_vertices + r] = acc.w;
  }
}

template <bool kSparse>
int launch(const Args& a, int run_blocks, cudaStream_t s) {
  wstep_runs<kSparse><<<run_blocks, gr::kThreads, 0, s>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int blocks = a.blocks1 + a.blocks4 +
                     static_cast<int>((32L * (a.n_vertices - a.rows1 - a.rows4) +
                                       gr::kThreads - 1) / gr::kThreads);
  if (blocks > 0) wstep_rows<kSparse><<<blocks, gr::kThreads, 0, s>>>(a);
  return gr::finish(s);
}

}  // namespace

// ch_act == null: the dense pass over every chunk; else the chunks it
// selects. mlat, mlon, ok: float[n_chunks * chunk] in slot order. y_lat,
// y_lon: float[n_vertices]. run_sums: float4[n_chunks * chunk] scratch.
// group_rows, run_start, tail_slot, rows1, rows4: the layout's run table
// (geo_step.py run_table). out: float[4 * n_vertices], written whole.
// run_blocks: the persistent grid of the run pass.
extern "C" int gr_weiszfeld_step(const void* ch_act, int run_blocks,
                                 int n_chunks, const void* chunk_rb,
                                 const void* row_local, const void* mlat,
                                 const void* mlon, const void* ok,
                                 const void* y_lat, const void* y_lon,
                                 void* run_sums, const void* group_rows,
                                 const void* run_start, const void* tail_slot,
                                 int n_tails, int rows1, int rows4,
                                 void* out, int window, int chunk,
                                 int n_vertices, void* stream) {
  if (run_blocks < 1) return cudaErrorInvalidValue;
  Args a{};
  a.ch_act = static_cast<const unsigned char*>(ch_act);
  a.chunk_rb = static_cast<const int*>(chunk_rb);
  a.row = static_cast<const int*>(row_local);
  a.mlat = static_cast<const float*>(mlat);
  a.mlon = static_cast<const float*>(mlon);
  a.ok = static_cast<const float*>(ok);
  a.y_lat = static_cast<const float*>(y_lat);
  a.y_lon = static_cast<const float*>(y_lon);
  a.run_sums = static_cast<float4*>(run_sums);
  a.group_rows = static_cast<const int*>(group_rows);
  a.run_start = static_cast<const int*>(run_start);
  a.tail_slot = static_cast<const int*>(tail_slot);
  a.out = static_cast<float*>(out);
  a.n_chunks = n_chunks;
  a.chunk = chunk;
  a.window = window;
  a.n_tails = n_tails;
  a.n_vertices = n_vertices;
  a.rows1 = rows1;
  a.rows4 = rows4;
  a.blocks1 = (rows1 + gr::kThreads - 1) / gr::kThreads;
  a.blocks4 = (4 * rows4 + gr::kThreads - 1) / gr::kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ch_act != nullptr ? launch<true>(a, run_blocks, s)
                           : launch<false>(a, run_blocks, s);
}

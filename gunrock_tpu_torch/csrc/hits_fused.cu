// Fused HITS pass: both Jacobi accumulations in one sweep of the push
// layout.
//
// Replaces: gunrock_tpu/ops/pallas/hits_fused.py::hits_fused_pass (kernel
// body _make_hits_kernel: per chunk, a one-hot gather of auth over the col
// window scattered by row, and a gather of hub over the row window
// scattered by col into a VMEM-resident whole-array accumulator).
//
// Contract: over the unit push layout (rows = sources, cols =
// destinations), for every real slot e of every chunk,
//   hub_raw[rb*W + row_local[e]]  += auth[cb*W + col_local[e]]
//   auth_raw[cb*W + col_local[e]] += hub[rb*W + row_local[e]]
// and every other entry of both is 0 (this covers the TPU's rb_occupied
// mask); both are written whole. Padding slots carry row_local == W but
// col_local == 0: the auth side scatters by column, so it must skip them
// by the ROW sentinel, or vertex cb*W would gain phantom hub mass.
//
// What bounds it on this card: bytes. Each slot reads 8 B of row/col
// metadata and gathers 4 B from each of auth and hub. At R-MAT scale 18 on
// the W=4096/C=1024 layout (5,359 chunks, 5.49M slots, 3.94M real) the
// metadata and four f32[V] vectors are ~48 MB, ~14 us at 3.35 TB/s.
//
// Design: spans, as the semiring pull's (semiring.cu), on two tables. The
// hub side is row-shaped and walks the layout's row span table (chunks
// sorted by row block, at most P chunks of one row block per span); the
// auth side scatters by column and walks the column span table
// (layout.py: chunk ids by column block in chunk_by_cb, cut the same way).
// Two launches:
// 1. hits_spans, one block per row span and then one per column span. A
//    row-span block gathers auth[cb*W + col] and adds it into a W-float hub
//    window in dynamic shared memory at row; a column-span block gathers
//    hub[rb*W + row] and adds it into an auth window at col. A warp reads
//    32 consecutive slots of the span at a time (a chunk's slots are
//    contiguous whichever table names it), and a segmented scan over the
//    warp sums each run of slots that add into one window entry before the
//    shared-memory atomic: the push layout keeps a chunk's slots in source
//    order, so the hub side meets runs of one row up to a chunk long, whose
//    adds would otherwise serialize on one word (0.227 ms for the span
//    pass before the scan, on an H100 80GB HBM3 at 700 W). Zero
//    messages are not added (the windows start at +0). Each block
//    writes its window to partial[span] with touched[span] set when it
//    added anything (written every call: no memset).
// 2. hits_combine, one block of 16 warps per (output block, strip of 512
//    entries), row blocks first: gr::reduce_span_strip combines the touched
//    partials of the block's spans into hub_raw or auth_raw, 0 where none.
// So no message leaves the SM as a global atomic. The first design sent two
// global atomicAdds per real slot (up to 7,878,410 at R-MAT 18), contended
// on the hub blocks: row block 0 owns 2,080 of the 5,359 chunks and column
// block 0 2,083 (39% each) at W=4096/C=1024. One launch of both sides,
// rather than one per side, lets the second walk of the layout's metadata
// (~44 MB) find part of it in the 50 MB L2. Float sums land in any order
// within a window (shared atomics), so the sums are not bit-reproducible.

#include "common.cuh"

namespace {

struct Args {
  const int* row_first_chunk;  // int[n_row_spans + 1]: chunk ids
  const int* rb_first_span;    // int[n_row_blocks + 1]
  const int* chunk_by_cb;      // int[n_chunks]: chunk ids by column block
  const int* col_first_chunk;  // int[n_col_spans + 1]: positions in chunk_by_cb
  const int* cb_first_span;    // int[n_col_blocks + 1]
  const int* chunk_rb;
  const int* chunk_cb;
  const int* row;
  const int* col;
  const float* auth;
  const float* hub;
  float* hub_raw;   // float[n_row_blocks * window], written whole
  float* auth_raw;  // float[n_col_blocks * window], written whole
  float* partial;   // float[(n_row_spans + n_col_spans) * window]
  int* touched;     // int[n_row_spans + n_col_spans]
  int n_row_spans;
  int n_col_spans;
  int n_chunks;
  int n_row_blocks;
  int n_col_blocks;
  int window;
  int chunk;
  long n_vertices;
};

// Adds val into win[key] for the calling warp's lanes, key < 0 meaning no
// message: a segmented scan sums each run of equal keys on consecutive
// lanes, and the run's last lane sends one shared-memory atomic (when the
// sum is not 0). The push layout keeps a chunk's slots in source order, so
// a hub's row comes in runs of up to a chunk: without the scan its adds
// serialize 32 deep on one word. All 32 lanes must call it.
__device__ __forceinline__ void add_runs(float* win, int key, float val,
                                         bool& sent) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int prev = __shfl_up_sync(kAll, key, 1);
  const unsigned heads = __ballot_sync(kAll, lane == 0 || prev != key);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(kAll, val, off);
    // lane - off is in this lane's run iff no run starts in (lane - off, lane]
    if (lane >= off && ((heads >> (lane - off + 1)) & ((1u << off) - 1u)) == 0u)
      val += up;
  }
  const bool tail = lane == 31 || ((heads >> (lane + 1)) & 1u);
  if (tail && key >= 0 && val != 0.0f) {
    atomicAdd(win + key, val);
    sent = true;
  }
}

__global__ void __launch_bounds__(gr::kThreads) hits_spans(const Args a) {
  extern __shared__ float4 win4[];  // the span's window, W floats
  float* win = reinterpret_cast<float*>(win4);
  __shared__ int any_sent;
  const int span = blockIdx.x;  // row spans, then column spans
  const bool by_col = span >= a.n_row_spans;
  const int* table = by_col ? a.col_first_chunk : a.row_first_chunk;
  const int s = by_col ? span - a.n_row_spans : span;
  const int first = table[s], last = table[s + 1];
  // uniform over the block, so a bad span leaves before any barrier
  if (!GR_IN_RANGE(first, a.n_chunks) ||
      !GR_IN_RANGE(last - first - 1, a.n_chunks - first))
    return;
  const int W4 = a.window / 4;
  for (int i = threadIdx.x; i < W4; i += blockDim.x)
    win4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (threadIdx.x == 0) any_sent = 0;
  __syncthreads();
  const float* g = by_col ? a.hub : a.auth;  // the gathered vector
  const int* gblock = by_col ? a.chunk_rb : a.chunk_cb;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool sent = false;
  const int n_slots = (last - first) * a.chunk;
  const bool pow2 = (a.chunk & (a.chunk - 1)) == 0;  // o / C as a shift
  const int shift = __ffs(a.chunk) - 1;
  // a warp takes 32 consecutive slots of the span at a time: one coalesced
  // load of each array, one scan; four such loads in flight
#pragma unroll 4
  for (int o0 = 32 * warp; o0 < n_slots; o0 += blockDim.x) {  // warp-uniform
    const int o = o0 + lane < n_slots ? o0 + lane : 0;
    const int q = pow2 ? o >> shift : o / a.chunk;
    const int i = first + q;
    const int ch = by_col ? a.chunk_by_cb[i] : i;
    int key = -1;
    float m = 0.0f;
    if (o0 + lane < n_slots && GR_IN_RANGE(ch, a.n_chunks)) {
      const long sl = static_cast<long>(ch) * a.chunk + (o - q * a.chunk);
      const int r = a.row[sl];
      if (r != a.window) {  // padding slots skipped by the row sentinel
        const int c = a.col[sl];
        const long gi = static_cast<long>(gblock[ch]) * a.window + (by_col ? r : c);
        const int wi = by_col ? c : r;
        if (GR_IN_RANGE(gi, a.n_vertices) && GR_IN_RANGE(wi, a.window)) {
          m = __ldg(g + gi);
          key = wi;
        }
      }
    }
    add_runs(win, key, m, sent);
  }
  if (sent) any_sent = 1;  // every writer stores the same 1
  __syncthreads();
  if (any_sent) {
    float4* out = reinterpret_cast<float4*>(a.partial + static_cast<long>(span) * a.window);
    for (int i = threadIdx.x; i < W4; i += blockDim.x) out[i] = win4[i];
  }
  if (threadIdx.x == 0) a.touched[span] = any_sent;
}

// Output block b = blockIdx.x (row blocks into hub_raw, then column blocks
// into auth_raw), strip blockIdx.y.
__global__ void __launch_bounds__(gr::kReduceWarps * 32) hits_combine(const Args a) {
  const bool by_col = static_cast<int>(blockIdx.x) >= a.n_row_blocks;
  const int b = by_col ? blockIdx.x - a.n_row_blocks : blockIdx.x;
  const int* first_span = by_col ? a.cb_first_span : a.rb_first_span;
  const int off = by_col ? a.n_row_spans : 0;  // column spans' partials
  float* y = (by_col ? a.auth_raw : a.hub_raw) + static_cast<long>(b) * a.window;
  gr::reduce_span_strip<gr::Add4>(a.partial, a.touched, off + first_span[b],
                                  off + first_span[b + 1],
                                  a.n_row_spans + a.n_col_spans, a.window,
                                  blockIdx.y * gr::kStrip, 0.0f, y);
}

}  // namespace

// auth, hub: float[n_vertices]. hub_raw: float[n_row_blocks * window],
// auth_raw: float[n_col_blocks * window], both written whole. scratch:
// float[(n_row_spans + n_col_spans) * (window + 1)], the partial windows
// and then the touched flags. window must be a multiple of 4.
extern "C" int gr_hits_fused(int n_row_spans, const void* row_first_chunk,
                             const void* rb_first_span, int n_col_spans,
                             const void* chunk_by_cb,
                             const void* col_first_chunk,
                             const void* cb_first_span, int n_chunks,
                             const void* chunk_rb, const void* chunk_cb,
                             const void* row_local, const void* col_local,
                             const void* auth, const void* hub, void* hub_raw,
                             void* auth_raw, void* scratch, int window,
                             int chunk, int n_vertices, int n_row_blocks,
                             int n_col_blocks, void* stream) {
  if (window % 4 != 0) return cudaErrorInvalidValue;
  Args a{};
  a.row_first_chunk = static_cast<const int*>(row_first_chunk);
  a.rb_first_span = static_cast<const int*>(rb_first_span);
  a.chunk_by_cb = static_cast<const int*>(chunk_by_cb);
  a.col_first_chunk = static_cast<const int*>(col_first_chunk);
  a.cb_first_span = static_cast<const int*>(cb_first_span);
  a.chunk_rb = static_cast<const int*>(chunk_rb);
  a.chunk_cb = static_cast<const int*>(chunk_cb);
  a.row = static_cast<const int*>(row_local);
  a.col = static_cast<const int*>(col_local);
  a.auth = static_cast<const float*>(auth);
  a.hub = static_cast<const float*>(hub);
  a.hub_raw = static_cast<float*>(hub_raw);
  a.auth_raw = static_cast<float*>(auth_raw);
  const int n_spans = n_row_spans + n_col_spans;
  a.partial = static_cast<float*>(scratch);
  a.touched = reinterpret_cast<int*>(a.partial + static_cast<long>(n_spans) * window);
  a.n_row_spans = n_row_spans;
  a.n_col_spans = n_col_spans;
  a.n_chunks = n_chunks;
  a.n_row_blocks = n_row_blocks;
  a.n_col_blocks = n_col_blocks;
  a.window = window;
  a.chunk = chunk;
  a.n_vertices = n_vertices;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_spans > 0) {
    const int smem = static_cast<int>(sizeof(float)) * window;
    if (smem > 48 * 1024) {  // above 48 KB only when asked for
      const cudaError_t err = cudaFuncSetAttribute(
          hits_spans, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
    hits_spans<<<n_spans, gr::kThreads, smem, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n_row_blocks + n_col_blocks, (window + gr::kStrip - 1) / gr::kStrip);
  hits_combine<<<grid, gr::kReduceWarps * 32, 0, s>>>(a);
  return gr::finish(s);
}

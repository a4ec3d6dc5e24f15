// Geolocation's Weiszfeld step over the bucketed chunk layout: the dense
// pass and the chunk-skipping pass.
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
// Contract: for every chunk (dense) or every chunk in `queue[0:*count]`
// (sparse: the active chunks from chunkplan.cu, the count read on the
// device), and every real slot s of it with ok[s] > 0, with
//   r = chunk_rb * W + row_local[s],
//   d = haversine(mlat[s], mlon[s], y_lat[r], y_lon[r])   (degrees in, km
//       out, radius 6371, `a` clipped to [0, 1] before the root),
// if d != 0:
//   cnt[r] += 1, dinv[r] += 1 / max(d, 1e-30), wlat[r] += mlat[s] / d,
//   wlon[r] += mlon[s] / d.
// out = float[4, n_vertices] = (cnt, dinv, wlat, wlon), already zero, so
// rows no (queued) chunk reaches stay 0. Padding slots carry
// row_local == W and are skipped before any load through the row.
//
// What bounds it on this card: bytes, nominally. Per real slot it
// reads 4 B of row_local and 12 B of mlat/mlon/ok, and per labeled slot
// two 4 B iterate values of its row (one address per row: a hub row's
// slots broadcast); it writes 16 B per vertex. At R-MAT scale 18 that is
// 3.94M slots * 16 B + 4.2 MB of output, ~67 MB, ~20 us at 3.35 TB/s.
// The ~25 f32 operations and five transcendentals (two sinf, one cosf of
// the slot, sqrtf, asinf; cosf of the row's latitude is per slot too) of
// each labeled slot are well under 1 us at 67 TFLOP/s; in practice the
// precise sinf/cosf/asinf cost tens of machine operations each, and the
// four atomics of every labeled slot of a hub row meet at four addresses
// (measured: ~4x the byte bound).
//
// Design: a persistent grid of a few blocks per SM loops over the chunks;
// a block takes one chunk at a time and its threads stride over its slots.
// The iterate is read per slot by row: no gather window, no one-hot. The
// degrees-to-radians products use __fmul_rn so that the compiler cannot
// contract them into the subtraction that follows: two coordinates that
// round to the same radians give d == 0 exactly, here as in the plain
// version, and d != 0 decides `cnt`. No --use_fast_math: sinf, cosf and
// asinf are the precise ones (the TPU kernel's Cephes polynomial exists
// because its compiler has no arcsin). Slots with ok == 0 (padding,
// unlabeled neighbours) are dropped before any arithmetic, so nothing NaN
// reaches an atomic.

#include "common.cuh"

namespace {

constexpr float kRad = 0.017453292519943295f;  // pi / 180
constexpr float kTwoRadius = 2.0f * 6371.0f;   // km

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

template <bool kDense>
__global__ void weiszfeld_step(const int* __restrict__ queue,
                               const int* __restrict__ count, int n_chunks,
                               const int* __restrict__ chunk_rb,
                               const int* __restrict__ row_local,
                               const float* __restrict__ mlat,
                               const float* __restrict__ mlon,
                               const float* __restrict__ ok,
                               const float* __restrict__ y_lat,
                               const float* __restrict__ y_lon,
                               float* __restrict__ out, int window, int chunk,
                               long n_vertices) {
  const int n_work = kDense ? n_chunks : *count;
  const long n_slots = static_cast<long>(n_chunks) * chunk;
  for (int q = blockIdx.x; q < n_work; q += gridDim.x) {
    const int ch = kDense ? q : queue[q];
    if (!GR_IN_RANGE(ch, n_chunks)) continue;
    const long ybase = static_cast<long>(chunk_rb[ch]) * window;
    const long sbase = static_cast<long>(ch) * chunk;
    for (int s = threadIdx.x; s < chunk; s += blockDim.x) {
      if (!GR_IN_RANGE(sbase + s, n_slots)) continue;
      const int rl = row_local[sbase + s];
      if (rl == window) continue;  // padding slot
      if (!(ok[sbase + s] > 0.0f)) continue;  // unlabeled neighbour
      const long r = ybase + rl;
      if (!GR_IN_RANGE(r, n_vertices)) continue;
      const float la = mlat[sbase + s], lo = mlon[sbase + s];
      const float d = haversine(la, lo, y_lat[r], y_lon[r]);
      if (d != 0.0f) {
        const float dinv = 1.0f / fmaxf(d, 1e-30f);
        atomicAdd(out + r, 1.0f);
        atomicAdd(out + n_vertices + r, dinv);
        atomicAdd(out + 2 * n_vertices + r, dinv * la);
        atomicAdd(out + 3 * n_vertices + r, dinv * lo);
      }
    }
  }
}

}  // namespace

// mlat, mlon, ok: float[n_chunks * chunk] in slot order. y_lat, y_lon:
// float[n_vertices]. out: float[4 * n_vertices], already zero. queue ==
// null: the dense pass over all n_chunks chunks; else the chunks
// queue[0:*count]. Both on a persistent grid of `blocks` blocks.
extern "C" int gr_weiszfeld_step(int blocks, const void* queue,
                                 const void* count, int n_chunks,
                                 const void* chunk_rb, const void* row_local,
                                 const void* mlat, const void* mlon,
                                 const void* ok, const void* y_lat,
                                 const void* y_lon, void* out, int window,
                                 int chunk, int n_vertices, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* rb = static_cast<const int*>(chunk_rb);
  const int* row = static_cast<const int*>(row_local);
  const float* la = static_cast<const float*>(mlat);
  const float* lo = static_cast<const float*>(mlon);
  const float* okp = static_cast<const float*>(ok);
  const float* yla = static_cast<const float*>(y_lat);
  const float* ylo = static_cast<const float*>(y_lon);
  float* o = static_cast<float*>(out);
  if (queue == nullptr)
    weiszfeld_step<true><<<blocks, gr::kThreads, 0, s>>>(
        nullptr, nullptr, n_chunks, rb, row, la, lo, okp, yla, ylo, o, window,
        chunk, n_vertices);
  else
    weiszfeld_step<false><<<blocks, gr::kThreads, 0, s>>>(
        static_cast<const int*>(queue), static_cast<const int*>(count),
        n_chunks, rb, row, la, lo, okp, yla, ylo, o, window, chunk,
        n_vertices);
  return gr::finish(s);
}

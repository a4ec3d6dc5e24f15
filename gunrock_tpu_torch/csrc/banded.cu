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
// window for unused tail indices).
//
// What bounds it on this card: bytes. 4 B of idx read and 4 B of out
// written per element, plus each window once (span * 4 B per block_t
// elements; the windows of neighbouring blocks overlap, so the table is
// read about once in all). For one triangle-counting slab of 4M wedges
// that is ~34 MB plus the 15 MB table: ~15 us at 3.35 TB/s.
//
// Design: Hopper gathers from global memory natively, so the window is
// kept as the contract and not as a correctness device. One thread block
// per `block_t` indices, which reads table[lo_g + local] from global
// memory (the window is L2-resident; neighbouring wedges read neighbouring
// or equal positions). The window offset is computed in 64 bits.

#include "common.cuh"

namespace {

__global__ void banded_gather(const int* __restrict__ table, long n_table,
                              const int* __restrict__ idx,
                              const int* __restrict__ block_lo,
                              int* __restrict__ out, long n_idx, int block_t,
                              int span) {
  const long g = blockIdx.x;
  const long lo = static_cast<long>(block_lo[g]) * 128;
  // the whole window must lie inside the table
  const bool fits = GR_IN_RANGE(lo, n_table) &&
                    GR_IN_RANGE(lo + span - 1, n_table);
  if (!fits) return;
  const long base = g * block_t;
  for (int t = threadIdx.x; t < block_t; t += blockDim.x) {
    if (!GR_IN_RANGE(base + t, n_idx)) continue;
    long local = static_cast<long>(idx[base + t]) - lo;
    local = local < 0 ? 0 : (local > span - 1 ? span - 1 : local);
    out[base + t] = table[lo + local];
  }
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
  const unsigned grid = static_cast<unsigned>(n_blocks);
  banded_gather<<<grid, gr::kThreads, 0, s>>>(tab, n_table, ix, lo, o, n_idx,
                                              block_t, span);
  return gr::finish(s);
}

// Hopper counterparts of the TPU probes' kernels: a gather along any axis
// (or flat), and a bulk copy of index-named blocks into shared memory.
//
// Gather. Replaces the nine gather pallas_calls of
// benchmarks/probe_gather.py::_build (lane :49, sublane :64, flat :79,
// twolevel :109, bench :128) and benchmarks/probe_gather2.py::run_variant
// (lane :46, sublane :61): out = take_along_axis(x, idx, axis), or the flat
// out = x[idx]. The output has idx's shape; x and idx agree on every axis
// but `axis`. For output element o = (outer, a, inner) with `inner` the
// product of the sizes after the axis,
//   out[o] = x[(outer * n_axis_x + idx[o]) * inner + inner_i];
// the flat gather is outer = inner = 1. The TPU's one-hot two-level gather
// (probe_gather.py's `twolevel`) works around a missing vector gather and
// has no counterpart: Hopper gathers natively. Bound: bytes, idx and out
// once each (8 B per element) plus x once. Design: one thread per output
// element, neighbouring threads on neighbouring outputs, so idx and out
// are read and written coalesced and the x reads land wherever idx says
// (L1/L2 for the probes' shapes). idx must lie in [0, n_axis_x); the
// checked build range-checks it.
//
// Block copy. Replaces benchmarks/probe_dma.py's kernel (:21-57, the
// pallas_call at :66): the manual-DMA pattern a streaming semiring kernel
// needs. Contract: read cnt on the device, then fill y with the sum over
// i < cnt of every element of block x[meta[i]]; x is [n_blocks, rows, 128]
// f32, y is [rows, 128]. Bound: bytes, cnt * rows * 512 B of blocks copied
// (x once, where blocks repeat) plus meta. Design: the TPU's SMEM meta
// batches and make_async_copy become, per thread block, a batch of meta
// staged in shared memory and a ring of kStages block buffers filled by
// the Tensor Memory Accelerator's bulk copy (cp.async.bulk ...
// mbarrier::complete_tx::bytes), one mbarrier per buffer. Thread 0 keeps
// up to kStages copies in flight; all threads wait on the current buffer's
// barrier, sum it, meet at __syncthreads, and thread 0 refills that buffer
// with the copy kStages ahead. Thread blocks take contiguous ranges of
// meta, combine their sums with one atomicAdd each into a scratch word,
// and a second pass fills y from it.

#include <cstdint>

#include "common.cuh"

namespace {

__global__ void gather(const float* __restrict__ x, const int* __restrict__ idx,
                       float* __restrict__ out, long n_out, long inner,
                       long n_axis_idx, long n_axis_x) {
  for (long o = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
       o < n_out; o += static_cast<long>(gridDim.x) * blockDim.x) {
    const long i = idx[o];
    if (!GR_IN_RANGE(i, n_axis_x)) continue;
    const long inner_i = o % inner;
    const long outer = o / (inner * n_axis_idx);
    out[o] = x[(outer * n_axis_x + i) * inner + inner_i];
  }
}

constexpr int kStages = 4;      // block buffers in flight per thread block
constexpr int kMetaBatch = 512;  // meta entries staged at a time

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Thread 0: start the copy of block `blk` (or, for a block the checked
// build refused, a plain arrival) into buffer `stage`.
__device__ __forceinline__ void issue(const float* x, int blk, float* buf,
                                      uint64_t* bar, uint32_t bytes,
                                      int block_floats) {
  const uint32_t b = smem_addr(bar);
  if (blk < 0) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(b)
                 : "memory");
    return;
  }
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(buf)),
      "l"(x + static_cast<long>(blk) * block_floats), "r"(bytes), "r"(b)
      : "memory");
}

__global__ void block_copy_sum(const float* __restrict__ x,
                               const int* __restrict__ meta, int n_meta,
                               const int* __restrict__ cnt, int n_blocks,
                               int block_floats, float* __restrict__ total) {
  extern __shared__ __align__(128) float ring[];  // kStages * block_floats
  __shared__ __align__(8) uint64_t bars[kStages];
  __shared__ int meta_s[kMetaBatch];
  __shared__ float warp_sums[32];

  const int n = min(*cnt, n_meta);
  const int per = (n + gridDim.x - 1) / gridDim.x;
  const int lo = min(n, static_cast<int>(blockIdx.x) * per);
  const int hi = min(n, lo + per);
  const uint32_t bytes = static_cast<uint32_t>(block_floats) * 4u;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(&bars[st]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc = 0.0f;
  int used = 0;  // copies consumed so far: buffer used % kStages, parity
  for (int base = lo; base < hi; base += kMetaBatch) {
    const int nb = min(kMetaBatch, hi - base);
    for (int j = threadIdx.x; j < nb; j += blockDim.x) {
      const int blk = meta[base + j];
      meta_s[j] = GR_IN_RANGE(blk, n_blocks) ? blk : -1;
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (int j = 0; j < min(kStages, nb); ++j) {
        const int st = (used + j) % kStages;
        issue(x, meta_s[j], ring + st * block_floats, &bars[st], bytes,
              block_floats);
      }
    for (int j = 0; j < nb; ++j, ++used) {
      const int st = used % kStages;
      mbar_wait(&bars[st], (used / kStages) & 1);
      if (meta_s[j] >= 0) {
        const float4* b4 = reinterpret_cast<const float4*>(ring + st * block_floats);
        for (int k = threadIdx.x; k < block_floats / 4; k += blockDim.x) {
          const float4 v = b4[k];
          acc += (v.x + v.y) + (v.z + v.w);
        }
      }
      __syncthreads();  // buffer st is read: it may be refilled
      if (threadIdx.x == 0 && j + kStages < nb)
        issue(x, meta_s[j + kStages], ring + st * block_floats, &bars[st],
              bytes, block_floats);
    }
  }

  acc = gr::block_sum(acc, warp_sums);
  if (threadIdx.x == 0 && hi > lo) atomicAdd(total, acc);
}

__global__ void fill(const float* __restrict__ total, float* __restrict__ y,
                     long n) {
  for (long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<long>(gridDim.x) * blockDim.x)
    y[i] = *total;
}

}  // namespace

// out = take_along_axis(x, idx, axis): n_out elements (idx's size), inner
// the product of the sizes after the axis, n_axis_idx / n_axis_x the
// axis's size in idx / x. The flat x[idx]: inner = 1, n_axis_idx = n_out,
// n_axis_x = x's size.
extern "C" int gr_gather(int blocks, const void* x, const void* idx, void* out,
                         long n_out, long inner, long n_axis_idx,
                         long n_axis_x, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gather<<<blocks, gr::kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const int*>(idx),
      static_cast<float*>(out), n_out, inner, n_axis_idx, n_axis_x);
  return gr::finish(s);
}

// y[0:block_floats] = sum of the blocks x[meta[i]], i < min(*cnt, n_meta).
// x: float[n_blocks * block_floats], 16-byte aligned, block_floats a
// multiple of 4; total: one float, zeroed by the caller.
extern "C" int gr_block_copy_sum(int blocks, const void* x, const void* meta,
                                 int n_meta, const void* cnt, int n_blocks,
                                 int block_floats, void* total, void* y,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = kStages * block_floats * 4;
  cudaError_t err = cudaFuncSetAttribute(
      block_copy_sum, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  block_copy_sum<<<blocks, gr::kThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const int*>(meta), n_meta,
      static_cast<const int*>(cnt), n_blocks, block_floats,
      static_cast<float*>(total));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fill<<<gr::grid_for(block_floats, 64), gr::kThreads, 0, s>>>(
      static_cast<const float*>(total), static_cast<float*>(y), block_floats);
  return gr::finish(s);
}

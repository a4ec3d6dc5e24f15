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
// once each (8 B per element) plus x once. Design: a thread takes four
// consecutive outputs, so idx and out are read and written coalesced and
// the four x reads (through the read-only path, __ldg) are in flight
// together; they land wherever idx says (L1/L2 for the probes' shapes).
// Where n_out and x's size are below 2^31 the index math is 32-bit and
// splits o into (outer, a, inner_i) by a multiply-high with a
// precomputed magic number (FastDiv, CUTLASS's FastDivmod), not by a
// division; where the rows hold whole groups of four (inner == 1 and
// n_axis_idx % 4 == 0, or inner % 4 == 0) a group shares one split, one
// int4 load of idx and one float4 store. Above 2^31 a 64-bit kernel takes
// one output a thread. idx must lie in [0, n_axis_x); the checked build
// range-checks it.
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

// n / d for a fixed d > 0 and any n in [0, 2^31) without a division:
// (umulhi(n, mul) >> shift) with mul = ceil(2^(31 + L) / d), shift = L - 1
// and L = ceil(log2 d) (d == 1 passes n through). CUTLASS's FastDivmod.
struct FastDiv {
  unsigned mul;
  int shift;
  int d;
  __device__ __forceinline__ int div(int n) const {
    return d == 1 ? n : static_cast<int>(__umulhi(static_cast<unsigned>(n), mul) >> shift);
  }
};

FastDiv fast_div(int d) {
  FastDiv f{0u, 0, d};
  if (d == 1) return f;
  int L = 0;
  while ((1ll << L) < d) ++L;
  f.mul = static_cast<unsigned>(((1ull << (31 + L)) + d - 1) / d);
  f.shift = L - 1;
  return f;
}

// The 32-bit gather: thread g takes outputs 4g .. 4g + 3. kVec: every group
// of four lies in one row (see above), idx and out are 16-byte aligned.
template <bool kVec>
__global__ void gather32(const float* __restrict__ x, const int* __restrict__ idx,
                         float* __restrict__ out, int n_out, int inner,
                         int n_axis_idx, int n_axis_x, FastDiv by_inner,
                         FastDiv by_axis) {
  const int n_groups = (n_out - 1) / 4 + 1;
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < n_groups;
       g += gridDim.x * blockDim.x) {
    const int o0 = 4 * g;
    if (kVec) {
      const int4 iv = *reinterpret_cast<const int4*>(idx + o0);
      const int q = by_inner.div(o0);
      const int inner_i = o0 - q * inner;
      const int outer = by_axis.div(q);
      const int base = outer * n_axis_x;
      const int step = inner == 1 ? 0 : 1;  // inner_i + k along the row
      const int i[4] = {iv.x, iv.y, iv.z, iv.w};
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = GR_IN_RANGE(i[k], n_axis_x)
                   ? __ldg(x + (base + i[k]) * inner + inner_i + step * k)
                   : 0.0f;
      *reinterpret_cast<float4*>(out + o0) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k >= n_out - o0) break;
        const int o = o0 + k;
        const int i = idx[o];
        if (!GR_IN_RANGE(i, n_axis_x)) continue;
        const int q = by_inner.div(o);
        const int outer = by_axis.div(q);
        out[o] = __ldg(x + (outer * n_axis_x + i) * inner + (o - q * inner));
      }
    }
  }
}

// The 64-bit gather, one output a thread, where n_out or x's size is
// 2^31 or more.
__global__ void gather64(const float* __restrict__ x, const int* __restrict__ idx,
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

// out = take_along_axis(x, idx, axis): n_out elements (idx's size, > 0),
// inner the product of the sizes after the axis, n_axis_idx / n_axis_x the
// axis's size in idx / x. The flat x[idx]: inner = 1, n_axis_idx = n_out,
// n_axis_x = x's size. `blocks` of 256 threads, each thread four outputs
// a round.
extern "C" int gr_gather(int blocks, const void* x, const void* idx, void* out,
                         long n_out, long inner, long n_axis_idx,
                         long n_axis_x, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const int* ip = static_cast<const int*>(idx);
  float* op = static_cast<float*>(out);
  constexpr long kMax32 = 0x7fffffffL;
  const long x_size = n_out / (inner * n_axis_idx) * n_axis_x * inner;
  if (n_out > kMax32 || x_size > kMax32) {
    gather64<<<blocks, gr::kThreads, 0, s>>>(xp, ip, op, n_out, inner,
                                            n_axis_idx, n_axis_x);
    return gr::finish(s);
  }
  const FastDiv by_inner = fast_div(static_cast<int>(inner));
  const FastDiv by_axis = fast_div(static_cast<int>(n_axis_idx));
  const bool rows4 = (inner == 1 && n_axis_idx % 4 == 0) || inner % 4 == 0;
  if (rows4 && gr::aligned16(idx) && gr::aligned16(out))
    gather32<true><<<blocks, gr::kThreads, 0, s>>>(
        xp, ip, op, static_cast<int>(n_out), static_cast<int>(inner),
        static_cast<int>(n_axis_idx), static_cast<int>(n_axis_x), by_inner,
        by_axis);
  else
    gather32<false><<<blocks, gr::kThreads, 0, s>>>(
        xp, ip, op, static_cast<int>(n_out), static_cast<int>(inner),
        static_cast<int>(n_axis_idx), static_cast<int>(n_axis_x), by_inner,
        by_axis);
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

// Active-chunk plan for the frontier-sparse semiring pull.
//
// Replaces: gunrock_tpu/ops/pallas/chunkplan.py::chunk_activity
// (_make_plan_kernel) together with the XLA word packing and the stable
// lax.sort compaction around it in
// gunrock_tpu/ops/pallas/semiring.py::_sparse_chunk_select.
//
// What bounds it on this card: nothing but launch latency. At R-MAT scale
// 18 (W=2048, 20,548 chunks) it reads two bool[V] masks (0.5 MB) and four
// int32[n_chunks] metadata arrays (0.3 MB) and writes the chunk mask and
// queue (0.1 MB): well under a microsecond of memory traffic at 3.35 TB/s.
//
// Design: two launches on the caller's stream.
// 1. pack_words: one thread per vertex. A warp covers 32 consecutive
//    vertices, which lie in one window because W is a multiple of 32, so
//    the warp ORs its sub-block bits together (__reduce_or_sync) and one
//    lane issues the atomicOr. That is 32x fewer atomics than one per
//    vertex on a full frontier.
// 2. test_chunks: one thread per chunk tests its occupancy words against
//    the packed words, writes ch_act and appends the chunk id to a device
//    queue with one warp-aggregated atomicAdd. The count stays on the
//    device for the pull kernel; queue order is unspecified, which the
//    atomic pull does not care about.

#include "common.cuh"

namespace {

__global__ void pack_words(const unsigned char* __restrict__ active,
                           const unsigned char* __restrict__ out_mask,
                           long n_vertices, int window, int n_col_blocks,
                           int n_row_blocks,
                           unsigned* __restrict__ act_words,
                           unsigned* __restrict__ om_words) {
  const int sub = window / 32;
  const long stride = static_cast<long>(gridDim.x) * blockDim.x;
  for (long base = static_cast<long>(blockIdx.x) * blockDim.x; base < n_vertices;
       base += stride) {
    const long v = base + threadIdx.x;
    const bool in = v < n_vertices;
    const unsigned bit = in ? 1u << ((v % window) / sub) : 0u;
    const unsigned a = __reduce_or_sync(0xffffffffu, in && active[v] ? bit : 0u);
    unsigned o = 0u;
    if (out_mask != nullptr)
      o = __reduce_or_sync(0xffffffffu, in && out_mask[v] ? bit : 0u);
    if ((threadIdx.x & 31) == 0) {
      const long w = v / window;
      if (a && GR_IN_RANGE(w, n_col_blocks)) atomicOr(&act_words[w], a);
      if (o && GR_IN_RANGE(w, n_row_blocks)) atomicOr(&om_words[w], o);
    }
  }
}

__global__ void test_chunks(const unsigned* __restrict__ act_words,
                            const unsigned* __restrict__ om_words,
                            const int* __restrict__ chunk_cb,
                            const int* __restrict__ chunk_rb,
                            const unsigned* __restrict__ src_bits,
                            const unsigned* __restrict__ dst_bits,
                            int n_chunks, int n_col_blocks,
                            int n_row_blocks, bool masked,
                            unsigned char* __restrict__ ch_act,
                            int* __restrict__ queue, int* __restrict__ count) {
  const int stride = gridDim.x * blockDim.x;
  for (int base = blockIdx.x * blockDim.x; base < n_chunks; base += stride) {
    const int i = base + threadIdx.x;
    bool act = false;
    if (i < n_chunks && GR_IN_RANGE(chunk_cb[i], n_col_blocks) &&
        GR_IN_RANGE(chunk_rb[i], n_row_blocks)) {
      act = (act_words[chunk_cb[i]] & src_bits[i]) != 0u;
      if (masked) act = act && (om_words[chunk_rb[i]] & dst_bits[i]) != 0u;
      ch_act[i] = act;
    }
    gr::warp_append(act, i, queue, count, n_chunks);
  }
}

}  // namespace

// words: int32[1 + n_col_blocks + n_row_blocks] scratch laid out as
// [count | act_words | om_words]; it is zeroed here. out_mask may be null.
extern "C" int gr_chunk_activity(const void* active, const void* out_mask,
                                 long n_vertices, int window, int n_col_blocks,
                                 int n_row_blocks, const void* chunk_cb,
                                 const void* chunk_rb, const void* src_bits,
                                 const void* dst_bits, int n_chunks, void* words,
                                 void* ch_act, void* queue, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* w = static_cast<unsigned*>(words);
  int* count = reinterpret_cast<int*>(w);
  unsigned* act_words = w + 1;
  unsigned* om_words = act_words + n_col_blocks;
  cudaMemsetAsync(w, 0, sizeof(unsigned) * (1 + n_col_blocks + n_row_blocks), s);
  pack_words<<<gr::grid_for(n_vertices, 4096), gr::kThreads, 0, s>>>(
      static_cast<const unsigned char*>(active),
      static_cast<const unsigned char*>(out_mask), n_vertices, window,
      n_col_blocks, n_row_blocks, act_words, om_words);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  test_chunks<<<gr::grid_for(n_chunks, 4096), gr::kThreads, 0, s>>>(
      act_words, om_words, static_cast<const int*>(chunk_cb),
      static_cast<const int*>(chunk_rb), static_cast<const unsigned*>(src_bits),
      static_cast<const unsigned*>(dst_bits), n_chunks, n_col_blocks,
      n_row_blocks, out_mask != nullptr, static_cast<unsigned char*>(ch_act),
      static_cast<int*>(queue), count);
  return gr::finish(s);
}

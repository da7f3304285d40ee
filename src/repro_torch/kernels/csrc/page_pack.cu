// Page gather / scatter between a frame pool and a contiguous block, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels `page_gather` (+ `_copy_kernel`) and
// `page_scatter` (+ `_scatter_kernel`) of
// src/repro/kernels/page_pack/page_pack.py: `gather` packs the pool rows
// named by a page list into a contiguous (n, E) block, `scatter` is the
// inverse and writes the block's rows into the pool in place, leaving every
// other row untouched.  A negative ("unmapped") index is clamped to row 0,
// as in the TPU kernels' index maps; an index past the pool is clamped to
// the last row so that a bad list can never touch memory outside the pool.
// With duplicate indices in a scatter the row that wins is undefined (blocks
// run in no order), as the order of the per-step DMAs is on the TPU.
//
// What bounds it on this card: bytes, purely: n * E * itemsize read and the
// same written, no arithmetic.
//
// What the design does about it: the TPU grid of one whole page per step
// becomes many independent blocks, (row, 16 KB piece of the row) each, so a
// copy of a few hundred rows fills all SMs; rows are copied as raw bytes
// (any element type), 16 bytes per thread per access with neighbouring
// threads on neighbouring addresses, four accesses in flight per thread;
// the block reads its own index.  When the row size or a base pointer is
// not a multiple of 16 bytes the same kernel runs with 4-, 2- or 1-byte
// words.  Not done here (later work): TMA bulk copies.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;       // words per thread per block

// grid (n, ceil(words_per_row / (kThreads * kUnroll))).
// kGather: dst[i] = src[idx[i]];  else: dst[idx[i]] = src[i].
template <typename W, bool kGather>
__global__ void page_copy_kernel(const W* __restrict__ src, W* __restrict__ dst,
                                 const int* __restrict__ indices,
                                 long long words_per_row, int pool_rows) {
  const int i = blockIdx.x;
  int row = indices[i];
  row = row < 0 ? 0 : row;
  row = row >= pool_rows ? pool_rows - 1 : row;
  const W* s = src + (long long)(kGather ? row : i) * words_per_row;
  W* d = dst + (long long)(kGather ? i : row) * words_per_row;
  const long long base = (long long)blockIdx.y * (kThreads * kUnroll) + threadIdx.x;
  W tmp[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long w = base + (long long)u * kThreads;
    if (w < words_per_row) tmp[u] = s[w];
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long w = base + (long long)u * kThreads;
    if (w < words_per_row) d[w] = tmp[u];
  }
}

template <typename W, bool kGather>
cudaError_t launch_words(const void* src, void* dst, const int* indices,
                         long long row_bytes, int n, int pool_rows,
                         cudaStream_t stream) {
  const long long words = row_bytes / (long long)sizeof(W);
  const long long per_block = (long long)kThreads * kUnroll;
  const long long pieces = (words + per_block - 1) / per_block;
  if (pieces > 65535) return cudaErrorInvalidValue;
  const dim3 grid(n, (unsigned)pieces);
  page_copy_kernel<W, kGather><<<grid, kThreads, 0, stream>>>(
      (const W*)src, (W*)dst, indices, words, pool_rows);
  return cudaGetLastError();
}

template <bool kGather>
int launch_copy(const void* src, void* dst, const void* indices,
                long long row_bytes, int n, int pool_rows, void* stream) {
  if (n < 0 || pool_rows <= 0 || row_bytes <= 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int* idx = (const int*)indices;
  const uintptr_t bits = (uintptr_t)src | (uintptr_t)dst | (uintptr_t)row_bytes;
  if (bits % 16 == 0)
    return (int)launch_words<uint4, kGather>(src, dst, idx, row_bytes, n, pool_rows, s);
  if (bits % 4 == 0)
    return (int)launch_words<uint32_t, kGather>(src, dst, idx, row_bytes, n, pool_rows, s);
  if (bits % 2 == 0)
    return (int)launch_words<uint16_t, kGather>(src, dst, idx, row_bytes, n, pool_rows, s);
  return (int)launch_words<uint8_t, kGather>(src, dst, idx, row_bytes, n, pool_rows, s);
}

}  // namespace

// pool: (pool_rows, row_bytes) contiguous; block: (n, row_bytes) contiguous;
// indices: (n,) int32.  Both return the cudaError_t of the launch (0 on
// success) and synchronise nothing.
extern "C" int repro_page_gather(const void* pool, const void* indices,
                                 void* block, long long row_bytes, int n,
                                 int pool_rows, void* stream) {
  return launch_copy<true>(pool, block, indices, row_bytes, n, pool_rows, stream);
}

extern "C" int repro_page_scatter(void* pool, const void* indices,
                                  const void* block, long long row_bytes, int n,
                                  int pool_rows, void* stream) {
  return launch_copy<false>(block, pool, indices, row_bytes, n, pool_rows, stream);
}

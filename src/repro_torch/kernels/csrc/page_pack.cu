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
// What the design does about it.  The host plans each copy from its total
// bytes and the SM count (`copy_plan` in page_pack.py: mode, piece bytes,
// blocks and ring slots) and picks one of two modes for 16-byte aligned
// rows (every pool of the port):
//  * large copies (16 MB and more: a serving step's KV rows) run as bulk
//    copies.  A block is one thread that streams its pieces (piece p,
//    p + grid, ...; up to 32 KB, in one row) through a ring of `stages`
//    shared-memory slots with the copy engine and nothing else: global ->
//    shared by a 1-D bulk copy (`cp.async.bulk ... mbarrier::complete_tx::
//    bytes`, one mbarrier a slot), shared -> global by a 1-D bulk copy in a
//    bulk group (`cp.async.bulk.global.shared::cta.bulk_group`), a slot
//    refilled once the store that last read it has finished reading
//    (`cp.async.bulk.wait_group.read`).  So a block keeps `stages` pieces
//    in flight without spending a register on the data.  The grid is four
//    blocks a SM, twice what fits at once (3 x 32 KB of shared memory a
//    block), so blocks that finish early hand their SM to the rest;
//  * small copies (the latent pools' 16 rows of 32 or 256 KB) run the word
//    loop: one block a (row, 16 KB piece), 16 bytes a thread.  A bulk
//    copy's round trip through shared memory costs ~0.45 us more than a
//    register round trip there, and such a copy is latency-bound: it sits
//    ~1 us above an empty kernel's time (tools/page_pack_sweep.py on an
//    H100 80GB HBM3 at 700 W).
// Rows that are not 16-byte aligned (or a base pointer that is not) take
// the word loop with 4-, 2- or 1-byte words.  One launch a call either way.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // the word loop: threads a block
constexpr int kUnroll = 4;       // words a thread a block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int clamp_row(int row, int pool_rows) {
  row = row < 0 ? 0 : row;
  return row >= pool_rows ? pool_rows - 1 : row;
}

// ----------------------------------------------------------- bulk copies
// grid (blocks), one thread.  Piece p: row p / per_row, bytes [(p % per_row)
// * piece, ...) of it.  kGather: dst[i] = src[idx[i]];  else: dst[idx[i]] =
// src[i].  Dynamic shared memory: `stages` slots of `piece` bytes, then
// `stages` mbarriers.
template <bool kGather>
__global__ void __launch_bounds__(32) page_bulk_kernel(
    const unsigned char* __restrict__ src, unsigned char* __restrict__ dst,
    const int* __restrict__ indices, long long row_bytes, int piece,
    int per_row, long long n_pieces, int pool_rows, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (threadIdx.x != 0) return;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + stages * piece);
  for (int s = 0; s < stages; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(smem_u32(bars + s)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");

  const long long mine =
      (n_pieces - blockIdx.x + gridDim.x - 1) / gridDim.x;   // pieces here
  // piece k of this block: where it is read and written, and its bytes
  auto locate = [&](long long k, const unsigned char** from,
                    unsigned char** to) -> uint32_t {
    const long long p = blockIdx.x + k * gridDim.x;
    const long long i = p / per_row;
    const long long off = (p - i * per_row) * (long long)piece;
    const long long row = clamp_row(indices[i], pool_rows);
    *from = src + (kGather ? row : i) * row_bytes + off;
    *to = dst + (kGather ? i : row) * row_bytes + off;
    const long long left = row_bytes - off;
    return (uint32_t)(left < piece ? left : piece);
  };
  auto load = [&](long long k) {
    const unsigned char* from;
    unsigned char* to;
    const uint32_t bytes = locate(k, &from, &to);
    const int s = (int)(k % stages);
    const uint32_t bar = smem_u32(bars + s);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        :: "r"(smem_u32(smem + s * piece)), "l"(from), "r"(bytes), "r"(bar)
        : "memory");
  };

  for (long long k = 0; k < mine && k < stages; ++k) load(k);
  for (long long k = 0; k < mine; ++k) {
    const int s = (int)(k % stages);
    const uint32_t parity = (uint32_t)((k / stages) & 1);
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n\t.reg .pred p;\n\t"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
          "selp.u32 %0, 1, 0, p;\n\t}"
          : "=r"(done) : "r"(smem_u32(bars + s)), "r"(parity) : "memory");
    }
    const unsigned char* from;
    unsigned char* to;
    const uint32_t bytes = locate(k, &from, &to);
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 :: "l"(to), "r"(smem_u32(smem + s * piece)), "r"(bytes)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    // the slot of piece k - 1 is free once its store has read it (every
    // group but the newest): refill it with piece k - 1 + stages
    if (k >= 1 && k - 1 + stages < mine) {
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      load(k - 1 + stages);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// ------------------------------------------------------------- word loop
// grid (n, ceil(words_per_row / (kThreads * kUnroll))).
// kGather: dst[i] = src[idx[i]];  else: dst[idx[i]] = src[i].
template <typename W, bool kGather>
__global__ void page_copy_kernel(const W* __restrict__ src, W* __restrict__ dst,
                                 const int* __restrict__ indices,
                                 long long words_per_row, int pool_rows) {
  const int i = blockIdx.x;
  const int row = clamp_row(indices[i], pool_rows);
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
cudaError_t launch_bulk(const void* src, void* dst, const int* indices,
                        long long row_bytes, int n, int pool_rows, int piece,
                        int blocks, int stages, cudaStream_t stream) {
  if (piece <= 0 || piece % 16 != 0 || blocks <= 0 || stages <= 0)
    return cudaErrorInvalidValue;
  const long long per_row = (row_bytes + piece - 1) / piece;
  if (per_row > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long n_pieces = per_row * n;
  const int grid = (int)(n_pieces < blocks ? n_pieces : blocks);
  const long long smem = (long long)stages * (piece + 8);
  // the kernel may use all the shared memory a block can opt into (set
  // once per device); a plan past it is refused
  static int optin[32] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (optin[dev] == 0) {
    int most = 0;
    e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(page_bulk_kernel<kGather>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return e;
    optin[dev] = most;
  }
  if (smem > optin[dev]) return cudaErrorInvalidValue;
  page_bulk_kernel<kGather><<<grid, 32, (size_t)smem, stream>>>(
      (const unsigned char*)src, (unsigned char*)dst, indices, row_bytes,
      piece, (int)per_row, n_pieces, pool_rows, stages);
  return cudaGetLastError();
}

// mode 1: bulk copies of `piece` bytes on at most `blocks` blocks through
// rings of `stages` slots (16-byte aligned rows only); mode 0: the word
// loop (piece, blocks and stages unused).
template <bool kGather>
int launch_copy(const void* src, void* dst, const void* indices,
                long long row_bytes, int n, int pool_rows, int mode,
                int piece, int blocks, int stages, void* stream) {
  if (n < 0 || pool_rows <= 0 || row_bytes <= 0) return (int)cudaErrorInvalidValue;
  if (mode != 0 && mode != 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int* idx = (const int*)indices;
  const uintptr_t bits = (uintptr_t)src | (uintptr_t)dst | (uintptr_t)row_bytes;
  if (bits % 16 == 0) {
    if (mode == 1)
      return (int)launch_bulk<kGather>(src, dst, idx, row_bytes, n,
                                       pool_rows, piece, blocks, stages, s);
    return (int)launch_words<uint4, kGather>(src, dst, idx, row_bytes, n,
                                             pool_rows, s);
  }
  if (bits % 4 == 0)
    return (int)launch_words<uint32_t, kGather>(src, dst, idx, row_bytes, n,
                                                pool_rows, s);
  if (bits % 2 == 0)
    return (int)launch_words<uint16_t, kGather>(src, dst, idx, row_bytes, n,
                                                pool_rows, s);
  return (int)launch_words<uint8_t, kGather>(src, dst, idx, row_bytes, n,
                                             pool_rows, s);
}

__global__ void empty_kernel() {}

}  // namespace

// pool: (pool_rows, row_bytes) contiguous; block: (n, row_bytes) contiguous;
// indices: (n,) int32; mode, piece, blocks, stages: the copy's plan
// (page_pack.copy_plan; see launch_copy).  Both return the cudaError_t of
// the launch (0 on success) and synchronise nothing.
extern "C" int repro_page_gather(const void* pool, const void* indices,
                                 void* block, long long row_bytes, int n,
                                 int pool_rows, int mode, int piece,
                                 int blocks, int stages, void* stream) {
  return launch_copy<true>(pool, block, indices, row_bytes, n, pool_rows,
                           mode, piece, blocks, stages, stream);
}

extern "C" int repro_page_scatter(void* pool, const void* indices,
                                  const void* block, long long row_bytes, int n,
                                  int pool_rows, int mode, int piece,
                                  int blocks, int stages, void* stream) {
  return launch_copy<false>(block, pool, indices, row_bytes, n, pool_rows,
                            mode, piece, blocks, stages, stream);
}

// One launch of an empty kernel of `blocks` one-warp blocks: the floor
// under a copy's time, measured the same way (no part of any path).
extern "C" int repro_empty_launch(int blocks, void* stream) {
  if (blocks <= 0) return (int)cudaErrorInvalidValue;
  empty_kernel<<<blocks, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

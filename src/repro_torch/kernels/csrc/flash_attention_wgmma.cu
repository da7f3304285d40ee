// Flash attention's bf16 forward on the tensor cores of NVIDIA Hopper
// (sm_90a): wgmma on tiles that the Tensor Memory Accelerator copies into
// shared memory, one producer warp and two consumer warpgroups.  The
// forward of every bf16 call of more than DECODE_MAX_ROWS query rows
// (flash_attention.py's `forward_entry`; flash_decode.cu takes the few-row
// calls, flash_attention_tc.cu holds the bf16 backward).
//
// Replaces the TPU kernel `flash_attention_kernel` / `_kernel` of
// src/repro/kernels/flash_attention/flash_attention.py:79: q (B, Sq, H, D)
// attends to k, v (B, Sk, KVH, D), query head h reading KV head h / G, key
// tiles wholly above the causal diagonal or outside the window skipped (the
// TPU kernel's block predicate, `k_range` of flash_mask.cuh), the mask of
// flash_mask.cuh applied element by element only on the tiles that
// straddle the diagonal, the window edge or the end of either sequence.
// Sq may differ from Sk: without a mask (cross-attention), or as one rank's
// rows of a sequence split, q row i at absolute position q_off + i with
// q_off + Sq <= Sk.  Same arithmetic as the TPU kernel: f32 running max,
// sum and accumulator, masked scores -1e30 (finite), the result divided by
// max(l, 1e-30); it also writes the per-row logsumexp lse (B, H, Sq) in
// natural log, which the backward kernels of flash_attention_tc.cu take.
//
// What bounds it on this card: operations.  At the training shape (B=1,
// S=4096, H=40, KVH=8, D=128, causal) it does about 1.72e11 FLOP (QK^T and
// PV) against ~0.1 GB of inputs and outputs, far above the ~295 FLOP per
// byte at which HBM would become the limit: the bound is the 989 TFLOP/s
// bf16 tensor-core rate, which only wgmma reaches.
//
// What the design does about it:
//  * a block is 128 query rows of one head: two consumer warpgroups of 64
//    rows (wgmma's m64) and a producer warpgroup, of which one thread
//    issues every copy.  setmaxnreg hands the producer's registers to the
//    consumers (24 and 240 a thread);
//  * the copies are cp.async.bulk.tensor over three 4-d tensor maps that
//    describe q (B, Sq, H, D) and k, v (B, Sk, KVH, D) by their strides, so
//    the model layout is read as it lies.  Each map's box is one 64-column
//    atom (128 bytes) of one head's rows, copied with the 128-byte swizzle
//    that the wgmma descriptors name.  Q is copied once; K and V go
//    through a ring of kStages stages (as many as shared memory holds)
//    under "full" (expect-tx) and "empty" mbarriers.  Rows past Sq or Sk
//    and columns past the head dim are zero-filled by the copy;
//  * S = Q K^T by wgmma.mma_async with both operands in shared memory,
//    K-major; P rounded to bf16 in registers (the m64nN f32 accumulator of
//    each warp has the m16n8 layout, which is the m16k16 A-fragment layout
//    of the next product) and fed as the register A operand of O += P V,
//    V the B operand in shared memory, MN-major (the instruction's
//    transpose bit);
//  * the softmax is what the tensor cores wait on (on an H100 a tile's
//    exp2 take half the time of its two products, at 16 a cycle an SM), so
//    the design hides it: a warpgroup issues tile j's QK^T before tile
//    j - 1's PV and runs tile j's softmax while both are in flight
//    (FlashAttention-3's overlap within a warpgroup), and the two
//    warpgroups take turns on named barriers to issue their products, so
//    one's softmax runs while the other's products do (its ping-pong).
//    The softmax itself: the running max of raw scores, p = exp2(s c - m c)
//    as one FFMA and one MUFU with c = log2(e) / sqrt(D), a row's max and
//    sum as four independent chains (a warp has little else to hide a
//    chain of 32 dependent adds behind, and a tree of 32 temporaries made
//    the D = 128 instance spill);
//  * a row whose every score so far is masked takes p = 0 (its running
//    max is -1e30, so exp2 is taken against 0, never exp2(-1e30 - -1e30));
//  * the blocks walk the (batch, head) pairs in groups whose K and V fit
//    in 32 MB of L2, and within a group the q tiles latest (heaviest)
//    first: DeepSeek-V3's 128 heads of 4,096 keys at D = 192 hold 384 MB
//    of K and V, which heads walked all together would read from HBM once
//    for every q tile;
//  * no atomics: each row's sums run over the key tiles in one order, so
//    two calls give identical bits.
//
// Head dims: instances at D = 64, 128 and 192; 16, 32 and 48 run the 64
// instance, 80, 96 and 112 the 128 one (flash_attention.py's
// `fwd_instance`).  The maps carry the true head dim and a box as wide as
// an atom, so the copy zero-fills the columns past it; those columns cost
// products (60 % more at D = 80, 14 % at D = 112) and are never written.
// Key tiles: 128 keys at D = 64, 112 at D = 128, 64 at D = 192, each with
// three stages or more.  A consumer thread holds O (D / 2 f32), the S of
// tile j (kBK / 2 f32) and the P of tile j - 1 (kBK / 4 words) at once:
// at D = 128 that was 160 registers with 128-key tiles, and the instance
// spilled at 240 a thread; 112 keys leave none (Q 32 KB and three stages
// of K and V, 168 KB).  At D = 192, O is 96 f32 and Q 48 KB; 64 keys a
// tile, three stages of 144 KB.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mask.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kConsumers = 2;                 // consumer warpgroups
constexpr int kWGRows = 64;                   // query rows a warpgroup
constexpr int kBQ = kConsumers * kWGRows;     // query rows a block
constexpr int kThreads = (kConsumers + 1) * 128;   // + the producer's
constexpr int kAtom = 64;                     // bf16 columns of an atom
constexpr int kAtomRow = 128;                 // its bytes a row
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kMaxSharedBytes = 232448;
// the K and V bytes a group of (batch, head) pairs may read while its
// blocks run together: well inside the 50 MB L2, so that each q tile of a
// head finds the head's K and V there
constexpr long long kL2Budget = 32ll << 20;

// Byte offsets into the block's dynamic shared memory (from a 1024-byte
// aligned base: the swizzle repeats every 8 rows of 128 bytes).  A tile of
// R rows is D / 64 atoms of R x 128 bytes, one after the other.
template <int D> struct Tiles {
  // keys a tile: the most that leaves no spill and three stages
  static constexpr int kBK = D == 64 ? 128 : D == 128 ? 112 : 64;
  static constexpr int kAtoms = D / kAtom;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBK * D * 2;      // one K (or V) stage
  // stages of the ring: as many as shared memory holds, at most 4
  static constexpr int kFit = (kMaxSharedBytes - kQBytes - 2048)
                              / (2 * kKVBytes);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBars = kV + kStages * kKVBytes;
  // q_full, then k_full, v_full and empty of each stage
  static constexpr int kBytes = kBars + (1 + 3 * kStages) * 8 + 1024;
  static_assert(D % kAtom == 0, "an instance is whole atoms");
  static_assert(kBytes <= kMaxSharedBytes, "shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// one box {64, 1, rows, 1} of a map (columns d0 .. d0 + 63 of rows
// s0 .. s0 + rows - 1 of head `head` of sequence b) -> shared memory,
// completion on `bar`; coordinates innermost first
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int d0, int head, int s0, int b,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(d0), "r"(head),
         "r"(s0), "r"(b), "r"(bar)
      : "memory");
}

// A wgmma operand in shared memory with the 128-byte swizzle: start
// address, leading and stride byte offsets (bits 0-13, 16-29, 32-45, each
// in 16-byte units), layout 1 = 128-byte swizzle (bits 62-63).  K-major
// (Q, K): rows 128 bytes apart, 8-row groups `sbo` = 1024 apart, `lbo`
// unused.  MN-major (V): 64-column atoms `lbo` apart, 8-key groups `sbo`
// apart.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4)
         | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

// named barrier `id` over `n` threads: wait, or arrive and go on
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most kPending committed groups of products are in flight
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending)
               : "memory");
}

// keeps the compiler from moving reads or writes of registers that an
// asynchronous product owns (its accumulator, its A fragments) across it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e]) :: "memory");
}

// d (m64 x N f32, N / 2 a thread) (+)= A B, bf16, k16.  wgmma_ss: A and B
// K-major in shared memory.  wgmma_rs: A in registers (the m16k16 fragment
// of each warp's 16 rows), B MN-major in shared memory.  scale_d 0
// overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d);
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d);

template <> __device__ __forceinline__ void wgmma_ss<64>(
    float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <> __device__ __forceinline__ void wgmma_ss<128>(
    float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <> __device__ __forceinline__ void wgmma_ss<112>(
    float (&d)[56], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, %56, %57, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <> __device__ __forceinline__ void wgmma_rs<64>(
    float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <> __device__ __forceinline__ void wgmma_rs<128>(
    float (&d)[64], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <> __device__ __forceinline__ void wgmma_rs<192>(
    float (&d)[96], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T of a warpgroup's 64 rows over one K stage, issued: D / 16 steps
// of k16, 32 bytes along an atom's rows, then the next atom
template <int D, int kBK>
__device__ __forceinline__ void issue_qk(float (&sc)[kBK / 2], uint32_t q_wg,
                                         uint32_t k_st) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<kBK>(
        sc,
        desc_sw128(q_wg + (kk / 4) * kBQ * kAtomRow + (kk % 4) * 32, 16,
                   1024),
        desc_sw128(k_st + (kk / 4) * kBK * kAtomRow + (kk % 4) * 32, 16,
                   1024),
        kk > 0);
}

// O += P V over one V stage, issued: kBK / 16 steps of 16 keys (2 KB of
// each atom); V's atoms are kBK rows of 128 bytes apart
template <int D, int kBK>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&pa)[kBK / 16][4],
                                         uint32_t v_st) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma_rs<D>(acc, pa[kk],
                desc_sw128(v_st + kk * 16 * kAtomRow, kBK * kAtomRow, 1024),
                1);
}

// The online softmax of one tile's scores, in place: sc becomes p, the
// row's max m (of raw scores: scale_log2 > 0 keeps their order) and sum l
// move on, and corr is what the accumulator of the tiles before must be
// multiplied by.  p = exp2(s scale_log2 - m scale_log2), one FFMA and one
// MUFU.  Element 4i + e of sc is row r0 + 8 (e >> 1), key
// k0 + 8 i + 2 tq + (e & 1); the mask applies only where the tile is not
// `full`.
template <int kBK>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[kBK / 2], float (&m)[2], float (&l)[2], float (&corr)[2],
    bool full, int r0, int k0, int tq, int Sq, int Sk, int causal,
    int window, int q_off, float scale_log2) {
  constexpr int kN = kBK / 4;               // a thread's elements of a row
  constexpr int kChains = 4;
  static_assert(kN % kChains == 0, "whole chains");
  if (!full) {
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!row_pair_valid(r0 + 8 * (e >> 1), k0 + 8 * i + 2 * tq + (e & 1),
                            Sq, Sk, causal, window, q_off))
          sc[4 * i + e] = kNegInf;
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    // element i of the thread's kN of the row: column group i / 2, the
    // pair's (i & 1); the max and the sum run as kChains independent
    // chains (a warp has little else to hide a chain's latency behind),
    // combined in a fixed order
    auto at = [&](int i) -> float& {
      return sc[4 * (i >> 1) + 2 * hf + (i & 1)];
    };
    float c[kChains];
#pragma unroll
    for (int u = 0; u < kChains; ++u) c[u] = at(u);
#pragma unroll
    for (int i = kChains; i < kN; ++i)
      c[i % kChains] = fmaxf(c[i % kChains], at(i));
#pragma unroll
    for (int w = 1; w < kChains; w *= 2)
#pragma unroll
      for (int u = 0; u + w < kChains; u += 2 * w)
        c[u] = fmaxf(c[u], c[u + w]);
    float mx = fmaxf(m[hf], c[0]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    corr[hf] = exp2_approx((m[hf] - mx) * scale_log2);
    m[hf] = mx;
    // every score of the row so far masked: p = exp2(-1e30 scale) = 0
    const float base = (mx == kNegInf ? 0.f : mx) * scale_log2;
#pragma unroll
    for (int u = 0; u < kChains; ++u) c[u] = 0.f;
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      at(i) = exp2_approx(fmaf(at(i), scale_log2, -base));
      c[i % kChains] += at(i);
    }
#pragma unroll
    for (int w = 1; w < kChains; w *= 2)
#pragma unroll
      for (int u = 0; u + w < kChains; u += 2 * w) c[u] += c[u + w];
    l[hf] = l[hf] * corr[hf] + c[0];
  }
}

// P in bf16: the m16k16 A fragments of k step kk are the n8 column groups
// 2 kk and 2 kk + 1 of S
template <int kBK>
__device__ __forceinline__ void pack_p(const float (&sc)[kBK / 2],
                                       uint32_t (&pa)[kBK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

// grid B H ceil(Sq / kBQ) (1-d, see `group`); block kThreads: consumer
// warpgroups 0 .. kConsumers - 1, the producer last.  D is the instance's
// head dim, head_dim <= D the tensors'.  q_map: q (B, Sq, H, head_dim),
// box {64, 1, kBQ, 1}; k_map, v_map: k, v (B, Sk, KVH, head_dim), box
// {64, 1, kBK, 1}.  o (B, Sq, H, head_dim) bf16 and lse (B, H, Sq) f32
// contiguous.  Consumer warpgroup w owns rows [64 w, 64 w + 64) of the q
// tile; in it warp x the 16 rows from 16 x, lane l rows l / 4 and l / 4 + 8
// of those (the m16n8 layout of each n8 column group).
template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_wgmma_fwd(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int B, int H, int Sq, int Sk, int G,
    int head_dim, int causal, int window, int q_off, int group,
    float scale_log2) {
  typedef Tiles<D> T;
  constexpr int kBK = T::kBK;
  constexpr int kStages = T::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u))
                                    & 1023u);
  const uint32_t s_q = smem_u32(smem + T::kQ);
  const uint32_t q_full = smem_u32(smem + T::kBars);

  // block order: the (batch, head) pairs in groups of `group`, and in a
  // group the q tiles latest (heaviest) first, each tile for every pair
  const int nq = (Sq + kBQ - 1) / kBQ;
  const int pairs = B * H;
  const int g0 = blockIdx.x / (group * nq) * group;      // the group's first
  const int size = min(group, pairs - g0);
  const int r = blockIdx.x - g0 * nq;
  const int t = r / size;
  const int pair = g0 + (r - t * size);
  const int b = pair / H, h = pair - b * H;
  const int q0 = (nq - 1 - t) * kBQ;
  const int kvh = h / G;
  int j_lo, j_hi;
  k_range(q_off + q0, kBQ, kBK, Sk, causal, window, j_lo, j_hi);
  // tile j of the block's [j_lo, j_hi): its stage, the parity of its use
  // of the stage, its K and V in shared memory and its barriers (k_full,
  // v_full, empty)
  auto stage = [&](int j) { return (j - j_lo) % kStages; };
  auto parity = [&](int j) {
    return (uint32_t)((j - j_lo) / kStages) & 1u;
  };
  auto k_tile = [&](int j) {
    return smem_u32(smem + T::kK + stage(j) * T::kKVBytes);
  };
  auto v_tile = [&](int j) {
    return smem_u32(smem + T::kV + stage(j) * T::kKVBytes);
  };
  auto bar = [&](int kind, int j) {
    return q_full + 8u * (uint32_t)(1 + kind * kStages + stage(j));
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar(0, j_lo + s), 1);         // the producer's expect-tx
      mbar_init(bar(1, j_lo + s), 1);
      mbar_init(bar(2, j_lo + s), kConsumers * 4);   // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (threadIdx.x == kConsumers * 128) {
      mbar_arrive_expect_tx(q_full, T::kQBytes);   // the whole box counts
      for (int a = 0; a < T::kAtoms; ++a)
        tma_load(s_q + a * kBQ * kAtomRow, &q_map, a * kAtom, h, q0, b,
                 q_full);
      for (int j = j_lo; j < j_hi; ++j) {
        mbar_wait(bar(2, j), parity(j) ^ 1u);   // the stage's last use done
        mbar_arrive_expect_tx(bar(0, j), T::kKVBytes);
        for (int a = 0; a < T::kAtoms; ++a)
          tma_load(k_tile(j) + a * kBK * kAtomRow, &k_map, a * kAtom, kvh,
                   j * kBK, b, bar(0, j));
        mbar_arrive_expect_tx(bar(1, j), T::kKVBytes);
        for (int a = 0; a < T::kAtoms; ++a)
          tma_load(v_tile(j) + a * kBK * kAtomRow, &v_map, a * kAtom, kvh,
                   j * kBK, b, bar(1, j));
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kConsumerRegs));
    const int lane = threadIdx.x & 31;
    const int tq = lane & 3;
    const int q0w = q0 + wg * kWGRows;                 // the warpgroup's
    const int r0 = q0w + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    const uint32_t q_wg = s_q + wg * kWGRows * kAtomRow;
    // both warpgroups compute on every tile of the block's (a row that
    // sees no key of a tile takes p = 0 there), and take turns to issue
    // their products: one's softmax runs while the other's products do
    // (FlashAttention-3's ping-pong), on named barriers 1 and 2
    auto my_turn = [&]() { named_sync(1 + wg, 2 * 128); };
    auto your_turn = [&]() { named_arrive(2 - wg, 2 * 128); };
    auto release = [&](int j) {
      if (lane == 0) mbar_arrive(bar(2, j));
    };
    if (wg == 1) your_turn();
    auto softmax = [&](float (&sc)[kBK / 2], float (&m)[2], float (&l)[2],
                       float (&corr)[2], int j) {
      softmax_tile<kBK>(sc, m, l, corr,
                        tile_full(q0w, kWGRows, j * kBK, kBK, Sq, Sk, causal,
                                  window, q_off),
                        r0, j * kBK, tq, Sq, Sk, causal, window, q_off,
                        scale_log2);
    };

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    mbar_wait(q_full, 0u);
    if (j_lo < j_hi) {
      // tile j's QK^T is issued before tile j - 1's PV, and its softmax
      // runs while that PV is in flight (FlashAttention-3's overlap within
      // a warpgroup): S of tile j and P of tile j - 1 are live together
      float sc[kBK / 2], corr[2];
      uint32_t pa[kBK / 16][4];
      mbar_wait(bar(0, j_lo), parity(j_lo));
      fence_regs(sc);
      my_turn();
      wgmma_fence();
      issue_qk<D, kBK>(sc, q_wg, k_tile(j_lo));
      wgmma_commit();
      your_turn();
      wgmma_wait<0>();
      fence_regs(sc);
      softmax(sc, m, l, corr, j_lo);            // acc is 0: nothing to scale
      pack_p<kBK>(sc, pa);
      for (int j = j_lo + 1; j < j_hi; ++j) {
        mbar_wait(bar(0, j), parity(j));
        fence_regs(sc);
        fence_regs(pa);
        fence_regs(acc);
        my_turn();
        wgmma_fence();
        issue_qk<D, kBK>(sc, q_wg, k_tile(j));
        wgmma_commit();
        mbar_wait(bar(1, j - 1), parity(j - 1));
        issue_pv<D, kBK>(acc, pa, v_tile(j - 1));
        wgmma_commit();
        your_turn();
        wgmma_wait<1>();                         // S of tile j is in
        fence_regs(sc);
        softmax(sc, m, l, corr, j);
        wgmma_wait<0>();                         // P V of tile j - 1 is in
        fence_regs(acc);
        fence_regs(pa);
        release(j - 1);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
        pack_p<kBK>(sc, pa);
      }
      mbar_wait(bar(1, j_hi - 1), parity(j_hi - 1));
      fence_regs(pa);
      fence_regs(acc);
      my_turn();
      wgmma_fence();
      issue_pv<D, kBK>(acc, pa, v_tile(j_hi - 1));
      wgmma_commit();
      your_turn();
      wgmma_wait<0>();
      fence_regs(acc);
      release(j_hi - 1);
    }

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float lr = l[hf];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int qp = r0 + 8 * hf;
      if (qp >= Sq) continue;
      const float inv = 1.f / fmaxf(lr, 1e-30f);
      __nv_bfloat16* orow =
          o + (((long long)b * Sq + qp) * H + h) * head_dim + 2 * tq;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        if (8 * i < head_dim)
          *reinterpret_cast<uint32_t*>(orow + 8 * i) = pack_bf16(
              acc[4 * i + 2 * hf] * inv, acc[4 * i + 2 * hf + 1] * inv);
      if (tq == 0)
        lse[((long long)b * H + h) * Sq + qp] =
            (m[hf] * scale_log2 + log2f(lr)) * kLn2;
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found once through the runtime's
// entry-point query (no link against libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess
        && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 tensor (B, S, heads, head_dim) with element strides (sb, ss, sh, 1)
// as a 4-d map (innermost first) whose box is one 64-column atom of `rows`
// rows of one head, 128-byte swizzled; the rows past S and the columns past
// head_dim are out of bounds, and the copy writes zeros there.  A dim of
// one never steps its stride: it gets a valid one.  flash_attention.py's
// `tensor_map` states the same rule.
bool tile_map(CUtensorMap* map, const void* t, int B, int S, int heads,
              int head_dim, int rows, long long sb, long long ss,
              long long sh) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  if (heads == 1) sh = head_dim;
  if (B == 1) sb = (long long)S * ss;
  const cuuint64_t dims[4] = {(cuuint64_t)head_dim, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kAtom, 1u, (cuuint32_t)rows, 1u};
  const cuuint32_t elem[4] = {1u, 1u, 1u, 1u};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(t),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int B, Sq, Sk, H, KVH, head_dim;
  long long sq_b, sq_s, sq_h, sk_b, sk_s, sk_h;
  int causal, window, q_off;
  cudaStream_t stream;
};

template <int D>
cudaError_t fwd_launch(const FwdArgs& a) {
  typedef Tiles<D> T;
  static unsigned int configured = 0u;        // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32 || !((configured >> dev) & 1u)) {
    err = cudaFuncSetAttribute(flash_wgmma_fwd<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::kBytes);
    if (err != cudaSuccess) return err;
    if (dev < 32) configured |= 1u << dev;
  }
  CUtensorMap q_map = {}, k_map = {}, v_map = {};
  if (!tile_map(&q_map, a.q, a.B, a.Sq, a.H, a.head_dim, kBQ, a.sq_b,
                a.sq_s, a.sq_h)
      || !tile_map(&k_map, a.k, a.B, a.Sk, a.KVH, a.head_dim, T::kBK, a.sk_b,
                   a.sk_s, a.sk_h)
      || !tile_map(&v_map, a.v, a.B, a.Sk, a.KVH, a.head_dim, T::kBK, a.sk_b,
                   a.sk_s, a.sk_h))
    return cudaErrorInvalidValue;
  const long long nq = (a.Sq + kBQ - 1) / kBQ;
  const long long blocks = nq * a.H * a.B;
  if (blocks > 0x7fffffffll) return cudaErrorInvalidValue;
  // pairs a group: as many whole KV heads' K and V as kL2Budget holds
  const int G = a.H / a.KVH;
  const long long kv = (long long)a.Sk * a.head_dim * 4;    // one KV head's
  const long long fit = kL2Budget / (kv > 0 ? kv : 1) * G;
  const int group = (int)(fit < 1 ? 1 : fit < (long long)a.B * a.H
                          ? fit : (long long)a.B * a.H);
  flash_wgmma_fwd<D><<<(unsigned)blocks, kThreads, T::kBytes, a.stream>>>(
      q_map, k_map, v_map, (__nv_bfloat16*)a.o, a.lse, a.B, a.H, a.Sq,
      a.Sk, G, a.head_dim, a.causal, a.window, a.q_off, group,
      kLog2e / sqrtf((float)a.head_dim));
  return cudaGetLastError();
}

}  // namespace

// bf16 only.  q (B, Sq, H, D) and k, v (B, Sk, KVH, D) are read through
// their element strides (batch, seq, head; unit stride over D; 16-byte
// aligned base, strides multiples of 8 elements; k and v share strides); q
// row i is at absolute position q_off + i (with a causal mask or a window,
// q_off + Sq <= Sk); o (B, Sq, H, D) and lse (B, H, Sq, f32) are
// contiguous.  Returns the cudaError_t of the launch (0 on success);
// nothing is synchronised.
extern "C" int repro_flash_attention_tc_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int B, int Sq, int Sk, int H, int KVH, int D,
    long long sq_b, long long sq_s, long long sq_h,
    long long sk_b, long long sk_s, long long sk_h,
    int causal, int window, int q_off, void* stream) {
  if (B <= 0 || B > 65535 || Sq <= 0 || Sk <= 0 || H <= 0 || KVH <= 0
      || H > 65535 || H % KVH != 0 || q_off < 0
      || (!(!causal && window <= 0) && (long long)q_off + Sq > Sk))
    return (int)cudaErrorInvalidValue;
  const FwdArgs args = {q, k, v, o, (float*)lse, B, Sq, Sk, H, KVH, D,
                        sq_b, sq_s, sq_h, sk_b, sk_s, sk_h, causal, window,
                        q_off, (cudaStream_t)stream};
  // the instance of a head dim (flash_attention.py's `fwd_instance`)
  switch (D) {
    case 16:
    case 32:
    case 48:
    case 64: return (int)fwd_launch<64>(args);
    case 80:
    case 96:
    case 112:
    case 128: return (int)fwd_launch<128>(args);
    case 192: return (int)fwd_launch<192>(args);
    default: return (int)cudaErrorInvalidValue;
  }
}

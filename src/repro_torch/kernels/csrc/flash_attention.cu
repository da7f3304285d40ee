// Flash attention's float32 route on the tensor cores of NVIDIA Hopper
// (sm_90a), forward and backward: error-compensated TF32 ("3xTF32",
// hopper.cuh) on wgmma, tiles that the Tensor Memory Accelerator copies
// into a ring in shared memory, one producer warp and one consumer
// warpgroup.  The route of every float32 tensor of more than
// DECODE_MAX_ROWS query rows (flash_attention.py's `forward_entry`;
// flash_decode.cu takes the few-row forwards, whose lse feeds the backward
// here alike); bf16 tensors take flash_attention_wgmma*.cu.
//
// Replaces the TPU kernel `flash_attention_kernel` / `_kernel` of
// src/repro/kernels/flash_attention/flash_attention.py:79: q (B, Sq, H, D)
// attends to k, v (B, Sk, KVH, D), query head h reading KV head h / G, key
// tiles wholly above the causal diagonal or outside the window skipped
// (`k_range` of flash_mask.cuh), the mask applied element by element only
// on the tiles that straddle the diagonal, the window edge or the end of
// either sequence.  Sq may differ from Sk: without a mask
// (cross-attention), or as one rank's rows of a sequence split, q row i at
// absolute position q_off + i with q_off + Sq <= Sk (shapes_ok refuses the
// rest).  Same arithmetic as the TPU kernel: f32 running max, sum and
// accumulator, masked scores -1e30 (finite), the result divided by
// max(l, 1e-30); it also writes the per-row logsumexp lse (B, H, Sq).  The
// reference has no backward kernel (XLA differentiates its chunked scan);
// here three kernels compute the gradients from lse:
//   flash_f32_bwd_dq    one block per (b, h, 64-row q tile): first
//                       delta = rowsum(dO * O) of its rows (written out
//                       for the next kernel), then dQ over the key tiles
//                       it sees;
//   flash_f32_bwd_dkdv  one block per (b, h, 64-key k tile): one query
//                       head's terms of dK, dV over the q tiles that see
//                       the k tile (at D = 192 as two passes, dV then
//                       dK);
//   flash_bwd_dkdv_sum_kernel  (G > 1) dK, dV = the G heads' terms, summed
//                       in head order from f32 scratch (B, Sk, H, D).
// No atomics: every sum has one order, and the gradients repeat bit for
// bit.
//
// What bounds it on this card: operations.  At the training shape (B=1,
// S=4096, H=40, KVH=8, D=128, causal) the forward does 1.72e11 FLOP and
// the backward 4.30e11 (S, dP, dV, dK, dQ) against ~0.2 GB of inputs and
// outputs.  On the CUDA cores the ceiling is 67 TFLOP/s (2.56 and 6.41
// ms); the tensor cores give 495 TFLOP/s in TF32, but one TF32 product
// keeps 11 bits of each operand, three decimal digits, too few for the f32
// checks (2e-5 forward, 1e-4 gradients).  Three TF32 products of split
// operands (big and small, hopper.cuh's split_tf32) keep about 22 bits,
// as accurate as f32 products for these sums, at an effective 165 TFLOP/s
// (1.04 and 2.60 ms).
//
// What the design does about it:
//  * every product is wgmma.mma_async.m64nNk8.f32.tf32.tf32, three a k
//    step (mma3_k8, mma3_k8_ss), B from shared memory, A from shared
//    memory or registers;
//  * TF32 wgmma reads both operands K-major only.  An A operand that a
//    block keeps (Q in S = Q K^T; dO in dP = dO V^T) is split once into
//    shared memory (split_tile: big in place, small beside) where its small
//    part fits, and both products read it there (ss); else (D = 192; K, V
//    in S^T = K Q^T and dP^T = V dO^T) it is loaded into registers by
//    ldmatrix and split one k step ahead of its products, in three
//    register sets, two steps' products in flight (mma3_tile; mma3_tile2
//    issues S^T's and dP^T's steps as one group, two sums in flight).  A
//    operands formed in registers (P, dS, P^T, dS^T) are split there
//    (frag_from_acc).  B operands read as
//    copied (K in S, V in dP, Q and dO in S^T and dP^T) are split once a
//    tile (big in place or beside, small beside); B operands whose
//    reduction runs down the copied rows (V in O += P V, K in dQ += dS K,
//    dO in dV += P^T dO, Q in dK += dS^T Q) are written transposed by the
//    consumers (transpose_tile), in the same pass that splits them or from
//    the split tiles.  An accumulator's thread holds columns 2t and 2t + 1
//    of each 8-column group where the TF32 A fragment takes t and t + 4, so
//    the transposed tile stores each group's rows in the order
//    0 2 4 6 1 3 5 7 and the accumulator goes in as it is;
//  * shared memory, not registers, is what binds: f32 is twice bf16's bytes
//    and the small parts double them again.  So a block is one consumer
//    warpgroup of 64 rows (wgmma's m64) and a producer warp (160 threads,
//    one block an SM, up to 255 registers a thread without setmaxnreg), and
//    the tiles and stages of each instance are what fits (below);
//  * the producer's one thread issues cp.async.bulk.tensor copies over 4-d
//    tensor maps of q, k, v, o and dout by their strides (the model layout
//    and the reference signature's views read as they lie), each box one
//    32-column atom of one head's rows with the 128-byte swizzle that the
//    wgmma descriptors name; lse and delta over 1-d maps from the 16-byte
//    aligned element at or before a tile's first (an unaligned 1-d copy is
//    an illegal instruction).  What a block keeps (forward, dQ: Q, dO; dK/dV:
//    K, V) is copied once, what it streams goes through a ring of stages
//    under full (expect-tx) and empty mbarriers; rows past Sq or Sk and
//    columns past the head dim are zero-filled by the copy;
//  * the online softmax as the bf16 forward's: the running max of raw
//    scores, p = exp2(s c - m c) with c = log2(e) / sqrt(D);
//  * the dK/dV blocks take one query head each and, for G > 1, write its
//    terms to scratch that flash_bwd_dkdv_sum_kernel adds in head order:
//    at StarCoder2-3B's 24 / 2 heads and S = 1,536 a block per KV head
//    would leave 48 blocks for 132 SMs.
//
// Head dims: instances at D = 64, 128 and 192 (flash_attention.py's
// `f32_instance`: 16, 32 and 48 run the 64 instance, 80, 96 and 112 the
// 128 one); the maps carry the true head dim, the copy zero-fills the
// columns past it, and those columns are never written.  Tiles
// (REPRO_F32_TILES; flash_attention.py's F32_TILES and `f32_smem_bytes`
// mirror them), shared memory at most 232,448 bytes a block:
//   forward  Q (split once at D = 64: big in place, small beside), K big
//            and small, V^T big and small, and a ring of K, V tiles as
//            copied, freed as soon as they are split: 64 keys a tile at
//            D = 64 (4 stages) and 128 (1), 32 at 192 (1).  At D = 128, 32
//            keys would leave room for Q small and three stages, and took
//            3.46 against 3.34 ms at the training shape on an H100 at 700 W
//            (tools/flash_tc_sweep.py's f32_fwd_32_keys);
//   dQ       Q, dO, split once (big in place, small beside) where that
//            leaves two stages, else split a k step at a time as they are
//            read (D = 192), K small, V small (O there until delta is
//            formed), a ring of K, V tiles split in place; once dP is in,
//            the stage's V tile and V small take K^T big and small: 64 keys
//            at D = 64 (4 stages), 32 at 128 (2) and 192 (1);
//   dK/dV    K, V (as copied), a ring of Q, dO tiles (split in place) with
//            their lse and delta, and Q small, dO small, dO^T and Q^T big
//            and small beside; the next q tile is split while dV's and dK's
//            products run: 64 query rows at D = 64 (2 stages), 32 at 128
//            (2); at 192 a dV pass (Q small, dO^T, 1 stage) and a dK pass
//            (Q small, dO small, Q^T where dO and dO small were, 1 stage),
//            since dK and dV together would be 192 f32 a thread.

#include <math.h>

#include "flash_mask.cuh"
#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kRows = 64;                 // rows a block owns: wgmma's m64
constexpr int kConsumerThreads = 128;     // one consumer warpgroup
constexpr int kThreads = kConsumerThreads + 32;   // + the producer warp
constexpr int kMaxStages = 4;
constexpr int kReserve = 1024 + 128;      // the base's alignment, barriers

// instance head dim, forward keys a tile, dQ keys a tile, dK/dV query rows
// a tile (see the header)
#define REPRO_F32_TILES(X) X(64, 64, 64, 64) X(128, 64, 32, 32) \
  X(192, 32, 32, 32)

template <int D> struct F32Tiles;
#define REPRO_TILES(DD, FK, QK, KR)                                      \
  template <> struct F32Tiles<DD> {                                      \
    static constexpr int kFwdKeys = FK, kDqKeys = QK, kDkdvRows = KR;    \
  };
REPRO_F32_TILES(REPRO_TILES)
#undef REPRO_TILES

// what a dK/dV launch computes: both (D <= 128), or one of the two passes
enum { kBothPass = 0, kDvPass = 1, kDkPass = 2 };

template <int D> struct FwdTiles {
  static constexpr int kBK = F32Tiles<D>::kFwdKeys;
  static constexpr int kQBytes = kRows * D * 4;
  static constexpr int kKVBytes = kBK * D * 4;      // one K or V tile
  // Q split once (big in place, small beside) where that leaves a stage;
  // else (D = 192) each k step of it is split as it is read
  static constexpr bool kPreSplit =
      (kMaxSharedBytes - 2 * kQBytes - 4 * kKVBytes - kReserve)
      / (2 * kKVBytes) >= 1;
  static constexpr int kQ = 0;
  static constexpr int kQs = kQ + kQBytes;
  static constexpr int kKb = kQs + (kPreSplit ? kQBytes : 0);
  static constexpr int kKs = kKb + kKVBytes;
  static constexpr int kVtb = kKs + kKVBytes;
  static constexpr int kVts = kVtb + kKVBytes;
  static constexpr int kRing = kVts + kKVBytes;     // stage s: K, V
  static constexpr int kFit = (kMaxSharedBytes - kRing - kReserve)
                              / (2 * kKVBytes);
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kBars = kRing + kStages * 2 * kKVBytes;
  // q_full, then full and empty of each stage
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8 + 1024;
  static_assert(D % kAtomF32 == 0 && kBK % kAtomF32 == 0, "whole atoms");
  static_assert(kStages >= 1 && kBytes <= kMaxSharedBytes, "shared memory");
};

template <int D> struct DqTiles {
  static constexpr int kBK = F32Tiles<D>::kDqKeys;
  static constexpr int kQBytes = kRows * D * 4;     // Q, dO or O
  static constexpr int kKVBytes = kBK * D * 4;
  // Q and dO split once (big in place, small beside) where that leaves two
  // stages; else (D = 192) each k step of them is split as it is read
  static constexpr bool kPreSplit =
      (kMaxSharedBytes - 4 * kQBytes - 2 * kKVBytes - kReserve)
      / (2 * kKVBytes) >= 2;
  static constexpr int kSplitBytes = kPreSplit ? kQBytes : 0;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kQBytes;
  static constexpr int kQs = kDO + kQBytes;
  static constexpr int kDOs = kQs + kSplitBytes;
  static constexpr int kKs = kDOs + kSplitBytes;    // O until delta is in
  static constexpr int kVs = kKs + kKVBytes;
  static constexpr int kRing = kVs + kKVBytes;      // stage s: K, V
  static constexpr int kFit = (kMaxSharedBytes - kRing - kReserve)
                              / (2 * kKVBytes);
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kBars = kRing + kStages * 2 * kKVBytes;
  // q_full, then full and empty of each stage
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8 + 1024;
  static_assert(D % kAtomF32 == 0 && kBK % kAtomF32 == 0, "whole atoms");
  static_assert(kQBytes <= 2 * kKVBytes, "O fits K small and V small");
  static_assert(kStages >= 1 && kBytes <= kMaxSharedBytes, "shared memory");
};

template <int D, int kPass> struct KvTiles {
  static constexpr bool kDv = kPass != kDkPass, kDk = kPass != kDvPass;
  static constexpr int kBQ = F32Tiles<D>::kDkdvRows;
  // lse and delta of a q tile: kBQ + 4 elements from the aligned element
  // at or before the tile's first
  static constexpr int kStatBox = kBQ + 4;
  static constexpr int kStatBytes = (kStatBox * 4 + 127) / 128 * 128;
  static constexpr int kKBytes = kRows * D * 4;     // K or V
  static constexpr int kQBytes = kBQ * D * 4;       // one Q, dO tile
  // beside the ring: Q small, then dO small (dK), dO^T big and small (dV)
  // and, for both, Q^T big and small
  static constexpr int kTiles = 1 + (kDk ? 1 : 0) + (kDv ? 2 : 0)
                                + (kDk && kDv ? 2 : 0);
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKBytes;
  static constexpr int kQs = kV + kKBytes;
  static constexpr int kDOs = kQs + kQBytes;                  // dK
  static constexpr int kDOt = kQs + (kDk ? 2 : 1) * kQBytes;  // dV: big
  static constexpr int kQt = kDOt + 2 * kQBytes;              // both: big
  static constexpr int kRing = kQs + kTiles * kQBytes;        // Q, dO
  static constexpr int kStage = 2 * kQBytes + 2 * kStatBytes;
  static constexpr int kFit = (kMaxSharedBytes - kRing - kReserve) / kStage;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kLse = kRing + kStages * 2 * kQBytes;
  static constexpr int kDelta = kLse + kStages * kStatBytes;
  static constexpr int kBars = kDelta + kStages * kStatBytes;
  // kv_full, then full and empty of each stage
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8 + 1024;
  static_assert(D % kAtomF32 == 0 && kBQ % kAtomF32 == 0, "whole atoms");
  static_assert(kStages >= 1 && kBytes <= kMaxSharedBytes, "shared memory");
};

// the block's dynamic shared memory from a 1024-byte aligned base (the
// swizzle repeats every 8 rows of 128 bytes)
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
}

// the consumer warpgroup's own barrier (the producer warp never joins it)
__device__ __forceinline__ void consumers_sync() {
  named_sync(1, kConsumerThreads);
}

// every element of a tile of kBytes at `src`: big to `big` (`src` itself
// or another tile of the same layout), small to `small`.  A thread's
// kLoads 16-byte reads are all issued before its writes (a write to `big`
// may be a read's address, so the compiler would not move them ahead).
template <int kBytes, int kLoads = kBytes / (16 * kConsumerThreads)>
__device__ __forceinline__ void split_tile(const unsigned char* src,
                                           unsigned char* big,
                                           unsigned char* small, int tid) {
  constexpr int kPer = kBytes / (16 * kConsumerThreads);
  static_assert(kPer * 16 * kConsumerThreads == kBytes && kPer % kLoads == 0,
                "whole rounds");
#pragma unroll
  for (int r0 = 0; r0 < kPer; r0 += kLoads) {
    float4 x[kLoads];
#pragma unroll
    for (int r = 0; r < kLoads; ++r)
      x[r] = *reinterpret_cast<const float4*>(
          src + 16 * (tid + (r0 + r) * kConsumerThreads));
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      const int o = 16 * (tid + (r0 + r) * kConsumerThreads);
      uint4 b, s;
      split_tf32(x[r].x, b.x, s.x);
      split_tf32(x[r].y, b.y, s.y);
      split_tf32(x[r].z, b.z, s.z);
      split_tf32(x[r].w, b.w, s.w);
      *reinterpret_cast<uint4*>(big + o) = b;
      *reinterpret_cast<uint4*>(small + o) = s;
    }
  }
}

// A K-major tile of R rows (keys or query rows) x D columns at `src` as
// the K-major tile of D rows x R columns that a product summing over those
// rows takes as B: row r becomes column 8 (r / 8) + (r % 8) / 2 + 4 (r % 2)
// (frag_from_acc's order).  kSplit: big to dst_b, small to dst_s; else the
// elements as they are to dst_b.  A thread writes 16 bytes of a row of the
// result at a time (four columns, from rows r0, r0 + 2, r0 + 4, r0 + 6 of
// src): column n of src, chunks of one parity, so that every offset but
// the chunk's is fixed for the thread; a warp's 32 threads take 32
// consecutive columns, so neither its reads nor its writes meet in a bank.
template <int R, int D, bool kSplit>
__device__ __forceinline__ void transpose_tile(const unsigned char* src,
                                               unsigned char* dst_b,
                                               unsigned char* dst_s,
                                               int tid) {
  static_assert(D % 64 == 0 && R % 32 == 0 && kConsumerThreads == 128,
                "64 columns a pass, chunks of both parities");
  const int par = tid >> 6;               // the parity of its chunks
#pragma unroll
  for (int blk = 0; blk < D / 64; ++blk) {
    const int n = blk * 64 + (tid & 63);
    const unsigned char* col = src + (n >> 5) * R * kAtomRow
                               + ((n & 3) << 2) + par * kAtomRow;
    int sw[4];                            // rows par + 2i of each 8-group
#pragma unroll
    for (int i = 0; i < 4; ++i)
      sw[i] = 2 * i * kAtomRow + (((((n & 31) >> 2) ^ (par + 2 * i))) << 4);
    float x[R / 8][4];                    // every read before the writes
#pragma unroll
    for (int k = 0; k < R / 8; ++k)       // chunk c = par + 2k
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x[k][i] = *reinterpret_cast<const float*>(col + 8 * k * kAtomRow
                                                  + sw[i]);
#pragma unroll
    for (int k = 0; k < R / 8; ++k) {
      const int off = (k >> 2) * D * kAtomRow + n * kAtomRow
                      + (((2 * (k & 3) + par) ^ (n & 7)) << 4);
      if constexpr (kSplit) {
        uint4 b, s;
        split_tf32(x[k][0], b.x, s.x);
        split_tf32(x[k][1], b.y, s.y);
        split_tf32(x[k][2], b.z, s.z);
        split_tf32(x[k][3], b.w, s.w);
        *reinterpret_cast<uint4*>(dst_b + off) = b;
        *reinterpret_cast<uint4*>(dst_s + off) = s;
      } else {
        *reinterpret_cast<float4*>(dst_b + off) =
            make_float4(x[k][0], x[k][1], x[k][2], x[k][3]);
      }
    }
  }
}

// the TF32 A fragment of k step kk (columns 8 kk .. 8 kk + 7) of the
// warpgroup's 64 rows of a K-major tile of kR rows at `tile`, split: warp
// w rows 16 w .. 16 w + 15, lane (g, t) rows g and g + 8 of those, columns
// t and t + 4 (hopper.cuh's wgmma_tf32).  One ldmatrix.x4 reads the four
// 8 x 4 f32 blocks (8 x 8 in its b16 terms) as the fragment: lane l gives
// the address of row l % 8 (+ 8 for odd l / 8) of chunk 2 (kk % 4)
// (+ 1 for l / 16), and thread (g, t) gets word t of row g of each, the
// fragment's order.  Rows g and g + 8 share the swizzle (r % 8 = g).
__device__ __forceinline__ void ldsm_x4(const unsigned char* p,
                                        uint32_t (&x)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3]) : "r"(smem_u32(p))
      : "memory");
}

template <int kR>
__device__ __forceinline__ void frag_from_tile(const unsigned char* tile,
                                               int kk, int warp, int lane,
                                               uint32_t (&big)[4],
                                               uint32_t (&small)[4]) {
  const int i = lane & 7, m = lane >> 3;
  const int row = 16 * warp + i + 8 * (m & 1);
  const int chunk = (2 * (kk & 3) + (m >> 1)) ^ i;
  uint32_t x[4];
  ldsm_x4(tile + (kk >> 2) * kR * kAtomRow + row * kAtomRow + (chunk << 4),
          x);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    split_tf32(__uint_as_float(x[e]), big[e], small[e]);
}

// k step kk of an accumulator (m64 x N f32: element 4 i + e is row
// g + 8 (e >> 1), column 8 i + 2 t + (e & 1)) as the A operand of the next
// product, split: the fragment's columns t and t + 4 are the accumulator's
// 2t and 2t + 1, which transpose_tile's B tiles expect
template <int N>
__device__ __forceinline__ void frag_from_acc(const float (&c)[N / 2], int kk,
                                              uint32_t (&big)[4],
                                              uint32_t (&small)[4]) {
  split_tf32(c[4 * kk], big[0], small[0]);
  split_tf32(c[4 * kk + 2], big[1], small[1]);
  split_tf32(c[4 * kk + 1], big[2], small[2]);
  split_tf32(c[4 * kk + 3], big[3], small[3]);
}

// one register set of an A fragment, as fence_regs (hopper.cuh): touched
// only while no product in flight reads it
__device__ __forceinline__ void fence_frag(uint32_t (&r)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[e]) :: "memory");
}

// register sets of a JIT-split A operand: the products of kSets - 1 k
// steps stay in flight while the next step's fragment is read and split
constexpr int kSets = 3;

// d (m64 x N) (+)= A B in 3xTF32 over kSteps k steps, issued and
// committed one k step a group: A the warpgroup's 64 rows of the K-major
// f32 tile of kAR rows at `a`, split one step ahead into the register sets
// fb / fs (the caller's, so that it can hold them past its wait); B big and
// small K-major tiles of N rows.  A set is rewritten only after the group
// that read it is in: wait<kSets - 1> leaves the last kSets - 1 steps in
// flight, none of which reads the set of the step after.  scale_d 0
// overwrites d.  The last kSets - 1 steps stay in flight.
template <int N, int kSteps, int kAR>
__device__ __forceinline__ void mma3_tile(float (&d)[N / 2],
                                          const unsigned char* a,
                                          uint32_t b_big, uint32_t b_small,
                                          uint32_t (&fb)[kSets][4],
                                          uint32_t (&fs)[kSets][4], int warp,
                                          int lane, int scale_d) {
  wgmma_wait<0>();                         // every set is free
  fence_regs(fb);
  fence_regs(fs);
  frag_from_tile<kAR>(a, 0, warp, lane, fb[0], fs[0]);
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const int u = kk % kSets, v = (kk + 1) % kSets;
    fence_frag(fb[u]);
    fence_frag(fs[u]);
    wgmma_fence();
    mma3_k8<N>(d, fb[u], fs[u], b_big, b_small, kk, kk > 0 ? 1 : scale_d);
    wgmma_commit();
    if (kk + 1 < kSteps) {
      wgmma_wait<kSets - 1>();             // step kk + 1 - kSets is in
      fence_frag(fb[v]);
      fence_frag(fs[v]);
      frag_from_tile<kAR>(a, kk + 1, warp, lane, fb[v], fs[v]);
    }
  }
}

// d1 (+)= A1 B1 and d2 (+)= A2 B2 as two mma3_tile calls over the same
// k steps, step kk of both issued as one group: two independent sums in
// flight, six products a group (A1's sets fb / fs, A2's gb / gs)
template <int N, int kSteps, int kAR>
__device__ __forceinline__ void mma3_tile2(
    float (&d1)[N / 2], const unsigned char* a1, uint32_t b1_big,
    uint32_t b1_small, float (&d2)[N / 2], const unsigned char* a2,
    uint32_t b2_big, uint32_t b2_small, uint32_t (&fb)[kSets][4],
    uint32_t (&fs)[kSets][4], uint32_t (&gb)[kSets][4],
    uint32_t (&gs)[kSets][4], int warp, int lane) {
  wgmma_wait<0>();                         // every set is free
  fence_regs(fb);
  fence_regs(fs);
  fence_regs(gb);
  fence_regs(gs);
  frag_from_tile<kAR>(a1, 0, warp, lane, fb[0], fs[0]);
  frag_from_tile<kAR>(a2, 0, warp, lane, gb[0], gs[0]);
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const int u = kk % kSets, v = (kk + 1) % kSets;
    fence_frag(fb[u]);
    fence_frag(fs[u]);
    fence_frag(gb[u]);
    fence_frag(gs[u]);
    wgmma_fence();
    mma3_k8<N>(d1, fb[u], fs[u], b1_big, b1_small, kk, kk > 0);
    mma3_k8<N>(d2, gb[u], gs[u], b2_big, b2_small, kk, kk > 0);
    wgmma_commit();
    if (kk + 1 < kSteps) {
      wgmma_wait<kSets - 1>();             // step kk + 1 - kSets is in
      fence_frag(fb[v]);
      fence_frag(fs[v]);
      fence_frag(gb[v]);
      fence_frag(gs[v]);
      frag_from_tile<kAR>(a1, kk + 1, warp, lane, fb[v], fs[v]);
      frag_from_tile<kAR>(a2, kk + 1, warp, lane, gb[v], gs[v]);
    }
  }
}

// d (m64 x N) += A B in 3xTF32, A split in registers (kSteps fragments),
// B big and small K-major tiles of N rows; issued and committed as one
// group
template <int N, int kSteps>
__device__ __forceinline__ void mma3_regs(float (&d)[N / 2],
                                          uint32_t (&ab)[kSteps][4],
                                          uint32_t (&as)[kSteps][4],
                                          uint32_t b_big, uint32_t b_small) {
  fence_regs(ab);
  fence_regs(as);
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
    mma3_k8<N>(d, ab[kk], as[kk], b_big, b_small, kk, 1);
  wgmma_commit();
}

// The online softmax of one tile's scores, in place, as the bf16 forward's
// (flash_attention_wgmma.cu): sc becomes p, the row's max m (of raw
// scores) and sum l move on, corr is what the accumulator of the tiles
// before must be multiplied by.  Element 4i + e of sc is row r0 + 8 (e >> 1),
// key k0 + 8 i + 2 tq + (e & 1); the mask applies only where the tile is
// not `full`.
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

// ------------------------------------------------------------------ forward
// grid B H ceil(Sq / 64) (1-d: the q tiles latest, the heaviest, first,
// each for every (batch, head) pair); block kThreads: the consumer
// warpgroup, then the producer warp.  D is the instance's head dim,
// head_dim <= D the tensors'.  q_map: q (B, Sq, H, head_dim), box {32, 1,
// 64, 1}; k_map, v_map: k, v (B, Sk, KVH, head_dim), box {32, 1, kBK, 1}.
// o (B, Sq, H, head_dim) and lse (B, H, Sq) f32 contiguous.  Warp w owns
// rows 16 w .. 16 w + 15 of the q tile, lane l rows l / 4 and l / 4 + 8 of
// those (the m16n8 layout of each n8 column group).
template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_f32_fwd(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, float* __restrict__ o,
    float* __restrict__ lse, int B, int H, int Sq, int Sk, int G,
    int head_dim, int causal, int window, int q_off, float scale_log2) {
  typedef FwdTiles<D> T;
  constexpr int kBK = T::kBK;
  constexpr int kStages = T::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t q_full = base + T::kBars;

  const int pairs = B * H;
  const int nq = (Sq + kRows - 1) / kRows;
  const int t = blockIdx.x / pairs;
  const int pair = blockIdx.x - t * pairs;
  const int b = pair / H, h = pair - b * H;
  const int q0 = (nq - 1 - t) * kRows;
  const int kvh = h / G;
  int j_lo, j_hi;
  k_range(q_off + q0, kRows, kBK, Sk, causal, window, j_lo, j_hi);
  // tile j of [j_lo, j_hi): its stage, the parity of its use of the stage,
  // its K and V as copied (byte offsets) and its barriers (0 full, 1 empty)
  auto stage = [&](int j) { return (j - j_lo) % kStages; };
  auto parity = [&](int j) {
    return (uint32_t)((j - j_lo) / kStages) & 1u;
  };
  auto k_raw = [&](int j) { return T::kRing + stage(j) * 2 * T::kKVBytes; };
  auto v_raw = [&](int j) { return k_raw(j) + T::kKVBytes; };
  auto bar = [&](int kind, int j) {
    return q_full + 8u * (uint32_t)(1 + kind * kStages + stage(j));
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar(0, j_lo + s), 1);         // the producer's expect-tx
      mbar_init(bar(1, j_lo + s), 1);         // the split is done
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // ------------------------------------------------------------ producer
    if (threadIdx.x == kConsumerThreads) {
      mbar_arrive_expect_tx(q_full, T::kQBytes);   // the whole box counts
      for (int a = 0; a < D / kAtomF32; ++a)
        tma_load(base + T::kQ + a * kRows * kAtomRow, &q_map, a * kAtomF32,
                 h, q0, b, q_full);
      for (int j = j_lo; j < j_hi; ++j) {
        mbar_wait(bar(1, j), parity(j) ^ 1u);   // the stage's last use done
        mbar_arrive_expect_tx(bar(0, j), 2 * T::kKVBytes);
        for (int a = 0; a < D / kAtomF32; ++a) {
          const int off = a * kBK * kAtomRow;
          tma_load(base + k_raw(j) + off, &k_map, a * kAtomF32, kvh,
                   j * kBK, b, bar(0, j));
          tma_load(base + v_raw(j) + off, &v_map, a * kAtomF32, kvh,
                   j * kBK, b, bar(0, j));
        }
      }
    }
    return;
  }
  // ------------------------------------------------------------- consumers
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, tq = lane & 3;
  const int r0 = q0 + 16 * warp + (lane >> 2);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  uint32_t fb[kSets][4] = {}, fs[kSets][4] = {};
  mbar_wait(q_full, 0u);
  if constexpr (T::kPreSplit) {     // Q big in place, small beside
    split_tile<T::kQBytes>(smem + T::kQ, smem + T::kQ, smem + T::kQs, tid);
    fence_proxy_async();
  }
  for (int j = j_lo; j < j_hi; ++j) {
    mbar_wait(bar(0, j), parity(j));
    consumers_sync();               // tile j - 1's products are in
    split_tile<T::kKVBytes>(smem + k_raw(j), smem + T::kKb, smem + T::kKs,
                            tid);
    transpose_tile<kBK, D, true>(smem + v_raw(j), smem + T::kVtb,
                                 smem + T::kVts, tid);
    fence_proxy_async();
    consumers_sync();
    if (tid == 0) mbar_arrive(bar(1, j));   // the stage is free
    float sc[kBK / 2];
    if constexpr (T::kPreSplit) {   // both operands in shared memory
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
        mma3_k8_ss<kBK>(sc, base + T::kQ, base + T::kQs, base + T::kKb,
                        base + T::kKs, kk, kk > 0);
      wgmma_commit();
    } else {
      mma3_tile<kBK, D / 8, kRows>(sc, smem + T::kQ, base + T::kKb,
                                   base + T::kKs, fb, fs, warp, lane, 0);
    }
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(fb);
    fence_regs(fs);
    float corr[2];
    softmax_tile<kBK>(sc, m, l, corr,
                      tile_full(q0, kRows, j * kBK, kBK, Sq, Sk, causal,
                                window, q_off),
                      r0, j * kBK, tq, Sq, Sk, causal, window, q_off,
                      scale_log2);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
    uint32_t pb[kBK / 8][4] = {}, ps[kBK / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) frag_from_acc<kBK>(sc, kk, pb[kk],
                                                            ps[kk]);
    mma3_regs<D, kBK / 8>(acc, pb, ps, base + T::kVtb, base + T::kVts);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pb);
    fence_regs(ps);
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float lr = l[hf];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int qp = r0 + 8 * hf;
    if (qp >= Sq) continue;
    const float inv = 1.f / fmaxf(lr, 1e-30f);
    float* orow = o + (((long long)b * Sq + qp) * H + h) * head_dim + 2 * tq;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      if (8 * i < head_dim)
        *reinterpret_cast<float2*>(orow + 8 * i) = make_float2(
            acc[4 * i + 2 * hf] * inv, acc[4 * i + 2 * hf + 1] * inv);
    if (tq == 0)
      lse[((long long)b * H + h) * Sq + qp] =
          (m[hf] * scale_log2 + log2f(lr)) * kLn2;
  }
}

// ------------------------------------------------------------ backward: dQ
// grid B H ceil(Sq / 64) (the q tiles latest first, as the forward's);
// threads as the forward's.  q_map, do_map, o_map: q, dout, o (B, Sq, H,
// head_dim), box {32, 1, 64, 1}; k_map, v_map: k, v (B, Sk, KVH, head_dim),
// box {32, 1, kBK, 1}.  lse (the forward's) and delta (written here)
// (B, H, Sq), dq (B, Sq, H, head_dim), contiguous.
template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_f32_bwd_dq(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap do_map,
    const __grid_constant__ CUtensorMap o_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const float* __restrict__ lse, float* __restrict__ delta,
    float* __restrict__ dq, int B, int H, int Sq, int Sk, int G,
    int head_dim, int causal, int window, int q_off, float scale_log2,
    float scale) {
  typedef DqTiles<D> T;
  constexpr int kBK = T::kBK;
  constexpr int kStages = T::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t q_full = base + T::kBars;

  const int pairs = B * H;
  const int nq = (Sq + kRows - 1) / kRows;
  const int t = blockIdx.x / pairs;
  const int pair = blockIdx.x - t * pairs;
  const int b = pair / H, h = pair - b * H;
  const int q0 = (nq - 1 - t) * kRows;
  const int kvh = h / G;
  int j_lo, j_hi;
  k_range(q_off + q0, kRows, kBK, Sk, causal, window, j_lo, j_hi);
  auto stage = [&](int j) { return (j - j_lo) % kStages; };
  auto parity = [&](int j) {
    return (uint32_t)((j - j_lo) / kStages) & 1u;
  };
  auto k_raw = [&](int j) { return T::kRing + stage(j) * 2 * T::kKVBytes; };
  auto v_raw = [&](int j) { return k_raw(j) + T::kKVBytes; };
  auto bar = [&](int kind, int j) {
    return q_full + 8u * (uint32_t)(1 + kind * kStages + stage(j));
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar(0, j_lo + s), 1);
      mbar_init(bar(1, j_lo + s), 4);         // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // ------------------------------------------------------------ producer
    if (threadIdx.x == kConsumerThreads) {
      mbar_arrive_expect_tx(q_full, 3 * T::kQBytes);
      for (int a = 0; a < D / kAtomF32; ++a) {
        const int off = a * kRows * kAtomRow;
        tma_load(base + T::kQ + off, &q_map, a * kAtomF32, h, q0, b, q_full);
        tma_load(base + T::kDO + off, &do_map, a * kAtomF32, h, q0, b,
                 q_full);
        tma_load(base + T::kKs + off, &o_map, a * kAtomF32, h, q0, b,
                 q_full);
      }
      for (int j = j_lo; j < j_hi; ++j) {
        mbar_wait(bar(1, j), parity(j) ^ 1u);
        mbar_arrive_expect_tx(bar(0, j), 2 * T::kKVBytes);
        for (int a = 0; a < D / kAtomF32; ++a) {
          const int off = a * kBK * kAtomRow;
          tma_load(base + k_raw(j) + off, &k_map, a * kAtomF32, kvh,
                   j * kBK, b, bar(0, j));
          tma_load(base + v_raw(j) + off, &v_map, a * kAtomF32, kvh,
                   j * kBK, b, bar(0, j));
        }
      }
    }
    return;
  }
  // ------------------------------------------------------------- consumers
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, tq = lane & 3;
  const int r0 = q0 + 16 * warp + (lane >> 2);
  const long long stat = ((long long)b * H + h) * Sq;
  mbar_wait(q_full, 0u);

  // delta = rowsum(dO * O): two threads a row, each the 16-byte chunks of
  // one parity of every atom's row (the swizzle moves a row's chunks alike
  // in dO and O, and the columns past the head dim are 0); a warp's 16 rows
  // are its own
  float dl[2], ls[2];
  {
    const int rr = tid >> 1, half = tid & 1;
    float sum = 0.f;
#pragma unroll
    for (int a = 0; a < D / kAtomF32; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int off = a * kRows * kAtomRow + rr * kAtomRow
                        + (2 * c + half) * 16;
        const float4 x = *reinterpret_cast<const float4*>(smem + T::kKs + off);
        const float4 y = *reinterpret_cast<const float4*>(smem + T::kDO + off);
        sum = fmaf(x.x, y.x, sum);
        sum = fmaf(x.y, y.y, sum);
        sum = fmaf(x.z, y.z, sum);
        sum = fmaf(x.w, y.w, sum);
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const int qp = q0 + rr;
    if (half == 0 && qp < Sq) delta[stat + qp] = sum;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      dl[hf] = __shfl_sync(0xffffffffu, sum, 2 * ((lane >> 2) + 8 * hf));
      const int qr = r0 + 8 * hf;
      ls[hf] = qr < Sq ? lse[stat + qr] * kLog2e : 0.f;
    }
  }
  if constexpr (T::kPreSplit) {    // Q and dO big in place, small beside
    consumers_sync();              // dO is read for delta
    split_tile<T::kQBytes>(smem + T::kQ, smem + T::kQ, smem + T::kQs, tid);
    split_tile<T::kQBytes>(smem + T::kDO, smem + T::kDO, smem + T::kDOs, tid);
    fence_proxy_async();
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  uint32_t fb[kSets][4] = {}, fs[kSets][4] = {}, gb[kSets][4] = {},
           gs[kSets][4] = {};
  for (int j = j_lo; j < j_hi; ++j) {
    const int k0 = j * kBK;
    mbar_wait(bar(0, j), parity(j));
    consumers_sync();          // O is read, tile j - 1's products are in
    split_tile<T::kKVBytes>(smem + k_raw(j), smem + k_raw(j), smem + T::kKs,
                            tid);
    split_tile<T::kKVBytes>(smem + v_raw(j), smem + v_raw(j), smem + T::kVs,
                            tid);
    fence_proxy_async();
    consumers_sync();
    float s[kBK / 2], dp[kBK / 2];
    if constexpr (T::kPreSplit) {    // both operands in shared memory
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
        mma3_k8_ss<kBK>(s, base + T::kQ, base + T::kQs, base + k_raw(j),
                        base + T::kKs, kk, kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
        mma3_k8_ss<kBK>(dp, base + T::kDO, base + T::kDOs, base + v_raw(j),
                        base + T::kVs, kk, kk > 0);
      wgmma_commit();
    } else {                          // Q and dO split as they are read
      mma3_tile2<kBK, D / 8, kRows>(s, smem + T::kQ, base + k_raw(j),
                                    base + T::kKs, dp, smem + T::kDO,
                                    base + v_raw(j), base + T::kVs, fb, fs,
                                    gb, gs, warp, lane);
    }
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    fence_regs(fb);
    fence_regs(fs);
    fence_regs(gb);
    fence_regs(gs);
    // dp becomes dS / scale: P = exp2(S c - lse log2 e), zero where masked.
    // Element 4i + e is row r0 + 8 (e >> 1), key k0 + 8 i + 2 tq + (e & 1)
    const bool full = tile_full(q0, kRows, k0, kBK, Sq, Sk, causal, window,
                                q_off);
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1;
        float p = exp2_approx(fmaf(s[4 * i + e], scale_log2, -ls[hf]));
        if (!full && !row_pair_valid(r0 + 8 * hf,
                                     k0 + 8 * i + 2 * tq + (e & 1), Sq, Sk,
                                     causal, window, q_off))
          p = 0.f;
        dp[4 * i + e] = p * (dp[4 * i + e] - dl[hf]);
      }
    // K^T where V and V small were: from K big and small as they are
    consumers_sync();          // every warp's S and dP are in
    transpose_tile<kBK, D, false>(smem + k_raw(j), smem + v_raw(j), nullptr,
                                  tid);
    transpose_tile<kBK, D, false>(smem + T::kKs, smem + T::kVs, nullptr, tid);
    fence_proxy_async();
    consumers_sync();
    uint32_t db[kBK / 8][4] = {}, ds[kBK / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) frag_from_acc<kBK>(dp, kk, db[kk],
                                                            ds[kk]);
    mma3_regs<D, kBK / 8>(acc, db, ds, base + v_raw(j), base + T::kVs);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(db);
    fence_regs(ds);
    if (lane == 0) mbar_arrive(bar(1, j));
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qp = r0 + 8 * hf;
    if (qp >= Sq) continue;
    float* row = dq + (((long long)b * Sq + qp) * H + h) * head_dim + 2 * tq;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      if (8 * i < head_dim)
        *reinterpret_cast<float2*>(row + 8 * i) = make_float2(
            acc[4 * i + 2 * hf] * scale, acc[4 * i + 2 * hf + 1] * scale);
  }
}

// ------------------------------------------------------- backward: dK, dV
// grid B OH ceil(Sk / 64) (1-d: the k tiles earliest, the heaviest under a
// causal mask, first, each for every (batch, head) pair); threads as the
// forward's.  Block (b, oh, k tile) takes query head h = oh (OH = H, G > 1:
// its terms go to f32 scratch that flash_bwd_dkdv_sum_kernel adds up) or
// h = oh = the KV head (OH = KVH, G = 1: dk, dv themselves), and the q
// tiles of h that see the k tile.  k_map, v_map: k, v (B, Sk, KVH,
// head_dim), box {32, 1, 64, 1}; q_map, do_map: q, dout (B, Sq, H,
// head_dim), box {32, 1, kBQ, 1}; lse_map, delta_map: lse, delta (B H Sq
// f32) as 1-d maps, box kStatBox.  pk, pv (B, Sk, OH, head_dim) f32,
// contiguous.  The warpgroup computes S^T = K Q^T and dP^T = V dO^T (rows:
// keys), so P^T and dS^T are the A operands of dV += P^T dO and
// dK += dS^T Q.  kPass: both gradients, or only dV (no V, no dP^T, no
// delta) or only dK.  A k tile that no row sees loops over no q tile and
// writes zeros: nothing is cleared beforehand, and under a sequence split
// each rank's dk, dv are one term of a sum.
template <int D, int kPass>
__global__ void __launch_bounds__(kThreads, 1) flash_f32_bwd_dkdv(
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap do_map,
    const __grid_constant__ CUtensorMap lse_map,
    const __grid_constant__ CUtensorMap delta_map, float* __restrict__ pk,
    float* __restrict__ pv, int B, int H, int OH, int KVH, int Sq, int Sk,
    int head_dim, int causal, int window, int q_off, float scale_log2,
    float scale) {
  typedef KvTiles<D, kPass> T;
  constexpr bool kDv = T::kDv, kDk = T::kDk;
  constexpr int kBQ = T::kBQ;
  constexpr int kStages = T::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t kv_full = base + T::kBars;

  const int pairs = B * OH;
  const int t = blockIdx.x / pairs;
  const int pair = blockIdx.x - t * pairs;
  const int b = pair / OH, oh = pair - b * OH;
  const int h = oh, kvh = OH == H ? h / (H / KVH) : oh;
  const int k0 = t * kRows;
  // the q tiles [i_lo, i_hi) that see this k tile: causal, rows at
  // q_off + qp >= k0; window, rows at q_off + qp <= window + k0 + 62
  const int nq = (Sq + kBQ - 1) / kBQ;
  const int i_lo = causal ? max(0, floor_div(k0 - q_off, kBQ)) : 0;
  const int i_hi = window > 0
      ? min(nq, floor_div(window + k0 + kRows - 2 - q_off, kBQ) + 1) : nq;
  const int n_it = max(0, i_hi - i_lo);
  auto q_start = [&](int it) { return (i_lo + it) * kBQ; };
  // the element of lse and delta (B H Sq) of row qs of head h
  auto stat_start = [&](int qs) {
    return (int)(((long long)b * H + h) * Sq + qs);
  };
  auto stage = [&](int it) { return it % kStages; };
  auto parity = [&](int it) { return (uint32_t)(it / kStages) & 1u; };
  auto q_raw = [&](int it) { return T::kRing + stage(it) * 2 * T::kQBytes; };
  auto do_raw = [&](int it) { return q_raw(it) + T::kQBytes; };
  auto bar = [&](int kind, int it) {
    return kv_full + 8u * (uint32_t)(1 + kind * kStages + stage(it));
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar(0, s), 1);
      mbar_init(bar(1, s), 4);                // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // ------------------------------------------------------------ producer
    if (threadIdx.x == kConsumerThreads) {
      mbar_arrive_expect_tx(kv_full, (kDk ? 2 : 1) * T::kKBytes);
      for (int a = 0; a < D / kAtomF32; ++a) {
        const int off = a * kRows * kAtomRow;
        tma_load(base + T::kK + off, &k_map, a * kAtomF32, kvh, k0, b,
                 kv_full);
        if (kDk)
          tma_load(base + T::kV + off, &v_map, a * kAtomF32, kvh, k0, b,
                   kv_full);
      }
      for (int it = 0; it < n_it; ++it) {
        const int qs = q_start(it);
        mbar_wait(bar(1, it), parity(it) ^ 1u);
        mbar_arrive_expect_tx(bar(0, it), 2 * T::kQBytes
                              + (kDk ? 2 : 1) * T::kStatBox * 4);
        for (int a = 0; a < D / kAtomF32; ++a) {
          const int off = a * kBQ * kAtomRow;
          tma_load(base + q_raw(it) + off, &q_map, a * kAtomF32, h, qs, b,
                   bar(0, it));
          tma_load(base + do_raw(it) + off, &do_map, a * kAtomF32, h, qs, b,
                   bar(0, it));
        }
        // from the aligned element at or before the tile's first; rows
        // past Sq read the next head's (or, past the end, zeros): their
        // columns are masked
        const int c0 = stat_start(qs) & ~3;
        tma_load_1d(base + T::kLse + stage(it) * T::kStatBytes, &lse_map, c0,
                    bar(0, it));
        if (kDk)
          tma_load_1d(base + T::kDelta + stage(it) * T::kStatBytes,
                      &delta_map, c0, bar(0, it));
      }
    }
    return;
  }
  // ------------------------------------------------------------- consumers
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, tq = lane & 3;
  const int kr0 = k0 + 16 * warp + (lane >> 2);
  // a pass's unused accumulator is one register, never touched
  float dk_acc[kDk ? D / 2 : 1], dv_acc[kDv ? D / 2 : 1];
#pragma unroll
  for (int i = 0; i < (kDk ? D / 2 : 1); ++i) dk_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kDv ? D / 2 : 1); ++i) dv_acc[i] = 0.f;
  uint32_t fb[kSets][4] = {}, fs[kSets][4] = {}, gb[kSets][4] = {},
           gs[kSets][4] = {};
  mbar_wait(kv_full, 0u);

  // the conversion of q tile `it` once its copy is in: Q big in place and
  // small beside; dK: dO the same; dV alone: dO^T big and small from dO as
  // copied
  auto convert = [&](int it) {             // 4 reads at a time: registers
    mbar_wait(bar(0, it), parity(it));
    split_tile<T::kQBytes, 4>(smem + q_raw(it), smem + q_raw(it),
                              smem + T::kQs, tid);
    if constexpr (kDk)
      split_tile<T::kQBytes, 4>(smem + do_raw(it), smem + do_raw(it),
                                smem + T::kDOs, tid);
    else
      transpose_tile<kBQ, D, true>(smem + do_raw(it), smem + T::kDOt,
                                   smem + T::kDOt + T::kQBytes, tid);
    fence_proxy_async();
    consumers_sync();
  };
  // both gradients: q tile it + 1 is converted while dV and dK of tile it
  // run (its Q small and dO small were read into the transposed tiles)
  if (kDv && kDk && n_it > 0) convert(0);

  for (int it = 0; it < n_it; ++it) {
    const int q0 = q_start(it);
    const int skew = stat_start(q0) & 3;            // see kStatBox
    const float* ls = reinterpret_cast<const float*>(
        smem + T::kLse + stage(it) * T::kStatBytes) + skew;
    const float* dl = reinterpret_cast<const float*>(
        smem + T::kDelta + stage(it) * T::kStatBytes) + skew;
    if (!(kDv && kDk)) {
      consumers_sync();          // iteration it - 1's products are in
      convert(it);
    }

    // rows: keys, columns: q.  Element 4i + e is key kr0 + 8 (e >> 1),
    // q row q0 + 8 i + 2 tq + (e & 1)
    float s[kBQ / 2], dp[kDk ? kBQ / 2 : 1];
    if constexpr (kDk)
      mma3_tile2<kBQ, D / 8, kRows>(s, smem + T::kK, base + q_raw(it),
                                    base + T::kQs, dp, smem + T::kV,
                                    base + do_raw(it), base + T::kDOs, fb, fs,
                                    gb, gs, warp, lane);
    else
      mma3_tile<kBQ, D / 8, kRows>(s, smem + T::kK, base + q_raw(it),
                                   base + T::kQs, fb, fs, warp, lane, 0);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    fence_regs(fb);
    fence_regs(fs);
    fence_regs(gb);
    fence_regs(gs);

    // P^T = exp2(S^T c - lse log2 e), zero where masked, in s; dK:
    // dS^T / scale = P^T (dP^T - delta), in dp
    const bool full = tile_full(q0, kBQ, k0, kRows, Sq, Sk, causal, window,
                                q_off);
#pragma unroll
    for (int i = 0; i < kBQ / 8; ++i) {
      const float lx = ls[8 * i + 2 * tq] * kLog2e;
      const float ly = ls[8 * i + 2 * tq + 1] * kLog2e;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = e & 1;
        float p = exp2_approx(fmaf(s[4 * i + e], scale_log2,
                                   -(c ? ly : lx)));
        if (!full && !row_pair_valid(q0 + 8 * i + 2 * tq + c,
                                     kr0 + 8 * (e >> 1), Sq, Sk, causal,
                                     window, q_off))
          p = 0.f;
        s[4 * i + e] = p;
      }
      if constexpr (kDk) {
        const float dx = dl[8 * i + 2 * tq], dy = dl[8 * i + 2 * tq + 1];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * i + e] = s[4 * i + e]
                          * (dp[4 * i + e] - ((e & 1) ? dy : dx));
      }
    }

    // the transposed B tiles: dV's dO^T (both: from dO big and small as
    // they are; dV alone: made by convert) and dK's Q^T (both: tiles of
    // their own; dK alone: where dO and dO small were)
    const int qt = kDv ? T::kQt : do_raw(it);
    const int qt_small = kDv ? T::kQt + T::kQBytes : T::kDOs;
    if constexpr (kDk) {
      consumers_sync();          // every warp's S^T and dP^T are in
      if constexpr (kDv) {
        transpose_tile<kBQ, D, false>(smem + do_raw(it), smem + T::kDOt,
                                      nullptr, tid);
        transpose_tile<kBQ, D, false>(smem + T::kDOs,
                                      smem + T::kDOt + T::kQBytes, nullptr,
                                      tid);
      }
      transpose_tile<kBQ, D, false>(smem + q_raw(it), smem + qt, nullptr,
                                    tid);
      transpose_tile<kBQ, D, false>(smem + T::kQs, smem + qt_small, nullptr,
                                    tid);
      fence_proxy_async();
      consumers_sync();
    }
    if (kDv && kDk && lane == 0) mbar_arrive(bar(1, it));   // stage read
    uint32_t pb[kDv ? kBQ / 8 : 1][4] = {}, ps[kDv ? kBQ / 8 : 1][4] = {};
    if constexpr (kDv) {
#pragma unroll
      for (int kk = 0; kk < kBQ / 8; ++kk) frag_from_acc<kBQ>(s, kk, pb[kk],
                                                              ps[kk]);
      mma3_regs<D, kBQ / 8>(dv_acc, pb, ps, base + T::kDOt,
                            base + T::kDOt + T::kQBytes);
    }
    uint32_t db[kDk ? kBQ / 8 : 1][4] = {}, ds[kDk ? kBQ / 8 : 1][4] = {};
    if constexpr (kDk) {
#pragma unroll
      for (int kk = 0; kk < kBQ / 8; ++kk) frag_from_acc<kBQ>(dp, kk, db[kk],
                                                              ds[kk]);
      mma3_regs<D, kBQ / 8>(dk_acc, db, ds, base + qt, base + qt_small);
    }
    if (kDv && kDk && it + 1 < n_it) convert(it + 1);
    wgmma_wait<0>();
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    fence_regs(pb);
    fence_regs(ps);
    fence_regs(db);
    fence_regs(ds);
    if (!(kDv && kDk) && lane == 0) mbar_arrive(bar(1, it));
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int kp = kr0 + 8 * hf;
    if (kp >= Sk) continue;
    const long long off = (((long long)b * Sk + kp) * OH + oh) * head_dim
                          + 2 * tq;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      if (8 * i >= head_dim) continue;
      if constexpr (kDk)
        *reinterpret_cast<float2*>(pk + off + 8 * i) =
            make_float2(dk_acc[4 * i + 2 * hf] * scale,
                        dk_acc[4 * i + 2 * hf + 1] * scale);
      if constexpr (kDv)
        *reinterpret_cast<float2*>(pv + off + 8 * i) =
            make_float2(dv_acc[4 * i + 2 * hf], dv_acc[4 * i + 2 * hf + 1]);
    }
  }
}

// ---------------------------------------------- backward: dK, dV of a group
// dk, dv (B, Sk, KVH, D) = the sums of the G query heads' terms in the
// scratch (B, Sk, KVH * G, D) that flash_f32_bwd_dkdv wrote, in head order
// g = 0 .. G - 1: one order, no atomics.  One thread a 16-byte chunk of a
// row (D is a multiple of 16).
__global__ void __launch_bounds__(256) flash_bwd_dkdv_sum_kernel(
    const float* __restrict__ part_k, const float* __restrict__ part_v,
    float* __restrict__ dk, float* __restrict__ dv, long long n_chunks,
    int G, int D) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n_chunks) return;
  const long long e = 4 * i;
  const long long row = e / D;          // (b, kp, kvh), row-major
  const long long col = e - row * D;
  const long long src = row * G * D + col;  // head kvh * G of the same (b, kp)
  float4 ak = make_float4(0.f, 0.f, 0.f, 0.f), av = ak;
  for (int g = 0; g < G; ++g) {
    const float4 x = *reinterpret_cast<const float4*>(part_k + src + g * D);
    const float4 y = *reinterpret_cast<const float4*>(part_v + src + g * D);
    ak.x += x.x; ak.y += x.y; ak.z += x.z; ak.w += x.w;
    av.x += y.x; av.y += y.y; av.z += y.z; av.w += y.w;
  }
  *reinterpret_cast<float4*>(dk + e) = ak;
  *reinterpret_cast<float4*>(dv + e) = av;
}

// ------------------------------------------------------------------ launch
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  float* part;
  int B, Sq, Sk, H, KVH, head_dim;
  long long sq_b, sq_s, sq_h, sk_b, sk_s, sk_h, so_b, so_s, so_h, sd_b,
      sd_s, sd_h;
  int causal, window, q_off;
  cudaStream_t stream;
};

template <int D>
cudaError_t fwd_launch(const Args& a, float* o, float* lse) {
  typedef FwdTiles<D> T;
  static unsigned int configured = 0u;        // one bit per device
  const cudaError_t err = allow_smem(flash_f32_fwd<D>, T::kBytes,
                                     configured);
  if (err != cudaSuccess) return err;
  CUtensorMap q_map = {}, k_map = {}, v_map = {};
  if (!tile_map_f32(&q_map, a.q, a.B, a.Sq, a.H, a.head_dim, kRows, a.sq_b,
                    a.sq_s, a.sq_h)
      || !tile_map_f32(&k_map, a.k, a.B, a.Sk, a.KVH, a.head_dim, T::kBK,
                       a.sk_b, a.sk_s, a.sk_h)
      || !tile_map_f32(&v_map, a.v, a.B, a.Sk, a.KVH, a.head_dim, T::kBK,
                       a.sk_b, a.sk_s, a.sk_h))
    return cudaErrorInvalidValue;
  const long long blocks = (long long)((a.Sq + kRows - 1) / kRows) * a.H
                           * a.B;
  if (blocks > 0x7fffffffll) return cudaErrorInvalidValue;
  flash_f32_fwd<D><<<(unsigned)blocks, kThreads, T::kBytes, a.stream>>>(
      q_map, k_map, v_map, o, lse, a.B, a.H, a.Sq, a.Sk, a.H / a.KVH,
      a.head_dim, a.causal, a.window, a.q_off,
      kLog2e / sqrtf((float)a.head_dim));
  return cudaGetLastError();
}

template <int D, int kPass>
cudaError_t dkdv_launch(const Args& a, float* pk, float* pv, int OH,
                        float scale_log2, float scale) {
  typedef KvTiles<D, kPass> T;
  static unsigned int configured = 0u;
  const cudaError_t err = allow_smem(flash_f32_bwd_dkdv<D, kPass>,
                                     T::kBytes, configured);
  if (err != cudaSuccess) return err;
  const long long n_stat = (long long)a.B * a.H * a.Sq;
  CUtensorMap k_map = {}, v_map = {}, q_map = {}, do_map = {}, lse_map = {},
              delta_map = {};
  if (!tile_map_f32(&k_map, a.k, a.B, a.Sk, a.KVH, a.head_dim, kRows,
                    a.sk_b, a.sk_s, a.sk_h)
      || !tile_map_f32(&v_map, a.v, a.B, a.Sk, a.KVH, a.head_dim, kRows,
                       a.sk_b, a.sk_s, a.sk_h)
      || !tile_map_f32(&q_map, a.q, a.B, a.Sq, a.H, a.head_dim, T::kBQ,
                       a.sq_b, a.sq_s, a.sq_h)
      || !tile_map_f32(&do_map, a.dout, a.B, a.Sq, a.H, a.head_dim, T::kBQ,
                       a.sd_b, a.sd_s, a.sd_h)
      || !vec_map(&lse_map, a.lse, n_stat, T::kStatBox)
      || !vec_map(&delta_map, a.delta, n_stat, T::kStatBox))
    return cudaErrorInvalidValue;
  const long long blocks = (long long)((a.Sk + kRows - 1) / kRows) * OH
                           * a.B;
  if (blocks > 0x7fffffffll) return cudaErrorInvalidValue;
  flash_f32_bwd_dkdv<D, kPass>
      <<<(unsigned)blocks, kThreads, T::kBytes, a.stream>>>(
          k_map, v_map, q_map, do_map, lse_map, delta_map, pk, pv, a.B, a.H,
          OH, a.KVH, a.Sq, a.Sk, a.head_dim, a.causal, a.window, a.q_off,
          scale_log2, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_launch(const Args& a) {
  typedef DqTiles<D> T;
  static unsigned int configured = 0u;
  cudaError_t err = allow_smem(flash_f32_bwd_dq<D>, T::kBytes, configured);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)a.head_dim);
  const float scale_log2 = kLog2e * scale;
  const int G = a.H / a.KVH;
  CUtensorMap q_map = {}, do_map = {}, o_map = {}, k_map = {}, v_map = {};
  if (!tile_map_f32(&q_map, a.q, a.B, a.Sq, a.H, a.head_dim, kRows, a.sq_b,
                    a.sq_s, a.sq_h)
      || !tile_map_f32(&do_map, a.dout, a.B, a.Sq, a.H, a.head_dim, kRows,
                       a.sd_b, a.sd_s, a.sd_h)
      || !tile_map_f32(&o_map, a.o, a.B, a.Sq, a.H, a.head_dim, kRows,
                       a.so_b, a.so_s, a.so_h)
      || !tile_map_f32(&k_map, a.k, a.B, a.Sk, a.KVH, a.head_dim, T::kBK,
                       a.sk_b, a.sk_s, a.sk_h)
      || !tile_map_f32(&v_map, a.v, a.B, a.Sk, a.KVH, a.head_dim, T::kBK,
                       a.sk_b, a.sk_s, a.sk_h))
    return cudaErrorInvalidValue;
  const long long blocks = (long long)((a.Sq + kRows - 1) / kRows) * a.H
                           * a.B;
  if (blocks > 0x7fffffffll) return cudaErrorInvalidValue;
  flash_f32_bwd_dq<D><<<(unsigned)blocks, kThreads, T::kBytes, a.stream>>>(
      q_map, do_map, o_map, k_map, v_map, a.lse, a.delta, (float*)a.dq, a.B,
      a.H, a.Sq, a.Sk, G, a.head_dim, a.causal, a.window, a.q_off,
      scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // G = 1: dk, dv themselves; else one query head a block into scratch
  const int OH = G == 1 ? a.KVH : a.H;
  float* pk = G == 1 ? (float*)a.dk : a.part;
  float* pv = G == 1 ? (float*)a.dv
                     : a.part + (long long)a.B * a.Sk * a.H * a.head_dim;
  if constexpr (D > 128) {        // two passes (see the header)
    err = dkdv_launch<D, kDvPass>(a, pk, pv, OH, scale_log2, scale);
    if (err != cudaSuccess) return err;
    err = dkdv_launch<D, kDkPass>(a, pk, pv, OH, scale_log2, scale);
  } else {
    err = dkdv_launch<D, kBothPass>(a, pk, pv, OH, scale_log2, scale);
  }
  if (err != cudaSuccess || G == 1) return err;
  const long long n_chunks = (long long)a.B * a.Sk * a.KVH * a.head_dim / 4;
  flash_bwd_dkdv_sum_kernel<<<(unsigned)((n_chunks + 255) / 256), 256, 0,
                              a.stream>>>(pk, pv, (float*)a.dk, (float*)a.dv,
                                          n_chunks, G, a.head_dim);
  return cudaGetLastError();
}

// with a causal mask or a window, the rows q_off .. q_off + Sq - 1 lie
// inside the Sk keys (see the header); lse and delta are addressed as one
// vector of B H Sq elements with 32-bit coordinates
bool shapes_ok(int B, int Sq, int Sk, int H, int KVH, int causal, int window,
               int q_off) {
  return B > 0 && B <= 65535 && Sq > 0 && Sk > 0 && q_off >= 0
         && ((!causal && window <= 0) || (long long)q_off + Sq <= Sk)
         && H > 0 && H <= 65535 && KVH > 0 && H % KVH == 0
         && (long long)B * H * Sq <= 0x7fffffffll;
}

// the instance of a head dim (flash_attention.py's `f32_instance`)
int instance(int D) {
  switch (D) {
    case 16: case 32: case 48: case 64: return 64;
    case 80: case 96: case 112: case 128: return 128;
    case 192: return 192;
    default: return 0;
  }
}

}  // namespace

// float32 only.  q (B, Sq, H, D) and k, v (B, Sk, KVH, D) are read through
// their element strides (batch, seq, head; unit stride over D; 16-byte
// aligned base, strides multiples of 4 elements; k and v share strides);
// q row i is at absolute position q_off + i (with a causal mask or a
// window, q_off + Sq <= Sk); o (B, Sq, H, D) and lse (B, H, Sq) are
// contiguous.  Returns the cudaError_t of the launch (0 on success);
// nothing is synchronised.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int B, int Sq, int Sk, int H, int KVH, int D,
    long long sq_b, long long sq_s, long long sq_h,
    long long sk_b, long long sk_s, long long sk_h,
    int causal, int window, int q_off, void* stream) {
  if (!shapes_ok(B, Sq, Sk, H, KVH, causal, window, q_off))
    return (int)cudaErrorInvalidValue;
  const Args a = {q, k, v, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, nullptr, B, Sq, Sk, H, KVH, D,
                  sq_b, sq_s, sq_h, sk_b, sk_s, sk_h, 0, 0, 0, 0, 0, 0,
                  causal, window, q_off, (cudaStream_t)stream};
  switch (instance(D)) {
    case 64: return (int)fwd_launch<64>(a, (float*)o, (float*)lse);
    case 128: return (int)fwd_launch<128>(a, (float*)o, (float*)lse);
    case 192: return (int)fwd_launch<192>(a, (float*)o, (float*)lse);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Gradients of repro_flash_attention_fwd (and of repro_flash_decode_fwd),
// float32.  q, o, dout (B, Sq, H, D) and k, v (B, Sk, KVH, D) are read
// through their element strides, as the forward reads q, k, v; lse (the
// forward's) and delta (scratch) (B, H, Sq) with a 16-byte aligned base;
// dq (B, Sq, H, D), dk, dv (B, Sk, KVH, D) contiguous; part: f32 scratch of
// 2 * B * Sk * H * D elements for the query heads' dK, dV terms where
// G = H / KVH > 1 (null at G = 1).  Launches on `stream`: dQ (which also
// writes delta), dK/dV (two passes at D = 192), and for G > 1 the group
// sum.  q_off as the forward's.  Returns the cudaError_t of the launches
// (0 on success); nothing is synchronised.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, void* part, int B, int Sq, int Sk, int H, int KVH, int D,
    long long sq_b, long long sq_s, long long sq_h,
    long long sk_b, long long sk_s, long long sk_h,
    long long so_b, long long so_s, long long so_h,
    long long sd_b, long long sd_s, long long sd_h,
    int causal, int window, int q_off, void* stream) {
  if (!shapes_ok(B, Sq, Sk, H, KVH, causal, window, q_off)
      || (H != KVH && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a = {q, k, v, o, dout, (const float*)lse, (float*)delta, dq,
                  dk, dv, (float*)part, B, Sq, Sk, H, KVH, D,
                  sq_b, sq_s, sq_h, sk_b, sk_s, sk_h,
                  so_b, so_s, so_h, sd_b, sd_s, sd_h,
                  causal, window, q_off, (cudaStream_t)stream};
  switch (instance(D)) {
    case 64: return (int)bwd_launch<64>(a);
    case 128: return (int)bwd_launch<128>(a);
    case 192: return (int)bwd_launch<192>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

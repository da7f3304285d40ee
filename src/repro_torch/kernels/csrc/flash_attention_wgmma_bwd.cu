// Flash attention's bf16 backward on the tensor cores of NVIDIA Hopper
// (sm_90a): wgmma on tiles that the Tensor Memory Accelerator copies into
// shared memory, one producer warp and two consumer warpgroups, as the
// forward of flash_attention_wgmma.cu.  The gradient route of every bf16
// tensor (flash_attention.cu keeps the f32 route on the CUDA cores); it
// takes the per-row logsumexp lse (B, H, Sq) that the bf16 forward
// (flash_attention_wgmma.cu, or flash_decode.cu for a few rows) writes.
//
// Replaces the gradient of the TPU kernel `flash_attention_kernel` /
// `_kernel` of src/repro/kernels/flash_attention/flash_attention.py: the
// reference has no backward kernel (XLA differentiates its chunked scan of
// src/repro/models/attention_ops.py).  q (B, Sq, H, D) attends to k, v
// (B, Sk, KVH, D), query head h reading KV head h / G.  Sq may differ from
// Sk: without a causal mask or a window (cross-attention), or as one
// rank's rows of a sequence split, q row i at absolute position q_off + i
// with q_off + Sq <= Sk (shapes_ok refuses the rest).  Every mask, tile
// predicate and tile range is flash_mask.cuh's and compares the row's
// absolute position with the key's; lse and delta stay indexed by the
// local row.  Two kernels compute the gradients from the logsumexp:
//   flash_wgmma_bwd_dq    one block per (b, h, 128-row q tile): first
//                         delta = rowsum(dO * O) of its rows (written out
//                         for the next kernel), then dQ over the 64-key
//                         tiles it sees;
//   flash_wgmma_bwd_dkdv  one block per (b, kv head, 128-key k tile): loops
//                         over the G query heads of the group and the
//                         64-row q tiles that see the k tile, so the GQA
//                         sum over G is taken inside one block, in one
//                         order; a k tile that no row sees writes zeros.
// No floating-point atomics anywhere: every sum has one order, and the
// gradients repeat bit for bit.
//
// What bounds it on this card: operations.  At the training shape (B=1,
// S=4096, H=40, KVH=8, D=128, causal) the backward does about 4.30e11 FLOP
// (counted: S, dP, dV, dK, dQ) against ~0.2 GB of inputs and outputs, far
// above the ~295 FLOP per byte at which HBM would become the limit: the
// bound is the 989 TFLOP/s bf16 tensor-core rate, which only wgmma
// reaches.
//
// Why the split recomputes S and dP: dQ sums over keys, dK and dV over
// query rows (and over the G heads of a group).  One kernel that forms a
// tile's S and dP once must add its dQ terms into rows that other blocks
// also add to, which takes atomics (an order that changes from run to
// run) or scratch of one dQ per k tile.  The split keeps each gradient in
// the block that owns its rows, with every sum in one order, for 7
// products a tile instead of 5 (S and dP in both kernels): the ceiling is
// 5 / 7 = 71 % of the bound, and the speed has to come from the rate at
// which the products run.
//
// What the design does about it:
//  * every product is wgmma.mma_async from shared memory: S = Q K^T and
//    dP = dO V^T (dQ), S^T = K Q^T and dP^T = V dO^T (dK/dV) with both
//    operands K-major; dQ += dS K, dV += P^T dO and dK += dS^T Q with the
//    f32 accumulator of the step before rounded to bf16 in registers as the
//    A operand (the m16n8 layout of each warp's accumulator is the m16k16
//    A-fragment layout) and B MN-major (the instruction's transpose bit),
//    as the forward's O += P V;
//  * a block is two consumer warpgroups of 64 rows (dQ: query rows; dK/dV:
//    keys) and a producer warpgroup of which one thread issues every copy;
//    setmaxnreg hands the producer's registers to the consumers (24 and
//    240 a thread);
//  * the copies are cp.async.bulk.tensor over 4-d tensor maps of q, k, v,
//    o and dout by their strides (the model layout and the reference
//    signature's views are read as they lie), each box one 64-column atom
//    of one head's rows, 128-byte swizzled; lse and delta over 1-d maps.
//    What a block keeps (dQ: Q, dO and, until delta is formed, O; dK/dV:
//    K and V) is copied once; what it streams (dQ: K and V; dK/dV: Q, dO,
//    lse and delta) goes through a ring of kStages stages under full
//    (expect-tx) and empty mbarriers.  Rows past Sq or Sk and columns past
//    the head dim are zero-filled by the copy;
//  * the elementwise work is what the tensor cores would wait on: in dQ a
//    warpgroup issues tile j's S and dP before tile j - 1's dQ product and
//    forms P = exp2(S c - lse log2 e) (one FFMA, one MUFU) and
//    dS = P (dP - delta) while that product runs.  In dK/dV, whose
//    accumulators hold twice the registers, P^T and dS^T are formed
//    before dV's and dK's products are issued together (issuing tile
//    i + 1's S^T and dP^T before them spilled at D = 128 and, with two
//    stages at D = 192, waited on the copies: slower at D = 64, 112 and
//    192).
//    The two warpgroups take turns to issue their S and dP (the
//    forward's ping-pong, hopper.cuh's turns), so one's elementwise work
//    runs while the other's products do;
//  * the blocks walk their pairs in groups whose streamed operands fit 32
//    MB of L2 (dQ: (batch, head) pairs, whose K and V stream; dK/dV:
//    (batch, kv head) pairs, whose G heads' Q and dO stream), the heaviest
//    tiles first: dQ the latest q tiles, dK/dV the earliest k tiles (the
//    most q tiles see them under a causal mask).  DeepSeek-V3's 128 heads
//    hold 384 MB of Q and dO at S = 4,096, which k tiles walked with every
//    head at once would read from HBM once each;
//  * the element mask applies only on the tiles that straddle the causal
//    diagonal, the window edge or the end of either sequence.
//
// Head dims: the forward's instances, D = 64, 128 and 192; 16, 32 and 48
// run the 64 instance, 80, 96 and 112 the 128 one (flash_attention.py's
// `bwd_instance`).  The maps carry the true head dim, the copy zero-fills
// the columns past it, and those columns are never written.  Tiles: dQ 64
// keys (32 at D = 192), dK/dV 64 query rows.  A dQ consumer thread holds
// dQ (D / 2 f32), S and dP of tile j (kBK f32) and dS of tile j - 1 (kBK /
// 4 words): at D = 192 with 64-key tiles that spilled at 240 registers a
// thread, so that instance takes 32-key tiles.  A dK/dV thread holds dK and
// dV (D f32: 128 at D = 128), S^T and dP^T (64) and the bf16 P^T and dS^T
// (32 words).  At D = 192 dK and dV together would be 192 f32 a thread, so
// dK/dV runs as two passes of the same kernel (kPass), a dV pass (S^T ->
// P^T, dV += P^T dO) and a dK pass (S^T, dP^T -> dS^T, dK += dS^T Q), each
// with one 96-register accumulator; the dK pass recomputes S^T (8 products
// a tile in all).
// Shared memory (stages at most 4): dQ Q, dO 2 x 32 KB at D = 128 and a
// ring of 4 stages of K + V 16 + 16 KB (D = 192: 48 KB each and 4 stages
// of 12 + 12 KB), O copied into the first stages until delta is formed;
// dK/dV K, V 2 x 32 KB and a ring of Q + dO 8 + 8 KB a stage (4 stages; 2
// at D = 192).

#include <math.h>

#include "flash_mask.cuh"
#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kConsumers = 2;                 // consumer warpgroups
constexpr int kWGRows = 64;                   // rows a warpgroup
constexpr int kRows = kConsumers * kWGRows;   // dQ: q rows; dK/dV: keys
constexpr int kThreads = (kConsumers + 1) * 128;   // + the producer's
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kBQ = 64;                       // dK/dV: query rows a tile
// lse and delta of a q tile: a 1-d copy whose start is 16-byte aligned
// (the copy refuses any other), so kBQ + 4 elements from the aligned
// element at or before the tile's first
constexpr int kStatBox = kBQ + 4;
constexpr int kMaxStages = 4;

// what a dK/dV launch computes: both (D <= 128), or one of the two passes
enum { kBothPass = 0, kDvPass = 1, kDkPass = 2 };

// dQ's keys a tile and byte offsets into the block's dynamic shared memory
// (from a 1024-byte aligned base): Q and dO, then the ring, stage s one K
// tile and one V tile; O lies in the first kOStages stages until every
// consumer warp has its delta
template <int D> struct DqTiles {
  // keys a tile: 64, or 32 where dQ's 96 f32 a thread leave too few
  // registers for 64 (D = 192)
  static constexpr int kBK = D > 128 ? 32 : 64;
  static constexpr int kAtoms = D / kAtom;
  static constexpr int kQBytes = kRows * D * 2;     // Q, dO or O
  static constexpr int kKVBytes = kBK * D * 2;      // one K (or V) tile
  static constexpr int kOStages = kQBytes / (2 * kKVBytes);
  static constexpr int kFit = (kMaxSharedBytes - 2 * kQBytes - 2048)
                              / (2 * kKVBytes);
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kQBytes;
  static constexpr int kRing = kDO + kQBytes;
  static constexpr int kBars = kRing + kStages * 2 * kKVBytes;
  // q_full, o_free, then full and empty of each stage
  static constexpr int kBytes = kBars + (2 + 2 * kStages) * 8 + 1024;
  static_assert(D % kAtom == 0, "an instance is whole atoms");
  static_assert(kOStages * 2 * kKVBytes == kQBytes, "O fills whole stages");
  static_assert(kStages >= 2 && kStages >= kOStages, "a ring");
  static_assert(kBytes <= kMaxSharedBytes, "shared memory");
};

// dK/dV's: K and V, then the ring, stage s one Q tile and one dO tile, then
// each stage's lse and delta (kStatBox f32 each, 128-byte slots)
template <int D> struct KvTiles {
  static constexpr int kAtoms = D / kAtom;
  static constexpr int kKBytes = kRows * D * 2;     // K or V
  static constexpr int kQBytes = kBQ * D * 2;       // one Q (or dO) tile
  static constexpr int kStatBytes = (kStatBox * 4 + 127) / 128 * 128;
  static constexpr int kFit = (kMaxSharedBytes - 2 * kKBytes - 2048)
                              / (2 * kQBytes + 2 * kStatBytes);
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKBytes;
  static constexpr int kRing = kV + kKBytes;
  static constexpr int kLse = kRing + kStages * 2 * kQBytes;
  static constexpr int kDelta = kLse + kStages * kStatBytes;
  static constexpr int kBars = kDelta + kStages * kStatBytes;
  // kv_full, then full and empty of each stage
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8 + 1024;
  static_assert(D % kAtom == 0, "an instance is whole atoms");
  static_assert(kStages >= 2, "a ring");
  static_assert(kBytes <= kMaxSharedBytes, "shared memory");
};

// the block's dynamic shared memory from a 1024-byte aligned base (the
// swizzle repeats every 8 rows of 128 bytes)
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
}

// ------------------------------------------------------------ backward: dQ
// grid B H ceil(Sq / kRows) (1-d, see `group`); block kThreads: consumer
// warpgroups 0 .. kConsumers - 1, the producer last.  D is the instance's
// head dim, head_dim <= D the tensors'.  q_map, do_map, o_map: q, dout, o
// (B, Sq, H, head_dim), box {64, 1, kRows, 1}; k_map, v_map: k, v
// (B, Sk, KVH, head_dim), box {64, 1, T::kBK, 1}.  lse (the forward's) and
// delta (written here) (B, H, Sq) f32, dq (B, Sq, H, head_dim) bf16,
// contiguous.  Consumer warpgroup w owns rows [64 w, 64 w + 64) of the q
// tile; in it warp x the 16 rows from 16 x, lane l rows l / 4 and
// l / 4 + 8 of those.
template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_wgmma_bwd_dq(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap do_map,
    const __grid_constant__ CUtensorMap o_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const float* __restrict__ lse, float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int B, int H, int Sq, int Sk, int G,
    int head_dim, int causal, int window, int q_off, int group,
    float scale_log2, float scale) {
  typedef DqTiles<D> T;
  constexpr int kStages = T::kStages;
  constexpr int kBK = T::kBK;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t s_q = smem_u32(smem + T::kQ);
  const uint32_t s_do = smem_u32(smem + T::kDO);
  const uint32_t s_o = smem_u32(smem + T::kRing);
  const uint32_t q_full = smem_u32(smem + T::kBars);
  const uint32_t o_free = q_full + 8u;

  // block order: the (batch, head) pairs in groups of `group`, and in a
  // group the q tiles latest (heaviest) first, each tile for every pair
  const int nq = (Sq + kRows - 1) / kRows;
  const int pairs = B * H;
  const int g0 = blockIdx.x / (group * nq) * group;
  const int size = min(group, pairs - g0);
  const int r = blockIdx.x - g0 * nq;
  const int t = r / size;
  const int pair = g0 + (r - t * size);
  const int b = pair / H, h = pair - b * H;
  const int q0 = (nq - 1 - t) * kRows;
  const int kvh = h / G;
  int j_lo, j_hi;
  k_range(q_off + q0, kRows, kBK, Sk, causal, window, j_lo, j_hi);
  // tile j of [j_lo, j_hi): its stage, the parity of its use of the stage,
  // its K and V in shared memory and its barriers (0 full, 1 empty)
  auto stage = [&](int j) { return (j - j_lo) % kStages; };
  auto parity = [&](int j) {
    return (uint32_t)((j - j_lo) / kStages) & 1u;
  };
  auto k_tile = [&](int j) {
    return smem_u32(smem + T::kRing + stage(j) * 2 * T::kKVBytes);
  };
  auto v_tile = [&](int j) { return k_tile(j) + T::kKVBytes; };
  auto bar = [&](int kind, int j) {
    return q_full + 8u * (uint32_t)(2 + kind * kStages + stage(j));
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(o_free, kConsumers * 4);          // every consumer warp
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar(0, j_lo + s), 1);           // the producer's expect-tx
      mbar_init(bar(1, j_lo + s), kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      mbar_arrive_expect_tx(q_full, 3 * T::kQBytes);   // whole boxes count
      for (int a = 0; a < T::kAtoms; ++a) {
        const int off = a * kRows * kAtomRow;
        tma_load(s_q + off, &q_map, a * kAtom, h, q0, b, q_full);
        tma_load(s_do + off, &do_map, a * kAtom, h, q0, b, q_full);
        tma_load(s_o + off, &o_map, a * kAtom, h, q0, b, q_full);
      }
      for (int j = j_lo; j < j_hi; ++j) {
        if (j - j_lo < T::kOStages)
          mbar_wait(o_free, 0u);                // O has left the stage
        else
          mbar_wait(bar(1, j), parity(j) ^ 1u); // the stage's last use done
        mbar_arrive_expect_tx(bar(0, j), 2 * T::kKVBytes);
        for (int a = 0; a < T::kAtoms; ++a) {
          const int off = a * kBK * kAtomRow;
          tma_load(k_tile(j) + off, &k_map, a * kAtom, kvh, j * kBK, b,
                   bar(0, j));
          tma_load(v_tile(j) + off, &v_map, a * kAtom, kvh, j * kBK, b,
                   bar(0, j));
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<kConsumerRegs>();
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;
    const int tq = lane & 3;
    const int q0w = q0 + wg * kWGRows;                 // the warpgroup's
    const int r0 = q0w + 16 * warp + (lane >> 2);
    const uint32_t q_wg = s_q + wg * kWGRows * kAtomRow;
    const uint32_t do_wg = s_do + wg * kWGRows * kAtomRow;
    const long long stat = ((long long)b * H + h) * Sq;
    mbar_wait(q_full, 0u);

    // delta = rowsum(dO * O) of the warp's 16 rows: two lanes a row, each
    // half of every atom's 128-byte row (the swizzle moves a row's 16-byte
    // chunks alike in dO and O, and the columns past the head dim are 0)
    float dl[2], ls[2];
    {
      const int rr = wg * kWGRows + 16 * warp + (lane >> 1);
      const int half = lane & 1;
      float sum = 0.f;
#pragma unroll
      for (int a = 0; a < T::kAtoms; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int off = a * kRows * kAtomRow + rr * kAtomRow
                          + (4 * half + c) * 16;
          const uint4 x = *reinterpret_cast<const uint4*>(
              smem + T::kRing + off);
          const uint4 y = *reinterpret_cast<const uint4*>(smem + T::kDO + off);
          const uint32_t xw[4] = {x.x, x.y, x.z, x.w};
          const uint32_t yw[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            sum = fmaf(__uint_as_float(xw[i] << 16),
                       __uint_as_float(yw[i] << 16), sum);
            sum = fmaf(__uint_as_float(xw[i] & 0xffff0000u),
                       __uint_as_float(yw[i] & 0xffff0000u), sum);
          }
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
    __syncwarp();
    if (lane == 0) mbar_arrive(o_free);

    auto release = [&](int j) {
      if (lane == 0) mbar_arrive(bar(1, j));
    };
    // s becomes P, dp becomes dS / scale: P = exp2(S c - lse log2 e), zero
    // where masked.  Element 4i + e is row r0 + 8 (e >> 1), key
    // j kBK + 8 i + 2 tq + (e & 1)
    auto grad = [&](float (&s)[kBK / 2], float (&dp)[kBK / 2], int j) {
      const int k0 = j * kBK;
      const bool full = tile_full(q0w, kWGRows, k0, kBK, Sq, Sk, causal,
                                  window, q_off);
#pragma unroll
      for (int i = 0; i < kBK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hf = e >> 1;
          float p = exp2_approx(fmaf(s[4 * i + e], scale_log2, -ls[hf]));
          if (!full && !row_pair_valid(r0 + 8 * hf,
                                       k0 + 8 * i + 2 * tq + (e & 1), Sq,
                                       Sk, causal, window, q_off))
            p = 0.f;
          dp[4 * i + e] = p * (dp[4 * i + e] - dl[hf]);
        }
    };

    if (wg == 1) your_turn(wg);
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    if (j_lo < j_hi) {
      // tile j's S and dP are issued before tile j - 1's dQ product, and
      // its dS is formed while that product runs: S and dP of tile j and
      // dS of tile j - 1 are live together
      float s[kBK / 2], dp[kBK / 2];
      uint32_t ds[kBK / 16][4];
      mbar_wait(bar(0, j_lo), parity(j_lo));
      fence_regs(s);
      fence_regs(dp);
      my_turn(wg);
      wgmma_fence();
      issue_ss<D, kBK, kRows>(s, q_wg, k_tile(j_lo));
      issue_ss<D, kBK, kRows>(dp, do_wg, v_tile(j_lo));
      wgmma_commit();
      your_turn(wg);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      grad(s, dp, j_lo);
      pack_p<kBK>(dp, ds);
      for (int j = j_lo + 1; j < j_hi; ++j) {
        mbar_wait(bar(0, j), parity(j));
        fence_regs(s);
        fence_regs(dp);
        fence_regs(ds);
        fence_regs(acc);
        my_turn(wg);
        wgmma_fence();
        issue_ss<D, kBK, kRows>(s, q_wg, k_tile(j));
        issue_ss<D, kBK, kRows>(dp, do_wg, v_tile(j));
        wgmma_commit();
        issue_rs<D, kBK>(acc, ds, k_tile(j - 1));
        wgmma_commit();
        your_turn(wg);
        wgmma_wait<1>();                         // S, dP of tile j are in
        fence_regs(s);
        fence_regs(dp);
        grad(s, dp, j);
        wgmma_wait<0>();                         // dS K of tile j - 1 is in
        fence_regs(acc);
        fence_regs(ds);
        release(j - 1);
        pack_p<kBK>(dp, ds);
      }
      fence_regs(ds);
      fence_regs(acc);
      my_turn(wg);
      wgmma_fence();
      issue_rs<D, kBK>(acc, ds, k_tile(j_hi - 1));
      wgmma_commit();
      your_turn(wg);
      wgmma_wait<0>();
      fence_regs(acc);
      release(j_hi - 1);
    }

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int qp = r0 + 8 * hf;
      if (qp >= Sq) continue;
      __nv_bfloat16* row =
          dq + (((long long)b * Sq + qp) * H + h) * head_dim + 2 * tq;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        if (8 * i < head_dim)
          *reinterpret_cast<uint32_t*>(row + 8 * i) = pack_bf16(
              acc[4 * i + 2 * hf] * scale, acc[4 * i + 2 * hf + 1] * scale);
    }
  }
}

// ------------------------------------------------------- backward: dK, dV
// grid B KVH ceil(Sk / kRows) (1-d, see `group`); threads as dQ's.
// k_map, v_map: k, v (B, Sk, KVH, head_dim), box {64, 1, kRows, 1}; q_map,
// do_map: q, dout (B, Sq, H, head_dim), box {64, 1, kBQ, 1}; lse_map,
// delta_map: lse, delta (B H Sq f32) as 1-d maps, box kStatBox.  dk, dv
// (B, Sk, KVH, head_dim) bf16, contiguous.  Consumer warpgroup w owns keys
// [64 w, 64 w + 64) of the k tile and computes S^T = K Q^T and
// dP^T = V dO^T, so P^T and dS^T are already the A operands of
// dV += P^T dO and dK += dS^T Q.  kPass: both gradients, or only dV (no V,
// no dP^T, no delta) or only dK (see the header: D = 192).  A k tile that
// no row of this call sees (past q_off + Sq under a causal mask, before
// every row's window) loops over no q tile and writes zeros: dk, dv are
// not cleared, and under a sequence split each rank's are one term of a
// sum.
template <int D, int kPass>
__global__ void __launch_bounds__(kThreads, 1) flash_wgmma_bwd_dkdv(
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap do_map,
    const __grid_constant__ CUtensorMap lse_map,
    const __grid_constant__ CUtensorMap delta_map,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int B,
    int H, int KVH, int Sq, int Sk, int head_dim, int causal, int window,
    int q_off, int group, float scale_log2, float scale) {
  typedef KvTiles<D> T;
  constexpr int kStages = T::kStages;
  constexpr bool kDv = kPass != kDkPass, kDk = kPass != kDvPass;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t s_k = smem_u32(smem + T::kK);
  const uint32_t s_v = smem_u32(smem + T::kV);
  const uint32_t kv_full = smem_u32(smem + T::kBars);
  const int G = H / KVH;

  // block order: the (batch, kv head) pairs in groups of `group`, and in a
  // group the k tiles earliest (heaviest) first, each tile for every pair
  const int nk = (Sk + kRows - 1) / kRows;
  const int pairs = B * KVH;
  const int g0 = blockIdx.x / (group * nk) * group;
  const int size = min(group, pairs - g0);
  const int r = blockIdx.x - g0 * nk;
  const int t = r / size;
  const int pair = g0 + (r - t * size);
  const int b = pair / KVH, kvh = pair - b * KVH;
  const int k0 = t * kRows;

  // the q tiles [i_lo, i_hi) that see this k tile, for each of the G
  // heads: causal, rows at q_off + qp >= k0; window, rows at
  // q_off + qp <= window + k0 + kRows - 2
  const int nq = (Sq + kBQ - 1) / kBQ;
  const int i_lo = causal ? max(0, floor_div(k0 - q_off, kBQ)) : 0;
  const int i_hi = window > 0
      ? min(nq, floor_div(window + k0 + kRows - 2 - q_off, kBQ) + 1) : nq;
  const int n_i = max(0, i_hi - i_lo);
  const int n_it = G * n_i;
  // iteration `it`: head kvh G + it / n_i, q tile i_lo + it % n_i; its
  // stage, the parity of its use of the stage, its tiles and barriers
  // (0 full, 1 empty)
  auto head = [&](int it) { return kvh * G + it / n_i; };
  auto q_start = [&](int it) { return (i_lo + it % n_i) * kBQ; };
  // the element of lse and delta (B H Sq) of row qs of head hh
  auto stat_start = [&](int hh, int qs) {
    return (int)(((long long)b * H + hh) * Sq + qs);
  };
  auto stage = [&](int it) { return it % kStages; };
  auto parity = [&](int it) { return (uint32_t)(it / kStages) & 1u; };
  auto q_tile = [&](int it) {
    return smem_u32(smem + T::kRing + stage(it) * 2 * T::kQBytes);
  };
  auto do_tile = [&](int it) { return q_tile(it) + T::kQBytes; };
  auto bar = [&](int kind, int it) {
    return kv_full + 8u * (uint32_t)(1 + kind * kStages + stage(it));
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar(0, s), 1);                  // the producer's expect-tx
      mbar_init(bar(1, s), kConsumers * 4);     // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      mbar_arrive_expect_tx(kv_full, (kDk ? 2 : 1) * T::kKBytes);
      for (int a = 0; a < T::kAtoms; ++a) {
        const int off = a * kRows * kAtomRow;
        tma_load(s_k + off, &k_map, a * kAtom, kvh, k0, b, kv_full);
        if (kDk) tma_load(s_v + off, &v_map, a * kAtom, kvh, k0, b, kv_full);
      }
      for (int it = 0; it < n_it; ++it) {
        const int hh = head(it), qs = q_start(it);
        mbar_wait(bar(1, it), parity(it) ^ 1u);   // the stage's last use
        mbar_arrive_expect_tx(bar(0, it), 2 * T::kQBytes
                              + (kDk ? 2 : 1) * kStatBox * 4);
        for (int a = 0; a < T::kAtoms; ++a) {
          const int off = a * kBQ * kAtomRow;
          tma_load(q_tile(it) + off, &q_map, a * kAtom, hh, qs, b,
                   bar(0, it));
          tma_load(do_tile(it) + off, &do_map, a * kAtom, hh, qs, b,
                   bar(0, it));
        }
        // from the aligned element at or before the tile's first; rows
        // past Sq read the next head's (or, past the end, zeros): their
        // columns are masked
        const int c0 = stat_start(hh, qs) & ~3;
        tma_load_1d(smem_u32(smem + T::kLse + stage(it) * T::kStatBytes),
                    &lse_map, c0, bar(0, it));
        if (kDk)
          tma_load_1d(
              smem_u32(smem + T::kDelta + stage(it) * T::kStatBytes),
              &delta_map, c0, bar(0, it));
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<kConsumerRegs>();
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;
    const int tq = lane & 3;
    const int kw0 = k0 + wg * kWGRows;                 // the warpgroup's
    const int kr0 = kw0 + 16 * warp + (lane >> 2);
    const uint32_t k_wg = s_k + wg * kWGRows * kAtomRow;
    const uint32_t v_wg = s_v + wg * kWGRows * kAtomRow;
    auto release = [&](int it) {
      if (lane == 0) mbar_arrive(bar(1, it));
    };
    // a pass's unused accumulator is one register, never touched
    float dk_acc[kDk ? D / 2 : 1], dv_acc[kDv ? D / 2 : 1];
#pragma unroll
    for (int i = 0; i < (kDk ? D / 2 : 1); ++i) dk_acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (kDv ? D / 2 : 1); ++i) dv_acc[i] = 0.f;
    mbar_wait(kv_full, 0u);
    if (wg == 1) your_turn(wg);

    for (int it = 0; it < n_it; ++it) {
      const int q0 = q_start(it);
      const int skew = stat_start(head(it), q0) & 3;   // see kStatBox
      const float* ls = reinterpret_cast<const float*>(
          smem + T::kLse + stage(it) * T::kStatBytes) + skew;
      const float* dl = reinterpret_cast<const float*>(
          smem + T::kDelta + stage(it) * T::kStatBytes) + skew;
      // rows: keys, columns: q.  Element 4i + e is key kr0 + 8 (e >> 1),
      // q row q0 + 8 i + 2 tq + (e & 1)
      float s[kBQ / 2], dp[kBQ / 2];
      mbar_wait(bar(0, it), parity(it));
      fence_regs(s);
      if constexpr (kDk) fence_regs(dp);
      my_turn(wg);
      wgmma_fence();
      issue_ss<D, kBQ, kRows>(s, k_wg, q_tile(it));
      if constexpr (kDk) issue_ss<D, kBQ, kRows>(dp, v_wg, do_tile(it));
      wgmma_commit();
      your_turn(wg);
      wgmma_wait<0>();
      fence_regs(s);
      if constexpr (kDk) fence_regs(dp);

      // P^T = exp2(S^T c - lse log2 e), zero where masked, in s
      const bool full = tile_full(q0, kBQ, kw0, kWGRows, Sq, Sk, causal,
                                  window, q_off);
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
      }
      // dS^T / scale = P^T (dP^T - delta), in dp; both go to bf16 A
      // fragments before either product is issued (an in-flight product's
      // A registers are not to be read)
      uint32_t pa[kBQ / 16][4], da[kBQ / 16][4];
      if constexpr (kDk) {
#pragma unroll
        for (int i = 0; i < kBQ / 8; ++i) {
          const float dx = dl[8 * i + 2 * tq], dy = dl[8 * i + 2 * tq + 1];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[4 * i + e] = s[4 * i + e]
                            * (dp[4 * i + e] - ((e & 1) ? dy : dx));
        }
        pack_p<kBQ>(dp, da);
        fence_regs(da);
        fence_regs(dk_acc);
      }
      if constexpr (kDv) {
        pack_p<kBQ>(s, pa);
        fence_regs(pa);
        fence_regs(dv_acc);
      }
      wgmma_fence();
      if constexpr (kDv) issue_rs<D, kBQ>(dv_acc, pa, do_tile(it));
      if constexpr (kDk) issue_rs<D, kBQ>(dk_acc, da, q_tile(it));
      wgmma_commit();
      wgmma_wait<0>();
      if constexpr (kDk) {
        fence_regs(da);
        fence_regs(dk_acc);
      }
      if constexpr (kDv) {
        fence_regs(pa);
        fence_regs(dv_acc);
      }
      release(it);
    }

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int kp = kr0 + 8 * hf;
      if (kp >= Sk) continue;
      const long long off = (((long long)b * Sk + kp) * KVH + kvh) * head_dim
                            + 2 * tq;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        if (8 * i >= head_dim) continue;
        if constexpr (kDk)
          *reinterpret_cast<uint32_t*>(dk + off + 8 * i) =
              pack_bf16(dk_acc[4 * i + 2 * hf] * scale,
                        dk_acc[4 * i + 2 * hf + 1] * scale);
        if constexpr (kDv)
          *reinterpret_cast<uint32_t*>(dv + off + 8 * i) =
              pack_bf16(dv_acc[4 * i + 2 * hf], dv_acc[4 * i + 2 * hf + 1]);
      }
    }
  }
}

// ------------------------------------------------------------------ launch
struct BwdArgs {
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
  int B, Sq, Sk, H, KVH, head_dim;
  long long sq_b, sq_s, sq_h, sk_b, sk_s, sk_h, so_b, so_s, so_h, sd_b,
      sd_s, sd_h;
  int causal, window, q_off;
  cudaStream_t stream;
};

// pairs a group: as many whole pairs as kL2Budget holds when each streams
// `bytes` (at least one, at most all), or all of them when the grid of
// `blocks` is under kFewWaves waves of the card.  A group runs its
// heaviest tiles first, so a group that starts late ends late: with
// Qwen3-14B's 256 dK/dV blocks of 10 to 320 q tiles (5 heads of 2 to 64),
// groups of 3 pairs left the last group's heaviest tiles for a third wave
constexpr int kFewWaves = 4;

int l2_group(long long bytes, long long pairs, long long blocks) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) == cudaSuccess
      && cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
             == cudaSuccess
      && blocks <= (long long)kFewWaves * sms)
    return (int)pairs;
  const long long fit = kL2Budget / (bytes > 0 ? bytes : 1);
  return (int)(fit < 1 ? 1 : fit < pairs ? fit : pairs);
}

template <int D, int kPass>
cudaError_t dkdv_launch(const BwdArgs& a, const CUtensorMap& k_map,
                        const CUtensorMap& v_map, const CUtensorMap& q_map,
                        const CUtensorMap& do_map, const CUtensorMap& lse_map,
                        const CUtensorMap& delta_map, float scale_log2,
                        float scale) {
  typedef KvTiles<D> T;
  static unsigned int configured = 0u;
  const cudaError_t err = allow_smem(flash_wgmma_bwd_dkdv<D, kPass>,
                                     T::kBytes, configured);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)((a.Sk + kRows - 1) / kRows) * a.KVH * a.B;
  if (blocks > 0x7fffffffll) return cudaErrorInvalidValue;
  // (batch, kv head) pairs a group: their G heads' Q and dO stream
  const int G = a.H / a.KVH;
  const int group = l2_group((long long)G * a.Sq * a.head_dim * 4,
                             (long long)a.B * a.KVH, blocks);
  flash_wgmma_bwd_dkdv<D, kPass>
      <<<(unsigned)blocks, kThreads, T::kBytes, a.stream>>>(
          k_map, v_map, q_map, do_map, lse_map, delta_map,
          (__nv_bfloat16*)a.dk, (__nv_bfloat16*)a.dv, a.B, a.H, a.KVH, a.Sq,
          a.Sk, a.head_dim, a.causal, a.window, a.q_off, group, scale_log2,
          scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_launch(const BwdArgs& a) {
  typedef DqTiles<D> T;
  static unsigned int configured = 0u;
  cudaError_t err = allow_smem(flash_wgmma_bwd_dq<D>, T::kBytes, configured);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)a.head_dim);
  const float scale_log2 = kLog2e * scale;
  const long long n_stat = (long long)a.B * a.H * a.Sq;
  CUtensorMap q_map = {}, do_map = {}, o_map = {}, k_map = {}, v_map = {};
  if (!tile_map(&q_map, a.q, a.B, a.Sq, a.H, a.head_dim, kRows, a.sq_b,
                a.sq_s, a.sq_h)
      || !tile_map(&do_map, a.dout, a.B, a.Sq, a.H, a.head_dim, kRows,
                   a.sd_b, a.sd_s, a.sd_h)
      || !tile_map(&o_map, a.o, a.B, a.Sq, a.H, a.head_dim, kRows, a.so_b,
                   a.so_s, a.so_h)
      || !tile_map(&k_map, a.k, a.B, a.Sk, a.KVH, a.head_dim, T::kBK,
                   a.sk_b, a.sk_s, a.sk_h)
      || !tile_map(&v_map, a.v, a.B, a.Sk, a.KVH, a.head_dim, T::kBK,
                   a.sk_b, a.sk_s, a.sk_h))
    return cudaErrorInvalidValue;
  const long long blocks = (long long)((a.Sq + kRows - 1) / kRows) * a.H
                           * a.B;
  if (blocks > 0x7fffffffll) return cudaErrorInvalidValue;
  // (batch, head) pairs a group: whole KV heads' K and V stream
  const int G = a.H / a.KVH;
  const long long kv_group = l2_group((long long)a.Sk * a.head_dim * 4,
                                      (long long)a.B * a.KVH, blocks);
  const int group = (int)(kv_group * G);
  flash_wgmma_bwd_dq<D><<<(unsigned)blocks, kThreads, T::kBytes, a.stream>>>(
      q_map, do_map, o_map, k_map, v_map, a.lse, a.delta,
      (__nv_bfloat16*)a.dq, a.B, a.H, a.Sq, a.Sk, G, a.head_dim, a.causal,
      a.window, a.q_off, group, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  CUtensorMap kk_map = {}, vv_map = {}, qq_map = {}, dd_map = {},
              lse_map = {}, delta_map = {};
  if (!tile_map(&kk_map, a.k, a.B, a.Sk, a.KVH, a.head_dim, kRows, a.sk_b,
                a.sk_s, a.sk_h)
      || !tile_map(&vv_map, a.v, a.B, a.Sk, a.KVH, a.head_dim, kRows, a.sk_b,
                   a.sk_s, a.sk_h)
      || !tile_map(&qq_map, a.q, a.B, a.Sq, a.H, a.head_dim, kBQ, a.sq_b,
                   a.sq_s, a.sq_h)
      || !tile_map(&dd_map, a.dout, a.B, a.Sq, a.H, a.head_dim, kBQ, a.sd_b,
                   a.sd_s, a.sd_h)
      || !vec_map(&lse_map, a.lse, n_stat, kStatBox)
      || !vec_map(&delta_map, a.delta, n_stat, kStatBox))
    return cudaErrorInvalidValue;
  if constexpr (D > 128) {        // two passes (see the header)
    err = dkdv_launch<D, kDvPass>(a, kk_map, vv_map, qq_map, dd_map, lse_map,
                                  delta_map, scale_log2, scale);
    if (err != cudaSuccess) return err;
    return dkdv_launch<D, kDkPass>(a, kk_map, vv_map, qq_map, dd_map,
                                   lse_map, delta_map, scale_log2, scale);
  } else {
    return dkdv_launch<D, kBothPass>(a, kk_map, vv_map, qq_map, dd_map,
                                     lse_map, delta_map, scale_log2, scale);
  }
}

// with a causal mask or a window, the rows q_off .. q_off + Sq - 1 lie
// inside the Sk keys (see the header); lse and delta are addressed as one
// vector of B H Sq elements with 32-bit coordinates
bool shapes_ok(int B, int Sq, int Sk, int H, int KVH, int causal, int window,
               int q_off) {
  return B > 0 && B <= 65535 && Sq > 0 && Sk > 0
         && (Sq + kRows - 1) / kRows <= 65535
         && (Sk + kRows - 1) / kRows <= 65535 && q_off >= 0
         && ((!causal && window <= 0) || (long long)q_off + Sq <= Sk)
         && H > 0 && H <= 65535 && KVH > 0 && H % KVH == 0
         && (long long)B * H * Sq <= 0x7fffffffll;
}

}  // namespace

// Gradients of repro_flash_attention_tc_fwd (flash_attention_wgmma.cu) and
// of repro_flash_decode_fwd, bf16.  q, o, dout (B, Sq, H, D) and k, v
// (B, Sk, KVH, D) are read through their element strides (batch, seq,
// head; unit stride over D; 16-byte aligned base, strides multiples of 8
// elements; k and v share strides), as the forward reads q, k, v; lse (the
// forward's) and delta (scratch) (B, H, Sq) f32 with a 16-byte aligned
// base; dq (B, Sq, H, D), dk, dv (B, Sk, KVH, D) contiguous.  Two launches
// on `stream` (three at D = 192): dQ, which also writes delta, then dK/dV.
// q_off as the forward's.  Returns the cudaError_t of the launches (0 on
// success); nothing is synchronised.
extern "C" int repro_flash_attention_tc_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int H, int KVH, int D,
    long long sq_b, long long sq_s, long long sq_h,
    long long sk_b, long long sk_s, long long sk_h,
    long long so_b, long long so_s, long long so_h,
    long long sd_b, long long sd_s, long long sd_h,
    int causal, int window, int q_off, void* stream) {
  if (!shapes_ok(B, Sq, Sk, H, KVH, causal, window, q_off))
    return (int)cudaErrorInvalidValue;
  const BwdArgs args = {q, k, v, o, dout, (const float*)lse, (float*)delta,
                        dq, dk, dv, B, Sq, Sk, H, KVH, D,
                        sq_b, sq_s, sq_h, sk_b, sk_s, sk_h,
                        so_b, so_s, so_h, sd_b, sd_s, sd_h,
                        causal, window, q_off, (cudaStream_t)stream};
  // the instance of a head dim (flash_attention.py's `bwd_instance`)
  switch (D) {
    case 16:
    case 32:
    case 48:
    case 64: return (int)bwd_launch<64>(args);
    case 80:
    case 96:
    case 112:
    case 128: return (int)bwd_launch<128>(args);
    case 192: return (int)bwd_launch<192>(args);
    default: return (int)cudaErrorInvalidValue;
  }
}

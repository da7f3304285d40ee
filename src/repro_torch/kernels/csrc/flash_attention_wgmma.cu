// Flash attention's bf16 forward on the tensor cores of NVIDIA Hopper
// (sm_90a): wgmma on tiles that the Tensor Memory Accelerator copies into
// shared memory, one producer warp and two consumer warpgroups.  The
// forward of every bf16 call of more than DECODE_MAX_ROWS query rows
// (flash_attention.py's `forward_entry`; flash_decode.cu takes the few-row
// calls, flash_attention_wgmma_bwd.cu holds the bf16 backward).
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
// natural log, which the backward kernels of flash_attention_wgmma_bwd.cu
// take.
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

#include <math.h>

#include "flash_mask.cuh"
#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kConsumers = 2;                 // consumer warpgroups
constexpr int kWGRows = 64;                   // query rows a warpgroup
constexpr int kBQ = kConsumers * kWGRows;     // query rows a block
constexpr int kThreads = (kConsumers + 1) * 128;   // + the producer's
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

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
    setmaxnreg_dec<kProducerRegs>();
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
    setmaxnreg_inc<kConsumerRegs>();
    const int lane = threadIdx.x & 31;
    const int tq = lane & 3;
    const int q0w = q0 + wg * kWGRows;                 // the warpgroup's
    const int r0 = q0w + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    const uint32_t q_wg = s_q + wg * kWGRows * kAtomRow;
    // both warpgroups compute on every tile of the block's (a row that
    // sees no key of a tile takes p = 0 there), and take turns to issue
    // their products (my_turn / your_turn): one's softmax runs while the
    // other's products do
    auto release = [&](int j) {
      if (lane == 0) mbar_arrive(bar(2, j));
    };
    if (wg == 1) your_turn(wg);
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
      my_turn(wg);
      wgmma_fence();
      issue_ss<D, kBK, kBQ>(sc, q_wg, k_tile(j_lo));
      wgmma_commit();
      your_turn(wg);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax(sc, m, l, corr, j_lo);            // acc is 0: nothing to scale
      pack_p<kBK>(sc, pa);
      for (int j = j_lo + 1; j < j_hi; ++j) {
        mbar_wait(bar(0, j), parity(j));
        fence_regs(sc);
        fence_regs(pa);
        fence_regs(acc);
        my_turn(wg);
        wgmma_fence();
        issue_ss<D, kBK, kBQ>(sc, q_wg, k_tile(j));
        wgmma_commit();
        mbar_wait(bar(1, j - 1), parity(j - 1));
        issue_rs<D, kBK>(acc, pa, v_tile(j - 1));
        wgmma_commit();
        your_turn(wg);
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
      my_turn(wg);
      wgmma_fence();
      issue_rs<D, kBK>(acc, pa, v_tile(j_hi - 1));
      wgmma_commit();
      your_turn(wg);
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
  const cudaError_t err = allow_smem(flash_wgmma_fwd<D>, T::kBytes,
                                     configured);
  if (err != cudaSuccess) return err;
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

// Flash attention's forward for calls of a few query rows (decode: one row
// per sequence over a long context), on NVIDIA Hopper (sm_90a): split-KV over
// a thread-block cluster, fed by a ring of 2-D bulk tensor copies.
//
// Replaces, for calls of at most DECODE_MAX_ROWS query rows
// (flash_attention.py's `forward_entry`), the TPU kernel
// `flash_attention_kernel` / `_kernel` of
// src/repro/kernels/flash_attention/flash_attention.py:79: q (B, Sq, H, D)
// attends to k, v (B, Sk, KVH, D), query head h reading KV head h / G, the
// rows at absolute positions q_off .. q_off + Sq - 1, masked by
// flash_mask.cuh's predicate (causal, window, k_pos < Sk).  Same function
// and outputs as flash_attention.cu and flash_attention_wgmma.cu: o in q's
// dtype and the per-row logsumexp lse (B, H, Sq) in f32, which the backward
// kernels of either route take unchanged.  Same arithmetic: f32 online
// softmax (in base 2: log2(e) / sqrt(D) is folded into q's scale), masked
// scores are -1e30 (finite), the result is divided by max(l, 1e-30).
//
// What bounds it on this card: bytes.  Each KV head's K and V rows are read
// once for all the G * Sq query rows that read them, Sk * KVH * D * 2
// elements a sequence, against 2 * G * Sq * D multiply-adds a K/V row pair:
// at Whisper's decode (G = 1, Sq = 1) two orders of magnitude below the
// ~295 operations per byte where the tensor cores would become the limit.
// So the products stay on the CUDA cores in f32, and the design keeps bytes
// in flight on every SM.  The mma.sync tile kernel before it tiled 128
// query rows by 128 keys with a grid (H, B, ceil(Sq / 128)): at Sq = 1 that
// is one block per query head (64 blocks on 132 SMs at Whisper's B = 4),
// each streaming all of its head's keys, 127 of its 128 mma rows padding:
// 0.041 ms there on an
// H100 at 700 W against a 0.00734 ms bound (24.6 MB of K and V), where this
// kernel takes 0.0089 ms.
//
// What the design does about it (after paged_attention.cu, which has run it
// on the card since its redesign):
//  * split-KV over a cluster: grid (N, KVH * row groups, B), cluster dims
//    (N, 1, 1).  Block r of a cluster takes the r-th of N equal shares, in
//    tiles, of the keys its rows can see ([first, end) from q_off, Sq, the
//    causal mask and the window); a share that lies past the end loads
//    nothing.  N comes from shapes alone (`decode_plan` in
//    flash_attention.py), so that B * KVH * N fills the card;
//  * one block holds all the G * Sq rows of its KV head (up to kMaxRows,
//    else several row groups), so K and V are read once per KV head, not
//    once per query head;
//  * a ring of kStages stages of kTile key rows of K and of V in shared
//    memory, filled by one producer lane with bulk tensor copies
//    (cp.async.bulk.tensor, completion on a "full" mbarrier with expect-tx)
//    through two tensor maps that describe k and v in the model layout
//    (B, Sk, KVH, D) by their strides: one head's key rows are KVH * D
//    elements apart, and one copy moves a whole stage (kTile rows, 16 KB at
//    Whisper's D = 64).  Rows past Sk are zero-filled by the copy; consumer
//    warps arrive on an "empty" mbarrier when done with a stage;
//  * consumers split the keys of a stage (8 a warp: 16 consumer warps in
//    bf16, whose stages are 128 rows, 4 in f32's 32) and accumulate every row
//    of the block (kR, a template parameter); for the scores eight lanes
//    share a key and keep their eighth of each row's q in registers; the
//    softmax runs one row a lane (lane `part` of each group of eight), the
//    probabilities go through shared memory to P.V, where lane t owns D / 32
//    columns of every row.  A score that the mask drops is replaced by a
//    select, its probability by another (never exp of -1e30 - -1e30);
//  * the partials are combined inside the cluster, not by a second kernel:
//    the warps' in warp order, then, after a cluster barrier, rank 0 reads
//    the other blocks' (m, l, acc) through distributed shared memory in rank
//    order, rescales by exp2(m_r - M), and writes o and lse.  One launch per
//    call, no scratch in device memory, no atomics: two calls give
//    identical bits.
//
// Sizes, chosen by timing at Whisper's decode on an H100 (PERF.md): a bf16
// stage is 128 key rows (16 consumer warps; 64-row stages with 8 warps and
// two blocks an SM were slower), the ring 4 stages (8 bought nothing; fewer
// where the ring would pass 192 KB), and the stages are copied by the
// tensor maps (the producer warp's 16-byte cp.async row copies were
// slower).
//
// Head dims: instances for D = 16, 32, 64, 128 and 192; 48 runs the 64
// instance, 80, 96 and 112 the 128 one.  The tensor maps carry the true D
// and a box as wide as the instance, so the copy zero-fills the columns past
// D; q is zero-padded the same way, and the columns past D are never
// written.  Rows a block (kMaxRows, the q slices in registers without
// spills): bf16 4 at D <= 64, 2 above; f32 8 and 4.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mask.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kKeys = 8;           // keys of a stage a consumer warp owns
constexpr int kParts = 8;          // lanes sharing a key for the scores
constexpr int kGroups = 32 / kParts;   // keys a warp scores at once
constexpr int kPasses = kKeys / kGroups;
constexpr int kMaxSplits = 8;      // the portable cluster size
constexpr int kMaxSharedBytes = 232448;
constexpr int kRingBudget = 196608;    // the ring's share of shared memory
constexpr int kMaxStages = 4;          // stages of the ring where they fit

// rows a block holds at most (kMaxRows): more q slices would spill (a bf16
// block's 544 threads leave 96 registers a thread)
template <typename T, int D> struct RowsPerBlock {
  static constexpr int kMax = sizeof(T) == 2 ? (D <= 64 ? 4 : 2)
                                             : (D <= 64 ? 8 : 4);
};

// kN raw elements read as one vector: aligned to the largest power of two
// that divides its size (12 bytes, bf16 P.V columns at D = 192: 4)
template <typename Raw, int kN>
struct alignas(sizeof(Raw) * kN & -(sizeof(Raw) * kN)) RawVec { Raw e[kN]; };

template <typename T> struct Elem;

template <> struct Elem<float> {
  typedef float Raw;
  static constexpr int kTile = 32;
  static constexpr CUtensorMapDataType kMapType =
      CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  __device__ static __forceinline__ float to_float(float r) { return r; }
  __device__ static __forceinline__ float load(const float* p) { return *p; }
  __device__ static __forceinline__ float from_float(float x) { return x; }
};

template <> struct Elem<__nv_bfloat16> {
  typedef unsigned short Raw;
  static constexpr int kTile = 128;
  static constexpr CUtensorMapDataType kMapType =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  __device__ static __forceinline__ float to_float(unsigned short r) {
    return __uint_as_float(static_cast<unsigned int>(r) << 16);
  }
  __device__ static __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static __forceinline__ __nv_bfloat16 from_float(float x) {
    return __float2bfloat16(x);
  }
};

// Byte offsets into the block's dynamic shared memory.  The warps'
// partials reuse the ring once every stage is consumed.
template <typename T, int D, int kR>
struct Layout {
  static constexpr int kTile = Elem<T>::kTile;
  static constexpr int kWarps = kTile / kKeys;           // consumer warps
  static constexpr int kThreads = (kWarps + 1) * 32;     // + the producer
  static constexpr int kRowBytes = D * (int)sizeof(T);
  static constexpr int kStageBytes = kTile * kRowBytes;  // K (or V) of one
  static constexpr int kStages =
      kMaxStages * 2 * kStageBytes <= kRingBudget
          ? kMaxStages : kRingBudget / (2 * kStageBytes);
  static constexpr int kRing = 2 * kStages * kStageBytes;  // K, then V
  static constexpr int kWarpAcc = 0;              // f32 [W][kR][D], in ring
  static constexpr int kWarpML = kWarpAcc + kWarps * kR * D * 4;  // [W][kR][2]
  static constexpr int kQ = kRing;                // f32 [kR][D]
  static constexpr int kBlockAcc = kQ + kR * D * 4;        // f32 [kR][D]
  static constexpr int kBlockML = kBlockAcc + kR * D * 4;  // f32 [kR][2]
  static constexpr int kP = kBlockML + ((kR * 2 * 4 + 15) / 16) * 16;
  // f32 [W][kKeys][8]: a warp's probabilities of a stage, for P.V
  static constexpr int kBars = kP + kWarps * kKeys * 8 * 4;
  static constexpr int kBytes = kBars + 2 * kStages * 8;   // full, empty
  static_assert(kWarpML + kWarps * kR * 2 * 4 <= kRing, "partials fit");
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

// one box {D, 1, kTile, 1} of k or v (key rows t0 .. t0 + kTile - 1 of head
// kvh of sequence b) -> this block's shared memory, completion on `bar`;
// coordinates innermost first
__device__ __forceinline__ void bulk_copy_tile(uint32_t dst,
                                               const CUtensorMap* map,
                                               int kvh, int t0, int b,
                                               uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(kvh),
         "r"(t0), "r"(b), "r"(bar)
      : "memory");
}

// grid (N, KVH * row_groups, B), cluster (N, 1, 1), block kThreads.  D is
// the instance's (shared-memory) head dim, head_dim <= D the tensors'.
// q (B, Sq, H, head_dim) with element strides (sq_b, sq_s, sq_h); o
// (B, Sq, H, head_dim) and lse (B, H, Sq) contiguous.  k_map, v_map: k and
// v (B, Sk, KVH, head_dim) as 4-d tensor maps, box {D, 1, kTile, 1}.  The
// rows of KV head kvh are rr = 0 .. G * Sq - 1, query head kvh * G + rr / Sq
// at position q_off + rr % Sq; row group rg holds rr = rg * kR + r.
template <typename T, int D, int kR>
__global__ void __launch_bounds__(Layout<T, D, kR>::kThreads, 1)
flash_decode_kernel(
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const T* __restrict__ q,
    const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
    float* __restrict__ lse, int Sq, int Sk, int H, int G, int head_dim,
    long long sq_b, long long sq_s, long long sq_h, long long sk_b,
    long long sk_s, long long sk_h, int causal, int window, int q_off,
    float scale) {
  typedef Layout<T, D, kR> L;
  typedef typename Elem<T>::Raw Raw;
  constexpr int kTile = L::kTile;
  constexpr int kWarps = L::kWarps;
  constexpr int kThreads = L::kThreads;
  constexpr int kStages = L::kStages;
  constexpr int kSlice = D / kParts;             // elements of a row a lane
  constexpr int kVecBytes =
      kSlice * (int)sizeof(T) < 16 ? kSlice * (int)sizeof(T) : 16;
  constexpr int kVec = kVecBytes / (int)sizeof(T);
  constexpr int kChunks = kSlice / kVec;         // a lane's chunks of a row
  constexpr int kCols = D >= 32 ? D / 32 : 1;    // P.V columns a lane
  static_assert(kTile % kKeys == 0 && kWarps >= 1, "tile");
  static_assert(D % kParts == 0 && kSlice % kVec == 0, "slice of a row");
  static_assert(kR <= kParts, "one row a lane in the softmax");

  extern __shared__ __align__(128) unsigned char smem[];
  float* q_sm = reinterpret_cast<float*>(smem + L::kQ);
  float* warp_acc = reinterpret_cast<float*>(smem + L::kWarpAcc);
  float* warp_ml = reinterpret_cast<float*>(smem + L::kWarpML);
  float* block_acc = reinterpret_cast<float*>(smem + L::kBlockAcc);
  float* block_ml = reinterpret_cast<float*>(smem + L::kBlockML);
  float* p_sm = reinterpret_cast<float*>(smem + L::kP);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  // full[s] = bars[s], empty[s] = bars[kStages + s]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_splits = (int)cluster.num_blocks();
  const int R = G * Sq;                           // rows of a KV head
  const int row_groups = (R + kR - 1) / kR;
  const int kvh = blockIdx.y / row_groups;
  const int r0 = (blockIdx.y - kvh * row_groups) * kR;
  const int rcount = R - r0 < kR ? R - r0 : kR;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // the block's rows: absolute position of row r (rows past rcount: -1,
  // which sees no key), and the keys any of them sees, [first, end)
  int qa[kR];
  int pos_lo = q_off + Sq, pos_hi = -1;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    qa[r] = r < rcount ? q_off + (r0 + r) % Sq : -1;
    if (r < rcount) {
      pos_lo = min(pos_lo, qa[r]);
      pos_hi = max(pos_hi, qa[r]);
    }
  }
  const int end = causal ? min(Sk, pos_hi + 1) : Sk;
  const int first = window > 0 ? max(0, pos_lo - window + 1) : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(bars + s), 1);      // the producer's expect-tx
      mbar_init(smem_u32(bars + kStages + s), kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // this block's share of [first, end), in whole tiles
  const int t_start = (first / kTile) * kTile;
  const int n_tiles = end > t_start ? (end - t_start + kTile - 1) / kTile : 0;
  const int per = (n_tiles + n_splits - 1) / n_splits;
  const int tile_lo = rank * per < n_tiles ? rank * per : n_tiles;
  const int tile_hi = tile_lo + per < n_tiles ? tile_lo + per : n_tiles;

  // consumers: the P.V accumulators of every row, and the running max and
  // sum of one row (lane `part` of each group of kParts lanes: row `part`)
  float acc[kR][kCols];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  float m_own = kNegInf, l_own = 0.f;

  if (warp == kWarps) {
    // ------------------------------------------------------------ producer
    if (lane == 0) {
      for (int i = tile_lo; i < tile_hi; ++i) {
        const int kk = i - tile_lo;
        const int s = kk % kStages;
        const uint32_t round = (uint32_t)(kk / kStages);
        mbar_wait(smem_u32(bars + kStages + s), (round & 1u) ^ 1u);
        const uint32_t full = smem_u32(bars + s);
        // the whole box counts, its zero-filled rows past Sk too
        mbar_arrive_expect_tx(full, 2u * (uint32_t)L::kStageBytes);
        const int t0 = t_start + i * kTile;
        bulk_copy_tile(smem_u32(smem + s * L::kStageBytes), &k_map, kvh, t0,
                       b, full);
        bulk_copy_tile(smem_u32(smem + (kStages + s) * L::kStageBytes),
                       &v_map, kvh, t0, b, full);
      }
    }
    __syncwarp();
  } else {
    // ----------------------------------------------------------- consumers
    // scores: the lanes of a group of kParts share a key; lane `part` owns
    // the 16-byte chunks part, part + kParts, ... of every row, so a
    // group's reads of one row are consecutive, and its slice of q for
    // every row stays in registers
    // q, scaled, staged by the consumer warps while the first copies fly
    for (int i = threadIdx.x; i < kR * D; i += kWarps * 32) {
      const int r = i / D;
      const int d = i - r * D;
      float x = 0.f;
      if (r < rcount && d < head_dim) {
        const int rr = r0 + r;
        const int g = rr / Sq;
        x = Elem<T>::load(q + b * sq_b + (long long)(rr - g * Sq) * sq_s
                          + (long long)(kvh * G + g) * sq_h + d) * scale;
      }
      q_sm[i] = x;
    }
    asm volatile("bar.sync 1, %0;" :: "r"(kWarps * 32) : "memory");
    const int grp = lane / kParts;
    const int part = lane % kParts;
    const int col = lane * kCols < D ? lane * kCols : 0;   // D == 16: half
    int qa_own = qa[0];
#pragma unroll
    for (int r = 1; r < kR; ++r)
      if (part == r) qa_own = qa[r];
    float qr[kR][kSlice];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          qr[r][c * kVec + e] = q_sm[r * D + (part + kParts * c) * kVec + e];
    for (int i = tile_lo; i < tile_hi; ++i) {
      const int kk = i - tile_lo;
      const int s = kk % kStages;
      const uint32_t round = (uint32_t)(kk / kStages);
      mbar_wait(smem_u32(bars + s), round & 1u);
      const int kp0 = t_start + i * kTile + warp * kKeys;   // warp's keys
      if (kp0 < end && kp0 + kKeys > first) {
        // every lane computes; a masked pair is dropped by a select
        float sc[kPasses][kR];
        const unsigned char* kbase = smem + s * L::kStageBytes
            + warp * kKeys * L::kRowBytes;
#pragma unroll
        for (int ps = 0; ps < kPasses; ++ps) {
          const unsigned char* krow =
              kbase + (ps * kGroups + grp) * L::kRowBytes;
#pragma unroll
          for (int r = 0; r < kR; ++r) sc[ps][r] = 0.f;
#pragma unroll
          for (int c = 0; c < kChunks; ++c) {
            const RawVec<Raw, kVec> kv = *reinterpret_cast<
                const RawVec<Raw, kVec>*>(krow + (part + kParts * c)
                                          * kVecBytes);
#pragma unroll
            for (int e = 0; e < kVec; ++e) {
              const float kf = Elem<T>::to_float(kv.e[e]);
#pragma unroll
              for (int r = 0; r < kR; ++r)
                sc[ps][r] = fmaf(qr[r][c * kVec + e], kf, sc[ps][r]);
            }
          }
          const int kp = kp0 + ps * kGroups + grp;
#pragma unroll
          for (int r = 0; r < kR; ++r) {
#pragma unroll
            for (int o_ = 1; o_ < kParts; o_ <<= 1)
              sc[ps][r] += __shfl_xor_sync(0xffffffffu, sc[ps][r], o_);
            if (!(qa[r] >= 0 && pair_valid(qa[r], kp, Sk, causal, window)))
              sc[ps][r] = kNegInf;
          }
        }
        // softmax in base 2 (q carries log2(e)), one row a lane: lane
        // `part` of each group keeps the running max and sum of row `part`
        // over its group's keys; each key's probabilities go to shared
        // memory, where every lane reads them for P.V
        float* p_warp = p_sm + warp * kKeys * 8;   // [key][row]
        float own[kPasses];
#pragma unroll
        for (int ps = 0; ps < kPasses; ++ps) {
          own[ps] = sc[ps][0];
#pragma unroll
          for (int r = 1; r < kR; ++r)
            if (part == r) own[ps] = sc[ps][r];
        }
        float mt = own[0];
#pragma unroll
        for (int ps = 1; ps < kPasses; ++ps) mt = fmaxf(mt, own[ps]);
#pragma unroll
        for (int o_ = kParts; o_ < 32; o_ <<= 1)
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o_));
        float corr = 1.f;
        const bool moved = mt > m_own;
        if (moved) {
          corr = exp2f(m_own - mt);
          l_own *= corr;
          m_own = mt;
        }
        if (__any_sync(0xffffffffu, moved)) {   // a row's max moved
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            const float cr = __shfl_sync(0xffffffffu, corr, r);
#pragma unroll
            for (int c = 0; c < kCols; ++c) acc[r][c] *= cr;
          }
        }
#pragma unroll
        for (int ps = 0; ps < kPasses; ++ps) {
          const bool valid = qa_own >= 0 && pair_valid(
              qa_own, kp0 + ps * kGroups + grp, Sk, causal, window);
          const float pv = valid ? exp2f(own[ps] - m_own) : 0.f;
          if (part < kR) p_warp[(ps * kGroups + grp) * 8 + part] = pv;
          l_own += pv;
        }
        __syncwarp();
        // P.V over the warp's keys (a masked key's p is 0; its V row is the
        // tensor's own or the copy's zero fill, so finite)
        const unsigned char* vbase = smem + (kStages + s) * L::kStageBytes
            + warp * kKeys * L::kRowBytes + col * (int)sizeof(T);
#pragma unroll
        for (int t = 0; t < kKeys; ++t) {
          const RawVec<Raw, kCols> vv = *reinterpret_cast<
              const RawVec<Raw, kCols>*>(vbase + t * L::kRowBytes);
          float vf[kCols];
#pragma unroll
          for (int c = 0; c < kCols; ++c) vf[c] = Elem<T>::to_float(vv.e[c]);
          float pr[kR];
#pragma unroll
          for (int r = 0; r + 4 <= kR; r += 4) {
            const float4 p4 = *reinterpret_cast<const float4*>(
                p_warp + t * 8 + r);
            pr[r] = p4.x; pr[r + 1] = p4.y; pr[r + 2] = p4.z; pr[r + 3] = p4.w;
          }
#pragma unroll
          for (int r = kR / 4 * 4; r < kR; ++r) pr[r] = p_warp[t * 8 + r];
#pragma unroll
          for (int r = 0; r < kR; ++r) {
#pragma unroll
            for (int c = 0; c < kCols; ++c)
              acc[r][c] = fmaf(pr[r], vf[c], acc[r][c]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(bars + kStages + s));
    }
  }
  __syncthreads();         // every stage is consumed: the ring is free

  if (warp < kWarps) {     // this warp's partial
#pragma unroll
    for (int o_ = kParts; o_ < 32; o_ <<= 1)      // row `part`'s sum
      l_own += __shfl_xor_sync(0xffffffffu, l_own, o_);
    if (lane < kR) {
      warp_ml[(warp * kR + lane) * 2] = m_own;
      warp_ml[(warp * kR + lane) * 2 + 1] = l_own;
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = lane * kCols + c;
        if (d < D) warp_acc[(warp * kR + r) * D + d] = acc[r][c];
      }
    }
  }
  __syncthreads();

  // the block's partial: its warps combined in warp order
  for (int i = threadIdx.x; i < rcount * head_dim; i += kThreads) {
    const int r = i / head_dim;
    const int d = i - r * head_dim;
    float M = kNegInf;
    for (int w = 0; w < kWarps; ++w)
      M = fmaxf(M, warp_ml[(w * kR + r) * 2]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(warp_ml[(w * kR + r) * 2] - M);
      lsum += warp_ml[(w * kR + r) * 2 + 1] * f;
      a += warp_acc[(w * kR + r) * D + d] * f;
    }
    block_acc[r * D + d] = a;
    if (d == 0) {
      block_ml[2 * r] = M;
      block_ml[2 * r + 1] = lsum;
    }
  }
  cluster.sync();          // every block's partial is written

  if (rank == 0) {         // the cluster's result: ranks in order
    for (int i = threadIdx.x; i < rcount * head_dim; i += kThreads) {
      const int r = i / head_dim;
      const int d = i - r * head_dim;
      float M = kNegInf;
      for (int rk = 0; rk < n_splits; ++rk)
        M = fmaxf(M, cluster.map_shared_rank(block_ml, rk)[2 * r]);
      float lsum = 0.f, a = 0.f;
      for (int rk = 0; rk < n_splits; ++rk) {
        const float* ml = cluster.map_shared_rank(block_ml, rk);
        const float f = exp2f(ml[2 * r] - M);
        lsum += ml[2 * r + 1] * f;
        a += cluster.map_shared_rank(block_acc, rk)[r * D + d] * f;
      }
      const int rr = r0 + r;
      const int g = rr / Sq;
      const int qi = rr - g * Sq;
      const int h = kvh * G + g;
      o[(((long long)b * Sq + qi) * H + h) * head_dim + d] =
          Elem<T>::from_float(a / fmaxf(lsum, 1e-30f));
      if (d == 0)
        lse[((long long)b * H + h) * Sq + qi] = (M + log2f(lsum)) * kLn2;
    }
  }
  cluster.sync();          // no block leaves while rank 0 reads its memory
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

// k or v (B, Sk, KVH, head_dim) with element strides (sb, ss, sh, 1) as a
// 4-d map (innermost first) whose box is kTile key rows of one head, `box_d`
// >= head_dim columns wide (the columns past head_dim, and the rows past
// Sk, are out of bounds: the copy writes zeros there)
template <typename T>
bool kv_map(CUtensorMap* map, const void* t, int B, int Sk, int KVH,
            int head_dim, int box_d, long long sb, long long ss, long long sh) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t es = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)head_dim, (cuuint64_t)KVH,
                              (cuuint64_t)Sk, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * es, (cuuint64_t)ss * es,
                                 (cuuint64_t)sb * es};
  const cuuint32_t box[4] = {(cuuint32_t)box_d, 1u,
                             (cuuint32_t)Elem<T>::kTile, 1u};
  const cuuint32_t elem[4] = {1u, 1u, 1u, 1u};
  return fn(map, Elem<T>::kMapType, 4, const_cast<void*>(t), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D, int kR>
using KernelFn = void (*)(const CUtensorMap, const CUtensorMap, const T*,
                          const T*, const T*, T*, float*, int, int, int, int,
                          int, long long, long long, long long, long long,
                          long long, long long, int, int, int, float);

// the instance's dynamic shared memory, set once per device
template <typename T, int D, int kR>
cudaError_t prepare(KernelFn<T, D, kR>* kern) {
  typedef Layout<T, D, kR> L;
  *kern = flash_decode_kernel<T, D, kR>;
  static unsigned int configured = 0u;        // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32 || !((configured >> dev) & 1u)) {
    err = cudaFuncSetAttribute(*kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::kBytes);
    if (err != cudaSuccess) return err;
    if (dev < 32) configured |= 1u << dev;
  }
  return cudaSuccess;
}

template <typename T, int D, int kR>
cudaLaunchConfig_t cluster_config(int grid_y, int grid_z, int n_splits,
                                  cudaLaunchAttribute* attr) {
  typedef Layout<T, D, kR> L;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_splits, grid_y, grid_z);
  cfg.blockDim = dim3(L::kThreads);
  cfg.dynamicSmemBytes = L::kBytes;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = n_splits;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

struct LaunchArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int B, Sq, Sk, H, KVH, head_dim;
  long long sq_b, sq_s, sq_h, sk_b, sk_s, sk_h;
  int causal, window, q_off, n_splits;
  cudaStream_t stream;

  template <typename T, int D, int kR>
  cudaError_t run() const {
    KernelFn<T, D, kR> kern;
    cudaError_t err = prepare<T, D, kR>(&kern);
    if (err != cudaSuccess) return err;
    // a batch of one never steps its batch stride: give the map a valid one
    const long long sb = B == 1 ? (long long)Sk * sk_s : sk_b;
    CUtensorMap k_map = {}, v_map = {};
    if (!kv_map<T>(&k_map, k, B, Sk, KVH, head_dim, D, sb, sk_s, sk_h)
        || !kv_map<T>(&v_map, v, B, Sk, KVH, head_dim, D, sb, sk_s, sk_h))
      return cudaErrorInvalidValue;
    const int G = H / KVH;
    const long long grid_y = (long long)KVH * ((G * Sq + kR - 1) / kR);
    if (grid_y > 65535) return cudaErrorInvalidValue;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg =
        cluster_config<T, D, kR>((int)grid_y, B, n_splits, &attr);
    cfg.stream = stream;
    // scores in log2 units: softmax by exp2 (log2(e) folded into q's scale)
    const float scale = 1.4426950408889634f / sqrtf((float)head_dim);
    err = cudaLaunchKernelEx(&cfg, kern, k_map, v_map, (const T*)q,
                             (const T*)k, (const T*)v, (T*)o, lse, Sq, Sk, H,
                             G, head_dim, sq_b, sq_s, sq_h, sb, sk_s, sk_h,
                             causal, window, q_off, scale);
    const cudaError_t last = cudaGetLastError();
    return err != cudaSuccess ? err : last;
  }
};

// how many clusters of n_splits blocks of an instance fit on the device at
// once (the SMs of a cluster must share a GPC)
struct ClusterQuery {
  int n_splits;
  int* count;

  template <typename T, int D, int kR>
  cudaError_t run() const {
    KernelFn<T, D, kR> kern;
    cudaError_t err = prepare<T, D, kR>(&kern);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cluster_config<T, D, kR>(1, 1, n_splits, &attr);
    return cudaOccupancyMaxActiveClusters(count, kern, &cfg);
  }
};

// rows a block: the rows of a KV head where an instance holds them, else
// the instance of kMaxRows rows in several row groups (rows past the count
// have q = 0 and are not written).  Each instance has no branch on the count.
template <typename T, int D, class Op>
cudaError_t dispatch_rows(int rows, const Op& op) {
  constexpr int kMax = RowsPerBlock<T, D>::kMax;
  if (rows == 1) return op.template run<T, D, 1>();
  if constexpr (kMax == 2) {
    return op.template run<T, D, 2>();
  } else {
    if (rows == 2) return op.template run<T, D, 2>();
    if constexpr (kMax == 4) {
      return op.template run<T, D, 4>();
    } else {
      if (rows <= 4) return op.template run<T, D, 4>();
      return op.template run<T, D, 8>();
    }
  }
}

// the instance of a head dim: its own where built, else the next one up
template <typename T, class Op>
cudaError_t dispatch_dim(int D, int rows, const Op& op) {
  switch (D) {
    case 16: return dispatch_rows<T, 16>(rows, op);
    case 32: return dispatch_rows<T, 32>(rows, op);
    case 48:
    case 64: return dispatch_rows<T, 64>(rows, op);
    case 80:
    case 96:
    case 112:
    case 128: return dispatch_rows<T, 128>(rows, op);
    case 192: return dispatch_rows<T, 192>(rows, op);
    default: return cudaErrorInvalidValue;
  }
}

// dtype_code: 0 = float32, 1 = bfloat16
template <class Op>
cudaError_t dispatch(int dtype_code, int D, int rows, const Op& op) {
  if (rows <= 0) return cudaErrorInvalidValue;
  if (dtype_code == 0) return dispatch_dim<float>(D, rows, op);
  if (dtype_code == 1) return dispatch_dim<__nv_bfloat16>(D, rows, op);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16.  q (B, Sq, H, D) and k, v
// (B, Sk, KVH, D) are read through their element strides (batch, seq, head;
// unit stride over D; k and v share strides, 16-byte aligned, multiples of
// 16 bytes); q row i is at absolute position q_off + i (with a causal mask
// or a window, q_off + Sq <= Sk); o (B, Sq, H, D) and lse (B, H, Sq, f32)
// are contiguous.  n_splits: blocks a cluster (1..8, decode_plan on the
// host).  Returns the cudaError_t of the launch (0 on success); nothing is
// synchronised.
extern "C" int repro_flash_decode_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int B, int Sq, int Sk, int H, int KVH, int D,
    long long sq_b, long long sq_s, long long sq_h,
    long long sk_b, long long sk_s, long long sk_h,
    int causal, int window, int q_off, int n_splits, int dtype_code,
    void* stream) {
  if (B <= 0 || B > 65535 || Sq <= 0 || Sk <= 0 || H <= 0 || KVH <= 0
      || H % KVH != 0 || q_off < 0 || n_splits < 1 || n_splits > kMaxSplits
      || (!(!causal && window <= 0) && (long long)q_off + Sq > Sk))
    return (int)cudaErrorInvalidValue;
  const LaunchArgs args = {q, k, v, o, (float*)lse, B, Sq, Sk, H, KVH, D,
                           sq_b, sq_s, sq_h, sk_b, sk_s, sk_h, causal, window,
                           q_off, n_splits, (cudaStream_t)stream};
  return (int)dispatch(dtype_code, D, (H / KVH) * Sq, args);
}

// *count = clusters of n_splits blocks of the (dtype, D, rows) instance that
// fit on the current device at once.  Returns a cudaError_t.
extern "C" int repro_flash_decode_active_clusters(
    int n_splits, int D, int rows, int dtype_code, int* count) {
  if (n_splits < 1 || n_splits > kMaxSplits) return (int)cudaErrorInvalidValue;
  const ClusterQuery query = {n_splits, count};
  return (int)dispatch(dtype_code, D, rows, query);
}

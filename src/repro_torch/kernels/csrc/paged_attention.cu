// Decode attention through a KV page table, for NVIDIA Hopper (sm_90a):
// split-KV over a thread-block cluster, fed by a ring of bulk copies.
//
// Replaces the TPU kernel `paged_attention_kernel` / `_kernel` of
// src/repro/kernels/paged_attention/paged_attention.py: one query token per
// sequence attends to its whole context, whose K/V rows live in a shared
// frame pool and are found through a per-sequence page table (the address
// translation of the paper, applied to the KV cache).  Same arithmetic:
// online softmax with fp32 accumulation (in base 2: 1 / ln 2 is folded into
// q's scale), masked scores are -1e30 (finite), the result is divided by
// max(l, 1e-30).
//
// What bounds it on this card: bytes.  Every valid K and V row is read
// once, sum_b len_b * KVH * D * 2 elements, and there are only 2 * G * D
// multiply-adds per K/V row pair read, two orders of magnitude below the
// ~295 operations per byte at which the tensor cores would become the
// limit; so the products stay on the CUDA cores in fp32 (an `mma` would buy
// nothing), and the design is about keeping bytes in flight on enough SMs
// and keeping the arithmetic's instruction stream short and branch-free.
//
// What the design does about it:
//  * split-KV over a cluster: the grid is (N, KVH * head groups, B) with
//    cluster dims (N, 1, 1).  Block r of a cluster takes the r-th of N equal
//    shares, in tiles, of the visible range [first, end) of its sequence
//    (computed here from `lengths` and `window`); shares that fall wholly
//    before the window or past the length load nothing.  N is chosen on the
//    host from shapes alone (`split_plan` in paged_attention.py), so a small
//    B * KVH still fills the card;
//  * the splits are combined inside the cluster, not by a second kernel:
//    each block leaves its (m, l, acc) partial in its own shared memory, and
//    after a cluster barrier the block of rank 0 reads the others' through
//    distributed shared memory, in rank order, rescales by exp(m_r - M) and
//    writes the output.  One launch per call, no scratch in device memory,
//    no atomics: two calls give identical bits;
//  * a ring of kStages stages of kTile rows of K and of V in shared memory,
//    filled by one producer warp with bulk tensor copies
//    (cp.async.bulk.tensor ... mbarrier::complete_tx) through two tensor
//    maps that describe the pools in the model layout (P, ps, KVH, D) by
//    their strides.  One copy moves `seg` = gcd(ps, kTile) rows of one head
//    (a whole 64-row stage at 256-token pages), addressed through that
//    segment's page-table entry; a segment never straddles a page.  Each
//    stage has a "full" mbarrier (expect-tx = the bytes of the segments
//    copied, set by lane 0 before any copy is issued; a stage with nothing
//    to copy still arrives) and an "empty" mbarrier on which every consumer
//    warp arrives when it is done with the stage.  Whole segments, not
//    rows: a 1-D bulk copy of one 256-byte row costs the copy engine ~60
//    cycles (measured on an H100), which caps an SM near 7.5 GB/s.
//  * segments of unmapped pages, or wholly outside [first, end), are never
//    copied and never turned into an address.  Rows that are masked hold
//    stale data (or other rows of a copied page), so the consumers drop
//    them by selects, never by multiplying with p = 0 (0 * NaN is NaN);
//  * the consumer warps split the tokens of a stage, not the heads: each of
//    the kTile / 8 warps owns 8 rows and accumulates all the block's query
//    heads (kG, a template parameter, so the arithmetic has no branches on
//    the head count), so no warp idles at G = 5.  For the
//    scores, eight lanes share a row and each keeps its eighth of q for
//    every head in registers (read from shared memory for every product,
//    q would make the shared-memory pipe, not the FMAs, set the time); a
//    lane's 16-byte chunks of a row are every eighth, so the eight lanes
//    read consecutive bytes.  The softmax runs one head a
//    lane (lane `part` of each group keeps head `part`'s running max and
//    sum, in base 2), and each row's probabilities go through shared
//    memory to P.V, where lane t owns D / 32 neighbouring output columns
//    of every head.  The warps' partials are combined in warp order with
//    the same rescaling as the cluster combine.
//
// Head dims (design (b) of the two that fit this layout): the instances are
// built for D = 16, 32, 64 and 128, whose rows split evenly into the eight
// lanes' 16-byte chunks and the 32 lanes' P.V columns.  A head dim between
// them (80: H2O-Danube, 112: Zamba2) runs the next instance up (128): the
// tensor maps describe the pools with their true D, and their box is the
// instance's width, so the bulk copy zero-fills the columns past D in
// shared memory; q is zero-padded the same way, so the padded columns add
// 0 to every score, and the output columns past D are never written.
// Device memory sees D's bytes only; shared memory and the consumers'
// arithmetic pay for the instance's width (1.6x at 80, 1.14x at 112).
//
// Page sizes: a bulk copy of `seg` rows must span a multiple of 128 bytes
// and a stage may take at most 32 of them (one a producer lane).  Where
// gcd(ps, kTile) fails that (odd pages, ps = 1, small pages at D = 16) the
// host passes seg = 0 and the producer warp copies rows instead: each lane
// issues 16-byte `cp.async` copies of the stage's chunks (row-major over
// the lanes, so neighbouring lanes read neighbouring bytes of a row),
// zero-filling the chunks past D, and arrives on the stage's full barrier
// through `cp.async.mbarrier.arrive.noinc` when its copies land (the
// barrier then counts 32 such arrivals and lane 0's plain one, which
// publishes the stage's masks).  The consumers are the same in both modes.
// 256-token pages take the bulk path, as before.
//
// A row for which no position is valid (length <= 0, or every page in
// reach unmapped) gets the reference's result: its softmax over equal
// -1e30 scores weighs every position alike, so the output is the mean of
// the V rows of all NP * ps positions, an unmapped page read as frame 0.
// That is decided after the cluster combine (total l == 0), and only that
// case reads a masked row.
//
// Compile-time knobs (tools/paged_decode_sweep.py builds variants of them):
// REPRO_PA_TILE_BF16 rows a bf16 stage (8 rows a consumer warp),
// REPRO_PA_STAGES stages, REPRO_PA_MAX_SPLITS the largest cluster the entry
// points accept (8, the portable limit; the sweep builds 16, which needs
// the non-portable cluster attribute).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef REPRO_PA_TILE_BF16
#define REPRO_PA_TILE_BF16 64
#endif
#ifndef REPRO_PA_STAGES
#define REPRO_PA_STAGES 4
#endif
#ifndef REPRO_PA_MAX_SPLITS
#define REPRO_PA_MAX_SPLITS 8
#endif

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kStages = REPRO_PA_STAGES;
constexpr int kRows = 8;           // rows of a stage a consumer warp owns
constexpr int kParts = 8;          // lanes sharing a row for the scores
constexpr int kGroups = 32 / kParts;   // rows a warp scores at once
constexpr int kPasses = kRows / kGroups;
constexpr int kMaxHeads = 8;       // query heads a block; G > 8 takes more
constexpr int kMaxSplits = REPRO_PA_MAX_SPLITS;   // largest cluster
constexpr int kMaxSharedBytes = 232448;

template <typename Raw, int kN>
struct alignas(sizeof(Raw) * kN) RawVec { Raw e[kN]; };

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
  static constexpr int kTile = REPRO_PA_TILE_BF16;
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
template <typename T, int D, int kG>
struct Layout {
  static constexpr int kTile = Elem<T>::kTile;
  static constexpr int kWarps = kTile / kRows;           // consumer warps
  static constexpr int kRowBytes = D * (int)sizeof(T);
  static constexpr int kStageBytes = kTile * kRowBytes;  // K (or V) of one
  static constexpr int kMasks = kTile / 32;       // valid-row words a stage
  static constexpr int kRing = 2 * kStages * kStageBytes;  // K, then V
  static constexpr int kWarpAcc = 0;              // f32 [W][kG][D], in ring
  static constexpr int kWarpML = kWarpAcc + kWarps * kG * D * 4;  // [W][kG][2]
  static constexpr int kQ = kRing;                // f32 [kG][D]
  static constexpr int kBlockAcc = kQ + kG * D * 4;        // f32 [kG][D]
  static constexpr int kBlockML = kBlockAcc + kG * D * 4;  // f32 [kG][2]
  static constexpr int kMask = kBlockML + ((kG * 2 * 4 + 15) / 16) * 16;
  static constexpr int kP = kMask + ((kStages * kMasks * 4 + 15) / 16) * 16;
  // f32 [W][kRows][8]: a warp's probabilities of a stage, for P.V
  static constexpr int kBars = kP + kWarps * kRows * 8 * 4;
  static constexpr int kBytes = kBars + 2 * kStages * 8;   // full, empty
  static_assert(kWarpML + kWarps * kG * 2 * 4 <= kRing, "partials fit");
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

// the stage's full barrier counts one arrival of this lane when all its
// earlier cp.async copies have landed (no increment of the pending count)
__device__ __forceinline__ void cp_async_arrive_noinc(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
               :: "r"(bar) : "memory");
}

// 16-byte asynchronous copy; `ok` false zero-fills the 16 bytes
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

// one box {D, 1, seg, 1} of a pool -> this block's shared memory,
// completion on `bar`; coordinates innermost first
__device__ __forceinline__ void bulk_copy_box(uint32_t dst,
                                              const CUtensorMap* map,
                                              int kvh, int tok, int frame,
                                              uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(kvh),
         "r"(tok), "r"(frame), "r"(bar)
      : "memory");
}

// grid (N, KVH * ceil(G / kG), B), cluster (N, 1, 1), block
// (kTile / kRows + 1) warps.  D is the instance's (shared-memory) head dim,
// head_dim <= D the tensors'.  q, out: (B, KVH * G, head_dim) contiguous.
// k_map, v_map: the pools (P, ps, KVH, head_dim) as 4-d tensor maps, box
// {D, 1, seg, 1} (unused when seg == 0: row copies); k_pool and v_pool,
// with element strides (stride_p, stride_t, stride_h), are read directly
// by the row copies, and v_pool where no position is valid.
template <typename T, int D, int kG>
__global__ void __launch_bounds__((Elem<T>::kTile / kRows + 1) * 32, 1)
paged_attention_kernel(
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const T* __restrict__ q,
    const T* __restrict__ k_pool, const T* __restrict__ v_pool,
    const int* __restrict__ page_table, const int* __restrict__ lengths,
    T* __restrict__ out, int G, int NP, int ps, int seg, int head_dim,
    long long stride_p, long long stride_t, long long stride_h, int window,
    float scale) {
  typedef Layout<T, D, kG> L;
  typedef typename Elem<T>::Raw Raw;
  constexpr int kTile = L::kTile;
  constexpr int kWarps = L::kWarps;
  constexpr int kThreads = (kWarps + 1) * 32;
  constexpr int kSlice = D / kParts;             // elements of a row a lane
  constexpr int kVecBytes =
      kSlice * (int)sizeof(T) < 16 ? kSlice * (int)sizeof(T) : 16;
  constexpr int kVec = kVecBytes / (int)sizeof(T);
  constexpr int kChunks = kSlice / kVec;         // a lane's chunks of a row
  constexpr int kCols = D >= 32 ? D / 32 : 1;    // P.V columns a lane
  static_assert(kTile % 32 == 0 && kWarps >= 1, "tile");
  static_assert(D % kParts == 0 && kSlice % kVec == 0, "slice of a row");

  extern __shared__ __align__(128) unsigned char smem[];
  float* q_sm = reinterpret_cast<float*>(smem + L::kQ);
  float* warp_acc = reinterpret_cast<float*>(smem + L::kWarpAcc);
  float* warp_ml = reinterpret_cast<float*>(smem + L::kWarpML);
  float* block_acc = reinterpret_cast<float*>(smem + L::kBlockAcc);
  float* block_ml = reinterpret_cast<float*>(smem + L::kBlockML);
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem + L::kMask);
  float* p_sm = reinterpret_cast<float*>(smem + L::kP);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  // full[s] = bars[s], empty[s] = bars[kStages + s]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_splits = (int)cluster.num_blocks();
  const int head_groups = (G + kG - 1) / kG;
  const int kvh = blockIdx.y / head_groups;
  const int g0 = (blockIdx.y - kvh * head_groups) * kG;
  const int KVH = gridDim.y / head_groups;
  const int gcount = G - g0 < kG ? G - g0 : kG;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long q_base =
      ((long long)b * KVH * G + (long long)kvh * G + g0) * head_dim;

  for (int i = threadIdx.x; i < kG * D; i += kThreads) {
    const int g = i / D;
    const int d = i - g * D;
    q_sm[i] = g < gcount && d < head_dim
                  ? Elem<T>::load(q + q_base + g * head_dim + d) * scale
                  : 0.f;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // bulk: lane 0's expect-tx arrival; rows: 32 cp.async arrivals and
      // lane 0's
      mbar_init(smem_u32(bars + s), seg > 0 ? 1 : 33);
      mbar_init(smem_u32(bars + kStages + s), kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // this block's share of the visible range, in whole tiles
  const int length = lengths[b];
  const int cap = NP * ps;
  const int end = length < cap ? length : cap;
  int first = 0;
  if (window > 0 && length - window > 0) first = length - window;
  const int* pt = page_table + (long long)b * NP;
  const int t_start = (first / kTile) * kTile;
  const int n_tiles = end > t_start ? (end - t_start + kTile - 1) / kTile : 0;
  const int per = (n_tiles + n_splits - 1) / n_splits;
  const int tile_lo = rank * per < n_tiles ? rank * per : n_tiles;
  const int tile_hi = tile_lo + per < n_tiles ? tile_lo + per : n_tiles;

  // consumers: the P.V accumulators of every head, and the running max and
  // sum of one head (lane `part` of each group of kParts lanes: head
  // `part`)
  float acc[kG][kCols];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[g][c] = 0.f;
  float m_own = kNegInf, l_own = 0.f;

  if (warp == kWarps && seg == 0) {
    // --------------------------------------------- producer: row copies
    // the 16-byte chunks of a stage's rows, row-major over the lanes;
    // lane j looks up the frames of rows j, j + 32, ...
    constexpr int kChunksRow = L::kRowBytes / 16;
    constexpr int kElemsChunk = 16 / (int)sizeof(T);
    const int live = head_dim / kElemsChunk;    // chunks with data in a row
    for (int i = tile_lo; i < tile_hi; ++i) {
      const int k = i - tile_lo;
      const int s = k % kStages;
      const uint32_t round = (uint32_t)(k / kStages);
      const int t0 = t_start + i * kTile;
      int fr[L::kMasks];
      uint32_t word[L::kMasks];
#pragma unroll
      for (int j = 0; j < L::kMasks; ++j) {
        const int pos = t0 + lane + 32 * j;
        fr[j] = pos >= first && pos < end ? pt[pos / ps] : -1;
        word[j] = __ballot_sync(0xffffffffu, fr[j] >= 0);
      }
      mbar_wait(smem_u32(bars + kStages + s), (round & 1u) ^ 1u);
      const uint32_t full = smem_u32(bars + s);
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < L::kMasks; ++j) masks[s * L::kMasks + j] = word[j];
      }
      __syncwarp();
      unsigned char* kdst = smem + s * L::kStageBytes;
      unsigned char* vdst = smem + (kStages + s) * L::kStageBytes;
#pragma unroll
      for (int it = 0; it < kTile * kChunksRow / 32; ++it) {
        const int c = lane + 32 * it;
        const int r = c / kChunksRow;
        const int ch = c - r * kChunksRow;
        // every lane's row of this step lies in [32 w, 32 w + 32), w =
        // it / kChunksRow: lane (r & 31) holds its frame in fr[w]
        const int f = __shfl_sync(0xffffffffu, fr[it / kChunksRow], r & 31);
        if (f >= 0) {
          const int pos = t0 + r;
          const long long at = (long long)f * stride_p
              + (long long)(pos - (pos / ps) * ps) * stride_t
              + (long long)kvh * stride_h
              + (ch < live ? ch * kElemsChunk : 0);
          const int dst = r * L::kRowBytes + ch * 16;
          cp_async16(smem_u32(kdst + dst), k_pool + at, ch < live);
          cp_async16(smem_u32(vdst + dst), v_pool + at, ch < live);
        }
      }
      cp_async_arrive_noinc(full);
      if (lane == 0) mbar_arrive(full);       // publishes the masks
    }
  } else if (warp == kWarps) {
    // ------------------------------------------------ producer: bulk copies
    // lane j copies segment j of each tile (n_seg <= 32, checked on the
    // host); its page-table entry is read one tile ahead
    const int n_seg = kTile / seg;
    const int seg_shift = __ffs(seg) - 1;       // seg is a power of two
    const uint32_t seg_bytes = (uint32_t)(seg * L::kRowBytes);
    auto seg_frame = [&](int i) -> int {
      const int p0 = t_start + i * kTile + lane * seg;
      return lane < n_seg && p0 < end && p0 + seg > first ? pt[p0 / ps] : -1;
    };
    int frame_next = tile_lo < tile_hi ? seg_frame(tile_lo) : -1;
    for (int i = tile_lo; i < tile_hi; ++i) {
      const int k = i - tile_lo;
      const int s = k % kStages;
      const uint32_t round = (uint32_t)(k / kStages);
      const int t0 = t_start + i * kTile;
      const int frame = frame_next;
      if (i + 1 < tile_hi) frame_next = seg_frame(i + 1);
      uint32_t word[L::kMasks];               // a row: mapped and in range
#pragma unroll
      for (int j = 0; j < L::kMasks; ++j) {
        const int r = lane + 32 * j;
        const int fr = __shfl_sync(0xffffffffu, frame, r >> seg_shift);
        word[j] = __ballot_sync(0xffffffffu, fr >= 0 && t0 + r >= first
                                && t0 + r < end);
      }
      const int n_copies = __popc(__ballot_sync(0xffffffffu, frame >= 0));
      mbar_wait(smem_u32(bars + kStages + s), (round & 1u) ^ 1u);
      const uint32_t full = smem_u32(bars + s);
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < L::kMasks; ++j) masks[s * L::kMasks + j] = word[j];
        mbar_arrive_expect_tx(full, (uint32_t)n_copies * 2u * seg_bytes);
      }
      __syncwarp();
      if (frame >= 0) {
        const int p0 = t0 + lane * seg;
        const int tok = p0 - (p0 / ps) * ps;
        const int at = s * L::kStageBytes + lane * (int)seg_bytes;
        bulk_copy_box(smem_u32(smem + at), &k_map, kvh, tok, frame, full);
        bulk_copy_box(smem_u32(smem + kStages * L::kStageBytes + at), &v_map,
                      kvh, tok, frame, full);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    // scores: the lanes of a group of kParts share a row; lane `part` owns
    // the 16-byte chunks part, part + kParts, ... of every row, so a
    // group's reads of one row are consecutive (no bank conflict), and its
    // slice of q for every head stays in registers
    const int grp = lane / kParts;
    const int part = lane % kParts;
    const int col = lane * kCols < D ? lane * kCols : 0;   // D == 16: half
    float qr[kG][kSlice];
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          qr[g][c * kVec + e] = q_sm[g * D + (part + kParts * c) * kVec + e];
    for (int i = tile_lo; i < tile_hi; ++i) {
      const int k = i - tile_lo;
      const int s = k % kStages;
      const uint32_t round = (uint32_t)(k / kStages);
      mbar_wait(smem_u32(bars + s), round & 1u);
      const uint32_t vmask =
          (masks[s * L::kMasks + (warp * kRows) / 32] >> ((warp * kRows) % 32))
          & ((1u << kRows) - 1u);
      if (vmask != 0u) {
        // every lane computes; a masked row is dropped by a select
        float sc[kPasses][kG];
        const unsigned char* kbase = smem + s * L::kStageBytes
            + warp * kRows * L::kRowBytes;
#pragma unroll
        for (int ps_ = 0; ps_ < kPasses; ++ps_) {
          const unsigned char* krow =
              kbase + (ps_ * kGroups + grp) * L::kRowBytes;
#pragma unroll
          for (int g = 0; g < kG; ++g) sc[ps_][g] = 0.f;
#pragma unroll
          for (int c = 0; c < kChunks; ++c) {
            const RawVec<Raw, kVec> kv = *reinterpret_cast<
                const RawVec<Raw, kVec>*>(krow + (part + kParts * c)
                                          * kVecBytes);
#pragma unroll
            for (int e = 0; e < kVec; ++e) {
              const float kf = Elem<T>::to_float(kv.e[e]);
#pragma unroll
              for (int g = 0; g < kG; ++g)
                sc[ps_][g] = fmaf(qr[g][c * kVec + e], kf, sc[ps_][g]);
            }
          }
#pragma unroll
          for (int g = 0; g < kG; ++g) {
#pragma unroll
            for (int o = 1; o < kParts; o <<= 1)
              sc[ps_][g] += __shfl_xor_sync(0xffffffffu, sc[ps_][g], o);
            if (!((vmask >> (ps_ * kGroups + grp)) & 1u)) sc[ps_][g] = kNegInf;
          }
        }
        // softmax in base 2 (q carries 1 / ln 2), one head a lane: lane
        // `part` of each group keeps the running max and sum of head
        // `part` over its group's rows; each row's probabilities go to
        // shared memory, where every lane reads them for P.V
        float* p_warp = p_sm + warp * kRows * 8;   // [row][head]
        float own[kPasses];
#pragma unroll
        for (int ps_ = 0; ps_ < kPasses; ++ps_) {
          own[ps_] = sc[ps_][0];
#pragma unroll
          for (int g = 1; g < kG; ++g)
            if (part == g) own[ps_] = sc[ps_][g];
        }
        float mt = own[0];
#pragma unroll
        for (int ps_ = 1; ps_ < kPasses; ++ps_) mt = fmaxf(mt, own[ps_]);
#pragma unroll
        for (int o = kParts; o < 32; o <<= 1)
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
        float corr = 1.f;
        const bool moved = mt > m_own;
        if (moved) {
          corr = exp2f(m_own - mt);
          l_own *= corr;
          m_own = mt;
        }
        if (__any_sync(0xffffffffu, moved)) {   // a head's max moved
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            const float cg = __shfl_sync(0xffffffffu, corr, g);
#pragma unroll
            for (int c = 0; c < kCols; ++c) acc[g][c] *= cg;
          }
        }
#pragma unroll
        for (int ps_ = 0; ps_ < kPasses; ++ps_) {
          const bool valid = (vmask >> (ps_ * kGroups + grp)) & 1u;
          const float pv = valid ? exp2f(own[ps_] - m_own) : 0.f;
          if (part < kG) p_warp[(ps_ * kGroups + grp) * 8 + part] = pv;
          l_own += pv;
        }
        __syncwarp();
        // P.V: every row is read, a masked row's values become 0 by a select
        const unsigned char* vbase = smem + (kStages + s) * L::kStageBytes
            + warp * kRows * L::kRowBytes + col * (int)sizeof(T);
#pragma unroll
        for (int t = 0; t < kRows; ++t) {
          const bool vt = (vmask >> t) & 1u;
          const RawVec<Raw, kCols> vv = *reinterpret_cast<
              const RawVec<Raw, kCols>*>(vbase + t * L::kRowBytes);
          float vf[kCols];
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            vf[c] = vt ? Elem<T>::to_float(vv.e[c]) : 0.f;
          float pg[kG];
#pragma unroll
          for (int g = 0; g + 4 <= kG; g += 4) {
            const float4 p4 = *reinterpret_cast<const float4*>(
                p_warp + t * 8 + g);
            pg[g] = p4.x; pg[g + 1] = p4.y; pg[g + 2] = p4.z; pg[g + 3] = p4.w;
          }
#pragma unroll
          for (int g = kG / 4 * 4; g < kG; ++g) pg[g] = p_warp[t * 8 + g];
#pragma unroll
          for (int g = 0; g < kG; ++g) {
#pragma unroll
            for (int c = 0; c < kCols; ++c)
              acc[g][c] = fmaf(pg[g], vf[c], acc[g][c]);
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
    for (int o = kParts; o < 32; o <<= 1)      // head `part`'s sum
      l_own += __shfl_xor_sync(0xffffffffu, l_own, o);
    if (lane < kG) {
      warp_ml[(warp * kG + lane) * 2] = m_own;
      warp_ml[(warp * kG + lane) * 2 + 1] = l_own;
    }
#pragma unroll
    for (int g = 0; g < kG; ++g) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = lane * kCols + c;
        if (d < D) warp_acc[(warp * kG + g) * D + d] = acc[g][c];
      }
    }
  }
  __syncthreads();

  // the block's partial: its warps combined in warp order (the columns
  // past head_dim hold zeros and are left out)
  for (int i = threadIdx.x; i < gcount * head_dim; i += kThreads) {
    const int g = i / head_dim;
    const int d = i - g * head_dim;
    float M = kNegInf;
    for (int w = 0; w < kWarps; ++w)
      M = fmaxf(M, warp_ml[(w * kG + g) * 2]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(warp_ml[(w * kG + g) * 2] - M);
      lsum += warp_ml[(w * kG + g) * 2 + 1] * f;
      a += warp_acc[(w * kG + g) * D + d] * f;
    }
    block_acc[g * D + d] = a;
    if (d == 0) {
      block_ml[2 * g] = M;
      block_ml[2 * g + 1] = lsum;
    }
  }
  cluster.sync();          // every block's partial is written

  if (rank == 0) {         // the cluster's result: ranks in order
    const long long head_off = (long long)kvh * stride_h;
    for (int i = threadIdx.x; i < gcount * head_dim; i += kThreads) {
      const int g = i / head_dim;
      const int d = i - g * head_dim;
      float M = kNegInf;
      for (int r = 0; r < n_splits; ++r)
        M = fmaxf(M, cluster.map_shared_rank(block_ml, r)[2 * g]);
      float lsum = 0.f, a = 0.f;
      for (int r = 0; r < n_splits; ++r) {
        const float* ml = cluster.map_shared_rank(block_ml, r);
        const float f = exp2f(ml[2 * g] - M);
        lsum += ml[2 * g + 1] * f;
        a += cluster.map_shared_rank(block_acc, r)[g * D + d] * f;
      }
      float denom = fmaxf(lsum, 1e-30f);
      if (lsum == 0.f) {   // no valid position (see the header)
        a = 0.f;
        for (int pos = 0; pos < cap; ++pos) {
          const int page = pos / ps;
          const int entry = pt[page] > 0 ? pt[page] : 0;
          a += Elem<T>::load(v_pool + (long long)entry * stride_p
                             + (long long)(pos - page * ps) * stride_t
                             + head_off + d);
        }
        denom = (float)cap;
      }
      out[q_base + g * head_dim + d] = Elem<T>::from_float(a / denom);
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

// a pool (P, ps, KVH, head_dim) with element strides (sp, st, sh, 1) as a
// 4-d map (innermost first) whose box is one head's `seg` rows of one page,
// `box_d` >= head_dim columns wide (the columns past head_dim are out of
// bounds: the copy writes zeros there)
template <typename T>
bool pool_map(CUtensorMap* map, const void* pool, int P, int ps, int KVH,
              int head_dim, int box_d, int seg, long long sp, long long st,
              long long sh) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t es = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)head_dim, (cuuint64_t)KVH,
                              (cuuint64_t)ps, (cuuint64_t)P};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * es, (cuuint64_t)st * es,
                                 (cuuint64_t)sp * es};
  const cuuint32_t box[4] = {(cuuint32_t)box_d, 1u, (cuuint32_t)seg, 1u};
  const cuuint32_t elem[4] = {1u, 1u, 1u, 1u};
  return fn(map, Elem<T>::kMapType, 4, const_cast<void*>(pool), dims,
            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D, int kG>
using KernelFn = void (*)(const CUtensorMap, const CUtensorMap, const T*,
                          const T*, const T*, const int*, const int*, T*, int,
                          int, int, int, int, long long, long long, long long,
                          int, float);

// the instance's launch attributes, set once per device: its dynamic shared
// memory (and, in a build for clusters above the portable 8, those)
template <typename T, int D, int kG>
cudaError_t prepare(KernelFn<T, D, kG>* kern) {
  typedef Layout<T, D, kG> L;
  *kern = paged_attention_kernel<T, D, kG>;
  if (L::kBytes > kMaxSharedBytes) return cudaErrorInvalidValue;
  static unsigned int configured = 0u;        // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32 || !((configured >> dev) & 1u)) {
    err = cudaFuncSetAttribute(*kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::kBytes);
    if (err != cudaSuccess) return err;
    if (kMaxSplits > 8) {
      err = cudaFuncSetAttribute(
          *kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
    }
    if (dev < 32) configured |= 1u << dev;
  }
  return cudaSuccess;
}

template <typename T, int D, int kG>
cudaLaunchConfig_t cluster_config(int grid_y, int grid_z, int n_splits,
                                  cudaLaunchAttribute* attr) {
  typedef Layout<T, D, kG> L;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_splits, grid_y, grid_z);
  cfg.blockDim = dim3((L::kWarps + 1) * 32);
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
  const void* k_pool;
  const void* v_pool;
  const int* page_table;
  const int* lengths;
  void* out;
  int B, KVH, G, head_dim, P, NP, ps, seg;
  long long stride_p, stride_t, stride_h;
  int window, n_splits;
  cudaStream_t stream;

  template <typename T, int D, int kG>
  cudaError_t run() const {
    typedef Layout<T, D, kG> L;
    KernelFn<T, D, kG> kern;
    cudaError_t err = prepare<T, D, kG>(&kern);
    if (err != cudaSuccess) return err;
    // seg: rows a bulk copy moves, or 0 for row copies (bulk_segment in
    // paged_attention.py); a bulk segment divides the page and the tile,
    // spans a multiple of 128 bytes, and a stage takes at most 32
    if (seg < 0 || (seg > 0 && (ps % seg != 0 || L::kTile % seg != 0
                                || (seg * L::kRowBytes) % 128 != 0
                                || L::kTile / seg > 32)))
      return cudaErrorInvalidValue;
    CUtensorMap k_map = {}, v_map = {};
    if (seg > 0
        && (!pool_map<T>(&k_map, k_pool, P, ps, KVH, head_dim, D, seg,
                         stride_p, stride_t, stride_h)
            || !pool_map<T>(&v_map, v_pool, P, ps, KVH, head_dim, D, seg,
                            stride_p, stride_t, stride_h)))
      return cudaErrorInvalidValue;
    const int head_groups = (G + kG - 1) / kG;
    if ((long long)KVH * head_groups > 65535) return cudaErrorInvalidValue;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg =
        cluster_config<T, D, kG>(KVH * head_groups, B, n_splits, &attr);
    cfg.stream = stream;
    // scores in log2 units: softmax by exp2 (1 / ln 2 folded into q's scale)
    const float scale = 1.4426950408889634f / sqrtf((float)head_dim);
    err = cudaLaunchKernelEx(&cfg, kern, k_map, v_map, (const T*)q,
                             (const T*)k_pool, (const T*)v_pool, page_table,
                             lengths, (T*)out, G, NP, ps, seg, head_dim,
                             stride_p, stride_t, stride_h, window, scale);
    const cudaError_t last = cudaGetLastError();
    return err != cudaSuccess ? err : last;
  }
};

// how many clusters of n_splits blocks of an instance fit on the device at
// once (the SMs of a cluster must share a GPC)
struct ClusterQuery {
  int n_splits;
  int* count;

  template <typename T, int D, int kG>
  cudaError_t run() const {
    KernelFn<T, D, kG> kern;
    cudaError_t err = prepare<T, D, kG>(&kern);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cluster_config<T, D, kG>(1, 1, n_splits, &attr);
    return cudaOccupancyMaxActiveClusters(count, kern, &cfg);
  }
};

// query heads a block: the group size where it is instantiated, else the
// next one up (the extra heads have q = 0 and are not written); above 8,
// groups of 8 in several blocks.  Each instance has no branch on the count.
template <typename T, int D, class Op>
cudaError_t dispatch_heads(int G, const Op& op) {
  if (G == 1) return op.template run<T, D, 1>();
  if (G == 2) return op.template run<T, D, 2>();
  if (G <= 4) return op.template run<T, D, 4>();
  if (G == 5) return op.template run<T, D, 5>();
  return op.template run<T, D, kMaxHeads>();
}

// the instance of a head dim: its own where built, else the next one up
// (80 and 112 run the 128 instance; see the header)
template <typename T, class Op>
cudaError_t dispatch_dim(int D, int G, const Op& op) {
  switch (D) {
    case 16: return dispatch_heads<T, 16>(G, op);
    case 32: return dispatch_heads<T, 32>(G, op);
    case 64: return dispatch_heads<T, 64>(G, op);
    case 80:
    case 112:
    case 128: return dispatch_heads<T, 128>(G, op);
    default: return cudaErrorInvalidValue;
  }
}

// dtype_code: 0 = float32, 1 = bfloat16
template <class Op>
cudaError_t dispatch(int dtype_code, int D, int G, const Op& op) {
  if (G <= 0) return cudaErrorInvalidValue;
  if (dtype_code == 0) return dispatch_dim<float>(D, G, op);
  if (dtype_code == 1) return dispatch_dim<__nv_bfloat16>(D, G, op);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16.  P: frames in the pools.
// n_splits: blocks a cluster (1..kMaxSplits), chosen by the caller; seg:
// rows of a bulk copy, or 0 for row copies (bulk_segment, on the host).
// Returns the cudaError_t of the launch (0 on success); nothing is
// synchronised.
extern "C" int repro_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* lengths, void* out,
    int B, int KVH, int G, int D, int P, int NP, int ps, int seg,
    long long stride_p, long long stride_t, long long stride_h,
    int window, int n_splits, int dtype_code, void* stream) {
  if (B <= 0 || B > 65535 || KVH <= 0 || P <= 0 || NP <= 0 || ps <= 0
      || n_splits < 1 || n_splits > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  const LaunchArgs args = {q, k_pool, v_pool, (const int*)page_table,
                           (const int*)lengths, out, B, KVH, G, D, P, NP, ps,
                           seg, stride_p, stride_t, stride_h, window, n_splits,
                           (cudaStream_t)stream};
  return (int)dispatch(dtype_code, D, G, args);
}

// *count = clusters of n_splits blocks of the (dtype, D, G) instance that
// fit on the current device at once.  Returns a cudaError_t.
extern "C" int repro_paged_attention_active_clusters(
    int n_splits, int D, int G, int dtype_code, int* count) {
  if (n_splits < 1 || n_splits > kMaxSplits) return (int)cudaErrorInvalidValue;
  const ClusterQuery query = {n_splits, count};
  return (int)dispatch(dtype_code, D, G, query);
}

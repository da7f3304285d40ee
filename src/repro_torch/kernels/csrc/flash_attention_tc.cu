// Blocked causal / sliding-window / non-causal attention in bf16 on the
// tensor cores of NVIDIA Hopper (sm_90a), forward and backward: the route
// of every bf16 tensor (flash_attention.cu keeps the f32 route on the CUDA
// cores).
//
// Replaces the TPU kernel `flash_attention_kernel` / `_kernel` of
// src/repro/kernels/flash_attention/flash_attention.py: q (B, Sq, H, D)
// attends to k, v (B, Sk, KVH, D), query head h reading KV head h / G, tiles
// wholly above the causal diagonal or outside the window skipped by the TPU
// kernel's block predicate (here for the forward's 128 x 128, dQ's 128 x 64
// and dK/dV's 64 x 128 (q x k) tiles), the tails masked by q_pos < Sq and
// k_pos < Sk.  Same arithmetic: f32 running max / sum /
// accumulator, masked scores are -1e30 (finite), the result is divided by
// max(l, 1e-30); the forward also writes the per-row logsumexp (B, H, Sq).
// The TPU kernel takes one S; here Sq may differ from Sk (cross-attention:
// 448 or 1 decoder rows over 1,500 encoder frames), and only without a
// causal mask or a window (shapes_ok refuses the rest), so every query row
// sees all Sk keys.  Sq = Sk runs exactly as before.
// The reference has no backward kernel (XLA differentiates its chunked
// scan); here two kernels compute the gradients from the logsumexp:
//   flash_tc_bwd_dq    one block per (b, h, 128-row q tile): first
//                      delta = rowsum(dO * O) of its rows (written out for
//                      the next kernel), then dQ over the k tiles it sees;
//   flash_tc_bwd_dkdv  one block per (b, kv_head, 128-key k tile): loops
//                      over the G query heads of the group and the 64-row
//                      q tiles that see the k tile, so the GQA sum over G
//                      is taken inside one block.
// No floating-point atomics anywhere: every sum has one order, and the
// gradients repeat bit for bit.  S and dP are computed in both kernels;
// that is the price of the atomic-free split.
//
// What bounds it on this card: operations.  At the training shape (B=1,
// S=4096, H=40, KVH=8, D=128, causal) the forward does about 1.72e11 FLOP
// and the backward about 4.30e11 (counted: QK^T, PV; S, dP, dV, dK, dQ)
// against ~0.1 GB of inputs and outputs, far above the ~295 FLOP per byte
// at which HBM would become the limit; the bound is the 989 TFLOP/s bf16
// tensor-core rate.
//
// What the design does about it:
//  * every product on the tensor cores: mma.sync.m16n8k16 with bf16
//    operands and f32 accumulators, operands fetched with ldmatrix
//    (.trans where the operand is stored k-major: V in P.V, dO in dV, Q in
//    dK, K in dQ).  mma.sync rather than wgmma: its fragments are per warp,
//    so P and dS go from the accumulators of one product straight into the
//    A operand of the next (the m16n8 f32 C layout of two n8 tiles is the
//    m16k16 bf16 A layout) and never touch shared memory, and each warp
//    owns 16 rows (or keys) outright; wgmma with TMA and a producer warp is
//    the next step (ROADMAP queue B);
//  * bf16 tiles in shared memory, never widened, rows padded by 16 bytes:
//    the 8 row addresses of an ldmatrix then fall into 8 disjoint groups of
//    4 banks for every head dim, so all ldmatrix reads are conflict-free;
//  * loads by cp.async (16 bytes a thread, rows past S zero-filled) into
//    two stages: the next K/V tile (forward, dQ) or Q/dO tile (dK/dV) is in
//    flight while the current one is multiplied;
//  * 8 warps of 16 rows each: 128 query rows per forward / dQ block and
//    128 keys per dK/dV block, one block an SM (forward 219 registers, dQ
//    214, dK/dV 255 at D=128, no spills; in dK/dV P^T is rounded to bf16
//    fragments and used for dV before dP^T is formed, so the two f32 tiles
//    are never live together); softmax max / sum reduced over the 4 lanes
//    of a row with two shuffles, the row sum only once at the end.  Two m16
//    tiles a warp (kFwdM = 2, FlashAttention-2's layout) halve the shared
//    memory read per product but spill at 255 registers
//    (tools/flash_tc_sweep.py measures the variants);
//  * exp2 with log2(e) / sqrt(D) folded into one multiply;
//  * the element mask is applied only on tiles that straddle the causal
//    diagonal, the window edge or the end of the sequence;
//  * forward and dQ launch their heaviest (latest) q tiles first, dK/dV
//    its heaviest (earliest) k tiles first: the q / k tile is the slowest
//    grid axis.
//
// Head dim 192 (DeepSeek-V3's MLA: nope 128 + rope 64, V zero-padded to
// 192 as the reference does).  The tiles above stop fitting there, in
// shared memory (the forward's 128 q rows and two stages of 128 keys are
// 256,000 B at 200 elements a row, over the 232,448 a block may have) and
// in registers (an accumulator row of 192 columns is 96 f32 a lane).  So
// at D > 128 the instances change their shapes, not their structure:
//  * the forward takes 64-key tiles (153,600 B): the O accumulator grows
//    from 64 to 96 registers a lane while the score tile shrinks from 64
//    to 32, so the live set stays that of D = 128;
//  * dQ takes 32-key tiles (153,600 B), for the same trade (96 + 16 + 16
//    against 64 + 32 + 32);
//  * dK/dV, which at D = 128 already holds 128 accumulator registers a
//    lane (255 registers in all), would need 192: it runs as two passes
//    of the same kernel instead (template kPass), a dV pass (S^T -> P^T,
//    dV += P^T dO) and a dK pass (S^T, dP^T -> dS^T, dK += dS^T Q), each
//    with one 96-register accumulator.  The dK pass recomputes S^T, so the
//    backward does 6 products of a tile where the fused kernel does 5
//    (counted with dQ's: S, dP, dQ; S, dV; S, dP, dK), for no spills.
//    Separate passes keep every sum in one order: no atomics at D = 192
//    either.
// D <= 128 keeps the tiles, the single fused dK/dV kernel and the timings
// of the design above.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 16;                 // the m16 of mma.sync
constexpr int kFwdWarps = 8;                     // forward: 8 warps,
constexpr int kFwdM = 1;                         //   1 m16 tile each,
constexpr int kFwdBQ = kFwdWarps * kRowsPerWarp * kFwdM;  // 128 q rows
constexpr int kFwdBK = 128;                      //   per 128-key tile,
constexpr int kFwdMinBlocks = 1;                 //   1 block an SM
constexpr int kDqBQ = kWarps * kRowsPerWarp;     // dQ: 128 q rows
constexpr int kDqBK = 64;                        //   per 64-key tile,
constexpr int kDqMinBlocks = 1;                  //   1 block an SM
constexpr int kKvBK = kWarps * kRowsPerWarp;     // dK/dV: 128 keys
constexpr int kKvBQ = 64;                        //   per 64-row q tile
constexpr int kWideD = 128;                      // head dims above: the
constexpr int kFwdBKWide = 64;                   //   forward's keys a tile,
constexpr int kDqBKWide = 32;                    //   dQ's keys a tile

// keys a tile of the forward and of dQ at head dim D
template <int D> struct KeyTile {
  static constexpr int kFwd = D > kWideD ? kFwdBKWide : kFwdBK;
  static constexpr int kDq = D > kWideD ? kDqBKWide : kDqBK;
};

// what a dK/dV launch computes: both (D <= 128), or one of the two passes
enum { kBothPass = 0, kDvPass = 1, kDkPass = 2 };

// bf16 elements per shared-memory row: D + 8, i.e. 2D + 16 bytes = an odd
// multiple of 4 words modulo 32 banks, so 8 rows at one column hit 8
// disjoint 4-bank groups
template <int D> struct Smem { static constexpr int kLD = D + 8; };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; `ok` false zero-fills the 16 bytes
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a * b: a 16 x 16 (row), b 16 x 8 (col), bf16; d 16 x 8, f32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// Lane offsets of ldmatrix.x4 row addresses (lane l gives row l % 8 of
// matrix l / 8).  A operand (m16 x k16, row-major): matrices (rows 0-7,
// k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15) -> a0..a3.
__device__ __forceinline__ int a_row(int lane) { return (lane & 7) + ((lane >> 3) & 1) * 8; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) * 8; }
// B operand stored n-major (rows n, k contiguous: K in QK^T): matrices
// (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15) ->
// b0, b1 of n tile 0, b0, b1 of n tile 1.
__device__ __forceinline__ int bn_row(int lane) { return (lane & 7) + (lane >> 4) * 8; }
__device__ __forceinline__ int bn_col(int lane) { return ((lane >> 3) & 1) * 8; }
// B operand stored k-major (rows k, n contiguous: V in P.V), read with
// .trans: matrices (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15),
// (k 8-15, n 8-15) -> the same b0, b1, b0, b1; the offsets are a_row/a_col.

// S = A B^T for one warp: A rows [a0, a0 + 16 kM) of `As` (kM m16 tiles),
// B rows [0, kN) of `Bs`, both (rows, D) bf16 at row stride LD; acc holds
// kN / 8 n8 tiles for each m tile.  A B fragment feeds all kM m tiles.
template <int D, int kM, int kN>
__device__ __forceinline__ void mma_abt(float (&acc)[kM][kN / 8][4],
                                        const bf16* As, int a0,
                                        const bf16* Bs, int lane) {
  constexpr int LD = Smem<D>::kLD;
  const uint32_t a_base = smem_u32(As + (a0 + a_row(lane)) * LD + a_col(lane));
  const uint32_t b_base = smem_u32(Bs + bn_row(lane) * LD + bn_col(lane));
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[kM][4];
#pragma unroll
    for (int mi = 0; mi < kM; ++mi)
      ldsm_x4(a_base + (mi * 16 * LD + kk * 16) * 2, a[mi]);
#pragma unroll
    for (int nn = 0; nn < kN / 16; ++nn) {
      uint32_t b[4];
      ldsm_x4(b_base + (nn * 16 * LD + kk * 16) * 2, b);
#pragma unroll
      for (int mi = 0; mi < kM; ++mi) {
        mma(acc[mi][2 * nn], a[mi], b[0], b[1]);
        mma(acc[mi][2 * nn + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

// The f32 accumulator tiles of a (16 kM x kK) product, rounded to bf16 as
// the A fragments of the next product (the m16n8 C layout of n8 tiles 2kk
// and 2kk + 1 is the m16k16 A layout of k step kk).
template <int kM, int kK>
__device__ __forceinline__ void pack_a(const float (&p)[kM][kK / 8][4],
                                       uint32_t (&a)[kM][kK / 16][4]) {
#pragma unroll
  for (int mi = 0; mi < kM; ++mi)
#pragma unroll
    for (int kk = 0; kk < kK / 16; ++kk) {
      a[mi][kk][0] = pack_bf16(p[mi][2 * kk][0], p[mi][2 * kk][1]);
      a[mi][kk][1] = pack_bf16(p[mi][2 * kk][2], p[mi][2 * kk][3]);
      a[mi][kk][2] = pack_bf16(p[mi][2 * kk + 1][0], p[mi][2 * kk + 1][1]);
      a[mi][kk][3] = pack_bf16(p[mi][2 * kk + 1][2], p[mi][2 * kk + 1][3]);
    }
}

// acc (16 kM x D) += A B for one warp: A (16 kM x kK) in bf16 fragments;
// B rows [0, kK) of `Bs` ((kK, D) bf16, row stride LD), read with
// ldmatrix.trans.
template <int D, int kM, int kK>
__device__ __forceinline__ void mma_ab(float (&acc)[kM][D / 8][4],
                                       const uint32_t (&a)[kM][kK / 16][4],
                                       const bf16* Bs, int lane) {
  constexpr int LD = Smem<D>::kLD;
  const uint32_t b_base = smem_u32(Bs + a_row(lane) * LD + a_col(lane));
#pragma unroll
  for (int kk = 0; kk < kK / 16; ++kk)
#pragma unroll
    for (int dd = 0; dd < D / 16; ++dd) {
      uint32_t b[4];
      ldsm_x4_t(b_base + (kk * 16 * LD + dd * 16) * 2, b);
#pragma unroll
      for (int mi = 0; mi < kM; ++mi) {
        mma(acc[mi][2 * dd], a[mi][kk], b[0], b[1]);
        mma(acc[mi][2 * dd + 1], a[mi][kk], b[2], b[3]);
      }
    }
}

// acc += P B with P given as f32 accumulator tiles (see pack_a, mma_ab)
template <int D, int kM, int kK>
__device__ __forceinline__ void mma_pb(float (&acc)[kM][D / 8][4],
                                       const float (&p)[kM][kK / 8][4],
                                       const bf16* Bs, int lane) {
  uint32_t a[kM][kK / 16][4];
  pack_a<kM, kK>(p, a);
  mma_ab<D, kM, kK>(acc, a, Bs, lane);
}

template <int kM, int kN>
__device__ __forceinline__ void zero(float (&x)[kM][kN][4]) {
#pragma unroll
  for (int mi = 0; mi < kM; ++mi)
#pragma unroll
    for (int i = 0; i < kN; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[mi][i][e] = 0.f;
}

// Start copying rows s0 .. s0 + kRows - 1 of one head into a (kRows, LD)
// tile; rows at or past S become zeros.  `base` points at (b, s = 0, head,
// d = 0); rows are `stride_s` elements apart, 16-byte aligned.
template <int D, int kRows, int kNThreads = kThreads>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base,
                                          long long stride_s, int s0, int S) {
  constexpr int LD = Smem<D>::kLD;
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < kRows * kChunks; c += kNThreads) {
    const int r = c / kChunks;
    const int ch = c - r * kChunks;
    const int s = s0 + r;
    const bool ok = s < S;
    const bf16* src = ok ? base + (long long)s * stride_s + ch * 8 : base;
    cp_async16(smem_u32(dst + r * LD + ch * 8), src, ok);
  }
}

__device__ __forceinline__ bool pair_valid(int qp, int kp, int Sq, int Sk,
                                           int causal, int window) {
  bool ok = qp < Sq && kp < Sk;
  if (causal) ok = ok && qp >= kp;
  if (window > 0) ok = ok && (qp - kp) < window;
  return ok;
}

// every (q, k) pair of the tiles [q0, q0 + bq) x [k0, k0 + bk) is valid
__device__ __forceinline__ bool tile_full(int q0, int bq, int k0, int bk,
                                          int Sq, int Sk, int causal,
                                          int window) {
  bool full = q0 + bq <= Sq && k0 + bk <= Sk;
  if (causal) full = full && k0 + bk - 1 <= q0;
  if (window > 0) full = full && (q0 + bq - 1) - k0 < window;
  return full;
}

// The k tiles [lo, hi) of size bk that the TPU kernel's block predicate
// keeps for the q tile [q0, q0 + bq), over Sk keys.
__device__ __forceinline__ void k_range(int q0, int bq, int bk, int Sk,
                                        int causal, int window, int& lo,
                                        int& hi) {
  lo = 0;
  hi = (Sk + bk - 1) / bk;
  if (causal) hi = min(hi, (q0 + bq - 1) / bk + 1);      // k0 <= q0 + bq - 1
  if (window > 0) {                          // q0 - (k0 + bk - 1) < window
    const int kmin = q0 - window - bk + 2;
    if (kmin > 0) lo = (kmin + bk - 1) / bk;
  }
}

// ------------------------------------------------------------------ forward
// grid (H, B, ceil(Sq / kFwdBQ)), q tile reversed.  q (B, Sq, H, D) with
// element strides (sq_b, sq_s, sq_h); k, v (B, Sk, KVH, D) with (sk_b, sk_s,
// sk_h); o contiguous (B, Sq, H, D); lse contiguous (B, H, Sq), f32.  Warp w
// owns rows [16 kFwdM w, 16 kFwdM (w + 1)) of the q tile.
template <int D>
__global__ void __launch_bounds__(kFwdWarps * 32, kFwdMinBlocks) flash_tc_fwd(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o,
    float* __restrict__ lse, int Sq, int Sk, int G, long long sq_b, long long sq_s,
    long long sq_h, long long sk_b, long long sk_s, long long sk_h,
    int causal, int window, float scale_log2) {
  constexpr int LD = Smem<D>::kLD;
  constexpr int kBQ = kFwdBQ, kBK = KeyTile<D>::kFwd, kM = kFwdM;
  constexpr int kNT = kFwdWarps * 32;
  constexpr int kND = D / 8, kNK = kBK / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);       // kBQ x LD
  bf16* Ks = Qs + kBQ * LD;                        // 2 stages of kBK x LD
  bf16* Vs = Ks + 2 * kBK * LD;                    // 2 stages of kBK x LD

  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;
  const int kvh = h / G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = warp * kRowsPerWarp * kM;
  const bf16* kb = k + b * sk_b + kvh * sk_h;
  const bf16* vb = v + b * sk_b + kvh * sk_h;

  int j_lo, j_hi;
  k_range(q0, kBQ, kBK, Sk, causal, window, j_lo, j_hi);
  load_tile<D, kBQ, kNT>(Qs, q + b * sq_b + h * sq_h, sq_s, q0, Sq);
  if (j_lo < j_hi) {
    load_tile<D, kBK, kNT>(Ks, kb, sk_s, j_lo * kBK, Sk);
    load_tile<D, kBK, kNT>(Vs, vb, sk_s, j_lo * kBK, Sk);
  }
  cp_async_commit();

  // row (mi, hf) of this thread: r0 + 16 mi + gq + 8 hf
  float acc[kM][kND][4];
  zero(acc);
  float m[kM][2], l[kM][2];
#pragma unroll
  for (int mi = 0; mi < kM; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) { m[mi][hf] = kNegInf; l[mi][hf] = 0.f; }

  for (int j = j_lo; j < j_hi; ++j) {
    const int st = (j - j_lo) & 1;
    cp_async_wait_all();
    __syncthreads();           // tile j is in; tile j - 1's stage is free
    if (j + 1 < j_hi) {
      load_tile<D, kBK, kNT>(Ks + (st ^ 1) * kBK * LD, kb, sk_s,
                             (j + 1) * kBK, Sk);
      load_tile<D, kBK, kNT>(Vs + (st ^ 1) * kBK * LD, vb, sk_s,
                             (j + 1) * kBK, Sk);
    }
    cp_async_commit();
    const bf16* Kt = Ks + st * kBK * LD;
    const bf16* Vt = Vs + st * kBK * LD;
    const int k0 = j * kBK;

    float s[kM][kNK][4];
    zero(s);
    mma_abt<D, kM, kBK>(s, Qs, r0, Kt, lane);

    const bool full = tile_full(q0, kBQ, k0, kBK, Sq, Sk, causal, window);
#pragma unroll
    for (int mi = 0; mi < kM; ++mi) {
#pragma unroll
      for (int i = 0; i < kNK; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[mi][i][e] * scale_log2;
          if (!full && !pair_valid(q0 + r0 + 16 * mi + gq + 8 * (e >> 1),
                                   k0 + 8 * i + 2 * tq + (e & 1), Sq, Sk,
                                   causal, window))
            x = kNegInf;
          s[mi][i][e] = x;
        }
      float mx[2] = {m[mi][0], m[mi][1]};
#pragma unroll
      for (int i = 0; i < kNK; ++i) {
        mx[0] = fmaxf(mx[0], fmaxf(s[mi][i][0], s[mi][i][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[mi][i][2], s[mi][i][3]));
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
        const float corr = exp2_approx(m[mi][hf] - mx[hf]);
        m[mi][hf] = mx[hf];
        l[mi][hf] *= corr;
#pragma unroll
        for (int i = 0; i < kND; ++i) {
          acc[mi][i][2 * hf] *= corr;
          acc[mi][i][2 * hf + 1] *= corr;
        }
      }
#pragma unroll
      for (int i = 0; i < kNK; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_approx(s[mi][i][e] - m[mi][e >> 1]);
          s[mi][i][e] = p;
          l[mi][e >> 1] += p;
        }
    }
    mma_pb<D, kM, kBK>(acc, s, Vt, lane);
  }

#pragma unroll
  for (int mi = 0; mi < kM; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float lr = l[mi][hf];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int qp = q0 + r0 + 16 * mi + gq + 8 * hf;
      if (qp >= Sq) continue;
      const float denom = fmaxf(lr, 1e-30f);
      bf16* orow = o + (((long long)b * Sq + qp) * H + h) * D + 2 * tq;
#pragma unroll
      for (int i = 0; i < kND; ++i)
        *reinterpret_cast<uint32_t*>(orow + 8 * i) = pack_bf16(
            acc[mi][i][2 * hf] / denom, acc[mi][i][2 * hf + 1] / denom);
      if (tq == 0)
        lse[((long long)b * H + h) * Sq + qp] = (m[mi][hf] + log2f(lr)) * kLn2;
    }
}

// ------------------------------------------------------------ backward: dQ
// grid (H, B, ceil(Sq / 128)), q tile reversed.  Every tensor contiguous:
// q, o, dout, dq (B, Sq, H, D); k, v (B, Sk, KVH, D); lse, delta (B, H, Sq).
// Writes delta = rowsum(dout * o) of its rows for flash_tc_bwd_dkdv.
template <int D>
__global__ void __launch_bounds__(kThreads, kDqMinBlocks) flash_tc_bwd_dq(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ o,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, bf16* __restrict__ dq, int Sq, int Sk, int KVH,
    int G, int causal, int window, float scale_log2, float scale) {
  constexpr int LD = Smem<D>::kLD;
  constexpr int kBQ = kDqBQ, kBK = KeyTile<D>::kDq;
  constexpr int kND = D / 8, kNK = kBK / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);       // kBQ x LD
  bf16* dOs = Qs + kBQ * LD;                       // kBQ x LD
  bf16* Ks = dOs + kBQ * LD;                       // 2 stages of kBK x LD
  bf16* Vs = Ks + 2 * kBK * LD;                    // 2 stages of kBK x LD

  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;
  const int kvh = h / G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = warp * kRowsPerWarp;
  const long long q_off = (long long)b * Sq * H * D + (long long)h * D;
  const long long kv_off = (long long)b * Sk * KVH * D + (long long)kvh * D;
  const long long sq = (long long)H * D, sk = (long long)KVH * D;

  int j_lo, j_hi;
  k_range(q0, kBQ, kBK, Sk, causal, window, j_lo, j_hi);
  load_tile<D, kBQ>(Qs, q + q_off, sq, q0, Sq);
  load_tile<D, kBQ>(dOs, dout + q_off, sq, q0, Sq);
  if (j_lo < j_hi) {
    load_tile<D, kBK>(Ks, k + kv_off, sk, j_lo * kBK, Sk);
    load_tile<D, kBK>(Vs, v + kv_off, sk, j_lo * kBK, Sk);
  }
  cp_async_commit();

  // delta of the warp's 16 rows: two lanes a row, 16-byte chunks
  float dl[2], ls[2];
  {
    const int r = lane >> 1, half = lane & 1;
    const int qp = q0 + r0 + r;
    float sum = 0.f;
    if (qp < Sq) {
      const bf16* orow = o + q_off + (long long)qp * sq;
      const bf16* drow = dout + q_off + (long long)qp * sq;
      for (int ch = half; ch < D / 8; ch += 2) {
        const uint4 a = *reinterpret_cast<const uint4*>(orow + ch * 8);
        const uint4 c = *reinterpret_cast<const uint4*>(drow + ch * 8);
        const uint32_t aw[4] = {a.x, a.y, a.z, a.w};
        const uint32_t cw[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sum = fmaf(__uint_as_float(aw[i] << 16), __uint_as_float(cw[i] << 16), sum);
          sum = fmaf(__uint_as_float(aw[i] & 0xffff0000u),
                     __uint_as_float(cw[i] & 0xffff0000u), sum);
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0 && qp < Sq) delta[((long long)b * H + h) * Sq + qp] = sum;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      dl[hf] = __shfl_sync(0xffffffffu, sum, 2 * (gq + 8 * hf));
      const int qr = q0 + r0 + gq + 8 * hf;
      ls[hf] = qr < Sq ? lse[((long long)b * H + h) * Sq + qr] * kLog2e : 0.f;
    }
  }

  float acc[1][kND][4];
  zero(acc);

  for (int j = j_lo; j < j_hi; ++j) {
    const int st = (j - j_lo) & 1;
    cp_async_wait_all();
    __syncthreads();
    if (j + 1 < j_hi) {
      load_tile<D, kBK>(Ks + (st ^ 1) * kBK * LD, k + kv_off, sk, (j + 1) * kBK, Sk);
      load_tile<D, kBK>(Vs + (st ^ 1) * kBK * LD, v + kv_off, sk, (j + 1) * kBK, Sk);
    }
    cp_async_commit();
    const bf16* Kt = Ks + st * kBK * LD;
    const bf16* Vt = Vs + st * kBK * LD;
    const int k0 = j * kBK;

    float s[1][kNK][4], dp[1][kNK][4];
    zero(s);
    zero(dp);
    mma_abt<D, 1, kBK>(s, Qs, r0, Kt, lane);
    mma_abt<D, 1, kBK>(dp, dOs, r0, Vt, lane);

    const bool full = tile_full(q0, kBQ, k0, kBK, Sq, Sk, causal, window);
#pragma unroll
    for (int i = 0; i < kNK; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1;
        float p = exp2_approx(s[0][i][e] * scale_log2 - ls[hf]);
        if (!full && !pair_valid(q0 + r0 + gq + 8 * hf,
                                 k0 + 8 * i + 2 * tq + (e & 1), Sq, Sk,
                                 causal, window))
          p = 0.f;
        dp[0][i][e] = p * (dp[0][i][e] - dl[hf]);    // dS / scale
      }
    mma_pb<D, 1, kBK>(acc, dp, Kt, lane);
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qp = q0 + r0 + gq + 8 * hf;
    if (qp >= Sq) continue;
    bf16* row = dq + q_off + (long long)qp * sq + 2 * tq;
#pragma unroll
    for (int i = 0; i < kND; ++i)
      *reinterpret_cast<uint32_t*>(row + 8 * i) =
          pack_bf16(acc[0][i][2 * hf] * scale, acc[0][i][2 * hf + 1] * scale);
  }
}

// ------------------------------------------------------- backward: dK, dV
// grid (KVH, B, ceil(Sk / 128)), k tile in order (the earliest keys are seen
// by the most q tiles).  Layouts as flash_tc_bwd_dq; delta is its output.
// Each warp owns 16 keys and computes S^T = K Q^T and dP^T = V dO^T, so P^T
// and dS^T are already the A operands of dV += P^T dO and dK += dS^T Q.
// kPass: both gradients, or only dV (no V, no dP^T) or only dK (see the
// header: head dims above 128).
template <int D, int kPass>
__global__ void __launch_bounds__(kThreads, 1) flash_tc_bwd_dkdv(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk, int H, int G,
    int causal, int window, float scale_log2, float scale) {
  constexpr int LD = Smem<D>::kLD;
  constexpr int kBK = kKvBK, kBQ = kKvBQ;
  constexpr int kND = D / 8, kNQ = kBQ / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);       // kBK x LD
  bf16* Vs = Ks + kBK * LD;                        // kBK x LD
  bf16* Qs = Vs + kBK * LD;                        // 2 stages of kBQ x LD
  bf16* dOs = Qs + 2 * kBQ * LD;                   // 2 stages of kBQ x LD
  float* Ls = reinterpret_cast<float*>(dOs + 2 * kBQ * LD);  // 2 x kBQ
  float* Ds = Ls + 2 * kBQ;                                    // 2 x kBQ

  const int kvh = blockIdx.x, b = blockIdx.y, KVH = gridDim.x;
  const int k0 = blockIdx.z * kBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = warp * kRowsPerWarp;
  const long long sq = (long long)H * D, sk = (long long)KVH * D;
  const long long kv_off = (long long)b * Sk * sk + (long long)kvh * D;

  // the q tiles [i_lo, i_hi) that see this k tile, for each of the G heads
  const int nq = (Sq + kBQ - 1) / kBQ;
  const int i_lo = causal ? k0 / kBQ : 0;
  const int i_hi = window > 0 ? min(nq, (window + k0 + kBK - 2) / kBQ + 1) : nq;
  const int n_i = max(0, i_hi - i_lo);
  const int n_it = G * n_i;

  constexpr bool kDv = kPass != kDkPass, kDk = kPass != kDvPass;
  load_tile<D, kBK>(Ks, k + kv_off, sk, k0, Sk);
  if (kDk) load_tile<D, kBK>(Vs, v + kv_off, sk, k0, Sk);
  // iteration `it`: head kvh * G + it / n_i, q tile i_lo + it % n_i
  auto load_q_tile = [&](int it, int stage) {
    const int gg = it / n_i;
    const int qs = (i_lo + it - gg * n_i) * kBQ;
    const long long q_off = (long long)b * Sq * sq + (long long)(kvh * G + gg) * D;
    load_tile<D, kBQ>(Qs + stage * kBQ * LD, q + q_off, sq, qs, Sq);
    load_tile<D, kBQ>(dOs + stage * kBQ * LD, dout + q_off, sq, qs, Sq);
  };
  // threads [0, kBQ) fetch lse * log2(e), [kBQ, 2 kBQ) delta of a q tile
  auto fetch_stat = [&](int it) -> float {
    const int t = threadIdx.x;
    if (t >= 2 * kBQ) return 0.f;
    const int gg = it / n_i;
    const int qp = (i_lo + it - gg * n_i) * kBQ + (t % kBQ);
    if (qp >= Sq) return 0.f;
    const long long idx = ((long long)b * H + kvh * G + gg) * Sq + qp;
    return t < kBQ ? lse[idx] * kLog2e : delta[idx];
  };
  auto store_stat = [&](int stage, float x) {
    const int t = threadIdx.x;
    if (t < kBQ) Ls[stage * kBQ + t] = x;
    else if (t < 2 * kBQ) Ds[stage * kBQ + t - kBQ] = x;
  };
  if (n_it > 0) {
    load_q_tile(0, 0);
    store_stat(0, fetch_stat(0));
  }
  cp_async_commit();

  // a pass's unused accumulator is one tile, never touched
  float dk_acc[1][kDk ? kND : 1][4], dv_acc[1][kDv ? kND : 1][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    cp_async_wait_all();
    __syncthreads();           // tile `it` is in; the other stage is free
    const bool more = it + 1 < n_it;
    float next_stat = 0.f;
    if (more) {
      load_q_tile(it + 1, st ^ 1);
      next_stat = fetch_stat(it + 1);
    }
    cp_async_commit();
    const int gg = it / n_i;
    const int q0 = (i_lo + it - gg * n_i) * kBQ;
    const bf16* Qt = Qs + st * kBQ * LD;
    const bf16* dOt = dOs + st * kBQ * LD;
    const float* Lt = Ls + st * kBQ;
    const float* Dt = Ds + st * kBQ;

    // rows: keys, columns: q.  P^T goes to bf16 fragments and into dV
    // before dP^T is formed, so the two f32 tiles are never live at once;
    // dS^T takes P^T from those fragments.
    float s[1][kNQ][4];
    zero(s);
    mma_abt<D, 1, kBQ>(s, Ks, r0, Qt, lane);
    const bool full = tile_full(q0, kBQ, k0, kBK, Sq, Sk, causal, window);
#pragma unroll
    for (int i = 0; i < kNQ; ++i) {
      const float2 lq = *reinterpret_cast<const float2*>(Lt + 8 * i + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = e & 1;
        float p = exp2_approx(s[0][i][e] * scale_log2 - (c ? lq.y : lq.x));
        if (!full && !pair_valid(q0 + 8 * i + 2 * tq + c,
                                 k0 + r0 + gq + 8 * (e >> 1), Sq, Sk,
                                 causal, window))
          p = 0.f;
        s[0][i][e] = p;
      }
    }
    uint32_t pa[1][kBQ / 16][4];
    pack_a<1, kBQ>(s, pa);
    if constexpr (kDv) mma_ab<D, 1, kBQ>(dv_acc, pa, dOt, lane);

    if constexpr (kDk) {
      float dp[1][kNQ][4];
      zero(dp);
      mma_abt<D, 1, kBQ>(dp, Vs, r0, dOt, lane);
#pragma unroll
      for (int i = 0; i < kNQ; ++i) {
        const float2 dl = *reinterpret_cast<const float2*>(Dt + 8 * i + 2 * tq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t w = pa[0][i >> 1][(i & 1) * 2 + (e >> 1)];
          const float p = __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
          dp[0][i][e] = p * (dp[0][i][e] - ((e & 1) ? dl.y : dl.x));  // dS / scale
        }
      }
      mma_pb<D, 1, kBQ>(dk_acc, dp, Qt, lane);
    }
    if (more) store_stat(st ^ 1, next_stat);
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int kp = k0 + r0 + gq + 8 * hf;
    if (kp >= Sk) continue;
    const long long off = kv_off + (long long)kp * sk + 2 * tq;
#pragma unroll
    for (int i = 0; i < kND; ++i) {
      if constexpr (kDk)
        *reinterpret_cast<uint32_t*>(dk + off + 8 * i) =
            pack_bf16(dk_acc[0][i][2 * hf] * scale,
                      dk_acc[0][i][2 * hf + 1] * scale);
      if constexpr (kDv)
        *reinterpret_cast<uint32_t*>(dv + off + 8 * i) =
            pack_bf16(dv_acc[0][i][2 * hf], dv_acc[0][i][2 * hf + 1]);
    }
  }
}

// ------------------------------------------------------------------ launch
template <int D> constexpr int fwd_smem() {
  return (kFwdBQ + 4 * KeyTile<D>::kFwd) * Smem<D>::kLD * 2;
}
template <int D> constexpr int dq_smem() {
  return (2 * kDqBQ + 4 * KeyTile<D>::kDq) * Smem<D>::kLD * 2;
}
template <int D> constexpr int dkdv_smem() {
  return (2 * kKvBK + 4 * kKvBQ) * Smem<D>::kLD * 2 + 4 * kKvBQ * 4;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

float scale_log2_of(int D) { return kLog2e / sqrtf((float)D); }

template <int D>
cudaError_t fwd_for(const void* q, const void* k, const void* v, void* o,
                    float* lse, int B, int Sq, int Sk, int H, int KVH,
                    const long long* sq, const long long* sk, int causal,
                    int window, cudaStream_t stream) {
  const int smem = fwd_smem<D>();
  cudaError_t e = allow_smem(flash_tc_fwd<D>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(H, B, (Sq + kFwdBQ - 1) / kFwdBQ);
  flash_tc_fwd<D><<<grid, kFwdWarps * 32, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, Sq, Sk,
      H / KVH, sq[0], sq[1], sq[2], sk[0], sk[1], sk[2], causal, window,
      scale_log2_of(D));
  return cudaGetLastError();
}

template <int D, int kPass>
cudaError_t dkdv_for(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dk, void* dv, int B, int Sq, int Sk, int H,
                     int KVH, int causal, int window, cudaStream_t stream) {
  const int smem_kv = dkdv_smem<D>();
  cudaError_t e = allow_smem(flash_tc_bwd_dkdv<D, kPass>, smem_kv);
  if (e != cudaSuccess) return e;
  flash_tc_bwd_dkdv<D, kPass><<<dim3(KVH, B, (Sk + kKvBK - 1) / kKvBK),
                                kThreads, smem_kv, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse,
      delta, (bf16*)dk, (bf16*)dv, Sq, Sk, H, H / KVH, causal, window,
      scale_log2_of(D), 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_for(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const float* lse,
                    float* delta, void* dq, void* dk, void* dv, int B, int Sq,
                    int Sk, int H, int KVH, int causal, int window,
                    cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)D);
  const int smem_q = dq_smem<D>();
  cudaError_t e = allow_smem(flash_tc_bwd_dq<D>, smem_q);
  if (e != cudaSuccess) return e;
  flash_tc_bwd_dq<D><<<dim3(H, B, (Sq + kDqBQ - 1) / kDqBQ), kThreads,
                       smem_q, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o,
      (const bf16*)dout, lse, delta, (bf16*)dq, Sq, Sk, KVH, H / KVH, causal,
      window, scale_log2_of(D), scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  if constexpr (D > kWideD) {     // two passes (see the header)
    e = dkdv_for<D, kDvPass>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk,
                             H, KVH, causal, window, stream);
    if (e != cudaSuccess) return e;
    return dkdv_for<D, kDkPass>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk,
                                H, KVH, causal, window, stream);
  } else {
    return dkdv_for<D, kBothPass>(q, k, v, dout, lse, delta, dk, dv, B, Sq,
                                  Sk, H, KVH, causal, window, stream);
  }
}

// Sq != Sk only without a causal mask or a window (see the header)
bool shapes_ok(int B, int Sq, int Sk, int H, int KVH, int causal, int window) {
  return B > 0 && B <= 65535 && Sq > 0 && Sk > 0
         && (Sq + kFwdBQ - 1) / kFwdBQ <= 65535
         && (Sk + kKvBK - 1) / kKvBK <= 65535
         && (Sq == Sk || (!causal && window <= 0))
         && H > 0 && KVH > 0 && H % KVH == 0;
}

#define REPRO_FOR_EACH_HEAD_DIM(X) \
  X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128) X(192)

}  // namespace

// bf16 only.  q (B, Sq, H, D) and k, v (B, Sk, KVH, D) are read through
// their element strides (batch, seq, head; unit stride over D, 16-byte
// aligned rows); o (B, Sq, H, D) and lse (B, H, Sq, f32) are contiguous.
// Returns the cudaError_t of the launch (0 on success); nothing is
// synchronised.
extern "C" int repro_flash_attention_tc_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int B, int Sq, int Sk, int H, int KVH, int D,
    long long sq_b, long long sq_s, long long sq_h,
    long long sk_b, long long sk_s, long long sk_h,
    int causal, int window, void* stream) {
  if (!shapes_ok(B, Sq, Sk, H, KVH, causal, window))
    return (int)cudaErrorInvalidValue;
  const long long sq[3] = {sq_b, sq_s, sq_h};
  const long long sk[3] = {sk_b, sk_s, sk_h};
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
#define REPRO_CASE(DD) \
    case DD: return (int)fwd_for<DD>(q, k, v, o, (float*)lse, B, Sq, Sk, H, \
                                     KVH, sq, sk, causal, window, s);
    REPRO_FOR_EACH_HEAD_DIM(REPRO_CASE)
#undef REPRO_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// Gradients of repro_flash_attention_tc_fwd, bf16.  Every tensor
// contiguous: q, o, dout, dq (B, Sq, H, D); k, v, dk, dv (B, Sk, KVH, D);
// lse (the forward's) and delta (scratch) (B, H, Sq) f32.  Two launches on
// `stream`: dQ (which also writes delta), then dK/dV.
extern "C" int repro_flash_attention_tc_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int H, int KVH, int D, int causal,
    int window, void* stream) {
  if (!shapes_ok(B, Sq, Sk, H, KVH, causal, window))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
#define REPRO_CASE(DD) \
    case DD: return (int)bwd_for<DD>(q, k, v, o, dout, (const float*)lse, \
                                     (float*)delta, dq, dk, dv, B, Sq, Sk, H, \
                                     KVH, causal, window, s);
    REPRO_FOR_EACH_HEAD_DIM(REPRO_CASE)
#undef REPRO_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

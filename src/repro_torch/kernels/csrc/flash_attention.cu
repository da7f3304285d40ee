// Blocked causal / sliding-window / non-causal attention for prefill and
// training, forward and backward, in f32 on the CUDA cores of NVIDIA Hopper
// (sm_90a).  This is the route of float32 tensors only: bf16 tensors take
// the tensor-core kernels of flash_attention_tc.cu (TF32 products would
// keep about three decimal digits, too few for the f32 checks).
//
// Replaces the TPU kernel `flash_attention_kernel` / `_kernel` of
// src/repro/kernels/flash_attention/flash_attention.py: q (B, Sq, H, D)
// attends to k, v (B, Sk, KVH, D), query head h reading KV head h / G, blocks
// wholly above the causal diagonal or outside the window skipped, the tail
// masked by k_pos < Sk.  Sq may differ from Sk (cross-attention) only
// without a causal mask or a window (shapes_ok refuses the rest); the TPU
// kernel takes one S.  Same arithmetic: f32 running max / sum /
// accumulator, masked scores are -1e30 (finite), the result is divided by
// max(l, 1e-30).  The reference has no backward kernel (XLA differentiates
// its chunked scan); here the forward also writes the per-row logsumexp
// and three more kernels compute the gradients from it:
//   flash_bwd_delta  D = rowsum(dO * O), one warp per row;
//   flash_bwd_dkdv   one block per (b, kv_head, k_block): loops over the G
//                    query heads of the group and over the q blocks that
//                    can see the k block, so the GQA sum over G is taken in
//                    one block (no atomics, deterministic);
//   flash_bwd_dq     one block per (b, h, q_block), loops over the kv
//                    blocks it can see.
//
// What bounds it on this card: operations.  At the training shape (S=4096,
// D=128, causal) there are ~S/2 * D * 4 flops per query row against a few
// hundred bytes read, far above the ~295 operations per byte at which HBM
// would become the limit.  In f32 on the CUDA cores the ceiling is the
// 67 TFLOP/s f32 rate.
//
// What the design does about it, within that:
//  * q, k, v are read in the model layout (B, S, heads, D) through strides
//    (the reference wrapper transposes all three per call); the tail rows
//    past S are zero-filled in shared memory, never fetched;
//  * 64 x 64 tiles staged in shared memory (q pre-scaled by 1/sqrt(D))
//    with a padded row stride, so a half-warp reading 16 different rows at
//    one column hits 16 different banks;
//  * 256 threads: thread (tr, tc) = (t / 16, t % 16) owns rows 4tr..4tr+3
//    of the score tile and keys tc, tc+16, tc+32, tc+48 — 16 FMAs per 8
//    shared loads — and the same 4 rows of the output, columns tc + 16c;
//    a row's max and sum are reduced over its 16 lanes by shuffles;
//  * whole kv (forward, dQ) or q (dK/dV) blocks outside the causal /
//    window band are skipped by the same predicate as the TPU kernel's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;            // query rows per tile
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 256;
constexpr int kLDP = kBK + 1;      // row stride of a score tile (floats)

// max / sum over the 16 lanes that share a row (lanes 0-15 or 16-31)
__device__ __forceinline__ float row_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// the TPU kernel's block predicate: is any (q, k) pair of the two tiles
// inside the causal / window band?
__device__ __forceinline__ bool block_needed(int q0, int k0, int causal,
                                             int window) {
  bool needed = true;
  if (causal) needed = k0 <= q0 + kBQ - 1;
  if (window > 0) needed = needed && (q0 - (k0 + kBK - 1) < window);
  return needed;
}

__device__ __forceinline__ bool pair_valid(int qp, int kp, int Sk, int causal,
                                           int window) {
  bool ok = kp < Sk;
  if (causal) ok = ok && qp >= kp;
  if (window > 0) ok = ok && (qp - kp) < window;
  return ok;
}

// Stage rows s0 .. s0 + kRows - 1 of one head into shared memory, times
// `mul`, at row stride `ld` floats; rows at or past S become zeros.
// `base` points at (b, s = 0, head, d = 0); rows are `stride_s` elements
// apart and 16-byte aligned, d has unit stride.
template <int D, int kRows>
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const float* base,
                                           long long stride_s, int s0, int S,
                                           float mul) {
  constexpr int kPer = 4;                      // floats in 16 bytes
  constexpr int kChunks = D / kPer;
  for (int c = threadIdx.x; c < kRows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int ch = c - r * kChunks;
    const int s = s0 + r;
    float f[kPer];
    if (s < S) {
      const float4 u = *reinterpret_cast<const float4*>(
          base + (long long)s * stride_s + ch * kPer);
      f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
    } else {
#pragma unroll
      for (int i = 0; i < kPer; ++i) f[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) dst[r * ld + ch * kPer + i] = f[i] * mul;
  }
}

// f32 row stride of a (rows, D) tile: odd, so 16 rows at one column fall
// into 16 banks
template <int D> struct Tile { static constexpr int kLD = D + 1; };

// ------------------------------------------------------------------ forward
// grid (ceil(Sq / kBQ), H, B).  q: (B, Sq, H, D) with element strides
// (sq_b, sq_s, sq_h); k, v: (B, Sk, KVH, D) with (sk_b, sk_s, sk_h); o
// contiguous (B, Sq, H, D); lse contiguous (B, H, Sq), f32.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse,
    int Sq, int Sk, int G, long long sq_b, long long sq_s, long long sq_h,
    long long sk_b, long long sk_s, long long sk_h, int causal, int window,
    float scale) {
  constexpr int LD = Tile<D>::kLD;
  constexpr int kCols = D / 16;               // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                           // kBQ x LD
  float* Ks = Qs + kBQ * LD;                  // kBK x LD
  float* Vs = Ks + kBK * LD;                  // kBK x D
  float* Ps = Vs + kBK * D;                   // kBQ x kLDP

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = gridDim.y;
  const int kvh = h / G;
  const int tr = threadIdx.x >> 4;
  const int tc = threadIdx.x & 15;
  const float* kbase = k + b * sk_b + kvh * sk_h;
  const float* vbase = v + b * sk_b + kvh * sk_h;

  stage_rows<D, kBQ>(Qs, LD, q + b * sq_b + h * sq_h, sq_s, q0, Sq, scale);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const int nk = (Sk + kBK - 1) / kBK;
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kBK;
    if (!block_needed(q0, k0, causal, window)) continue;
    __syncthreads();                 // the previous tile is consumed
    stage_rows<D, kBK>(Ks, LD, kbase, sk_s, k0, Sk, 1.f);
    stage_rows<D, kBK>(Vs, D, vbase, sk_s, k0, Sk, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(4 * tr + i) * LD + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = Ks[(tc + 16 * jj) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * tr + i;
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (!pair_valid(qp, k0 + tc + 16 * jj, Sk, causal, window))
          s[i][jj] = kNegInf;
        mx = fmaxf(mx, s[i][jj]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - m_new);
        Ps[(4 * tr + i) * kLDP + tc + 16 * jj] = p;
        rs += p;
      }
      l[i] = l[i] * corr + row_sum(rs);
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
    __syncwarp();                    // a row's P is written and read by its 16 lanes

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(4 * tr + i) * kLDP + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = Vs[kk * D + tc + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
    __syncwarp();                    // P is read before the next tile rewrites it
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * tr + i;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = o + (((long long)b * Sq + qp) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      orow[tc + 16 * c] = acc[i][c] / denom;
    if (tc == 0) lse[((long long)b * H + h) * Sq + qp] = m[i] + logf(l[i]);
  }
}

// ------------------------------------------------------------ backward: D
// One warp per (b, s, h) row of the contiguous (B, Sq, H, D) o and dout;
// delta (B, H, Sq) = rowsum(dout * o) in f32.
__global__ void __launch_bounds__(kThreads) flash_bwd_delta_kernel(
    const float* __restrict__ o, const float* __restrict__ dout,
    float* __restrict__ delta, long long n_rows, int S, int H, int D) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(o[row * D + d], dout[row * D + d], acc);
  acc = warp_sum(acc);
  if (lane == 0) {
    const long long b = row / ((long long)S * H);
    const long long rem = row - b * S * H;
    const long long s = rem / H;
    const long long h = rem - s * H;
    delta[(b * H + h) * S + s] = acc;
  }
}

// Score tile of one (q tile, k tile) pair, recomputed from the saved
// logsumexp: writes P and dS = P * (dP - delta) into shared memory.  Rows
// 4tr..4tr+3, keys tc + 16 jj, as in the forward.
template <int D>
__device__ __forceinline__ void bwd_scores(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* lse_s, const float* dl_s, float* Ps, float* dSs, int q0,
    int k0, int Sq, int Sk, int causal, int window) {
  constexpr int LD = Tile<D>::kLD;
  const int tr = threadIdx.x >> 4;
  const int tc = threadIdx.x & 15;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) { s[i][jj] = 0.f; dp[i][jj] = 0.f; }
#pragma unroll 2
  for (int d = 0; d < D; ++d) {
    float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = Qs[(4 * tr + i) * LD + d];
      dov[i] = dOs[(4 * tr + i) * LD + d];
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      kv[jj] = Ks[(tc + 16 * jj) * LD + d];
      vv[jj] = Vs[(tc + 16 * jj) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
        dp[i][jj] = fmaf(dov[i], vv[jj], dp[i][jj]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * tr + i;
    const int qp = q0 + r;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int kp = k0 + tc + 16 * jj;
      const bool ok = qp < Sq && pair_valid(qp, kp, Sk, causal, window);
      const float p = ok ? expf(s[i][jj] - lse_s[r]) : 0.f;
      if (Ps != nullptr) Ps[r * kLDP + tc + 16 * jj] = p;
      dSs[r * kLDP + tc + 16 * jj] = p * (dp[i][jj] - dl_s[r]);
    }
  }
}

// Stage the saved logsumexp and delta of rows q0 .. q0 + kBQ - 1 of one head.
__device__ __forceinline__ void stage_row_stats(
    float* lse_s, float* dl_s, const float* lse, const float* delta,
    long long head_off, int q0, int S) {
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const int qp = q0 + r;
    lse_s[r] = qp < S ? lse[head_off + qp] : 0.f;
    dl_s[r] = qp < S ? delta[head_off + qp] : 0.f;
  }
}

// ------------------------------------------------------- backward: dK, dV
// grid (ceil(Sk / kBK), KVH, B).  All tensors contiguous: q, dout
// (B, Sq, H, D); k, v, dk, dv (B, Sk, KVH, D); lse, delta (B, H, Sq).
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int H,
    int G,
    int causal, int window, float scale) {
  constexpr int LD = Tile<D>::kLD;
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                           // kBK x LD
  float* Vs = Ks + kBK * LD;                  // kBK x LD
  float* Qs = Vs + kBK * LD;                  // kBQ x LD (pre-scaled)
  float* dOs = Qs + kBQ * LD;                 // kBQ x LD
  float* Ps = dOs + kBQ * LD;                 // kBQ x kLDP
  float* dSs = Ps + kBQ * kLDP;               // kBQ x kLDP
  float* lse_s = dSs + kBQ * kLDP;            // kBQ
  float* dl_s = lse_s + kBQ;                  // kBQ

  const int k0 = blockIdx.x * kBK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int KVH = gridDim.y;
  const int tr = threadIdx.x >> 4;
  const int tc = threadIdx.x & 15;
  const long long kv_off = (long long)b * Sk * KVH * D + (long long)kvh * D;
  stage_rows<D, kBK>(Ks, LD, k + kv_off, (long long)KVH * D, k0, Sk, 1.f);
  stage_rows<D, kBK>(Vs, LD, v + kv_off, (long long)KVH * D, k0, Sk, 1.f);

  float dk_acc[4][kCols], dv_acc[4][kCols];     // keys 4tr+i, columns tc+16c
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) { dk_acc[i][c] = 0.f; dv_acc[i][c] = 0.f; }

  const int nq = (Sq + kBQ - 1) / kBQ;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const long long q_off = (long long)b * Sq * H * D + (long long)h * D;
    const long long head_off = ((long long)b * H + h) * Sq;
    for (int qi = 0; qi < nq; ++qi) {
      const int q0 = qi * kBQ;
      if (!block_needed(q0, k0, causal, window)) continue;
      __syncthreads();               // the previous q tile is consumed
      stage_rows<D, kBQ>(Qs, LD, q + q_off, (long long)H * D, q0, Sq, scale);
      stage_rows<D, kBQ>(dOs, LD, dout + q_off, (long long)H * D, q0, Sq, 1.f);
      stage_row_stats(lse_s, dl_s, lse, delta, head_off, q0, Sq);
      __syncthreads();
      bwd_scores<D>(Qs, dOs, Ks, Vs, lse_s, dl_s, Ps, dSs, q0, k0, Sq, Sk,
                    causal, window);
      __syncthreads();               // P, dS are read by key instead of by row
#pragma unroll 2
      for (int r = 0; r < kBQ; ++r) {
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[r * kLDP + 4 * tr + i];
          dsv[i] = dSs[r * kLDP + 4 * tr + i];
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float dov = dOs[r * LD + tc + 16 * c];
          const float qv = Qs[r * LD + tc + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][c] = fmaf(pv[i], dov, dv_acc[i][c]);
            dk_acc[i][c] = fmaf(dsv[i], qv, dk_acc[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + 4 * tr + i;
    if (kp >= Sk) continue;
    const long long row = kv_off + (long long)kp * KVH * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dk[row + tc + 16 * c] = dk_acc[i][c];
      dv[row + tc + 16 * c] = dv_acc[i][c];
    }
  }
}

// ------------------------------------------------------------ backward: dQ
// grid (ceil(Sq / kBQ), H, B); layouts as flash_bwd_dkdv_kernel.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int Sq, int Sk, int KVH, int G, int causal,
    int window,
    float scale) {
  constexpr int LD = Tile<D>::kLD;
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                           // kBQ x LD (pre-scaled)
  float* dOs = Qs + kBQ * LD;                 // kBQ x LD
  float* Ks = dOs + kBQ * LD;                 // kBK x LD
  float* Vs = Ks + kBK * LD;                  // kBK x LD
  float* dSs = Vs + kBK * LD;                 // kBQ x kLDP
  float* lse_s = dSs + kBQ * kLDP;            // kBQ
  float* dl_s = lse_s + kBQ;                  // kBQ

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = gridDim.y;
  const int kvh = h / G;
  const int tr = threadIdx.x >> 4;
  const int tc = threadIdx.x & 15;
  const long long q_off = (long long)b * Sq * H * D + (long long)h * D;
  const long long kv_off = (long long)b * Sk * KVH * D + (long long)kvh * D;
  stage_rows<D, kBQ>(Qs, LD, q + q_off, (long long)H * D, q0, Sq, scale);
  stage_rows<D, kBQ>(dOs, LD, dout + q_off, (long long)H * D, q0, Sq, 1.f);
  stage_row_stats(lse_s, dl_s, lse, delta, ((long long)b * H + h) * Sq, q0,
                  Sq);

  float dq_acc[4][kCols];                     // rows 4tr+i, columns tc+16c
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq_acc[i][c] = 0.f;

  const int nk = (Sk + kBK - 1) / kBK;
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kBK;
    if (!block_needed(q0, k0, causal, window)) continue;
    __syncthreads();                 // the previous k tile is consumed
    stage_rows<D, kBK>(Ks, LD, k + kv_off, (long long)KVH * D, k0, Sk, 1.f);
    stage_rows<D, kBK>(Vs, LD, v + kv_off, (long long)KVH * D, k0, Sk, 1.f);
    __syncthreads();
    bwd_scores<D>(Qs, dOs, Ks, Vs, lse_s, dl_s, nullptr, dSs, q0, k0, Sq, Sk,
                  causal, window);
    __syncwarp();                    // a row's dS is written and read by its 16 lanes
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float dsv[4], kv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(4 * tr + i) * kLDP + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = Ks[kk * LD + tc + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) dq_acc[i][c] = fmaf(dsv[i], kv[c], dq_acc[i][c]);
    }
    __syncwarp();                    // dS is read before the next tile rewrites it
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * tr + i;
    if (qp >= Sq) continue;
    float* row = dq + q_off + (long long)qp * H * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      row[tc + 16 * c] = dq_acc[i][c] * scale;
  }
}

// ------------------------------------------------------------------ launch
template <int D> constexpr int fwd_smem() {
  return (kBQ * Tile<D>::kLD + kBK * Tile<D>::kLD + kBK * D + kBQ * kLDP) * 4;
}
template <int D> constexpr int dkdv_smem() {
  return (2 * kBK * Tile<D>::kLD + 2 * kBQ * Tile<D>::kLD + 2 * kBQ * kLDP
          + 2 * kBQ) * 4;
}
template <int D> constexpr int dq_smem() {
  return (2 * kBQ * Tile<D>::kLD + 2 * kBK * Tile<D>::kLD + kBQ * kLDP
          + 2 * kBQ) * 4;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int D>
cudaError_t fwd_for(const float* q, const float* k, const float* v, float* o,
                    float* lse, int B, int Sq, int Sk, int H, int KVH,
                    const long long* sq, const long long* sk, int causal,
                    int window, cudaStream_t stream) {
  const int smem = fwd_smem<D>();
  cudaError_t e = allow_smem(flash_fwd_kernel<D>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, lse, Sq, Sk, H / KVH, sq[0], sq[1], sq[2], sk[0], sk[1], sk[2],
      causal, window, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_for(const float* q, const float* k, const float* v,
                    const float* o, const float* dout, const float* lse,
                    float* delta, float* dq, float* dk, float* dv, int B,
                    int Sq, int Sk, int H, int KVH, int causal, int window,
                    cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)D);
  const long long n_rows = (long long)B * Sq * H;
  const int rows_per_block = kThreads / 32;
  flash_bwd_delta_kernel<<<(unsigned)((n_rows + rows_per_block - 1) / rows_per_block),
                           kThreads, 0, stream>>>(o, dout, delta, n_rows, Sq,
                                                  H, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const int smem_kv = dkdv_smem<D>();
  e = allow_smem(flash_bwd_dkdv_kernel<D>, smem_kv);
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_kernel<D><<<dim3((Sk + kBK - 1) / kBK, KVH, B), kThreads,
                             smem_kv, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, Sq, Sk, H, H / KVH, causal, window,
      scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const int smem_q = dq_smem<D>();
  e = allow_smem(flash_bwd_dq_kernel<D>, smem_q);
  if (e != cudaSuccess) return e;
  flash_bwd_dq_kernel<D><<<dim3((Sq + kBQ - 1) / kBQ, H, B), kThreads,
                           smem_q, stream>>>(
      q, k, v, dout, lse, delta, dq, Sq, Sk, KVH, H / KVH, causal, window,
      scale);
  return cudaGetLastError();
}

// 192: DeepSeek-V3's MLA (nope 128 + rope 64); its dK/dV kernel needs
// 231,424 B of shared memory (dkdv_smem), 1,024 under a block's 232,448
#define REPRO_FOR_EACH_HEAD_DIM(X) \
  X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128) X(192)

// Sq != Sk only without a causal mask or a window (see the header)
bool shapes_ok(int B, int Sq, int Sk, int H, int KVH, int causal, int window) {
  return B > 0 && B <= 65535 && Sq > 0 && Sk > 0 && H > 0 && H <= 65535
         && KVH > 0 && H % KVH == 0
         && (Sq == Sk || (!causal && window <= 0));
}

}  // namespace

// float32 only.  q (B, Sq, H, D) and k, v (B, Sk, KVH, D) are read through
// their element strides (batch, seq, head; unit stride over D, 16-byte
// aligned rows); o (B, Sq, H, D) and lse (B, H, Sq) are contiguous.  Returns
// the cudaError_t of the launch (0 on success); nothing is synchronised.
extern "C" int repro_flash_attention_fwd(
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
    case DD: return (int)fwd_for<DD>((const float*)q, (const float*)k, \
                                     (const float*)v, (float*)o, (float*)lse, \
                                     B, Sq, Sk, H, KVH, sq, sk, causal, window, \
                                     s);
    REPRO_FOR_EACH_HEAD_DIM(REPRO_CASE)
#undef REPRO_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// Gradients of repro_flash_attention_fwd, float32.  Every tensor
// contiguous: q, o, dout, dq (B, Sq, H, D); k, v, dk, dv (B, Sk, KVH, D);
// lse (the forward's) and delta (scratch) (B, H, Sq).  Three launches on
// `stream`.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int H, int KVH, int D, int causal,
    int window, void* stream) {
  if (!shapes_ok(B, Sq, Sk, H, KVH, causal, window))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
#define REPRO_CASE(DD) \
    case DD: return (int)bwd_for<DD>( \
        (const float*)q, (const float*)k, (const float*)v, (const float*)o, \
        (const float*)dout, (const float*)lse, (float*)delta, (float*)dq, \
        (float*)dk, (float*)dv, B, Sq, Sk, H, KVH, causal, window, s);
    REPRO_FOR_EACH_HEAD_DIM(REPRO_CASE)
#undef REPRO_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// The mask and tile ranges of the flash-attention kernels
// (flash_attention.cu, flash_attention_wgmma.cu, flash_attention_wgmma_bwd.cu,
// flash_decode.cu), in one place.  `pair_valid`: whether the query row at
// absolute position qa sees the key at position kp of Sk keys under a
// causal mask and a sliding window.  The reference's predicate
// (src/repro/kernels/flash_attention/flash_attention.py, `_kernel`):
// k_pos < Sk, causal q_pos >= k_pos, window q_pos - k_pos < window.
// A kernel whose rows sit at q_off + local row (a rank's rows of a
// sequence split) passes q_off + row.  The tile predicates below take the
// tiles' sizes as arguments, so every kernel's tiles use the same rules.

#pragma once

namespace {

__device__ __forceinline__ bool pair_valid(int qa, int kp, int Sk, int causal,
                                           int window) {
  bool ok = kp < Sk;
  if (causal) ok = ok && qa >= kp;
  if (window > 0) ok = ok && (qa - kp) < window;
  return ok;
}

// qp: the local row (checked against Sq); its absolute position q_off + qp
// is what the mask compares with the key
__device__ __forceinline__ bool row_pair_valid(int qp, int kp, int Sq, int Sk,
                                               int causal, int window,
                                               int q_off) {
  return qp < Sq && pair_valid(q_off + qp, kp, Sk, causal, window);
}

// the TPU kernel's block predicate: is any (q, k) pair of the q tile at
// absolute positions [qa, qa + bq) and the k tile [k0, k0 + bk) inside the
// causal / window band?
__device__ __forceinline__ bool tile_needed(int qa, int bq, int k0, int bk,
                                            int causal, int window) {
  bool needed = true;
  if (causal) needed = k0 <= qa + bq - 1;
  if (window > 0) needed = needed && (qa - (k0 + bk - 1) < window);
  return needed;
}

// every (q, k) pair of the tiles [q0, q0 + bq) x [k0, k0 + bk) is valid
// (q0 local, at absolute position q_off + q0)
__device__ __forceinline__ bool tile_full(int q0, int bq, int k0, int bk,
                                          int Sq, int Sk, int causal,
                                          int window, int q_off) {
  bool full = q0 + bq <= Sq && k0 + bk <= Sk;
  const int qa = q_off + q0;
  if (causal) full = full && k0 + bk - 1 <= qa;
  if (window > 0) full = full && (qa + bq - 1) - k0 < window;
  return full;
}

// floor(a / b) for b > 0 and any a
__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((b - 1 - a) / b);
}

// The k tiles [lo, hi) of size bk that the block predicate keeps for the q
// tile at absolute position qa .. qa + bq - 1, over Sk keys.
__device__ __forceinline__ void k_range(int qa, int bq, int bk, int Sk,
                                        int causal, int window, int& lo,
                                        int& hi) {
  lo = 0;
  hi = (Sk + bk - 1) / bk;
  if (causal) hi = min(hi, (qa + bq - 1) / bk + 1);      // k0 <= qa + bq - 1
  if (window > 0) {                          // qa - (k0 + bk - 1) < window
    const int kmin = qa - window - bk + 2;
    if (kmin > 0) lo = (kmin + bk - 1) / bk;
  }
}

}  // namespace

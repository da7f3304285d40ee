// The mask of the flash-attention kernels (flash_attention.cu,
// flash_attention_tc.cu, flash_decode.cu), in one place: whether the query
// row at absolute position qa sees the key at position kp of Sk keys under
// a causal mask and a sliding window.  The reference's predicate
// (src/repro/kernels/flash_attention/flash_attention.py, `_kernel`):
// k_pos < Sk, causal q_pos >= k_pos, window q_pos - k_pos < window.
// A kernel whose rows sit at q_off + local row (a rank's rows of a
// sequence split) passes q_off + row.

#pragma once

namespace {

__device__ __forceinline__ bool pair_valid(int qa, int kp, int Sk, int causal,
                                           int window) {
  bool ok = kp < Sk;
  if (causal) ok = ok && qa >= kp;
  if (window > 0) ok = ok && (qa - kp) < window;
  return ok;
}

}  // namespace

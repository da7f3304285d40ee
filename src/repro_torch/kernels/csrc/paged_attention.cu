// Decode attention through a KV page table, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_attention_kernel` / `_kernel` of
// src/repro/kernels/paged_attention/paged_attention.py: one query token per
// sequence attends to its whole context, whose K/V rows live in a shared
// frame pool and are found through a per-sequence page table (the address
// translation of the paper, applied to the KV cache).  Same arithmetic:
// online softmax with fp32 accumulation, masked scores are -1e30 (finite),
// the result is divided by max(l, 1e-30).
//
// What bounds it on this card: bytes.  Every valid K and V row is read
// exactly once, sum_b len_b * KVH * D * 2 elements, and there are only
// 2 * G * D multiply-adds per K/V row pair read, far below the ~295
// operations per byte at which the tensor cores would become the limit.
//
// What the design does about it:
//  * the pools are read in the model's layout (P, ps, KVH, D) through the
//    strides that are passed in, so no transposed copy of the pool is ever
//    made (the TPU wrapper transposes the whole pool on each call);
//  * the TPU grid (batch, kv_head, page) with a sequential page axis and
//    accumulators in scratch memory becomes one block per (kv_head, batch)
//    that loops over 32-token tiles; (m, l, acc) stay in registers;
//  * a tile of K and V is staged in shared memory once, with 16-byte loads,
//    and shared by all G query heads of the group, one warp per head, so
//    K/V bytes are fetched once per group and not once per head;
//  * the block reads its own page-table entries and its length (no scalar
//    prefetch); tiles wholly past `length` or wholly before the sliding
//    window are skipped, and masked rows (unmapped page, past the length,
//    outside the window) are not fetched at all: they are zero-filled in
//    shared memory and get probability 0, so a -1 entry can never turn
//    into an address (the TPU kernel clamps it to frame 0 and masks).
//  * the block always has 8 warps and every thread takes part in the
//    loads; the next tile's 16-byte loads are issued into registers before
//    the current tile is computed, so their latency hides behind the
//    arithmetic (one block has no neighbour on its SM to hide it);
//  * within a tile, lane t owns token t for the score (a full D-long dot
//    product against the query kept in shared memory as fp32; the padded
//    row stride keeps the 16-byte shared loads free of bank conflicts),
//    and each lane owns D/32 neighbouring output columns for P.V, with the
//    32 probabilities passed around by warp shuffles.
// Not done here (later work): split-KV across blocks for small B*KVH,
// cp.async/TMA bulk loads, tensor-core products.
//
// A row for which no position is valid (length <= 0, or every page in
// reach unmapped) gets the reference's result: its softmax over equal
// -1e30 scores weighs every position alike, so the output is the mean of
// the V rows of all NP * ps positions, an unmapped page read as frame 0.
// Only that case reads a masked row, after the walk.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTile = 32;        // tokens per tile == lanes per warp
constexpr int kWarps = 8;        // warps per block == query heads per block
constexpr int kThreads = kWarps * 32;

// kCols neighbouring elements of a shared-memory row, read in one access
template <typename Raw, int kCols>
struct alignas(sizeof(Raw) * kCols) RawVec { Raw e[kCols]; };

__device__ __forceinline__ float bf16_bits_to_float(unsigned int bits16) {
  return __uint_as_float(bits16 << 16);
}

template <typename T> struct Elem;

template <> struct Elem<float> {
  typedef float Raw;                        // storage type of one element
  static constexpr int kPerChunk = 4;       // elements in 16 bytes
  __device__ static __forceinline__ float raw_to_float(float r) { return r; }
  __device__ static __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
  }
  __device__ static __forceinline__ float load(const float* p) { return *p; }
  __device__ static __forceinline__ float from_float(float x) { return x; }
};

template <> struct Elem<__nv_bfloat16> {
  typedef unsigned short Raw;
  static constexpr int kPerChunk = 8;
  __device__ static __forceinline__ float raw_to_float(unsigned short r) {
    return bf16_bits_to_float(r);
  }
  __device__ static __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = bf16_bits_to_float(u.x & 0xffffu); f[1] = __uint_as_float(u.x & 0xffff0000u);
    f[2] = bf16_bits_to_float(u.y & 0xffffu); f[3] = __uint_as_float(u.y & 0xffff0000u);
    f[4] = bf16_bits_to_float(u.z & 0xffffu); f[5] = __uint_as_float(u.z & 0xffff0000u);
    f[6] = bf16_bits_to_float(u.w & 0xffffu); f[7] = __uint_as_float(u.w & 0xffff0000u);
  }
  __device__ static __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static __forceinline__ __nv_bfloat16 from_float(float x) {
    return __float2bfloat16(x);
  }
};

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// grid (KVH, B, ceil(G / kWarps)), block (kThreads).
// q, out: (B, KVH * G, D) contiguous.  k_pool, v_pool: (P, ps, KVH, D) with
// element strides (stride_p, stride_t, stride_h) and unit stride over D.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ page_table,
    const int* __restrict__ lengths, T* __restrict__ out,
    int G, int NP, int ps, long long stride_p, long long stride_t,
    long long stride_h, int window, float scale) {
  typedef typename Elem<T>::Raw Raw;
  constexpr int kRowBytes = D * (int)sizeof(T);
  constexpr int kRowStride = kRowBytes + 16;     // pad: conflict-free 16-byte reads
  constexpr int kChunks = kRowBytes / 16;        // 16-byte chunks per row
  constexpr int kPerChunk = Elem<T>::kPerChunk;
  constexpr int kCols = D >= 32 ? D / 32 : 1;    // output columns per lane
  constexpr int kTileChunks = kTile * kChunks;   // 16-byte loads per tile (K)
  constexpr int kTasks = (kTileChunks + kThreads - 1) / kThreads;

  __shared__ __align__(16) unsigned char k_sm[kTile * kRowStride];
  __shared__ __align__(16) unsigned char v_sm[kTile * kRowStride];
  __shared__ __align__(16) float q_sm[kWarps * D];
  __shared__ int valid_sm[kTile];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int KVH = gridDim.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.z * kWarps + warp;      // query head within the group
  const bool head_ok = g < G;
  const long long q_off = ((long long)b * KVH * G + (long long)kvh * G + g) * D;

  if (head_ok) {
    for (int d = lane; d < D; d += 32)
      q_sm[warp * D + d] = Elem<T>::load(q + q_off + d) * scale;
  }

  const int length = lengths[b];
  const int cap = NP * ps;
  const int end = length < cap ? length : cap;
  int first = 0;
  if (window > 0 && length - window > 0) first = length - window;
  const int* pt = page_table + (long long)b * NP;

  // this thread's share of a tile: kTasks (row, chunk) pairs of K and of V
  uint4 k_reg[kTasks], v_reg[kTasks];
  bool ok_reg[kTasks];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int i = 0; i < kTasks; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int r = c / kChunks;
      const int ch = c - r * kChunks;
      const int pos = t0 + r;
      k_reg[i] = make_uint4(0u, 0u, 0u, 0u);
      v_reg[i] = k_reg[i];
      ok_reg[i] = false;
      if (c < kTileChunks && pos < end && pos >= first) {
        const int page = pos / ps;
        const int entry = pt[page];
        if (entry >= 0) {
          ok_reg[i] = true;
          const long long off = (long long)entry * stride_p
              + (long long)(pos - page * ps) * stride_t
              + (long long)kvh * stride_h + (long long)ch * kPerChunk;
          k_reg[i] = *reinterpret_cast<const uint4*>(k_pool + off);
          v_reg[i] = *reinterpret_cast<const uint4*>(v_pool + off);
        }
      }
    }
  };

  float m = kNegInf;
  float l = 0.f;                                 // this lane's share of the sum
  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;

  int t0 = (first / kTile) * kTile;
  if (t0 < end) fetch(t0);
  for (; t0 < end; t0 += kTile) {
    __syncthreads();       // the previous tile is consumed; q_sm is written
#pragma unroll
    for (int i = 0; i < kTasks; ++i) {
      const int c = threadIdx.x + i * kThreads;
      if (c < kTileChunks) {
        const int r = c / kChunks;
        const int ch = c - r * kChunks;
        *reinterpret_cast<uint4*>(k_sm + r * kRowStride + ch * 16) = k_reg[i];
        *reinterpret_cast<uint4*>(v_sm + r * kRowStride + ch * 16) = v_reg[i];
        if (ch == 0) valid_sm[r] = ok_reg[i] ? 1 : 0;
      }
    }
    __syncthreads();
    if (t0 + kTile < end) fetch(t0 + kTile);     // in flight during the math

    if (head_ok) {
      const bool valid = valid_sm[lane] != 0;
      float s = kNegInf;
      if (valid) {
        const unsigned char* krow = k_sm + lane * kRowStride;
        const float4* qw = reinterpret_cast<const float4*>(q_sm + warp * D);
        // four independent partial sums: with one or two warps on a
        // scheduler a single chain of 128 dependent FMAs would stall it
        float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
#pragma unroll
        for (int ch = 0; ch < kChunks; ++ch) {
          const uint4 raw = *reinterpret_cast<const uint4*>(krow + ch * 16);
          float kf[kPerChunk];
          Elem<T>::unpack(raw, kf);
#pragma unroll
          for (int j = 0; j < kPerChunk / 4; ++j) {
            const float4 qv = qw[ch * (kPerChunk / 4) + j];
            d0 = fmaf(qv.x, kf[4 * j + 0], d0);
            d1 = fmaf(qv.y, kf[4 * j + 1], d1);
            d2 = fmaf(qv.z, kf[4 * j + 2], d2);
            d3 = fmaf(qv.w, kf[4 * j + 3], d3);
          }
        }
        const float dot = (d0 + d1) + (d2 + d3);
        s = dot;
      }
      const float m_new = fmaxf(m, warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float corr = expf(m - m_new);
      l = l * corr + p;
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[i] *= corr;
      // P.V without a branch and fully unrolled, so that the shuffles and
      // shared loads of all 32 tokens can be in flight together; masked
      // rows are zero in shared memory and have p == 0
      const int col = lane * kCols < D ? lane * kCols : 0;   // D == 16: half idle
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        const float pt_t = __shfl_sync(0xffffffffu, p, t);
        const RawVec<Raw, kCols> vv = *reinterpret_cast<
            const RawVec<Raw, kCols>*>(v_sm + t * kRowStride
                                       + col * (int)sizeof(T));
#pragma unroll
        for (int i = 0; i < kCols; ++i)
          acc[i] = fmaf(pt_t, Elem<T>::raw_to_float(vv.e[i]), acc[i]);
      }
      m = m_new;
    }
  }

  if (head_ok) {
    const float lsum = warp_sum(l);        // >= 1 once a position is valid
    float denom = fmaxf(lsum, 1e-30f);
    if (lsum == 0.f) {               // no valid position (see the header)
      const int col = lane * kCols < D ? lane * kCols : 0;
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
      for (int pos = 0; pos < cap; ++pos) {
        const int page = pos / ps;
        const int entry = pt[page] > 0 ? pt[page] : 0;
        const T* vrow = v_pool + (long long)entry * stride_p
            + (long long)(pos - page * ps) * stride_t
            + (long long)kvh * stride_h + col;
#pragma unroll
        for (int i = 0; i < kCols; ++i) acc[i] += Elem<T>::load(vrow + i);
      }
      denom = (float)cap;
    }
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int d = lane * kCols + i;
      if (d < D) out[q_off + d] = Elem<T>::from_float(acc[i] / denom);
    }
  }
}

template <typename T>
cudaError_t launch_for_dtype(
    const void* q, const void* k_pool, const void* v_pool,
    const int* page_table, const int* lengths, void* out,
    int B, int KVH, int G, int D, int NP, int ps,
    long long stride_p, long long stride_t, long long stride_h,
    int window, cudaStream_t stream) {
  const dim3 grid(KVH, B, (G + kWarps - 1) / kWarps);
  const dim3 block(kThreads);
  const float scale = 1.0f / sqrtf((float)D);
#define REPRO_LAUNCH(DD)                                                     \
  paged_attention_kernel<T, DD><<<grid, block, 0, stream>>>(                 \
      (const T*)q, (const T*)k_pool, (const T*)v_pool, page_table, lengths,  \
      (T*)out, G, NP, ps, stride_p, stride_t, stride_h, window, scale)
  switch (D) {
    case 16: REPRO_LAUNCH(16); break;
    case 32: REPRO_LAUNCH(32); break;
    case 64: REPRO_LAUNCH(64); break;
    case 128: REPRO_LAUNCH(128); break;
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the
// launch (0 on success); nothing is synchronised.
extern "C" int repro_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* lengths, void* out,
    int B, int KVH, int G, int D, int NP, int ps,
    long long stride_p, long long stride_t, long long stride_h,
    int window, int dtype_code, void* stream) {
  if (B <= 0 || KVH <= 0 || G <= 0 || NP <= 0 || ps <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* pt = (const int*)page_table;
  const int* ln = (const int*)lengths;
  if (dtype_code == 0)
    return (int)launch_for_dtype<float>(q, k_pool, v_pool, pt, ln, out, B, KVH,
                                        G, D, NP, ps, stride_p, stride_t,
                                        stride_h, window, s);
  if (dtype_code == 1)
    return (int)launch_for_dtype<__nv_bfloat16>(q, k_pool, v_pool, pt, ln, out,
                                                B, KVH, G, D, NP, ps, stride_p,
                                                stride_t, stride_h, window, s);
  return (int)cudaErrorInvalidValue;
}

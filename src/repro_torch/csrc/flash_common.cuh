// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the tile geometry, the argument block, the mask, the tile-skipping
// ranges, the asynchronous tile loader and the launch helpers.
//
// Layout: q (B, H, Sq, hd), k (B, KV, Sk, hd), v (B, KV, Sk, dv), all fp32
// and contiguous; query head h reads KV head h / (H / KV). A block has 4
// warps and owns a 64-row tile (query rows in the forward and dq kernels,
// key rows in the dkv kernel); each warp owns 16 of its rows, as the rows of
// m16n8k8 tensor-core fragments (mma_tf32.cuh). The kernels are templated
// on a head-width bucket E (16, 32, 64, 128, 256) that covers hd and dv:
// columns past hd or dv are zero in shared memory and never written out.
// The tiles a block streams through (key tiles in the forward and dq
// kernels, query tiles in the dkv kernel) are 32 rows: against 64 they
// halve the score fragments' registers and the streamed tiles' shared
// memory, which lets more blocks share an SM; they measured faster at every
// shape tried (PERF.md, PR 13).
//
// The kernels are also templated on the element type T of q, k, v, do and
// the outputs o, dq, dk, dv: fp32, or bf16 (the reference's kernel bodies
// cast bf16 inputs to fp32, flash_attention.py:46-48 and
// flash_attention_bwd.py:70-73, 107-110, and write their outputs in the
// inputs' dtypes). A bf16 tile is loaded with plain loads and converted to
// fp32 into the same shared-memory tile, so everything after the load is
// the fp32 kernel; outputs round to bf16 on the store. The log-sum-exp and
// D rows stay fp32.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "mma_tf32.cuh"

namespace repro {
namespace flash {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // rows a block owns: 16 per warp
constexpr int kMaxSmem = 232448;    // bytes of shared memory a block may use on sm_90
constexpr float kNegInf = -1e30f;   // the reference's finite mask value (never -inf: -inf - -inf is NaN)

constexpr int kStream = 32;         // rows of a streamed tile

// Blocks per SM a kernel's registers must leave room for (3 caps them at 170
// a thread): 3 up to head width 64, where the kernels fit without spilling
// and measured faster than at their natural 168-177; 1 above, where the
// accumulators need more.
__host__ __device__ constexpr int min_blocks(int e) { return e <= 64 ? 3 : 1; }

// Shared-memory row stride for bucket E: E + 4 floats. Both fragment reads,
// src[g * S + t] and src[2t * S + g], then hit 32 distinct banks.
template <int E>
__host__ __device__ constexpr int stride() { return E + 4; }

template <typename T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  const T* dout;      // backward only
  const float* lse;   // backward only
  const float* dsum;  // backward only: rowsum(do * o)
  T* o;               // forward: o; dq kernel: dq; dkv kernel: dk
  void* lse_out;      // forward: lse (fp32); dkv kernel: dv (T)
  int64_t B, H, KV, Sq, Sk, hd, dv, q_pos0, window;  // window < 0: none
  float scale, softcap;                              // softcap <= 0: none
  int causal;
  int vec4;     // hd and dv multiples of 4 and q, k, v, do 16-byte aligned: 16-byte copies
  int stages;   // 2: the streamed tiles are double-buffered; 1: one buffer
  int cluster;  // dkv: blocks per cluster (they sum their query heads' dk/dv partials)
};

// The smallest bucket that holds both head widths.
inline int bucket(int64_t hd, int64_t dv) {
  const int64_t w = hd > dv ? hd : dv;
  return w <= 16 ? 16 : w <= 32 ? 32 : w <= 64 ? 64 : w <= 128 ? 128 : 256;
}

inline bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

// The keys query position qpos may see: [*lo, *hi], clamped to [0, Sk - 1]
// (empty when *lo > *hi). A row's mask is then two int32 compares per key.
template <typename P>
__device__ __forceinline__ void key_range(const P& p, int64_t qpos, int* lo, int* hi) {
  int64_t a = 0, z = p.Sk - 1;
  if (p.causal && qpos < z) z = qpos;
  if (p.window >= 0 && qpos - p.window + 1 > a) a = qpos - p.window + 1;
  *lo = static_cast<int>(a);
  *hi = static_cast<int>(z < a ? a - 1 : z);
}

// The query rows (not positions) that may see key position kpos: [*lo, *hi],
// clamped to [0, Sq - 1]; empty for a key at or past Sk.
template <typename P>
__device__ __forceinline__ void query_range(const P& p, int64_t kpos, int* lo, int* hi) {
  int64_t a = 0, z = p.Sq - 1;
  if (p.causal && kpos - p.q_pos0 > a) a = kpos - p.q_pos0;
  if (p.window >= 0 && kpos + p.window - 1 - p.q_pos0 < z) z = kpos + p.window - 1 - p.q_pos0;
  if (kpos >= p.Sk) z = -1;
  *lo = static_cast<int>(a);
  *hi = static_cast<int>(z < a ? a - 1 : z);
}

// Softcapped logit; writes d(cap * tanh(x / cap))/dx = 1 - t^2 to chain.
template <typename P>
__device__ __forceinline__ float logit(const P& p, float dot, float* chain) {
  float x = dot * p.scale;
  *chain = 1.f;
  if (p.softcap > 0.f) {
    const float t = tanhf(x / p.softcap);
    x = p.softcap * t;
    *chain = 1.f - t * t;
  }
  return x;
}

// Key tiles [*begin, *end) of `tile` rows that hold an allowed key for some
// query position in [qlo, qhi]; tiles outside are masked for every row and
// skipped.
template <typename P>
__device__ __forceinline__ void key_tiles(const P& p, int tile, int64_t qlo, int64_t qhi,
                                          int64_t* begin, int64_t* end) {
  int64_t kmax = p.Sk;  // exclusive
  if (p.causal && qhi + 1 < kmax) kmax = qhi + 1;
  int64_t kmin = 0;
  if (p.window >= 0 && qlo - p.window + 1 > 0) kmin = qlo - p.window + 1;
  *begin = kmin / tile;
  *end = kmax <= kmin ? *begin : (kmax + tile - 1) / tile;
}

// Query tiles [*begin, *end) (row indices, not positions) of `tile` rows
// that hold a row allowed to see some key in [klo, khi].
template <typename P>
__device__ __forceinline__ void query_tiles(const P& p, int tile, int64_t klo, int64_t khi,
                                            int64_t* begin, int64_t* end) {
  int64_t lo = 0, hi = p.Sq;  // rows [lo, hi)
  if (p.causal && klo - p.q_pos0 > lo) lo = klo - p.q_pos0;
  if (p.window >= 0 && khi + p.window - p.q_pos0 < hi) hi = khi + p.window - p.q_pos0;
  *begin = lo / tile;
  *end = hi <= lo ? *begin : (hi + tile - 1) / tile;
}

// Start the copy of rows [row0, row0 + R) of a (rows, width) matrix into a
// shared R x stride<E>() tile with cp.async; rows at or past `rows` and
// columns at or past `width` are written as zeros. The caller commits.
// A bf16 matrix is loaded and converted at once (the caller's wait and
// barrier then find it in place).
template <int E, int R>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const bf16* __restrict__ src,
                                          int64_t row0, int64_t rows, int64_t width, bool) {
  constexpr int S = stride<E>();
  for (int i = threadIdx.x; i < R * E; i += kThreads) {
    const int r = i / E, c = i % E;
    const bool ok = row0 + r < rows && c < width;
    dst[r * S + c] = ok ? to_f32(src[(row0 + r) * width + c]) : 0.f;
  }
}

template <int E, int R>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const float* __restrict__ src,
                                          int64_t row0, int64_t rows, int64_t width, bool vec4) {
  constexpr int S = stride<E>();
  if (vec4) {
    constexpr int C = E / 4;
    for (int i = threadIdx.x; i < R * C; i += kThreads) {
      const int r = i / C, c = (i % C) * 4;
      const bool ok = row0 + r < rows && c < width;
      tc::cp_async16(dst + r * S + c, ok ? src + (row0 + r) * width + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < R * E; i += kThreads) {
      const int r = i / E, c = i % E;
      const bool ok = row0 + r < rows && c < width;
      tc::cp_async4(dst + r * S + c, ok ? src + (row0 + r) * width + c : src, ok);
    }
  }
}

// Start the copy of entries [i0, i0 + R) of a vector of length n (zeros past n).
template <int R>
__device__ __forceinline__ void load_vec(float* __restrict__ dst, const float* __restrict__ src, int64_t i0,
                                         int64_t n) {
  for (int i = threadIdx.x; i < R; i += kThreads) {
    const bool ok = i0 + i < n;
    tc::cp_async4(dst + i, ok ? src + i0 + i : src, ok);
  }
}

// Max and sum over the 4 lanes of a quad (the lanes that share a row of a
// C fragment).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Opt in to more than 48 KB of dynamic shared memory where a launch needs it.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

// Call f(std::integral_constant<int, E>{}) for the bucket E of (hd, dv).
template <typename F>
inline int by_bucket(int64_t hd, int64_t dv, F&& f) {
  switch (bucket(hd, dv)) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return f(std::integral_constant<int, 256>{});
  }
}

}  // namespace flash
}  // namespace repro

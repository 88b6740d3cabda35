// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the tile geometry, the argument block, the mask and the tile-skipping
// ranges, and the dot products that read shared memory.
//
// Layout: q (B, H, Sq, hd), k (B, KV, Sk, hd), v (B, KV, Sk, dv), all fp32
// and contiguous; query head h reads KV head h / (H / KV). A block has 8
// warps; each warp owns 4 rows of its block's 32-row tile (query rows in the
// forward and dq kernels, key rows in the dkv kernel), and each lane owns
// one row of the other side's 32-row tile. Output columns live in registers
// as kChunks = 8 chunks of 32 lanes, so hd and dv go up to 256.
#pragma once

#include "common.cuh"

namespace repro {
namespace flash {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = kWarps * kRowsPerWarp;  // 32 rows per tile, one per lane
constexpr int kMaxDim = 256;
constexpr int kChunks = kMaxDim / 32;
constexpr float kNegInf = -1e30f;  // the reference's finite mask value (never -inf: -inf - -inf is NaN)

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;  // backward only
  const float* lse;   // backward only
  const float* dsum;  // backward only: rowsum(do * o)
  float* o;           // forward: o; dq kernel: dq; dkv kernel: dk
  float* lse_out;     // forward: lse; dkv kernel: dv
  int64_t B, H, KV, Sq, Sk, hd, dv, q_pos0, window;  // window < 0: none
  float scale, softcap;                              // softcap <= 0: none
  int causal;
};

// Row stride of a tile whose lanes each read their own row: odd, so the 32
// lanes reading one column hit 32 different banks.
__host__ __device__ inline int64_t odd_stride(int64_t d) { return d | 1; }

__device__ __forceinline__ bool allowed(const Params& p, int64_t qpos, int64_t kpos) {
  if (p.causal && qpos < kpos) return false;
  if (p.window >= 0 && qpos - kpos >= p.window) return false;
  return true;
}

// Softcapped logit; writes d(cap * tanh(x / cap))/dx = 1 - t^2 to chain.
__device__ __forceinline__ float logit(const Params& p, float dot, float* chain) {
  float x = dot * p.scale;
  *chain = 1.f;
  if (p.softcap > 0.f) {
    const float t = tanhf(x / p.softcap);
    x = p.softcap * t;
    *chain = 1.f - t * t;
  }
  return x;
}

// Key tiles [*begin, *end) that hold an allowed key for some query position
// in [qlo, qhi]; tiles outside are masked for every row and skipped.
__device__ __forceinline__ void key_tiles(const Params& p, int64_t qlo, int64_t qhi, int64_t* begin,
                                          int64_t* end) {
  int64_t kmax = p.Sk;  // exclusive
  if (p.causal && qhi + 1 < kmax) kmax = qhi + 1;
  int64_t kmin = 0;
  if (p.window >= 0 && qlo - p.window + 1 > 0) kmin = qlo - p.window + 1;
  *begin = kmin / kTile;
  *end = kmax <= kmin ? *begin : (kmax + kTile - 1) / kTile;
}

// Query tiles [*begin, *end) (row indices, not positions) that hold a row
// allowed to see some key in [klo, khi].
__device__ __forceinline__ void query_tiles(const Params& p, int64_t klo, int64_t khi, int64_t* begin,
                                            int64_t* end) {
  int64_t lo = 0, hi = p.Sq;  // rows [lo, hi)
  if (p.causal && klo - p.q_pos0 > lo) lo = klo - p.q_pos0;
  if (p.window >= 0 && khi + p.window - p.q_pos0 < hi) hi = khi + p.window - p.q_pos0;
  *begin = lo / kTile;
  *end = hi <= lo ? *begin : (hi + kTile - 1) / kTile;
}

// s[r] += sum_d a[r * a_stride + d] * b[d] for the R rows of a. Every lane
// reads the same rows of a (a broadcast) and its own row b, in d order.
// float4 reads of a where its rows are 16-byte aligned.
template <int R>
__device__ __forceinline__ void dot_rows(const float* __restrict__ a, int64_t a_stride,
                                         const float* __restrict__ b, int64_t n, float (&s)[R]) {
  if ((n & 3) == 0 && (a_stride & 3) == 0) {
    for (int64_t d = 0; d < n; d += 4) {
      const float b0 = b[d], b1 = b[d + 1], b2 = b[d + 2], b3 = b[d + 3];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 av = *reinterpret_cast<const float4*>(a + r * a_stride + d);
        s[r] = fmaf(av.x, b0, s[r]);
        s[r] = fmaf(av.y, b1, s[r]);
        s[r] = fmaf(av.z, b2, s[r]);
        s[r] = fmaf(av.w, b3, s[r]);
      }
    }
  } else {
    for (int64_t d = 0; d < n; ++d) {
      const float bd = b[d];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] = fmaf(a[r * a_stride + d], bd, s[r]);
    }
  }
}

// Copy rows [row0, row0 + kTile) of a (rows, width) matrix into shared memory
// with row stride `stride`; rows at or past `rows` are zero.
__device__ __forceinline__ void load_tile(float* __restrict__ dst, int64_t stride,
                                          const float* __restrict__ src, int64_t row0, int64_t rows,
                                          int64_t width) {
  const int64_t n = kTile * width;
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
    const int64_t r = i / width, c = i - r * width;
    dst[r * stride + c] = row0 + r < rows ? src[(row0 + r) * width + c] : 0.f;
  }
}

// Opt in to more than 48 KB of dynamic shared memory where a launch needs it.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

}  // namespace flash
}  // namespace repro

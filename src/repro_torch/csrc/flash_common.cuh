// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu
// and their bf16 counterparts flash_fwd_bf16.cu, flash_bwd_bf16.cu): the tile
// geometry, the argument block, the mask, the tile-skipping ranges, the fp32
// tiles' asynchronous loader, the dkv kernels' cluster sum and the launch
// helpers.
//
// Layout: q (B, H, Sq, hd), k (B, KV, Sk, hd), v (B, KV, Sk, dv), contiguous;
// query head h reads KV head h / (H / KV). A block has 4 warps and owns a
// 64-row tile (query rows in the forward and dq kernels, key rows in the dkv
// kernel); each warp owns 16 of its rows. The kernels are templated on a
// head-width bucket E (16, 32, 64, 128, 256) that covers hd and dv: columns
// past hd or dv are zero in shared memory and never written out.
//
// fp32 (flash_fwd.cu, flash_bwd.cu): the warps' rows are the rows of m16n8k8
// split-TF32 fragments (mma_tf32.cuh), tiles are fp32 in shared memory at a
// padded stride (stride<E>()), and the tiles a block streams through (key
// tiles in the forward and dq kernels, query tiles in the dkv kernel) are 32
// rows: against 64 they halve the score fragments' registers and the
// streamed tiles' shared memory, which lets more blocks share an SM; they
// measured faster at every shape tried (PERF.md §6).
//
// bf16 (the reference's kernel bodies cast bf16 inputs to fp32,
// flash_attention.py:46-48 and flash_attention_bwd.py:70-73, 107-110, and
// write their outputs in the inputs' dtypes): kernels of their own on
// Hopper's bf16 tensor cores, the block one warpgroup issuing wgmma, tiles
// bf16 in wgmma's swizzled layout (wgmma_bf16.cuh). The log-sum-exp and D
// rows stay fp32 in both.
#pragma once

#include <cooperative_groups.h>

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

constexpr int kStream = 32;         // rows of an fp32 kernel's streamed tile
constexpr int kStages = 3;          // the bf16 kernels' ring of streamed tiles
constexpr float kLog2e = 1.4426950408889634f;  // the bf16 kernels' softmax runs in log2 units (exp2)
constexpr float kLn2 = 0.6931471805599453f;

// Blocks per SM a kernel's registers must leave room for (3 caps them at 168
// a thread): 3 up to head width 64, where the kernels fit without spilling
// and measured faster than at their natural counts (the fp32 ones' 168-177,
// the bf16 dkv kernel's 182; PERF.md §6); 1 above, where the accumulators
// need more.
__host__ __device__ constexpr int min_blocks(int e) { return e <= 64 ? 3 : 1; }

// Rows of a bf16 key tile (forward and dq kernels): 64, or 32 at E = 256,
// where o's or dq's accumulator alone takes 128 registers a thread.
__host__ __device__ constexpr int bf16_key_rows(int e) { return e <= 128 ? 64 : 32; }

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
  int vec;      // rows copy in 16-byte chunks: hd and dv multiples of 4 (fp32) or 8 (bf16, wg::vec_copies),
                // q, k, v, do 16-byte aligned
  int stages;   // fp32: 2, the streamed tiles are double-buffered; 1, one buffer. bf16: kStages, always
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

// Whether every query position in [qlo, qhi] may see every key in [k0, k1]
// (k1 < Sk): then a tile needs no mask.
template <typename P>
__device__ __forceinline__ bool sees_all(const P& p, int64_t qlo, int64_t qhi, int64_t k0, int64_t k1) {
  return k1 < p.Sk && (!p.causal || k1 <= qlo) && (p.window < 0 || qhi - k0 < p.window);
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

// Start the copy of rows [row0, row0 + R) of a (rows, width) fp32 matrix
// into a shared R x stride<E>() tile with cp.async; rows at or past `rows`
// and columns at or past `width` are written as zeros. The caller commits.
template <int E, int R>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const float* __restrict__ src,
                                          int64_t row0, int64_t rows, int64_t width, bool vec) {
  constexpr int S = stride<E>();
  if (vec) {
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

// What a dkv launch accumulates.
constexpr int kDk = 1, kDv = 2;

// The largest cluster size up to 8 that divides G (the dkv kernels' blocks
// of one KV head's query heads).
inline int cluster_size(int64_t G) {
  for (int c = 8; c > 1; --c)
    if (G % c == 0) return c;
  return 1;
}

// Entry idx of `part` summed over the cluster's blocks in rank order; the
// (at most 8) remote reads are issued before the sum so their latencies
// overlap.
__device__ __forceinline__ float cluster_sum(cooperative_groups::cluster_group& cluster, float* part, int idx) {
  const int n = static_cast<int>(cluster.num_blocks());
  float v[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) v[c] = c < n ? cluster.map_shared_rank(part, c)[idx] : 0.f;
  float sum = v[0];
#pragma unroll
  for (int c = 1; c < 8; ++c)
    if (c < n) sum += v[c];
  return sum;
}

// Launch kernel(p) on `grid` in clusters of (p.cluster, 1, 1) blocks.
template <typename T>
int launch_cluster(void (*kernel)(Params<T>), const Params<T>& p, size_t smem, dim3 grid, cudaStream_t stream) {
  const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute la[1];
  la[0].id = cudaLaunchAttributeClusterDimension;
  la[0].val.clusterDim.x = static_cast<unsigned>(p.cluster);
  la[0].val.clusterDim.y = 1;
  la[0].val.clusterDim.z = 1;
  cfg.attrs = la;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, p);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return repro::launch_status();
}

}  // namespace flash
}  // namespace repro

// Eq. 1 L1 sums in one fixed order, shared by the L1 rows kernel (l1.cu)
// and the fused assign kernel (assign_lerp.cu).
//
// The order depends on the element index and on nothing else, so the bits of
// L1(x, c) depend only on the two rows' values and on N: not on M, C, the
// row's place in its matrix, its alignment or the entry point.
//
//   1. N is cut into chunks of kChunk elements (the last one ragged).
//   2. In a chunk, thread t of the kThreads-thread block owns the groups of
//      four elements that start at 4 t + 4 kThreads j, j < kSteps, and sums
//      |x - c| over them in one register, j-major, then element by element.
//      A row that is not 16-byte aligned loads the same four elements with
//      two 8-byte or four 4-byte loads; elements past N load as 0.
//   3. Each warp sums its lanes with an xor butterfly (warp_sum); the
//      chunk's partial is the pairwise tree over the 8 warp sums
//      ((w0 + w4) + (w2 + w6)) + ((w1 + w5) + (w3 + w7)).
//   4. The chunk partials of one output reduce in one warp: lane l sums
//      chunks l, l + 32, ... in chunk order, then warp_sum.
//
// tests/test_torch_l1_order.py models this order in numpy.
//
// bf16 rows (the bf16 instantiations of l1.cu and assign_lerp.cu) take the
// same four-element groups, loaded as 8 bytes where the row is 8-byte
// aligned, else as two 4-byte or four 2-byte loads, and converted to fp32
// on load: the sums are then the fp32 kernel's on the rows cast to fp32,
// bit for bit, in the same order.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kSteps = 4;                        // float4 groups per thread and chunk
constexpr int64_t kChunk = 4 * kThreads * kSteps;  // 4096 elements
constexpr int kWarps = kThreads / 32;
constexpr int kTileC = 4;                        // c rows a work item takes

inline int64_t l1_chunks(int64_t n) { return (n + kChunk - 1) / kChunk; }

// 16, 8 or 4: the widest load a row at this address takes.
__device__ __forceinline__ int row_align(const float* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  return (a & 15u) == 0 ? 16 : ((a & 7u) == 0 ? 8 : 4);
}

// 8, 4 or 2: the widest load a bf16 row at this address takes (four values
// in 8 bytes).
__device__ __forceinline__ int row_align(const bf16* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  return (a & 7u) == 0 ? 8 : ((a & 3u) == 0 ? 4 : 2);
}

// Elements g .. g+3 of a row (g % 4 == 0), 0 past n, whatever the alignment.
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int64_t g, int64_t n,
                                        int align) {
  if (g + 4 <= n) {
    if (align == 16) return *reinterpret_cast<const float4*>(row + g);
    if (align == 8) {
      const float2 a = *reinterpret_cast<const float2*>(row + g);
      const float2 b = *reinterpret_cast<const float2*>(row + g + 2);
      return make_float4(a.x, a.y, b.x, b.y);
    }
    return make_float4(row[g], row[g + 1], row[g + 2], row[g + 3]);
  }
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (g < n) v.x = row[g];
  if (g + 1 < n) v.y = row[g + 1];
  if (g + 2 < n) v.z = row[g + 2];
  return v;
}

// The two bf16 values of a 4-byte word as fp32 (element g in the low half).
__device__ __forceinline__ float2 bf16x2_to_f32(uint32_t w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

// Elements g .. g+3 of a bf16 row (g % 4 == 0) as fp32, 0 past n.
__device__ __forceinline__ float4 load4(const bf16* __restrict__ row, int64_t g, int64_t n, int align) {
  if (g + 4 <= n) {
    if (align >= 4) {
      uint32_t lo, hi;
      if (align == 8) {
        const uint2 w = *reinterpret_cast<const uint2*>(row + g);
        lo = w.x;
        hi = w.y;
      } else {
        lo = *reinterpret_cast<const uint32_t*>(row + g);
        hi = *reinterpret_cast<const uint32_t*>(row + g + 2);
      }
      const float2 a = bf16x2_to_f32(lo), b = bf16x2_to_f32(hi);
      return make_float4(a.x, a.y, b.x, b.y);
    }
    return make_float4(to_f32(row[g]), to_f32(row[g + 1]), to_f32(row[g + 2]), to_f32(row[g + 3]));
  }
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (g < n) v.x = to_f32(row[g]);
  if (g + 1 < n) v.y = to_f32(row[g + 1]);
  if (g + 2 < n) v.z = to_f32(row[g + 2]);
  return v;
}

__device__ __forceinline__ float add_abs4(float acc, float4 a, float4 b) {
  acc += fabsf(a.x - b.x);
  acc += fabsf(a.y - b.y);
  acc += fabsf(a.z - b.z);
  acc += fabsf(a.w - b.w);
  return acc;
}

// Step 3: the chunk partial from the 8 warp sums part[0..7].
__device__ __forceinline__ float warp_tree(const float* part) {
  return ((part[0] + part[4]) + (part[2] + part[6])) + ((part[1] + part[5]) + (part[3] + part[7]));
}

// Rows first .. first + R - 1 of a (rows, n) matrix (a missing row repeats
// the last one): the four-element groups thread threadIdx.x owns in the
// chunk that starts at element g0 - 4 threadIdx.x.
template <int R, typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ base, int64_t first,
                                          int64_t rows, int64_t n, int64_t g0,
                                          float4 (&v)[R][kSteps]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const T* p = base + (first + r < rows ? first + r : rows - 1) * n;
    const int al = row_align(p);
#pragma unroll
    for (int j = 0; j < kSteps; ++j) v[r][j] = load4(p, g0 + 4 * kThreads * j, n, al);
  }
}

// Steps 2-3a, no barrier: the warp sums of x rows xv[0 .. m_valid) against
// one c row, stored by lane 0 to part[warp][mi * G + ci].
template <int TM, int G>
__device__ __forceinline__ void warp_partials(const float4 (&xv)[TM][kSteps],
                                              const float4 (&cv)[kSteps], int64_t m_valid, int ci,
                                              float (&part)[kWarps][TM * G]) {
#pragma unroll
  for (int mi = 0; mi < TM; ++mi) {
    if (mi < m_valid) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kSteps; ++j) acc = add_abs4(acc, xv[mi][j], cv[j]);
      acc = warp_sum(acc);
      if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5][mi * G + ci] = acc;
    }
  }
}

// Step 3b: the chunk partial of output (mi, ci) from the warp sums, stored to
// dst[mi * ld + ci] for mi < m_valid and ci < c_valid. Every thread of the
// block must call it.
template <int TM, int G>
__device__ __forceinline__ void store_partials(const float (&part)[kWarps][TM * G],
                                               int64_t m_valid, int64_t c_valid, float* dst,
                                               int64_t ld) {
  __syncthreads();
  if (threadIdx.x < TM * G) {
    const int mi = threadIdx.x / G, ci = threadIdx.x % G;
    if (mi < m_valid && ci < c_valid) {
      float w[kWarps];
#pragma unroll
      for (int i = 0; i < kWarps; ++i) w[i] = part[i][threadIdx.x];
      dst[mi * ld + ci] = warp_tree(w);
    }
  }
  __syncthreads();  // part may be reused
}

// Steps 2-3 for chunk `k` of x rows [m0, m0 + TM) against c rows
// [c0, c0 + TC): the partial of output (m, c) goes to
// dst[(m - m0) * ld + (c - c0)] for the rows that exist. One x row issues
// all its rows' loads before the first sum (latency decides there); four x
// rows take the c rows one by one (registers, so two blocks fit an SM).
// Every thread of the block must call it.
template <int TM, int TC, typename T>
__device__ __forceinline__ void chunk_partials(const T* __restrict__ x, int64_t m_rows,
                                               const T* __restrict__ c, int64_t c_rows,
                                               int64_t n, int64_t k, int64_t m0, int64_t c0,
                                               float* dst, int64_t ld) {
  __shared__ float part[kWarps][TM * TC];
  const int64_t g0 = k * kChunk + 4 * threadIdx.x;
  float4 xv[TM][kSteps];
  load_rows<TM>(x, m0, m_rows, n, g0, xv);
  if constexpr (TM == 1) {
    float4 cv[TC][kSteps];
    load_rows<TC>(c, c0, c_rows, n, g0, cv);
#pragma unroll
    for (int ci = 0; ci < TC; ++ci)
      if (c0 + ci < c_rows) warp_partials<TM, TC>(xv, cv[ci], m_rows - m0, ci, part);
  } else {
#pragma unroll
    for (int ci = 0; ci < TC; ++ci) {
      if (c0 + ci >= c_rows) break;
      float4 cv[1][kSteps];
      load_rows<1>(c, c0 + ci, c_rows, n, g0, cv);
      warp_partials<TM, TC>(xv, cv[0], m_rows - m0, ci, part);
    }
  }
  store_partials<TM, TC>(part, m_rows - m0, c_rows - c0, dst, ld);
}

// Step 4 for one output, in one warp: the partials p[k * stride], k < chunks,
// written by other blocks before a grid-wide sync, so read from L2.
__device__ __forceinline__ float sum_chunks(const float* p, int64_t chunks, int64_t stride) {
  float a = 0.f;
  for (int64_t k = threadIdx.x & 31; k < chunks; k += 32) a += __ldcg(p + k * stride);
  return warp_sum(a);
}

// Blocks of `kernel` that fit on the device at once with `smem` bytes of
// dynamic shared memory each (a cooperative launch may not ask for more),
// queried once per device, kernel and size (one cache each); 0 if the
// query fails.
template <typename Kernel>
inline int coresident_blocks(Kernel kernel, int device, int* cache, size_t smem) {
  if (cache[device] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
      return 0;
    cache[device] = per_sm * sms;
  }
  return cache[device];
}

}  // namespace repro

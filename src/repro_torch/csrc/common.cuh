// Shared helpers for the repro_torch kernels: fixed-order warp and block
// reductions (deterministic for a given launch shape, no atomics), the
// element conversions of the bf16 instantiations, and the error-return
// convention every C entry point follows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_API extern "C" __attribute__((visibility("default")))

namespace repro {

constexpr int kThreads = 256;

using bf16 = __nv_bfloat16;

// An input element as fp32: a bf16 value is exactly the fp32 value with the
// same upper 16 bits, so the conversion loses nothing and everything after
// the load is the fp32 kernel.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// An fp32 result in an output's element type (round to nearest even for bf16).
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;  // every lane holds the same total
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float block_max(float v) {
  __shared__ float part[kThreads / 32];
  __shared__ float total;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) part[wid] = v;
  __syncthreads();
  if (wid == 0) {
    float w = lane < kThreads / 32 ? part[lane] : -3.4e38f;
    w = warp_max(w);
    if (lane == 0) total = w;
  }
  __syncthreads();
  return total;
}

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

// Make `device` current only when it is not (the runtime keeps it per thread).
inline void use_device(int device) {
  int cur = -1;
  if (cudaGetDevice(&cur) != cudaSuccess || cur != device) cudaSetDevice(device);
}

}  // namespace repro

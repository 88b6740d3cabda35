// Family A: L1 rows. (M, N) x (C, N) -> (M, C) fp32 L1 distances (Eq. 1).
//
// Replaces the TPU kernels src/repro/kernels/l1_distance.py::l1_distance
// (_l1_kernel, one upload against C centers, M = 1 here) and
// src/repro/kernels/l1_pairwise.py::l1_distance_pairwise (_pairwise_kernel).
//
// Bound: bytes. Each output reads two N-float rows once and does 3 flops
// per element pair, far below the card's operations-per-byte balance. At the
// paper's widths (N = 4,550 .. 25,418, C <= 8) a launch moves well under a
// megabyte, so what bounds it in practice is launch latency, not bandwidth.
// Design: one 256-thread block per output element (grid (C, M)); threads
// stride over N with 16-byte float4 loads where both rows are 16-byte
// aligned (a row of odd stride falls back to scalar loads), and accumulate
// in fp32. The block sum is a fixed-order warp butterfly plus one warp over
// the partials, so a given launch shape always gives the same bits.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(repro::kThreads)
l1_rows_kernel(const float* __restrict__ x, const float* __restrict__ c,
               float* __restrict__ out, int64_t n, int64_t c_rows) {
  const int64_t ci = blockIdx.x;
  const int64_t mi = blockIdx.y;
  const float* xr = x + mi * n;
  const float* cr = c + ci * n;
  float acc = 0.f;
  int64_t tail = 0;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(xr) | reinterpret_cast<uintptr_t>(cr)) & 15u) == 0;
  if (aligned) {
    const int64_t n4 = n >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* c4 = reinterpret_cast<const float4*>(cr);
    for (int64_t k = threadIdx.x; k < n4; k += blockDim.x) {
      const float4 a = x4[k];
      const float4 b = c4[k];
      acc += fabsf(a.x - b.x);
      acc += fabsf(a.y - b.y);
      acc += fabsf(a.z - b.z);
      acc += fabsf(a.w - b.w);
    }
    tail = n4 << 2;
  }
  for (int64_t k = tail + threadIdx.x; k < n; k += blockDim.x) acc += fabsf(xr[k] - cr[k]);
  const float s = repro::block_sum(acc);
  if (threadIdx.x == 0) out[mi * c_rows + ci] = s;
}

}  // namespace

REPRO_API int repro_l1_rows(const float* x, const float* c, float* out, int64_t m,
                            int64_t c_rows, int64_t n, int device, void* stream) {
  cudaSetDevice(device);
  if (m <= 0 || c_rows <= 0) return repro::launch_status();
  const dim3 grid(static_cast<unsigned>(c_rows), static_cast<unsigned>(m));
  l1_rows_kernel<<<grid, repro::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, c, out, n, c_rows);
  return repro::launch_status();
}

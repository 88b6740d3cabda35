// Family D: cluster-merge attention (paper Algorithm 1, lines 2-6).
//
// Replaces the TPU kernels src/repro/kernels/merge_attention.py::merge_attention
// (_max_kernel, then _blend_kernel).
//
//   p      = (va - vm) * (vt - vm)
//   alpha  = relu(p) / max(max(p), 1e-12)
//   merged = alpha * va + (1 - alpha) * vm
//
// Bound: bytes (three N-float reads per pass, one N-float write); at the
// paper's widths a merge moves ~0.5 MB, so launch latency dominates. On the
// TPU pass 1 carried a running max across a sequential grid; here blocks run
// in parallel, so pass 1 writes one partial max per block and pass 2 lets
// every block reduce those few partials itself (max is order-free, so the
// result is exact) before blending its elements. The blend is pinned to
// round(round(alpha*va) + round((1-alpha)*vm)) so the kernel and its plain
// PyTorch version agree bit for bit.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(repro::kThreads)
merge_max_kernel(const float* __restrict__ vm, const float* __restrict__ va,
                 const float* __restrict__ vt, int64_t n, float* __restrict__ partial) {
  float mx = -3.4e38f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; k < n;
       k += stride) {
    const float m = vm[k];
    mx = fmaxf(mx, (va[k] - m) * (vt[k] - m));
  }
  mx = repro::block_max(mx);
  if (threadIdx.x == 0) partial[blockIdx.x] = mx;
}

__global__ void __launch_bounds__(repro::kThreads)
merge_blend_kernel(const float* __restrict__ vm, const float* __restrict__ va,
                   const float* __restrict__ vt, int64_t n, const float* __restrict__ partial,
                   int64_t n_partial, float* __restrict__ out) {
  float mx = -3.4e38f;
  for (int64_t k = threadIdx.x; k < n_partial; k += blockDim.x) mx = fmaxf(mx, partial[k]);
  const float denom = fmaxf(repro::block_max(mx), 1e-12f);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; k < n;
       k += stride) {
    const float m = vm[k];
    const float a = va[k];
    const float p = (a - m) * (vt[k] - m);
    const float alpha = fmaxf(p, 0.f) / denom;
    out[k] = __fadd_rn(__fmul_rn(alpha, a), __fmul_rn(__fsub_rn(1.f, alpha), m));
  }
}

}  // namespace

// Blocks used by both passes for a length-n merge; the wrapper sizes the
// partial buffer with it.
REPRO_API int64_t repro_merge_blocks(int64_t n) {
  const int64_t per_block = 4 * repro::kThreads;
  int64_t blocks = (n + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;
  if (blocks > 1024) blocks = 1024;
  return blocks;
}

REPRO_API int repro_merge_attention(const float* vm, const float* va, const float* vt,
                                    int64_t n, float* partial, float* out, int device,
                                    void* stream) {
  cudaSetDevice(device);
  const int64_t blocks = repro_merge_blocks(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  merge_max_kernel<<<static_cast<unsigned>(blocks), repro::kThreads, 0, s>>>(vm, va, vt, n,
                                                                            partial);
  const int rc = repro::launch_status();
  if (rc != 0) return rc;
  merge_blend_kernel<<<static_cast<unsigned>(blocks), repro::kThreads, 0, s>>>(
      vm, va, vt, n, partial, blocks, out);
  return repro::launch_status();
}

// Family B: select-lerp, the second half of the fused Eq. 1 assignment +
// mixed-rate center blend.
//
// Replaces the TPU kernel src/repro/kernels/assign_lerp.py::_select_lerp
// (_select_lerp_kernel, reached through assign_and_lerp). The distance
// vector comes from family A (l1.cu, M = 1) on the same stream.
//
// Bound: bytes. It reads C distances, one center row and the upload (2N
// floats) and writes N floats; at the paper's widths that is ~0.3 MB, so
// the launch latency dominates. Design: every block reads the C distances
// itself (C is a handful) and takes the FIRST-index argmin with numpy's NaN
// rule (a NaN is the minimum; the first NaN wins), so the index never goes
// through the host and no second launch is needed. Block 0 stores the index
// to device memory. Each block then blends its chunk of row idx as the
// pinned two-op form round(round((1-b)*c) + round(b*u)) with __fmul_rn /
// __fadd_rn, which nvcc cannot contract into an FMA — the same bits as the
// reference's fenced blend (src/repro/kernels/ref.py::assign_and_lerp_ref).
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(repro::kThreads)
select_lerp_kernel(const float* __restrict__ dists, int64_t c_rows,
                   const float* __restrict__ centers, const float* __restrict__ u,
                   int64_t n, float omb, float b, int* __restrict__ idx_out,
                   float* __restrict__ out) {
  __shared__ int s_idx;
  if (threadIdx.x == 0) {
    int64_t best = 0;
    float bv = dists[0];
    for (int64_t i = 1; i < c_rows && !isnan(bv); ++i) {
      const float d = dists[i];
      if (isnan(d) || d < bv) {
        best = i;
        bv = d;
      }
    }
    s_idx = static_cast<int>(best);
    if (blockIdx.x == 0) *idx_out = static_cast<int>(best);
  }
  __syncthreads();
  const float* cr = centers + static_cast<int64_t>(s_idx) * n;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; k < n;
       k += stride) {
    out[k] = __fadd_rn(__fmul_rn(omb, cr[k]), __fmul_rn(b, u[k]));
  }
}

}  // namespace

REPRO_API int repro_select_lerp(const float* dists, int64_t c_rows, const float* centers,
                                const float* u, int64_t n, double beta, int* idx_out,
                                float* out, int device, void* stream) {
  cudaSetDevice(device);
  // beta folds like the reference's Python float: (1 - beta) in double,
  // then one rounding to fp32 (src/repro/kernels/assign_lerp.py:36).
  const float omb = static_cast<float>(1.0 - beta);
  const float b = static_cast<float>(beta);
  const int64_t per_block = 4 * repro::kThreads;
  int64_t blocks = (n + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;
  select_lerp_kernel<<<static_cast<unsigned>(blocks), repro::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(dists, c_rows, centers, u, n, omb,
                                                            b, idx_out, out);
  return repro::launch_status();
}

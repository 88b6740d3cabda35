// Family C: chi-squared client feedback (paper Eq. 2/3).
//
// Replaces the TPU kernels src/repro/kernels/chi2_feedback.py::chi2_feedback
// (_chi2_kernel) and ::chi2_feedback_segmented (_chi2_seg_kernel).
//
// g = sum_j (fp - ft)^2 / max(ft, 1e-6) * Var(ss), Var the POPULATION
// variance (mean first, then sum (s - mean)^2 / J).
//
// Bound: bytes, and at the server's sizes (M = a few hundred probe rows,
// J = 6..10 classes) launch latency: the whole input is a few KB. Design:
// kernel 1 gives every row one warp (lanes stride over J; butterflies sum
// in a fixed order). Kernel 2 is the segmented form's per-cluster sum: one
// block per segment walks all M rows with a fixed thread-to-row mapping and
// a fixed-order block sum — deterministic, no atomicAdd. Membership comes
// as int32 segment ids (-1 = none) instead of the TPU kernel's one-hot
// matrix, which is never built on the card.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(repro::kThreads)
chi2_rows_kernel(const float* __restrict__ fp, const float* __restrict__ ft,
                 const float* __restrict__ ss, float* __restrict__ g, int64_t m, int64_t j) {
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= m) return;  // uniform across the warp: one warp is one row
  const float* a = fp + row * j;
  const float* t = ft + row * j;
  const float* s = ss + row * j;
  float chi = 0.f, ssum = 0.f;
  for (int64_t k = lane; k < j; k += 32) {
    const float d = a[k] - t[k];
    chi += (d * d) / fmaxf(t[k], 1e-6f);
    ssum += s[k];
  }
  chi = repro::warp_sum(chi);
  ssum = repro::warp_sum(ssum);
  const float mean = ssum / static_cast<float>(j);
  float var = 0.f;
  for (int64_t k = lane; k < j; k += 32) {
    const float d = s[k] - mean;
    var += d * d;
  }
  var = repro::warp_sum(var) / static_cast<float>(j);
  if (lane == 0) g[row] = chi * var;
}

__global__ void __launch_bounds__(repro::kThreads)
segment_sum_kernel(const float* __restrict__ g, const int* __restrict__ seg, int64_t m,
                   float* __restrict__ seg_sum) {
  const int sid = blockIdx.x;
  float acc = 0.f;
  for (int64_t r = threadIdx.x; r < m; r += blockDim.x) {
    if (seg[r] == sid) acc += g[r];
  }
  const float total = repro::block_sum(acc);
  if (threadIdx.x == 0) seg_sum[sid] = total;
}

}  // namespace

REPRO_API int repro_chi2_rows(const float* fp, const float* ft, const float* ss, float* g,
                              int64_t m, int64_t j, int device, void* stream) {
  cudaSetDevice(device);
  if (m <= 0) return repro::launch_status();
  const int64_t rows_per_block = repro::kThreads / 32;
  const int64_t blocks = (m + rows_per_block - 1) / rows_per_block;
  chi2_rows_kernel<<<static_cast<unsigned>(blocks), repro::kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(fp, ft, ss, g, m, j);
  return repro::launch_status();
}

REPRO_API int repro_segment_sum(const float* g, const int* seg, int64_t m, int64_t s,
                                float* seg_sum, int device, void* stream) {
  cudaSetDevice(device);
  if (s <= 0) return repro::launch_status();
  segment_sum_kernel<<<static_cast<unsigned>(s), repro::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(g, seg, m, seg_sum);
  return repro::launch_status();
}

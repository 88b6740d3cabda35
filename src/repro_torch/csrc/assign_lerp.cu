// Family B: the fused on-arrival assignment and mixed-rate center blend
// (Eq. 1 + Sec. 4) in one launch: L1 distances of one upload to C centers,
// their first-index argmin, and the blend of the winning center.
//
// Replaces the TPU kernels src/repro/kernels/assign_lerp.py::_select_lerp
// (_select_lerp_kernel, reached through assign_and_lerp) and, inside it,
// src/repro/kernels/l1_distance.py::l1_distance.
//
// Bound: bytes. It reads the upload and the C centers once and writes the
// blended row (and C distances): (C + 2) N floats. At the paper's widths
// that is ~0.5 MB, so launch latency and one memory round trip decide.
// Design: one cooperative launch of at most the co-resident block count.
//   1. Blocks walk the work items (a 4096-element chunk of u against 4
//      centers) and store each chunk's partial sums to a (chunks, C)
//      scratch, in the order of l1_rows.cuh: the distances are bitwise
//      those of l1.cu for the same rows.
//   2. Grid sync. Every block sums the partials of every center in chunk
//      order (one warp per center) and takes the first-index argmin with
//      numpy's NaN rule (a NaN is the minimum; the first NaN wins), so all
//      blocks hold the same index and nothing goes through the host. Block
//      0 stores the distances and the index.
//   3. Each block blends its chunks of row idx as the pinned two-op form
//      round(round((1-b)*c) + round(b*u)) with __fmul_rn / __fadd_rn, which
//      nvcc cannot contract into an FMA: the same bits as the reference's
//      fenced blend (src/repro/kernels/ref.py::assign_and_lerp_ref).
//      With C <= 4 and one block per chunk (the MLP and LM paths' shapes),
//      each block keeps its chunk of u and of the centers in registers
//      across the sync and blends from them; otherwise it reads the winning
//      chunk again, from L2 ((C + 1) N floats fit the 50 MB L2 up to C ~ 15
//      at N = 783,360).
//
// bf16 upload and centers (repro_assign_lerp_bf16): the same kernel on
// bf16 loads converted to fp32 (l1_rows.cuh), the reference's cast
// (assign_lerp.py:30-31): fp32 distances and blended row, the fp32
// kernel's bits on the rows cast to fp32.
#include <cooperative_groups.h>

#include "l1_rows.cuh"

namespace cg = cooperative_groups;

namespace {

// a before b in numpy's argmin order (NaN first, then smaller, then lower index)
__device__ __forceinline__ bool before(float av, int ai, float bv, int bi) {
  if (isnan(av) || isnan(bv)) return isnan(av) && (!isnan(bv) || ai < bi);
  return av < bv || (av == bv && ai < bi);
}

// out[g .. g+3] (those below n) = the pinned blend of c and u.
__device__ __forceinline__ void blend4(float* __restrict__ out, int64_t g, int64_t n, float omb,
                                       float b, float4 c, float4 u) {
  if (g >= n) return;
  const float4 r = make_float4(__fadd_rn(__fmul_rn(omb, c.x), __fmul_rn(b, u.x)),
                               __fadd_rn(__fmul_rn(omb, c.y), __fmul_rn(b, u.y)),
                               __fadd_rn(__fmul_rn(omb, c.z), __fmul_rn(b, u.z)),
                               __fadd_rn(__fmul_rn(omb, c.w), __fmul_rn(b, u.w)));
  if (g + 4 <= n) {
    *reinterpret_cast<float4*>(out + g) = r;  // out is a fresh, 16-byte aligned row
  } else {
    out[g] = r.x;
    if (g + 1 < n) out[g + 1] = r.y;
    if (g + 2 < n) out[g + 2] = r.z;
  }
}

template <typename T>
__global__ void __launch_bounds__(repro::kThreads)
assign_lerp_kernel(const T* __restrict__ u, const T* __restrict__ centers, int64_t c_rows,
                   int64_t n, int64_t chunks, float omb, float b, float* scratch,
                   float* __restrict__ dists, int* __restrict__ idx_out, float* __restrict__ out) {
  __shared__ float best_v[repro::kWarps];
  __shared__ int best_i[repro::kWarps];
  __shared__ int s_idx;
  // One chunk per block and every center in it: the block keeps its chunk of
  // u and of the centers in registers across the grid sync and blends from
  // them. Otherwise it walks the work items and reads the winner again.
  const bool resident = c_rows <= repro::kTileC && gridDim.x == chunks;
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * repro::kChunk + 4 * threadIdx.x;
  float4 uv[1][repro::kSteps], cv[repro::kTileC][repro::kSteps];
  if (resident) {
    repro::load_rows<1>(u, 0, 1, n, g0, uv);
    repro::load_rows<repro::kTileC>(centers, 0, c_rows, n, g0, cv);
    __shared__ float part[repro::kWarps][repro::kTileC];
#pragma unroll
    for (int ci = 0; ci < repro::kTileC; ++ci)
      if (ci < c_rows) repro::warp_partials<1, repro::kTileC>(uv, cv[ci], 1, ci, part);
    repro::store_partials<1, repro::kTileC>(part, 1, c_rows, scratch + blockIdx.x * c_rows, 0);
  } else {
    const int64_t c_tiles = (c_rows + repro::kTileC - 1) / repro::kTileC;
    for (int64_t w = blockIdx.x; w < chunks * c_tiles; w += gridDim.x) {
      const int64_t k = w % chunks, c0 = (w / chunks) * repro::kTileC;
      repro::chunk_partials<1, repro::kTileC>(u, 1, centers, c_rows, n, k, 0, c0,
                                              scratch + k * c_rows + c0, 0);
    }
  }
  cg::this_grid().sync();
  // 2. distances and the argmin: warp w takes centers w, w + 8, ... in order
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  float bv = 0.f;
  int bi = -1;
  for (int64_t ci = wid; ci < c_rows; ci += repro::kWarps) {
    const float d = repro::sum_chunks(scratch + ci, chunks, c_rows);
    if (bi < 0 || before(d, static_cast<int>(ci), bv, bi)) {
      bv = d;
      bi = static_cast<int>(ci);
    }
    if (blockIdx.x == 0 && lane == 0) dists[ci] = d;
  }
  if (lane == 0) {
    best_v[wid] = bv;
    best_i[wid] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = best_v[0];
    int i = best_i[0];
    for (int j = 1; j < repro::kWarps; ++j)
      if (best_i[j] >= 0 && before(best_v[j], best_i[j], v, i)) {
        v = best_v[j];
        i = best_i[j];
      }
    s_idx = i;
    if (blockIdx.x == 0) *idx_out = i;
  }
  __syncthreads();
  // 3. the blend of row idx, chunk by chunk
  const int idx = s_idx;
  if (resident) {
#pragma unroll
    for (int j = 0; j < repro::kSteps; ++j) {
      float4 c = cv[0][j];
#pragma unroll
      for (int ci = 1; ci < repro::kTileC; ++ci)
        if (ci == idx) c = cv[ci][j];  // a select, so cv stays in registers
      blend4(out, g0 + 4 * repro::kThreads * j, n, omb, b, c, uv[0][j]);
    }
    return;
  }
  const T* cr = centers + static_cast<int64_t>(idx) * n;
  const int al_c = repro::row_align(cr), al_u = repro::row_align(u);
  for (int64_t k = blockIdx.x; k < chunks; k += gridDim.x) {
#pragma unroll
    for (int j = 0; j < repro::kSteps; ++j) {
      const int64_t g = k * repro::kChunk + 4 * (threadIdx.x + repro::kThreads * j);
      blend4(out, g, n, omb, b, repro::load4(cr, g, n, al_c), repro::load4(u, g, n, al_u));
    }
  }
}

template <typename T>
int assign_lerp(const T* u, const T* centers, int64_t c_rows, int64_t n, int64_t chunks, double beta,
                float* scratch, float* dists, int* idx_out, float* out, int device, void* stream) {
  static int coresident[64];
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  repro::use_device(device);
  if (c_rows <= 0 || n <= 0 || chunks != repro::l1_chunks(n) ||
      (reinterpret_cast<uintptr_t>(out) & 15u) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // beta folds like the reference's Python float: (1 - beta) in double,
  // then one rounding to fp32 (src/repro/kernels/assign_lerp.py:36).
  float omb = static_cast<float>(1.0 - beta);
  float b = static_cast<float>(beta);
  const int cap = repro::coresident_blocks(assign_lerp_kernel<T>, device, coresident, 0);
  int64_t blocks = chunks * ((c_rows + repro::kTileC - 1) / repro::kTileC);
  if (blocks > cap) blocks = cap;
  void* args[] = {&u, &centers, &c_rows, &n, &chunks, &omb, &b, &scratch, &dists, &idx_out, &out};
  const cudaError_t rc = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(assign_lerp_kernel<T>), dim3(static_cast<unsigned>(blocks)),
      dim3(repro::kThreads), args, 0, static_cast<cudaStream_t>(stream));
  return rc != cudaSuccess ? static_cast<int>(rc) : repro::launch_status();
}

}  // namespace

// scratch: chunks * c_rows floats, chunks = ceil(n / 4096); any other
// `chunks` is refused. out must be 16-byte aligned.
REPRO_API int repro_assign_lerp(const float* u, const float* centers, int64_t c_rows, int64_t n,
                                int64_t chunks, double beta, float* scratch, float* dists,
                                int* idx_out, float* out, int device, void* stream) {
  return assign_lerp(u, centers, c_rows, n, chunks, beta, scratch, dists, idx_out, out, device, stream);
}

// The same on a bf16 upload and centers (fp32 distances and blended row).
REPRO_API int repro_assign_lerp_bf16(const repro::bf16* u, const repro::bf16* centers, int64_t c_rows,
                                     int64_t n, int64_t chunks, double beta, float* scratch, float* dists,
                                     int* idx_out, float* out, int device, void* stream) {
  return assign_lerp(u, centers, c_rows, n, chunks, beta, scratch, dists, idx_out, out, device, stream);
}

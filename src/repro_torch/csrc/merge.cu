// Family D: cluster-merge attention (paper Algorithm 1, lines 2-6) in one launch.
//
// Replaces the TPU kernels src/repro/kernels/merge_attention.py::merge_attention
// (_max_kernel through the pallas_call at :68, then _blend_kernel at :77).
//
//   p      = (va - vm) * (vt - vm)
//   alpha  = relu(p) / max(max_k p_k, 1e-12)
//   merged = alpha * va + (1 - alpha) * vm
//
// Bits. Every step is one round-to-nearest operation (__fsub_rn, __fmul_rn,
// __fdiv_rn, __fadd_rn), so nvcc contracts nothing into an FMA and the blend
// is the pinned two-op form. Every max propagates NaN, as jnp.max and
// jnp.maximum do (src/repro/kernels/ref.py:46): a NaN in any p makes the
// normalizer NaN, and with it every output. relu(p) is `p <= 0 ? 0 : p`: a
// NaN passes and -0 becomes +0, as jnp.maximum(p, 0.0) gives. Apart from NaN
// a max does not depend on the order of its operands, and the sign of a zero
// cannot reach the normalizer, because max(+-0, 1e-12) = 1e-12. So the
// output's bits depend on the three inputs alone, not on the launch shape or
// the order in which blocks finish, and the kernel is held to its plain
// version (kernels/merge.py) bit for bit at every shape, with no model of a
// summation order (unlike l1_rows.cuh and chi2.cu).
//
// Bound: bytes. 3 N floats read and N written; at the MLP path's N = 25,418
// that is 0.4 MB, so launch latency and one memory round trip decide, and
// how many SMs share the round trip: one SM pulls about 25 KB in a
// microsecond. The launch is one kernel:
//
//   - N <= 4096: one ordinary block of 1024 threads, 4 elements each, no
//     grid sync.
//   - Otherwise a cooperative grid: blocks of T threads, each thread taking E
//     elements a step, with (T, E) the first of (256, 1), (256, 2) within 64
//     blocks, (256, 4), (512, 8) within 128 blocks, else (512, 12) and as
//     many blocks as the card holds at once. Each thread keeps its first
//     step's vm, va and p in registers, so a grid that covers N in one step
//     (every path's N, 783,360 included; up to 1.6 M on the H100) reads every
//     input once. Warps reduce p's max by shuffles, the block through shared
//     memory; each block writes its max to block_maxima, grid.sync(), and
//     every warp reduces the block maxima. The blend runs from registers;
//     further steps, if any, read their elements again (from L2, 50 MB).
//
// The shapes come from measurements on the H100 (PERF.md section 6):
// 16 SMs of a thread-block cluster, sharing the max through distributed
// shared memory instead of a grid sync, pulled N = 25,418 slower (0.0045 ms)
// than the 50 blocks above (0.0037); fewer, fuller blocks lose at every N,
// and so does a grid much larger than the card's 132 SMs.
//
// Each element is read and written by one thread, reads first, so `out` may
// alias `vm` (neither is __restrict__): the server merges a plane row in
// place. Loads are 4-byte and coalesced across a warp, so a row's alignment
// (a plane row of odd index is only 8-byte aligned at N % 4 = 2) needs no
// path of its own. block_maxima is a module array, so two merges must not
// run at once on one device; launches on one stream never do.
//
// bf16 rows (repro_merge_attention_bf16): the same kernel on bf16 loads,
// each converted to fp32 (the reference's casts, merge_attention.py:36-44),
// the merged value rounded to bf16 on the store (its output in
// v_main.dtype, :82): the fp32 kernel's result on the rows cast to fp32,
// rounded once to nearest even.
#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxBlocks = 2048;  // of a grid: block_maxima's length

__device__ float block_maxima[kMaxBlocks];

// max(a, b) with NaN propagated, as jnp.maximum.
__device__ __forceinline__ float nan_max(float a, float b) { return (isnan(a) || a > b) ? a : b; }

__device__ __forceinline__ float warp_nan_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float agreement(float m, float a, float t) {
  return __fmul_rn(__fsub_rn(a, m), __fsub_rn(t, m));
}

__device__ __forceinline__ float blend(float m, float a, float p, float denom) {
  const float alpha = __fdiv_rn(p <= 0.f ? 0.f : p, denom);
  return __fadd_rn(__fmul_rn(alpha, a), __fmul_rn(__fsub_rn(1.f, alpha), m));
}

// Thread t of block b takes elements b T E + j T + t, j < E, then the same a
// grid's T E gridDim.x further on, while below n.
template <int T, int E, typename V>
__global__ void __launch_bounds__(T)
merge_kernel(const V* vm, const V* __restrict__ va, const V* __restrict__ vt, int64_t n, V* out) {
  __shared__ float part[T / 32];
  const int lane = threadIdx.x & 31;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * (T * E) + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * (T * E);
  float m[E], a[E], p[E];
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int64_t k = first + j * T;
    const bool in = k < n;
    m[j] = in ? repro::to_f32(vm[k]) : 0.f;
    a[j] = in ? repro::to_f32(va[k]) : 0.f;
    p[j] = in ? agreement(m[j], a[j], repro::to_f32(vt[k])) : -INFINITY;
    mx = nan_max(mx, p[j]);
  }
  for (int64_t base = first + stride; base < n; base += stride) {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int64_t k = base + j * T;
      if (k < n) mx = nan_max(mx, agreement(repro::to_f32(vm[k]), repro::to_f32(va[k]), repro::to_f32(vt[k])));
    }
  }
  mx = warp_nan_max(mx);
  if (lane == 0) part[threadIdx.x >> 5] = mx;
  __syncthreads();
  mx = warp_nan_max(lane < T / 32 ? part[lane] : -INFINITY);
  if (gridDim.x > 1) {
    if (threadIdx.x == 0) block_maxima[blockIdx.x] = mx;
    cg::this_grid().sync();
    mx = -INFINITY;
    for (unsigned b = lane; b < gridDim.x; b += 32) mx = nan_max(mx, __ldcg(block_maxima + b));
    mx = warp_nan_max(mx);
  }
  const float denom = nan_max(mx, 1e-12f);
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int64_t k = first + j * T;
    if (k < n) out[k] = repro::from_f32<V>(blend(m[j], a[j], p[j], denom));
  }
  for (int64_t base = first + stride; base < n; base += stride) {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int64_t k = base + j * T;
      if (k < n) {
        const float mk = repro::to_f32(vm[k]), ak = repro::to_f32(va[k]);
        out[k] = repro::from_f32<V>(blend(mk, ak, agreement(mk, ak, repro::to_f32(vt[k])), denom));
      }
    }
  }
}

template <int T, int E, typename V>
int launch(const V* vm, const V* va, const V* vt, int64_t n, V* out, int64_t blocks, cudaStream_t stream) {
  const auto kernel = merge_kernel<T, E, V>;
  if (blocks == 1) {  // no other block to wait for: an ordinary launch
    kernel<<<1, T, 0, stream>>>(vm, va, vt, n, out);
    return repro::launch_status();
  }
  void* args[] = {&vm, &va, &vt, &n, &out};
  const cudaError_t rc = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                                     dim3(static_cast<unsigned>(blocks)), dim3(T),
                                                     args, 0, stream);
  const int last = repro::launch_status();  // also clears a refusal, so the next call does not see it
  return rc != cudaSuccess ? static_cast<int>(rc) : last;
}

// Blocks of merge_kernel<512, 12, V> the card holds at once (cached per device).
template <typename V>
cudaError_t coresident(int device, int64_t* blocks) {
  static int64_t cached[64];
  if (cached[device] == 0) {
    int per_sm = 0, sms = 0;
    cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, merge_kernel<512, 12, V>, 512, 0);
    if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (rc != cudaSuccess) return rc;
    const int64_t all = static_cast<int64_t>(per_sm) * sms;
    cached[device] = all < kMaxBlocks ? all : kMaxBlocks;
  }
  *blocks = cached[device];
  return cudaSuccess;
}

int64_t blocks_for(int64_t n, int64_t per_block) { return (n + per_block - 1) / per_block; }

template <typename V>
int merge(const V* vm, const V* va, const V* vt, int64_t n, V* out, int device, void* stream) {
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  repro::use_device(device);
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (n <= 1024 * 4) return launch<1024, 4>(vm, va, vt, n, out, 1, s);
  if (n <= 64 * 256) return launch<256, 1>(vm, va, vt, n, out, blocks_for(n, 256), s);
  if (n <= 64 * 256 * 2) return launch<256, 2>(vm, va, vt, n, out, blocks_for(n, 256 * 2), s);
  if (n <= 128 * 256 * 4) return launch<256, 4>(vm, va, vt, n, out, blocks_for(n, 256 * 4), s);
  if (n <= 128 * 512 * 8) return launch<512, 8>(vm, va, vt, n, out, blocks_for(n, 512 * 8), s);
  int64_t cap = 0;
  const cudaError_t rc = coresident<V>(device, &cap);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int64_t blocks = blocks_for(n, 512 * 12);
  return launch<512, 12>(vm, va, vt, n, out, blocks < cap ? blocks : cap, s);
}

}  // namespace

// The merged center of three length-n rows into out, in one launch. out may
// be vm itself; no other input may overlap it.
REPRO_API int repro_merge_attention(const float* vm, const float* va, const float* vt, int64_t n,
                                    float* out, int device, void* stream) {
  return merge(vm, va, vt, n, out, device, stream);
}

// The same on bf16 rows (a bf16 merged row).
REPRO_API int repro_merge_attention_bf16(const repro::bf16* vm, const repro::bf16* va, const repro::bf16* vt,
                                         int64_t n, repro::bf16* out, int device, void* stream) {
  return merge(vm, va, vt, n, out, device, stream);
}

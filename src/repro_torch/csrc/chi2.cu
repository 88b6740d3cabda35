// Family C: chi-squared client feedback (paper Eq. 2/3).
//
// Replaces the TPU kernels src/repro/kernels/chi2_feedback.py::chi2_feedback
// (_chi2_kernel) and ::chi2_feedback_segmented (_chi2_seg_kernel).
//
// g = chi2 * Var(s): chi2 = sum_j (fp - ft)^2 / max(ft, 1e-6), Var the
// POPULATION variance (mean first, then sum (s - mean)^2 / J). Segment sums
// add g per cluster slot; membership comes as int32 segment ids (-1 = none)
// instead of the TPU kernel's one-hot matrix, which is never built here.
//
// Bound: bytes, and at the server's sizes (M = a few to a few hundred rows,
// J = 2..16 classes) launch latency: the whole input is a few KB. So both
// entry points are one launch of one kernel (chi2_feedback is the segmented
// form with S = 0), and the design spends nothing on a second pass:
//
//   1. Rows come in tiles of kRows rows (J <= kMaxThreadJ: one thread per
//      row) or kWarps rows (wider J: one warp per row). Block b takes tiles
//      b, b + gridDim.x, ... .
//   2. J <= kMaxThreadJ: the block stages its tile of f_pred, f_true and
//      s_soft (rows x J floats, contiguous) and its segment ids into shared
//      memory with 4-byte cp.async copies (one round trip), at a row stride
//      of J | 1 floats (odd: no bank conflicts at even J). Each thread then
//      computes the term (fp - ft)^2 / max(ft, 1e-6) of the elements it
//      copied, in place, so no thread divides J times in a row.
//      Thread r then sums its row in j order, j = 0 .. J-1:
//        chi2 = sum term,  mean = (sum s) / J,
//        var = (sum (s - mean)^2) / J,  g = chi2 * var,
//      every step one round-to-nearest operation (__fadd_rn, __fsub_rn,
//      __fmul_rn, __fdiv_rn): nvcc contracts nothing into an FMA.
//   3. J > kMaxThreadJ: lane l sums elements l, l + 32, ... in order with the
//      same operations, read from device memory; the lanes meet in an xor
//      butterfly (offsets 16, 8, 4, 2, 1); the mean comes from the
//      butterflied sum, the variance's partials the same way.
//   4. Segment sums (S > 0), no atomics: in each tile, warp w takes segments
//      w, w + kWarps, ...; lane l sums the g of the tile's rows l, l + 32, ...
//      whose id is s, in row order from 0, the lanes meet in the butterfly,
//      and lane 0 adds the tile's sum to the block's partial, so a block adds
//      its tiles' sums in tile order. Past one tile the grid is one
//      thread-block cluster of at most kCluster blocks; after cluster.sync(),
//      block rank 0 reads the others' partials through distributed shared
//      memory and adds them in rank order. A one-block grid (M <= one tile)
//      is an ordinary launch and writes its partials as the sums; with S = 0
//      the grid is one ordinary block per tile.
//
// So the bits depend on the inputs, M, J and S alone, never on timing.
// Output: one buffer, g (M floats) then seg_sum (S floats).
// tests/test_torch_chi2_order.py models this order in numpy. On the H100,
// 4-byte cp.async staging beat a 1-D cp.async.bulk and plain loads, and
// element-parallel terms beat a thread dividing J times (PERF.md §6).
//
// bf16 rows (repro_chi2_bf16): the same kernel, each element converted to
// fp32 as it is staged (a plain load instead of the 4-byte cp.async) or
// read (the warp rows), the reference's casts (chi2_feedback.py:21-23,
// :68-70): fp32 g and segment sums, the fp32 kernel's bits on the rows
// cast to fp32.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = repro::kThreads;        // rows of a tile, one per thread
constexpr int kWarps = repro::kThreads / 32;  // warps of a block; rows of a tile past kMaxThreadJ
constexpr int kMaxThreadJ = 32;               // widest J a thread takes alone
constexpr int kCluster = 8;                   // blocks of the segmented grid (portable)
constexpr int kMaxSmem = 232448;              // shared memory a block may opt in to

template <typename V>
struct Args {
  const V* fp;
  const V* ft;
  const V* ss;
  const int* seg;  // null when s == 0
  float* out;      // g (m floats), then seg_sum (s floats)
  int64_t m, j, s;
};

// Dynamic shared memory of a launch: the staged tiles (thread rows only),
// then the tile's g and segment ids, then the block's S partials. The
// wrapper (kernels/chi2.py::smem_bytes) checks the same sum before it
// launches; past kMaxSmem the launch returns cudaErrorInvalidValue.
int64_t smem_bytes(int64_t m, int64_t j, int64_t s) {
  const int64_t tile = j <= kMaxThreadJ ? kRows : kWarps;
  const int64_t cap = m < tile ? m : tile;
  const int64_t staged = j <= kMaxThreadJ ? 3 * cap * (j | 1) : 0;
  return 4 * (staged + 2 * cap + s);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// f(e, r, c) for the elements e = threadIdx.x, + kThreads, ... < n of a tile
// of rows of j floats, e at row r and column c (one division, then steps).
template <typename F>
__device__ __forceinline__ void for_my_elements(int n, int j, F&& f) {
  if (n <= 0) return;
  const int dr = repro::kThreads / j, dc = repro::kThreads % j;
  int r = threadIdx.x / j, c = threadIdx.x % j;
#pragma unroll 4
  for (int e = threadIdx.x; e < n; e += repro::kThreads) {
    f(e, r, c);
    r += dr;
    c += dc;
    if (c >= j) {
      c -= j;
      ++r;
    }
  }
}

__device__ __forceinline__ float chi2_term(float a, float t) {
  const float d = __fsub_rn(a, t);
  return __fdiv_rn(__fmul_rn(d, d), fmaxf(t, 1e-6f));
}

// Step 2's row sums: g of one row from its J terms and s values (shared
// memory), j <= kMaxThreadJ. Unrolled, so the loads run ahead of the adds.
__device__ __forceinline__ float row_g(const float* term, const float* s, int j) {
  float chi = 0.f, sum = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxThreadJ; ++k) {
    if (k < j) {
      chi = __fadd_rn(chi, term[k]);
      sum = __fadd_rn(sum, s[k]);
    }
  }
  const float jf = static_cast<float>(j);
  const float mean = __fdiv_rn(sum, jf);
  float var = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxThreadJ; ++k) {
    if (k < j) {
      const float d = __fsub_rn(s[k], mean);
      var = __fadd_rn(var, __fmul_rn(d, d));
    }
  }
  return __fmul_rn(chi, __fdiv_rn(var, jf));
}

__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;  // every lane holds the same bits (addition commutes)
}

// Step 3: g of one row in one warp, lanes strided over J.
template <typename V>
__device__ __forceinline__ float row_g_warp(const V* a, const V* t, const V* s, int64_t j, int lane) {
  float chi = 0.f, sum = 0.f;
  for (int64_t k = lane; k < j; k += 32) {
    chi = __fadd_rn(chi, chi2_term(repro::to_f32(a[k]), repro::to_f32(t[k])));
    sum = __fadd_rn(sum, repro::to_f32(s[k]));
  }
  chi = lanes_sum(chi);
  const float jf = static_cast<float>(j);
  const float mean = __fdiv_rn(lanes_sum(sum), jf);
  float var = 0.f;
  for (int64_t k = lane; k < j; k += 32) {
    const float d = __fsub_rn(repro::to_f32(s[k]), mean);
    var = __fadd_rn(var, __fmul_rn(d, d));
  }
  return __fmul_rn(chi, __fdiv_rn(lanes_sum(var), jf));
}

template <bool kThreadRows, typename V>
__global__ void __launch_bounds__(repro::kThreads) chi2_kernel(Args<V> p) {
  extern __shared__ float smem[];
  constexpr int T = kThreadRows ? kRows : kWarps;
  const int cap = static_cast<int>(p.m < T ? p.m : T);
  const int j = static_cast<int>(p.j);  // only read as an int on the thread-row path
  const int stride = j | 1;
  float* staged = smem;  // f_pred, f_true, s_soft tiles: cap rows of `stride` floats each
  float* gs = smem + (kThreadRows ? 3 * cap * stride : 0);
  int* ids = reinterpret_cast<int*>(gs + cap);
  float* part = reinterpret_cast<float*>(ids + cap);
  for (int64_t i = threadIdx.x; i < p.s; i += blockDim.x) part[i] = 0.f;
  const int64_t tiles = (p.m + T - 1) / T;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t r0 = tile * T;
    const int rows = static_cast<int>(p.m - r0 < T ? p.m - r0 : T);
    const int n = kThreadRows ? rows * j : 0;
    const int64_t base = r0 * p.j;
    for_my_elements(n, j, [&](int e, int r, int c) {
      const int at = r * stride + c;
      if constexpr (std::is_same_v<V, float>) {
        cp_async4(staged + at, p.fp + base + e);
        cp_async4(staged + cap * stride + at, p.ft + base + e);
        cp_async4(staged + 2 * cap * stride + at, p.ss + base + e);
      } else {
        staged[at] = repro::to_f32(p.fp[base + e]);
        staged[cap * stride + at] = repro::to_f32(p.ft[base + e]);
        staged[2 * cap * stride + at] = repro::to_f32(p.ss[base + e]);
      }
    });
    if (p.s > 0 && static_cast<int>(threadIdx.x) < rows)
      cp_async4(reinterpret_cast<float*>(ids) + threadIdx.x,
                reinterpret_cast<const float*>(p.seg) + r0 + threadIdx.x);
    cp_async_wait_all();
    // the terms of this thread's own copies, in place of the f_pred tile
    for_my_elements(n, j, [&](int, int r, int c) {
      const int at = r * stride + c;
      staged[at] = chi2_term(staged[at], staged[cap * stride + at]);
    });
    __syncthreads();
    if constexpr (kThreadRows) {
      const int r = threadIdx.x;
      if (r < rows) {
        const float g = row_g(staged + r * stride, staged + (2 * cap + r) * stride, j);
        p.out[r0 + r] = g;
        gs[r] = g;
      }
    } else {
      const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
      if (w < rows) {
        const int64_t off = (r0 + w) * p.j;
        const float g = row_g_warp(p.fp + off, p.ft + off, p.ss + off, p.j, lane);
        if (lane == 0) {
          p.out[r0 + w] = g;
          gs[w] = g;
        }
      }
    }
    if (p.s > 0) {
      __syncthreads();
      const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
      for (int64_t sid = w; sid < p.s; sid += kWarps) {
        float acc = 0.f;
        for (int r = lane; r < rows; r += 32)
          if (ids[r] == sid) acc = __fadd_rn(acc, gs[r]);
        acc = lanes_sum(acc);
        if (lane == 0) part[sid] = __fadd_rn(part[sid], acc);
      }
    }
    __syncthreads();  // the tile's shared memory is reused by the next one
  }
  if (p.s == 0) return;
  if (gridDim.x == 1) {  // an ordinary launch: the block's partials are the sums
    __syncthreads();
    for (int64_t sid = threadIdx.x; sid < p.s; sid += blockDim.x) p.out[p.m + sid] = part[sid];
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0) {
    const int nb = static_cast<int>(cluster.num_blocks());
    for (int64_t sid = threadIdx.x; sid < p.s; sid += blockDim.x) {
      float total = part[sid];
      for (int b = 1; b < nb; ++b) total = __fadd_rn(total, cluster.map_shared_rank(part, b)[sid]);
      p.out[p.m + sid] = total;
    }
  }
  cluster.sync();  // no block leaves while rank 0 still reads its partials
}

template <bool kThreadRows, typename V>
int launch(const Args<V>& p, int device, cudaStream_t stream) {
  constexpr int64_t T = kThreadRows ? kRows : kWarps;
  const int64_t smem = smem_bytes(p.m, p.j, p.s);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static int64_t allowed[64];  // dynamic shared memory opted in to so far, per device
  if (smem > 48 * 1024 && smem > allowed[device]) {
    const cudaError_t rc = cudaFuncSetAttribute(
        chi2_kernel<kThreadRows, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    allowed[device] = smem;
  }
  const int64_t tiles = (p.m + T - 1) / T;
  const int64_t blocks = p.s > 0 ? (tiles < kCluster ? (tiles > 0 ? tiles : 1) : kCluster) : tiles;
  if (blocks == 1 || p.s == 0) {  // no block reads another's partials: no cluster
    chi2_kernel<kThreadRows, V><<<static_cast<unsigned>(blocks), repro::kThreads, static_cast<size_t>(smem),
                                  stream>>>(p);
    return repro::launch_status();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(repro::kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute la[1];
  la[0].id = cudaLaunchAttributeClusterDimension;
  la[0].val.clusterDim.x = static_cast<unsigned>(blocks);
  la[0].val.clusterDim.y = 1;
  la[0].val.clusterDim.z = 1;
  cfg.attrs = la;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, chi2_kernel<kThreadRows, V>, p);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return repro::launch_status();
}

template <typename V>
int chi2(const V* fp, const V* ft, const V* ss, const int* seg, float* out, int64_t m, int64_t j, int64_t s,
         int device, void* stream) {
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  repro::use_device(device);
  if (m < 0 || j < 0 || s < 0 || (m > 0 && s > 0 && seg == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m + s == 0) return repro::launch_status();
  const Args<V> p{fp, ft, ss, seg, out, m, j, s};
  const auto st = static_cast<cudaStream_t>(stream);
  return j <= kMaxThreadJ ? launch<true>(p, device, st) : launch<false>(p, device, st);
}

}  // namespace

// g (and, for s > 0, the segment sums of `seg`) of the (m, j) rows into
// out[0 .. m + s): one launch, or none when there is nothing to write.
REPRO_API int repro_chi2(const float* fp, const float* ft, const float* ss, const int* seg,
                         float* out, int64_t m, int64_t j, int64_t s, int device, void* stream) {
  return chi2(fp, ft, ss, seg, out, m, j, s, device, stream);
}

// The same on bf16 rows (fp32 g and segment sums).
REPRO_API int repro_chi2_bf16(const repro::bf16* fp, const repro::bf16* ft, const repro::bf16* ss,
                              const int* seg, float* out, int64_t m, int64_t j, int64_t s, int device,
                              void* stream) {
  return chi2(fp, ft, ss, seg, out, m, j, s, device, stream);
}

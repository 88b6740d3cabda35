// Family A: L1 rows. (M, N) x (C, N) -> (M, C) fp32 L1 distances (Eq. 1).
//
// Replaces the TPU kernels src/repro/kernels/l1_distance.py::l1_distance
// (_l1_kernel, one upload against C centers, M = 1) and ::pairwise_l1
// (C = M), and src/repro/kernels/l1_pairwise.py::l1_distance_pairwise
// (_pairwise_kernel). On the upload path the same sums run inside the fused
// assign kernel (assign_lerp.cu).
//
// Bound: bytes. Each output reads two N-float rows and does 3 flops per
// element pair, far below the card's operations-per-byte balance. At the
// paper's widths (N = 4,550 .. 25,418) a call moves well under a megabyte
// and launch latency plus one memory round trip decide; at the LM delta's
// width (N = 783,360) it moves megabytes and bandwidth decides.
// Design: N splits into 4096-element chunks (l1_rows.cuh); a work item is
// one chunk of a tile of TM x rows by TC c rows, so each block loads a chunk
// of each row once and keeps 4 (TM + TC) 16-byte loads in flight per thread.
// Past one chunk, one cooperative launch of at most the co-resident block
// count: blocks walk the work items and store each chunk's partials to a
// (chunks, M, C) scratch, the grid syncs, and one warp per output sums its
// chunk partials in chunk order (N <= 4096: an ordinary launch that stores
// the partials as the outputs). No atomics: the
// bits depend only on the two rows and N (l1_rows.cuh), at any alignment.
//
// bf16 rows (repro_l1_rows_bf16): the same kernel instantiated on bf16
// loads (l1_rows.cuh), the reference's cast of its inputs to fp32
// (l1_distance.py:30-31, l1_pairwise.py:31-32); fp32 distances, the fp32
// kernel's bits on the rows cast to fp32. Half the bytes a row.
#include <cooperative_groups.h>

#include "l1_rows.cuh"

namespace cg = cooperative_groups;

namespace {

// kOneChunk (N <= 4096): each block's partials are the outputs, stored
// directly: no scratch, no grid sync, an ordinary launch of one block per
// output. The bits are the same, since step 4 of a single partial p is
// p + 0 + ... + 0 = p.
template <int TM, int TC, bool kOneChunk, typename T>
__global__ void __launch_bounds__(repro::kThreads)
l1_rows_kernel(const T* __restrict__ x, const T* __restrict__ c, float* __restrict__ out,
               float* scratch, int64_t m_rows, int64_t c_rows, int64_t n, int64_t chunks) {
  const int64_t mc = m_rows * c_rows;
  const int64_t c_tiles = (c_rows + TC - 1) / TC;
  const int64_t items = chunks * c_tiles * ((m_rows + TM - 1) / TM);
  for (int64_t w = blockIdx.x; w < items; w += gridDim.x) {
    const int64_t k = w % chunks, tile = w / chunks;
    const int64_t m0 = (tile / c_tiles) * TM, c0 = (tile % c_tiles) * TC;
    float* dst = kOneChunk ? out : scratch + k * mc;
    repro::chunk_partials<TM, TC>(x, m_rows, c, c_rows, n, k, m0, c0, dst + m0 * c_rows + c0,
                                  c_rows);
  }
  if constexpr (!kOneChunk) {
    cg::this_grid().sync();
    const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
    for (int64_t o = warp; o < mc; o += warps) {
      const float s = repro::sum_chunks(scratch + o, chunks, mc);
      if ((threadIdx.x & 31) == 0) out[o] = s;
    }
  }
}

// Past one chunk: a cooperative launch of TM x TC tiles.
template <int TM, typename T>
int launch_chunked(const T* x, const T* c, float* out, float* scratch, int64_t m,
                   int64_t c_rows, int64_t n, int device, cudaStream_t stream) {
  constexpr int TC = repro::kTileC;
  static int coresident[64];
  int64_t chunks = repro::l1_chunks(n);
  const int64_t items = chunks * ((c_rows + TC - 1) / TC) * ((m + TM - 1) / TM);
  const int cap = repro::coresident_blocks(l1_rows_kernel<TM, TC, false, T>, device, coresident, 0);
  const int64_t outs_blocks = (m * c_rows + repro::kWarps - 1) / repro::kWarps;
  int64_t blocks = items > outs_blocks ? items : outs_blocks;
  if (blocks > cap) blocks = cap;
  void* args[] = {&x, &c, &out, &scratch, &m, &c_rows, &n, &chunks};
  const cudaError_t rc = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(l1_rows_kernel<TM, TC, false, T>), dim3(static_cast<unsigned>(blocks)),
      dim3(repro::kThreads), args, 0, stream);
  return rc != cudaSuccess ? static_cast<int>(rc) : repro::launch_status();
}

template <typename T>
int l1_rows(const T* x, const T* c, float* out, float* scratch, int64_t m, int64_t c_rows, int64_t n,
            int64_t chunks, int device, void* stream) {
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  repro::use_device(device);
  if (m <= 0 || c_rows <= 0) return repro::launch_status();
  if (n <= 0 || chunks != repro::l1_chunks(n)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (chunks == 1) {
    l1_rows_kernel<1, 1, true, T><<<static_cast<unsigned>(m * c_rows), repro::kThreads, 0, s>>>(
        x, c, out, scratch, m, c_rows, n, chunks);
    return repro::launch_status();
  }
  // Four x rows per block share each c row's loads where rows are wide and
  // blocks plenty; one where latency decides. The tile does not change the bits.
  return m >= 4 && chunks >= 8 ? launch_chunked<4, T>(x, c, out, scratch, m, c_rows, n, device, s)
                               : launch_chunked<1, T>(x, c, out, scratch, m, c_rows, n, device, s);
}

}  // namespace

// scratch: chunks * m * c_rows floats, chunks = ceil(n / 4096); any other
// `chunks` is refused, so the caller's count cannot drift from the kernel's.
REPRO_API int repro_l1_rows(const float* x, const float* c, float* out, float* scratch,
                            int64_t m, int64_t c_rows, int64_t n, int64_t chunks, int device,
                            void* stream) {
  return l1_rows(x, c, out, scratch, m, c_rows, n, chunks, device, stream);
}

// The same on bf16 rows (fp32 distances).
REPRO_API int repro_l1_rows_bf16(const repro::bf16* x, const repro::bf16* c, float* out, float* scratch,
                                 int64_t m, int64_t c_rows, int64_t n, int64_t chunks, int device,
                                 void* stream) {
  return l1_rows(x, c, out, scratch, m, c_rows, n, chunks, device, stream);
}

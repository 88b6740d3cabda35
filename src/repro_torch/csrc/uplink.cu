// The compressed uplink's cohort encodes: int8 with a scale a chunk, and
// error-feedback top-k. One launch encodes a cohort of B uploads.
//
// Replaces the reference's jitted cohort encodes (not pallas_calls):
// src/repro/fl/uplink.py::_encode_int8 (:141) and ::_encode_topk (:131),
// which gather each upload's anchor (and residual) row from the codec's
// plane, encode, and hand the new rows back to the plane in a second step.
// Here each kernel reads the rows in the plane through the row ids and
// writes the advanced anchors (and residuals) back in place; `mat` is only
// read and the reconstruction goes to `rec`, a matrix of its own. Row ids
// must be distinct, and no row of `mat` or `rec` may lie in the plane.
//
// Bits. Every step is one IEEE operation rounded to nearest (__fsub_rn,
// __fadd_rn, __fdiv_rn, rintf), and int8's two fused steps are
// __fmaf_rn, as XLA fuses them in the reference's jitted encode: the scale
// fma(max, fl(1/127), 1e-12) and the reconstruction fma(q, s, A), each
// rounded once. A chunk's max over |d| propagates NaN, as jnp.max does (not
// fmaxf); a NaN code becomes 0, as the reference's float-to-int8 conversion
// makes it, and a -0 code +0. Top-k adds sent to every anchor element, as
// the reference's A + sent does (-0 + 0 is +0), and writes the elements it
// changes. Top-k's keys are the bits of |c| as uint32, every NaN made one
// key above inf's, so the order is lax.top_k's: larger first, ties to the
// lower index, NaNs equal, +0 equal to -0. The kernels' results depend on
// their inputs alone (a max and counts do not depend on the order of their
// terms), so they are held to their plain versions (kernels/uplink.py) bit
// for bit.
//
// Bound: bytes. int8 reads mat and the anchor and writes rec and the anchor,
// 16 B an element. Top-k reads mat, the anchor and the residual and writes
// rec and the residual, 20 B an element, and writes only the anchor
// elements that change, 4 B each (the k sent a row, and unsent -0 anchors).
// At the paths' rows (2,304 to 25,418 floats) a launch moves at most 0.6 MB
// a row, so latency and the number of SMs that share the row decide.
//
//   - uplink_int8_kernel: one block of 256 threads a (chunk, row), so a
//     cohort of B rows of n floats is B * ceil(n / chunk) blocks (9 for a
//     har row at the default chunk of 512, 1,530 for the full-width
//     783,360 delta). A pass finds the chunk's max of |mat - A|, a second
//     quantizes and reconstructs from the same elements (L1 holds them).
//   - top-k, a radix select over the keys' four bytes, highest first: each
//     pass counts the keys that match the bytes chosen so far in 256 bins
//     (lanes of a warp that share a bin add once, __match_any_sync), and
//     one warp picks the bin that holds the k-th largest key. The first
//     pass writes c into `rec`, which the later passes read back (from L2).
//     After the four passes the k-th key, the count above it and the count
//     equal to it are known: where every key equal to it is taken, the
//     last pass selects by key alone; else it walks the row in index order,
//     a block-wide count of equal keys per tile, and takes the first ones.
//     The last pass writes the residual, the reconstruction and the anchor
//     elements that change. Two launches of it:
//       uplink_topk_kernel, one block of 1024 threads a row, for rows under
//       8,192 floats and for cohorts too large to split;
//       uplink_topk_split_kernel, one cooperative launch where each row of
//       8,192 floats or more is split over as many blocks of 512 threads as
//       the card holds at once (B * parts of them, at least 2,048 floats a
//       block; with limits of 65,536 and 4,096 instead, rows of 25,418
//       floats stayed unsplit and took 1.6-2.5x longer at B <= 32). Each pass adds the blocks' histograms into the row's in a
//       scratch buffer and waits at the grid barrier (five barriers a
//       launch, the first after zeroing the buffer); every block then picks
//       the same bin. A block's own counts of the last pass go to the
//       buffer too, so the ordered tie count starts from the keys equal to
//       the k-th in the row's earlier slices.
//
// On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6): int8 0.0021 ms
// at (1, 4550) and 0.0069 ms at (1, 783360); top-k 0.0101 ms at (1, 4550),
// under torch.topk's 0.0427; at (1, 25418) one block a row took 0.0392 ms
// and the split launch 0.0158; at (1, 783360) 1.3765 ms and 0.0247 (383
// blocks), under torch.topk's 0.1628.
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kInt8Threads = 256;
constexpr int kTopkThreads = 1024;
constexpr int kSplitThreads = 512;
constexpr int64_t kSplitMinN = 8192;       // shorter rows keep one block a row
constexpr int64_t kSplitMinSlice = 2048;   // a split row's floats a block, at least
constexpr float kInv127 = 1.0f / 127.0f;  // fl(1/127), XLA's reciprocal of the divisor

// max(a, b) with NaN propagated, as jnp.maximum.
__device__ __forceinline__ float nan_max(float a, float b) { return (isnan(a) || a > b) ? a : b; }

__device__ __forceinline__ float warp_nan_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// grid (chunks, B): block (c, b) encodes elements [c chunk, (c + 1) chunk) of row b.
__global__ void __launch_bounds__(kInt8Threads)
uplink_int8_kernel(float* plane, const int64_t* __restrict__ anchor_rows, const float* __restrict__ mat,
                   float* __restrict__ rec, int64_t n, int64_t chunk) {
  __shared__ float part[kInt8Threads / 32];
  const int64_t row = blockIdx.y;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t hi = lo + chunk < n ? lo + chunk : n;
  float* a = plane + anchor_rows[row] * n;
  const float* m = mat + row * n;
  float* out = rec + row * n;
  const int lane = threadIdx.x & 31;
  float mx = 0.f;  // the reference's max runs over |d| and the padding's zeros
  for (int64_t i = lo + threadIdx.x; i < hi; i += kInt8Threads) mx = nan_max(mx, fabsf(__fsub_rn(m[i], a[i])));
  mx = warp_nan_max(mx);
  if (lane == 0) part[threadIdx.x >> 5] = mx;
  __syncthreads();  // also orders every read of the anchor before the writes below
  mx = warp_nan_max(lane < kInt8Threads / 32 ? part[lane] : 0.f);
  const float s = __fmaf_rn(mx, kInv127, 1e-12f);
  for (int64_t i = lo + threadIdx.x; i < hi; i += kInt8Threads) {
    const float av = a[i];
    float q = rintf(__fdiv_rn(__fsub_rn(m[i], av), s));
    q = q < -127.f ? -127.f : (q > 127.f ? 127.f : q);  // a NaN fails both tests and stays NaN
    q = isnan(q) ? 0.f : __fadd_rn(q, 0.f);             // NaN -> 0, -0 -> +0: the int8 round trip
    const float r = __fmaf_rn(q, s, av);
    out[i] = r;
    a[i] = r;
  }
}

// The key of c: the bits of |c|, every NaN one key above inf (0x7f800000).
__device__ __forceinline__ uint32_t key_of(float c) {
  const uint32_t b = __float_as_uint(c) & 0x7fffffffu;
  return b > 0x7f800000u ? 0x7fc00000u : b;
}

// Adds to hist (256 bins in shared memory) the keys of c[lo, hi) that match
// `prefix` under `prefix_mask`, by their byte at `shift`. Pass 0 computes c
// = (mat - A) + R, the reference's order, and keeps it in `c`; the later
// passes read it back there. Lanes of a warp that share a bin add once.
template <int T>
__device__ __forceinline__ void count_keys(int pass, int lo, int hi, const float* m, const float* a, const float* r,
                                           float* c, uint32_t prefix, uint32_t prefix_mask, int shift, int* hist) {
  const int lane = threadIdx.x & 31;
  for (int base = lo; base < hi; base += T) {
    const int i = base + threadIdx.x;
    int bin = 256;  // no bin: past the slice, or the key does not match the prefix
    if (i < hi) {
      float ci;
      if (pass == 0) {
        ci = __fadd_rn(__fsub_rn(m[i], a[i]), r[i]);
        c[i] = ci;
      } else {
        ci = c[i];
      }
      const uint32_t key = key_of(ci);
      if ((key & prefix_mask) == prefix) bin = static_cast<int>((key >> shift) & 0xffu);
    }
    const unsigned same = __match_any_sync(0xffffffffu, bin);
    if (bin < 256 && lane == __ffs(same) - 1) atomicAdd(&hist[bin], __popc(same));
  }
}

// Warp 0 finds the bin of hist (a pass's 256 counts, in shared memory) that
// holds the remaining-th largest matching key: the prefix with that byte,
// the matching keys in larger bins, and the bin's count.
__device__ __forceinline__ void pick_bin(const int* hist, int remaining, uint32_t prefix, int shift,
                                         uint32_t* pick_prefix, int* pick_above, int* pick_equal) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= 32) return;
  // lane l holds bins 255 - 8 l down to 248 - 8 l: lower lanes, larger keys
  int cnt[8], total = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    cnt[j] = hist[255 - 8 * lane - j];
    total += cnt[j];
  }
  int incl = total;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  int acc = incl - total;  // matching keys in the bins of lower lanes
  if (acc < remaining && remaining <= incl) {
    int bin = -1, count = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (bin < 0) {
        if (acc + cnt[j] >= remaining) {
          bin = 255 - 8 * lane - j;
          count = cnt[j];
        } else {
          acc += cnt[j];
        }
      }
    }
    *pick_prefix = prefix | (static_cast<uint32_t>(bin) << shift);
    *pick_above = acc;
    *pick_equal = count;
  }
}

// The last pass over c[lo, hi): `kth` is the k-th largest key. Every key
// above it is sent; of the keys equal to it, all where `take_all_equal`,
// else those whose rank among them in index order (`taken` of them lie
// before lo) is below `remaining`. Writes the residual, the reconstruction
// over c, and the anchor elements that change.
template <int T>
__device__ __forceinline__ void send_keys(int lo, int hi, uint32_t kth, bool take_all_equal, int taken, int remaining,
                                          float* a, float* r, float* c, int* warp_count) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int base = lo; base < hi; base += T) {
    const int i = base + tid;
    float ci = 0.f;
    uint32_t key = 0;
    if (i < hi) {
      ci = c[i];
      key = key_of(ci);
    }
    bool chosen = i < hi && key > kth;
    const bool tie = i < hi && key == kth;
    if (take_all_equal) {
      chosen = chosen || tie;
    } else {
      const unsigned ties = __ballot_sync(0xffffffffu, tie);
      if (lane == 0) warp_count[warp] = __popc(ties);
      __syncthreads();
      int before = 0, tile = 0;
      for (int w = 0; w < T / 32; ++w) {
        const int v = warp_count[w];
        before += w < warp ? v : 0;
        tile += v;
      }
      chosen = chosen || (tie && taken + before + __popc(ties & ((1u << lane) - 1u)) < remaining);
      taken += tile;
      __syncthreads();  // warp_count is written again by the next tile
    }
    if (i < hi) {
      const float sent = chosen ? ci : 0.f;
      const float av = a[i];
      const float ri = __fadd_rn(av, sent);  // also where nothing was sent: -0 + 0 = +0
      if (__float_as_uint(ri) != __float_as_uint(av)) a[i] = ri;
      r[i] = __fsub_rn(ci, sent);
      c[i] = ri;
    }
  }
}

// grid (B): block b encodes row b.
__global__ void __launch_bounds__(kTopkThreads)
uplink_topk_kernel(float* plane, const int64_t* __restrict__ anchor_rows, const int64_t* __restrict__ resid_rows,
                   const float* __restrict__ mat, float* __restrict__ rec, int n, int k) {
  __shared__ int hist[256];
  __shared__ int warp_count[kTopkThreads / 32];
  __shared__ uint32_t pick_prefix;
  __shared__ int pick_above, pick_equal;
  const int64_t row = blockIdx.x;
  float* a = plane + anchor_rows[row] * static_cast<int64_t>(n);
  float* r = plane + resid_rows[row] * static_cast<int64_t>(n);
  const float* m = mat + row * n;
  float* c = rec + row * n;  // c until the last pass writes the reconstruction over it
  const int tid = threadIdx.x;

  uint32_t prefix = 0, prefix_mask = 0;
  int remaining = k;  // selected keys still to place among those that match the prefix
  int equal = 0;      // keys equal to the k-th, after the last pass
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    if (tid < 256) hist[tid] = 0;
    __syncthreads();
    count_keys<kTopkThreads>(pass, 0, n, m, a, r, c, prefix, prefix_mask, shift, hist);
    __syncthreads();
    pick_bin(hist, remaining, prefix, shift, &pick_prefix, &pick_above, &pick_equal);
    __syncthreads();
    prefix = pick_prefix;
    prefix_mask |= 0xffu << shift;
    remaining -= pick_above;
    equal = pick_equal;
    __syncthreads();  // every thread has read the picks before the next pass may write them
  }
  // prefix is the k-th largest key; `remaining` of the keys equal to it are taken, lowest index first
  send_keys<kTopkThreads>(0, n, prefix, equal == remaining, 0, remaining, a, r, c, warp_count);
}

// One cooperative launch of B * parts blocks: block g encodes slice g % parts
// of row g / parts (contiguous, in index order). Each pass adds the blocks'
// shared-memory histograms into the row's in `ws` and waits at the grid
// barrier; every block of the row then reads the row's histogram and picks
// the same bin. The last pass's per-block histograms also go to `ws`, so a
// block knows how many keys equal to the k-th lie in the slices before its
// own. ws: B x 4 x 256 row counts (zeroed here), then B x parts x 256.
__global__ void __launch_bounds__(kSplitThreads)
uplink_topk_split_kernel(float* plane, const int64_t* __restrict__ anchor_rows,
                         const int64_t* __restrict__ resid_rows, const float* __restrict__ mat,
                         float* __restrict__ rec, int* ws, int B, int n, int k, int parts, int len) {
  __shared__ int hist[256];
  __shared__ int warp_count[kSplitThreads / 32];
  __shared__ uint32_t pick_prefix;
  __shared__ int pick_above, pick_equal;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x / parts;
  const int part = blockIdx.x % parts;
  const int lo = min(n, part * len), hi = min(n, lo + len);
  float* a = plane + anchor_rows[row] * static_cast<int64_t>(n);
  float* r = plane + resid_rows[row] * static_cast<int64_t>(n);
  const float* m = mat + row * n;
  float* c = rec + row * n;
  int* row_hist = ws + row * 1024;
  int* part_hist = ws + static_cast<int64_t>(B) * 1024 + row * parts * 256;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * kSplitThreads + tid; j < static_cast<int64_t>(B) * 1024;
       j += static_cast<int64_t>(gridDim.x) * kSplitThreads)
    ws[j] = 0;
  grid.sync();

  uint32_t prefix = 0, prefix_mask = 0;
  int remaining = k, equal = 0;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    if (tid < 256) hist[tid] = 0;
    __syncthreads();
    count_keys<kSplitThreads>(pass, lo, hi, m, a, r, c, prefix, prefix_mask, shift, hist);
    __syncthreads();
    if (tid < 256) {
      const int h = hist[tid];
      if (h) atomicAdd(&row_hist[pass * 256 + tid], h);
      if (pass == 3) part_hist[part * 256 + tid] = h;
    }
    grid.sync();
    if (tid < 256) hist[tid] = __ldcg(&row_hist[pass * 256 + tid]);
    __syncthreads();
    pick_bin(hist, remaining, prefix, shift, &pick_prefix, &pick_above, &pick_equal);
    __syncthreads();
    prefix = pick_prefix;
    prefix_mask |= 0xffu << shift;
    remaining -= pick_above;
    equal = pick_equal;
    __syncthreads();
  }
  const bool take_all_equal = equal == remaining;
  int taken = 0;  // keys equal to the k-th in the row's earlier slices
  if (!take_all_equal) {
    for (int q = tid; q < part; q += kSplitThreads) taken += __ldcg(&part_hist[q * 256 + (prefix & 0xffu)]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) taken += __shfl_xor_sync(0xffffffffu, taken, o);
    if ((tid & 31) == 0) warp_count[tid >> 5] = taken;
    __syncthreads();
    taken = 0;
    for (int w = 0; w < kSplitThreads / 32; ++w) taken += warp_count[w];
    __syncthreads();  // send_keys writes warp_count again
  }
  send_keys<kSplitThreads>(lo, hi, prefix, take_all_equal, taken, remaining, a, r, c, warp_count);
}

// The launch for B rows of n floats on the current device: plan = {parts
// (0: one block a row), ws ints}. A row of at least kSplitMinN floats is
// split over the blocks the card holds at once, at least kSplitMinSlice
// floats a block, where that gives it two or more.
cudaError_t topk_plan(int64_t B, int64_t n, int device, int64_t* plan) {
  plan[0] = 0;
  plan[1] = 0;
  if (n < kSplitMinN) return cudaSuccess;
  static int cap[64] = {0};
  if (cap[device] == 0) {
    int per_sm = 0, sms = 0;
    cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, uplink_topk_split_kernel, kSplitThreads, 0);
    if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (rc != cudaSuccess) return rc;
    cap[device] = per_sm * sms;
  }
  const int64_t by_slice = (n + kSplitMinSlice - 1) / kSplitMinSlice;
  const int64_t parts = cap[device] / B < by_slice ? cap[device] / B : by_slice;
  if (parts < 2) return cudaSuccess;
  plan[0] = parts;
  plan[1] = B * 1024 + B * parts * 256;
  return cudaSuccess;
}

}  // namespace

// The int8 reconstruction of B rows of n floats (chunk floats a scale) into
// rec, the anchors plane[anchor_rows[b]] advanced to it in place.
REPRO_API int repro_uplink_int8(float* plane, const int64_t* anchor_rows, const float* mat, float* rec, int64_t B,
                                int64_t n, int64_t chunk, int device, void* stream) {
  if (device < 0) return static_cast<int>(cudaErrorInvalidDevice);
  repro::use_device(device);
  if (B <= 0 || B > 65535 || n <= 0 || chunk <= 0 || chunk > n) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunks = (n + chunk - 1) / chunk;
  if (chunks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  uplink_int8_kernel<<<dim3(static_cast<unsigned>(chunks), static_cast<unsigned>(B)), kInt8Threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(plane, anchor_rows, mat, rec, n, chunk);
  return repro::launch_status();
}

// plan (2) int64: the launch repro_uplink_topk makes for B rows of n
// floats: {blocks a row (0: one block a row, no workspace), ws ints}.
REPRO_API int repro_uplink_topk_plan(int64_t B, int64_t n, int device, int64_t* plan) {
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  repro::use_device(device);
  if (B <= 0 || B > 0x7fffffff || n <= 0 || n > 0x7fffffff - kTopkThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(topk_plan(B, n, device, plan));
}

// The EF-top-k reconstruction of B rows of n floats (k kept a row) into rec,
// the anchors plane[anchor_rows[b]] and residuals plane[resid_rows[b]]
// advanced in place. ws: ws_ints ints of scratch, at least the plan's.
REPRO_API int repro_uplink_topk(float* plane, const int64_t* anchor_rows, const int64_t* resid_rows, const float* mat,
                                float* rec, int* ws, int64_t B, int64_t n, int64_t k, int64_t ws_ints, int device,
                                void* stream) {
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  repro::use_device(device);
  if (B <= 0 || B > 0x7fffffff || n <= 0 || n > 0x7fffffff - kTopkThreads || k <= 0 || k > n)
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t plan[2];
  const cudaError_t planned = topk_plan(B, n, device, plan);
  if (planned != cudaSuccess) return static_cast<int>(planned);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plan[0] == 0) {
    uplink_topk_kernel<<<static_cast<unsigned>(B), kTopkThreads, 0, st>>>(
        plane, anchor_rows, resid_rows, mat, rec, static_cast<int>(n), static_cast<int>(k));
    return repro::launch_status();
  }
  if (ws == nullptr || ws_ints < plan[1]) return static_cast<int>(cudaErrorInvalidValue);
  int b = static_cast<int>(B), nn = static_cast<int>(n), kk = static_cast<int>(k), parts = static_cast<int>(plan[0]);
  int len = static_cast<int>((n + parts - 1) / parts);
  void* args[] = {&plane, &anchor_rows, &resid_rows, &mat, &rec, &ws, &b, &nn, &kk, &parts, &len};
  const cudaError_t rc = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(uplink_topk_split_kernel),
                                                     dim3(static_cast<unsigned>(B * parts)), dim3(kSplitThreads),
                                                     args, 0, st);
  return rc != cudaSuccess ? static_cast<int>(rc) : repro::launch_status();
}

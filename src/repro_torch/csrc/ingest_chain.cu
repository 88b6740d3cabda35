// The coalesced server ingest in one launch: for a segment of S uploads of
// distinct clients, in order, each step scores its upload against the
// carried center matrix (every earlier step's blend included), takes the
// first-index argmin, applies the switch veto and the forced (pinned)
// index, blends the chosen row, and sums the predictor's three L1
// statistics of the step.
//
// Replaces src/repro/kernels/ops.py::ingest_chain (_ingest_chain_jit, a
// lax.scan whose step calls the TPU kernel
// src/repro/kernels/l1_distance.py::l1_distance, pallas_call at :51). It is
// not itself a pallas_call.
//
// Bound: bytes and latency. A step reads the upload, the C carried rows and
// the chosen center's anchor and writes the blended row twice: (C + 4) N
// floats, 3 flops an element pair. At the paper's widths a step moves about
// half a megabyte, so the two grid-wide syncs a step and the memory round
// trip decide, as they do for the per-event assign it replaces.
// Design: one cooperative launch of at most the co-resident block count.
// Per step j:
//   A. Blocks walk the work items (a 4096-element chunk of U[j] against 4
//      carried rows) and store each chunk's partial sums to a (chunks, C)
//      scratch in the order of l1_rows.cuh: the distances are bitwise those
//      of l1.cu and assign_lerp.cu for the same rows. Grid sync.
//   B. Every block sums the partials in chunk order (one warp a center),
//      takes the first-index argmin with numpy's NaN rule, then the veto
//      d[amin] > fl(fl(1 - margin) * d[prev]) as the host computes it in
//      fp32 (clustering.py), and the forced index, which skips both. All
//      blocks hold the same index; nothing goes through the host.
//   C. Each block blends its chunks of the chosen row in the pinned two-op
//      form round(round((1-b)*c) + round(b*u)) (__fmul_rn / __fadd_rn, no
//      FMA), writes them to the carried row and to blended[j], and stores
//      per-chunk partials of change = L1(new, old), gap_before = L1(old,
//      anchor) and gap_after = L1(new, anchor), in l1_rows.cuh's order, to
//      an (S, chunks, 3) scratch. Grid sync: step j + 1 reads the rows.
// After the last step the statistics' partials are summed in chunk order,
// one warp an output, so each is bitwise l1_distance of the same two rows.
// The carried rows are written and read again by other blocks inside the
// launch, so every load of them bypasses L1 (__ldcg).
#include <cooperative_groups.h>

#include "l1_rows.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCenters = 1024;  // the distances of a step live in shared memory

// a before b in numpy's argmin order (NaN first, then smaller, then lower index)
__device__ __forceinline__ bool before(float av, int ai, float bv, int bi) {
  if (isnan(av) || isnan(bv)) return isnan(av) && (!isnan(bv) || ai < bi);
  return av < bv || (av == bv && ai < bi);
}

// repro::load4 through L2 only: for rows that other blocks wrote in this launch.
__device__ __forceinline__ float4 load4_cg(const float* row, int64_t g, int64_t n, int align) {
  if (g + 4 <= n) {
    if (align == 16) return __ldcg(reinterpret_cast<const float4*>(row + g));
    if (align == 8) {
      const float2 a = __ldcg(reinterpret_cast<const float2*>(row + g));
      const float2 b = __ldcg(reinterpret_cast<const float2*>(row + g + 2));
      return make_float4(a.x, a.y, b.x, b.y);
    }
    return make_float4(__ldcg(row + g), __ldcg(row + g + 1), __ldcg(row + g + 2), __ldcg(row + g + 3));
  }
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (g < n) v.x = __ldcg(row + g);
  if (g + 1 < n) v.y = __ldcg(row + g + 1);
  if (g + 2 < n) v.z = __ldcg(row + g + 2);
  return v;
}

// Elements g .. g+3 (those below n) of a row at any alignment.
__device__ __forceinline__ void store4(float* row, int64_t g, int64_t n, int align, float4 v) {
  if (g + 4 <= n) {
    if (align == 16) {
      *reinterpret_cast<float4*>(row + g) = v;
    } else if (align == 8) {
      *reinterpret_cast<float2*>(row + g) = make_float2(v.x, v.y);
      *reinterpret_cast<float2*>(row + g + 2) = make_float2(v.z, v.w);
    } else {
      row[g] = v.x;
      row[g + 1] = v.y;
      row[g + 2] = v.z;
      row[g + 3] = v.w;
    }
    return;
  }
  if (g < n) row[g] = v.x;
  if (g + 1 < n) row[g + 1] = v.y;
  if (g + 2 < n) row[g + 2] = v.z;
}

__device__ __forceinline__ float4 blend4(float omb, float b, float4 c, float4 u) {
  return make_float4(__fadd_rn(__fmul_rn(omb, c.x), __fmul_rn(b, u.x)),
                     __fadd_rn(__fmul_rn(omb, c.y), __fmul_rn(b, u.y)),
                     __fadd_rn(__fmul_rn(omb, c.z), __fmul_rn(b, u.z)),
                     __fadd_rn(__fmul_rn(omb, c.w), __fmul_rn(b, u.w)));
}

// Phase A for chunk k of u against carried rows [c0, c0 + kTileC): the chunk
// partials to dst[ci], ci < c_rows - c0. Every thread of the block calls it.
__device__ __forceinline__ void distance_partials(const float* __restrict__ u, const float* carried,
                                                  int64_t c_rows, int64_t n, int64_t k, int64_t c0,
                                                  float* dst) {
  constexpr int TC = repro::kTileC;
  __shared__ float part[repro::kWarps][TC];
  const int64_t g0 = k * repro::kChunk + 4 * threadIdx.x;
  float4 uv[1][repro::kSteps], cv[TC][repro::kSteps];
  repro::load_rows<1>(u, 0, 1, n, g0, uv);
#pragma unroll
  for (int ci = 0; ci < TC; ++ci) {
    const float* p = carried + (c0 + ci < c_rows ? c0 + ci : c_rows - 1) * n;
    const int al = repro::row_align(p);
#pragma unroll
    for (int j = 0; j < repro::kSteps; ++j) cv[ci][j] = load4_cg(p, g0 + 4 * repro::kThreads * j, n, al);
  }
#pragma unroll
  for (int ci = 0; ci < TC; ++ci)
    if (c0 + ci < c_rows) repro::warp_partials<1, TC>(uv, cv[ci], 1, ci, part);
  repro::store_partials<1, TC>(part, 1, c_rows - c0, dst, 0);
}

__global__ void __launch_bounds__(repro::kThreads)
ingest_chain_kernel(const float* __restrict__ U, float* carried, const float* __restrict__ bcast,
                    const int* __restrict__ prev_forced, int64_t steps, int64_t c_rows, int64_t n,
                    int64_t chunks, float omb, float b, float omm, float* scratch, float* stat_part,
                    float* __restrict__ dists, int* __restrict__ cids, float* __restrict__ stats,
                    float* __restrict__ blended) {
  __shared__ float s_dist[kMaxCenters];
  __shared__ float best_v[repro::kWarps];
  __shared__ int best_i[repro::kWarps];
  __shared__ int s_cid;
  __shared__ float part[repro::kWarps][3];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int64_t c_tiles = (c_rows + repro::kTileC - 1) / repro::kTileC;
  for (int64_t j = 0; j < steps; ++j) {
    const float* u = U + j * n;
    // A. distance partials of u against the carried rows
    for (int64_t w = blockIdx.x; w < chunks * c_tiles; w += gridDim.x) {
      const int64_t k = w % chunks, c0 = (w / chunks) * repro::kTileC;
      distance_partials(u, carried, c_rows, n, k, c0, scratch + k * c_rows + c0);
    }
    grid.sync();
    // B. distances, argmin, veto and forced index, the same in every block
    float bv = 0.f;
    int bi = -1;
    for (int64_t ci = wid; ci < c_rows; ci += repro::kWarps) {
      const float d = repro::sum_chunks(scratch + ci, chunks, c_rows);
      if (bi < 0 || before(d, static_cast<int>(ci), bv, bi)) {
        bv = d;
        bi = static_cast<int>(ci);
      }
      if (lane == 0) {
        s_dist[ci] = d;
        if (blockIdx.x == 0) dists[j * c_rows + ci] = d;
      }
    }
    if (lane == 0) {
      best_v[wid] = bv;
      best_i[wid] = bi;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float v = best_v[0];
      int amin = best_i[0];
      for (int i = 1; i < repro::kWarps; ++i)
        if (best_i[i] >= 0 && before(best_v[i], best_i[i], v, amin)) {
          v = best_v[i];
          amin = best_i[i];
        }
      const int prev = prev_forced[j], forced = prev_forced[steps + j];
      int cid = amin;
      if (forced >= 0) {
        cid = forced;
      } else if (prev >= 0 && prev != amin && s_dist[amin] > __fmul_rn(omm, s_dist[prev])) {
        cid = prev;  // not decisively closer: the client stays
      }
      s_cid = cid;
      if (blockIdx.x == 0) cids[j] = cid;
    }
    __syncthreads();
    // C. the blend of the chosen row and the partials of its statistics
    float* row = carried + static_cast<int64_t>(s_cid) * n;
    const float* anchor = bcast + static_cast<int64_t>(s_cid) * n;
    float* out = blended + j * n;
    const int al_r = repro::row_align(row), al_u = repro::row_align(u);
    const int al_a = repro::row_align(anchor), al_o = repro::row_align(out);
    for (int64_t k = blockIdx.x; k < chunks; k += gridDim.x) {
      float change = 0.f, gap_before = 0.f, gap_after = 0.f;
#pragma unroll
      for (int s = 0; s < repro::kSteps; ++s) {
        const int64_t g = k * repro::kChunk + 4 * (threadIdx.x + repro::kThreads * s);
        const float4 c = load4_cg(row, g, n, al_r);
        const float4 a = repro::load4(anchor, g, n, al_a);
        const float4 nw = blend4(omb, b, c, repro::load4(u, g, n, al_u));
        change = repro::add_abs4(change, nw, c);
        gap_before = repro::add_abs4(gap_before, c, a);
        gap_after = repro::add_abs4(gap_after, nw, a);
        store4(row, g, n, al_r, nw);
        store4(out, g, n, al_o, nw);
      }
      change = repro::warp_sum(change);
      gap_before = repro::warp_sum(gap_before);
      gap_after = repro::warp_sum(gap_after);
      if (lane == 0) {
        part[wid][0] = change;
        part[wid][1] = gap_before;
        part[wid][2] = gap_after;
      }
      repro::store_partials<1, 3>(part, 1, 3, stat_part + (j * chunks + k) * 3, 0);
    }
    grid.sync();
  }
  // the statistics: output o = 3 j + s sums its chunk partials in chunk order
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t o = warp; o < 3 * steps; o += warps) {
    const float s = repro::sum_chunks(stat_part + (o / 3) * chunks * 3 + o % 3, chunks, 3);
    if (lane == 0) stats[o] = s;
  }
}

int coresident[64];

}  // namespace

// U (S, n) uploads; carried (C, n) the gathered centers, blended in place;
// bcast (C, n) their anchors; prev_forced (2 S) int32: the prev indices,
// then the forced ones (-1: none). scratch: chunks * C floats; stat_part:
// S * chunks * 3 floats, chunks = ceil(n / 4096); any other `chunks` is
// refused. Outputs: dists (S, C), cids (S,), stats (S, 3) as (change,
// gap_before, gap_after), blended (S, n).
REPRO_API int repro_ingest_chain(const float* U, float* carried, const float* bcast,
                                 const int* prev_forced, int64_t steps, int64_t c_rows, int64_t n,
                                 int64_t chunks, double beta, double margin, float* scratch,
                                 float* stat_part, float* dists, int* cids, float* stats,
                                 float* blended, int device, void* stream) {
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  repro::use_device(device);
  if (steps <= 0 || c_rows <= 0 || c_rows > kMaxCenters || n <= 0 || chunks != repro::l1_chunks(n))
    return static_cast<int>(cudaErrorInvalidValue);
  // beta and the margin fold like the host's Python floats: (1 - x) in
  // double, then one rounding to fp32
  float omb = static_cast<float>(1.0 - beta);
  float b = static_cast<float>(beta);
  float omm = static_cast<float>(1.0 - margin);
  const int cap = repro::coresident_blocks(ingest_chain_kernel, device, coresident);
  int64_t blocks = chunks * ((c_rows + repro::kTileC - 1) / repro::kTileC);
  if (blocks > cap) blocks = cap;
  void* args[] = {&U,     &carried, &bcast,   &prev_forced, &steps,     &c_rows, &n,     &chunks,
                  &omb,   &b,       &omm,     &scratch,     &stat_part, &dists,  &cids,  &stats,
                  &blended};
  const cudaError_t rc = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(ingest_chain_kernel), dim3(static_cast<unsigned>(blocks)),
      dim3(repro::kThreads), args, 0, static_cast<cudaStream_t>(stream));
  return rc != cudaSuccess ? static_cast<int>(rc) : repro::launch_status();
}

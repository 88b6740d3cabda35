// The coalesced server ingest in one launch: for a segment of S uploads of
// distinct clients, in order, each step scores its upload against the
// carried center matrix (every earlier step's blend included), takes the
// first-index argmin, applies the switch veto and the forced (pinned)
// index, blends the chosen row, and sums the predictor's three L1
// statistics of the step and, for the ingest guard, a fourth: the
// post-blend center norm L1(new, 0).
//
// Replaces src/repro/kernels/ops.py::ingest_chain (_ingest_chain_jit, a
// lax.scan whose step calls the TPU kernel
// src/repro/kernels/l1_distance.py::l1_distance, pallas_call at :51). It is
// not itself a pallas_call.
//
// Bound: latency. A step reads the upload, the C carried rows and the chosen
// center's anchor and writes the blended row twice: (C + 4) N floats, 3
// flops an element pair. At the paper's widths that is half a megabyte a
// step on a grid of a few blocks, and each step waits on the one before, so
// the step's chain of dependent events decides: one grid-wide barrier, one
// L2 round trip for the distances, and the block work between them (on an
// H100 at C = 4, N = 25,418 about 1.1, 0.5 and 2.5 us of a 4.1 us step;
// PERF.md).
// Design: one cooperative launch. A work item is (chunk k of 4096 elements,
// tile of 4 carried rows). Each item has one owning block for the whole
// launch (block b owns items b, b + G, ...), and inside the block thread t
// owns the item's elements 4 t + 1024 s (s < 4), in the distance pass and in
// the blend alike. Only that thread reads or writes them, so a step's blend
// and the next step's distances need no barrier between them.
//   Rows on chip: where every item has a block of its own (items <= the
//   blocks that fit at once with that much shared memory), a block loads
//   its item's segment-start rows and anchors into shared memory and keeps
//   them there; the chunk of the next step's upload is copied in with
//   cp.async while the current step runs (two buffers), issued right after
//   the step's barrier, while the partials come back through L2. Elements
//   past N are held as 0, which is what the L1 order loads there. Otherwise
//   (many centers) the owner keeps its rows in the output `carried` matrix,
//   read through L2, and reads the upload and anchors from global memory.
// Per step j:
//   a. The owners store each item's distance partials, in the order of
//      l1_rows.cuh (so the distances are bitwise those of l1.cu and
//      assign_lerp.cu for the same rows), into slot j % 2 of a (2, chunks, C)
//      slab. Grid sync: the one barrier of the step.
//   b. Every block sums the slot's partials in chunk order (one warp a
//      center), takes the first-index argmin with numpy's NaN rule, then the
//      veto d[amin] > fl(fl(1 - margin) * d[prev]) as the host computes it in
//      fp32 (clustering.py), and the forced index, which skips both. All
//      blocks hold the same index; nothing goes through the host.
//   c. The owners of the chosen row's tile blend their chunks in the pinned
//      two-op form round(round((1-b)*c) + round(b*u)) (__fmul_rn /
//      __fadd_rn, no FMA), write them to blended[j], and store per-chunk
//      partials of change = L1(new, old), gap_before = L1(old, anchor) and
//      gap_after = L1(new, anchor), and with the norm (kStats = 4) cnorm =
//      L1(new, 0), in l1_rows.cuh's order, to an (S, chunks, kStats)
//      scratch. Then straight on to step j + 1. A block
//      writes slot j % 2 again at step j + 2, after step j + 1's barrier,
//      which every block reaches only after it has read the slot at step j.
// After the last step the owners write their rows to `carried` (never to
// the input centers), one more grid sync, and the statistics' partials are
// summed in chunk order, one warp an output, so each is bitwise l1_distance
// of the same two rows: S + 1 grid syncs a launch.
// Two instantiations: kStats = 3 is the chain without the norm, the launch,
// outputs and buffers a run with no guard makes; kStats = 4 adds the norm's
// accumulator to step c and its column to `stats`.
#include <cooperative_groups.h>

#include "l1_rows.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCenters = 1024;  // the distances of a step live in shared memory
constexpr int kTileC = repro::kTileC;
constexpr int kSteps = repro::kSteps;

// Dynamic shared memory of a block that holds r rows on chip: r rows, their
// r anchors and two upload buffers, one chunk each.
constexpr size_t chip_bytes(int r) { return static_cast<size_t>(2 * r + 2) * repro::kChunk * sizeof(float); }

// a before b in numpy's argmin order (NaN first, then smaller, then lower index)
__device__ __forceinline__ bool before(float av, int ai, float bv, int bi) {
  if (isnan(av) || isnan(bv)) return isnan(av) && (!isnan(bv) || ai < bi);
  return av < bv || (av == bv && ai < bi);
}

// repro::load4 through L2 only: for the carried rows, which this launch writes.
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

template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(kBytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Elements g .. g+3 of a row (any alignment) into the 16-byte aligned dst[0..3]
// in shared memory, 0 past n: the widest copies the row's alignment allows.
__device__ __forceinline__ void stage4(float* dst, const float* row, int64_t g, int64_t n, int align) {
  if (g + 4 <= n) {
    if (align == 16) {
      cp_async<16>(dst, row + g);
    } else if (align == 8) {
      cp_async<8>(dst, row + g);
      cp_async<8>(dst + 2, row + g + 2);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) cp_async<4>(dst + e, row + g + e);
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (g + e < n)
      cp_async<4>(dst + e, row + g + e);
    else
      dst[e] = 0.f;
  }
}

// This thread's elements of chunk k of a row into its places in a chunk
// buffer in shared memory.
__device__ __forceinline__ void stage_chunk(float* buf, const float* row, int64_t k, int64_t n) {
  const int align = repro::row_align(row);
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int li = 4 * (threadIdx.x + repro::kThreads * s);
    stage4(buf + li, row, k * repro::kChunk + li, n, align);
  }
}

// This thread's four groups of chunk k: from a chunk buffer in shared
// memory (on chip) or from the row in the carried matrix.
__device__ __forceinline__ void carried_groups(float4 (&v)[kSteps], bool on_chip, const float* buf,
                                               const float* row, int64_t k, int64_t n) {
  if (on_chip) {
#pragma unroll
    for (int s = 0; s < kSteps; ++s) v[s] = reinterpret_cast<const float4*>(buf)[threadIdx.x + repro::kThreads * s];
  } else {
    const int align = repro::row_align(row);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) v[s] = load4_cg(row, k * repro::kChunk + 4 * (threadIdx.x + repro::kThreads * s), n, align);
  }
}

// The butterfly of warp_sum on K values at once, interleaved: each value
// takes the same adds in the same order as repro::warp_sum.
template <int K>
__device__ __forceinline__ void warp_sum_n(float (&v)[K]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < K; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  }
}

// The items block `first` owns, walked without a division a step: item
// w = first + i G is (chunk w % chunks, tile w / chunks).
struct Items {
  int k0, t0, dk, dt, chunks;
  __device__ Items(int first, int grid, int chunks_)
      : k0(first % chunks_), t0(first / chunks_), dk(grid % chunks_), dt(grid / chunks_), chunks(chunks_) {}
  __device__ __forceinline__ void next(int& k, int& t) const {
    k += dk;
    t += dt;
    if (k >= chunks) {
      k -= chunks;
      ++t;
    }
  }
};

template <int kStats>
__global__ void __launch_bounds__(repro::kThreads)
ingest_chain_kernel(const float* __restrict__ U, const float* __restrict__ centers, const float* __restrict__ bcast,
                    const int* __restrict__ prev_forced, int64_t steps, int64_t c_rows, int64_t n,
                    int64_t chunks, float omb, float b, float omm, int on_chip_flag, float* partials,
                    float* stat_part, float* __restrict__ dists, int* __restrict__ cids,
                    float* __restrict__ stats, float* __restrict__ blended, float* carried) {
  extern __shared__ float4 chip[];
  __shared__ float s_dist[kMaxCenters];
  __shared__ float best_v[repro::kWarps];
  __shared__ int best_i[repro::kWarps];
  __shared__ float dpart[repro::kWarps][kTileC];
  __shared__ float spart[repro::kWarps][kStats];
  cg::grid_group grid = cg::this_grid();
  const bool on_chip = on_chip_flag != 0;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int rows_c = static_cast<int>(c_rows);
  const int items = static_cast<int>(chunks) * ((rows_c + kTileC - 1) / kTileC);
  const Items mine(blockIdx.x, gridDim.x, static_cast<int>(chunks));
  // on chip, a block's one item: rows [0, r), anchors [r, 2r), upload buffers 2r and 2r + 1
  const int r = rows_c < kTileC ? rows_c : kTileC;
  float* rows = reinterpret_cast<float*>(chip);
  float* anchors = rows + r * repro::kChunk;
  float* ubuf = anchors + r * repro::kChunk;

  // the segment-start rows: on chip into shared memory, else into `carried`
  for (int w = blockIdx.x, k = mine.k0, t = mine.t0; w < items; w += gridDim.x, mine.next(k, t)) {
    const int c0 = t * kTileC;
    for (int ci = 0; ci < kTileC && c0 + ci < rows_c; ++ci) {
      const float* src = centers + (c0 + ci) * n;
      if (on_chip) {
        stage_chunk(rows + ci * repro::kChunk, src, k, n);
        stage_chunk(anchors + ci * repro::kChunk, bcast + (c0 + ci) * n, k, n);
      } else {
        float* dst = carried + (c0 + ci) * n;
        const int al_s = repro::row_align(src), al_d = repro::row_align(dst);
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          const int64_t g = k * repro::kChunk + 4 * (threadIdx.x + repro::kThreads * s);
          store4(dst, g, n, al_d, repro::load4(src, g, n, al_s));
        }
      }
    }
    if (on_chip) stage_chunk(ubuf, U, k, n);
  }
  cp_async_commit();

  for (int64_t j = 0; j < steps; ++j) {
    const float* u = U + j * n;
    const int slot = static_cast<int>(j & 1);
    float* pslot = partials + slot * chunks * c_rows;
    const float* ucur = ubuf + slot * repro::kChunk;
    const int prev = prev_forced[j], forced = prev_forced[steps + j];  // issued now, used after the barrier
    // a. distance partials of u against the owned rows
    if (on_chip) cp_async_wait_all();  // u's chunk is in ucur
    for (int w = blockIdx.x, k = mine.k0, t = mine.t0; w < items; w += gridDim.x, mine.next(k, t)) {
      const int c0 = t * kTileC, valid = rows_c - c0 < kTileC ? rows_c - c0 : kTileC;
      float4 uv[kSteps];
      carried_groups(uv, on_chip, ucur, u, k, n);
      float acc[kTileC];
#pragma unroll
      for (int ci = 0; ci < kTileC; ++ci) {
        const int cr = ci < valid ? ci : valid - 1;  // a missing row repeats the last one
        float4 cv[kSteps];
        carried_groups(cv, on_chip, rows + cr * repro::kChunk, carried + (c0 + cr) * n, k, n);
        acc[ci] = 0.f;
#pragma unroll
        for (int s = 0; s < kSteps; ++s) acc[ci] = repro::add_abs4(acc[ci], uv[s], cv[s]);
      }
      warp_sum_n(acc);
      if (lane == 0) {
#pragma unroll
        for (int ci = 0; ci < kTileC; ++ci) dpart[wid][ci] = acc[ci];
      }
      repro::store_partials<1, kTileC>(dpart, 1, valid, pslot + static_cast<int64_t>(k) * c_rows + c0, 0);
    }
    grid.sync();
    if (on_chip && j + 1 < steps) {  // the next upload's chunk, while the partials come back
      stage_chunk(ubuf + (slot ^ 1) * repro::kChunk, u + n, mine.k0, n);
      cp_async_commit();
    }
    // b. distances, argmin, veto and forced index, the same in every thread
    float bv = 0.f;
    int bi = -1;
    for (int ci = wid; ci < rows_c; ci += repro::kWarps) {
      const float d = repro::sum_chunks(pslot + ci, chunks, c_rows);
      if (bi < 0 || before(d, ci, bv, bi)) {
        bv = d;
        bi = ci;
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
    float v = best_v[0];
    int amin = best_i[0];
#pragma unroll
    for (int i = 1; i < repro::kWarps; ++i) {
      if (best_i[i] >= 0 && before(best_v[i], best_i[i], v, amin)) {
        v = best_v[i];
        amin = best_i[i];
      }
    }
    int cid = amin;
    if (forced >= 0) {
      cid = forced;
    } else if (prev >= 0 && prev != amin && s_dist[amin] > __fmul_rn(omm, s_dist[prev])) {
      cid = prev;  // not decisively closer: the client stays
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) cids[j] = cid;
    // c. the owners of the chosen row's tile: its blend and its statistics' partials
    const int ct = cid / kTileC, ci = cid % kTileC;
    float* crow = carried + static_cast<int64_t>(cid) * n;
    const float* anchor = bcast + static_cast<int64_t>(cid) * n;
    float* out = blended + j * n;
    for (int w = blockIdx.x, k = mine.k0, t = mine.t0; w < items; w += gridDim.x, mine.next(k, t)) {
      if (t != ct) continue;
      float4 cv[kSteps], av[kSteps], uv[kSteps];
      carried_groups(cv, on_chip, rows + ci * repro::kChunk, crow, k, n);
      carried_groups(uv, on_chip, ucur, u, k, n);
      if (on_chip) {
        carried_groups(av, true, anchors + ci * repro::kChunk, anchor, k, n);
      } else {
        const int al_a = repro::row_align(anchor);
#pragma unroll
        for (int s = 0; s < kSteps; ++s)
          av[s] = repro::load4(anchor, k * repro::kChunk + 4 * (threadIdx.x + repro::kThreads * s), n, al_a);
      }
      const int al_r = repro::row_align(crow), al_o = repro::row_align(out);
      float st[kStats] = {};  // change, gap_before, gap_after (, cnorm)
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const int li = 4 * (threadIdx.x + repro::kThreads * s);
        const int64_t g = k * repro::kChunk + li;
        const float4 nw = blend4(omb, b, cv[s], uv[s]);
        st[0] = repro::add_abs4(st[0], nw, cv[s]);
        st[1] = repro::add_abs4(st[1], cv[s], av[s]);
        st[2] = repro::add_abs4(st[2], nw, av[s]);
        if constexpr (kStats == 4) st[3] = repro::add_abs4(st[3], nw, make_float4(0.f, 0.f, 0.f, 0.f));
        if (on_chip)
          *reinterpret_cast<float4*>(rows + ci * repro::kChunk + li) = nw;
        else
          store4(crow, g, n, al_r, nw);
        store4(out, g, n, al_o, nw);
      }
      warp_sum_n(st);
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < kStats; ++q) spart[wid][q] = st[q];
      }
      repro::store_partials<1, kStats>(spart, 1, kStats, stat_part + (j * chunks + k) * kStats, 0);
    }
  }
  // the final rows to `carried`
  if (on_chip) {
    const int c0 = mine.t0 * kTileC;
    for (int ci = 0; ci < kTileC && c0 + ci < rows_c; ++ci) {
      float* dst = carried + (c0 + ci) * n;
      const int al = repro::row_align(dst);
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const int li = 4 * (threadIdx.x + repro::kThreads * s);
        store4(dst, mine.k0 * repro::kChunk + li, n, al, *reinterpret_cast<const float4*>(rows + ci * repro::kChunk + li));
      }
    }
  }
  grid.sync();
  // the statistics: output o = kStats j + s sums its chunk partials in chunk order
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t o = warp; o < kStats * steps; o += warps) {
    const float s = repro::sum_chunks(stat_part + (o / kStats) * chunks * kStats + o % kStats, chunks, kStats);
    if (lane == 0) stats[o] = s;
  }
}

// co-resident blocks by instantiation (0: 3 statistics, 1: 4), rows held on
// chip (0: none) and device
int coresident[2][kTileC + 1][64];
bool chip_smem_set[2][64];

// The launch of ingest_chain_kernel<kStats> for C rows of width n (chunks =
// ceil(n / 4096)) on the current device: plan = {blocks, dynamic shared
// memory bytes, rows on chip (1) or in `carried` (0)}. Rows go on chip when
// every item gets a block of its own.
template <int kStats>
cudaError_t chain_plan(int64_t c_rows, int64_t chunks, int device, int64_t* plan) {
  constexpr int v = kStats == 4;
  if (!chip_smem_set[v][device]) {
    const cudaError_t rc = cudaFuncSetAttribute(ingest_chain_kernel<kStats>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                static_cast<int>(chip_bytes(kTileC)));
    if (rc != cudaSuccess) return rc;
    chip_smem_set[v][device] = true;
  }
  const int r = c_rows < kTileC ? static_cast<int>(c_rows) : kTileC;
  const int64_t items = chunks * ((c_rows + kTileC - 1) / kTileC);
  const int cap_chip = repro::coresident_blocks(ingest_chain_kernel<kStats>, device, coresident[v][r], chip_bytes(r));
  if (cap_chip > 0 && items <= cap_chip) {
    plan[0] = items;
    plan[1] = static_cast<int64_t>(chip_bytes(r));
    plan[2] = 1;
    return cudaSuccess;
  }
  const int cap = repro::coresident_blocks(ingest_chain_kernel<kStats>, device, coresident[v][0], 0);
  if (cap <= 0) return cudaErrorInvalidConfiguration;  // the occupancy query failed
  plan[0] = items < cap ? items : cap;
  plan[1] = 0;
  plan[2] = 0;
  return cudaSuccess;
}

}  // namespace

// plan (3) int64: the launch repro_ingest_chain makes for C rows of width n
// and nstats statistics a step (3, or 4 with the center norm).
REPRO_API int repro_ingest_chain_plan(int64_t c_rows, int64_t n, int nstats, int device, int64_t* plan) {
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  repro::use_device(device);
  if (c_rows <= 0 || c_rows > kMaxCenters || n <= 0 || (nstats != 3 && nstats != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunks = repro::l1_chunks(n);
  return static_cast<int>(nstats == 4 ? chain_plan<4>(c_rows, chunks, device, plan)
                                      : chain_plan<3>(c_rows, chunks, device, plan));
}

// U (S, n) uploads; centers (C, n) the segment-start centers (only read);
// bcast (C, n) their anchors; prev_forced (2 S) int32: the prev indices,
// then the forced ones (-1: none). partials: 2 * chunks * C floats;
// stat_part: S * chunks * nstats floats, chunks = ceil(n / 4096); any other
// `chunks` is refused. nstats: 3, or 4 with the center norm. Outputs: dists
// (S, C), cids (S,), stats (S, nstats) as (change, gap_before, gap_after[,
// cnorm]), blended (S, n), carried (C, n) the centers after the last step.
REPRO_API int repro_ingest_chain(const float* U, const float* centers, const float* bcast,
                                 const int* prev_forced, int64_t steps, int64_t c_rows, int64_t n,
                                 int64_t chunks, double beta, double margin, float* partials,
                                 float* stat_part, float* dists, int* cids, float* stats,
                                 float* blended, float* carried, int nstats, int device, void* stream) {
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  repro::use_device(device);
  if (steps <= 0 || c_rows <= 0 || c_rows > kMaxCenters || n <= 0 || chunks != repro::l1_chunks(n) ||
      (nstats != 3 && nstats != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t plan[3];
  const cudaError_t planned =
      nstats == 4 ? chain_plan<4>(c_rows, chunks, device, plan) : chain_plan<3>(c_rows, chunks, device, plan);
  if (planned != cudaSuccess) return static_cast<int>(planned);
  // beta and the margin fold like the host's Python floats: (1 - x) in
  // double, then one rounding to fp32
  float omb = static_cast<float>(1.0 - beta);
  float b = static_cast<float>(beta);
  float omm = static_cast<float>(1.0 - margin);
  int on_chip = static_cast<int>(plan[2]);
  void* args[] = {&U,     &centers, &bcast, &prev_forced, &steps,    &c_rows,    &n,     &chunks,
                  &omb,   &b,       &omm,   &on_chip,     &partials, &stat_part, &dists, &cids,
                  &stats, &blended, &carried};
  const void* kernel = nstats == 4 ? reinterpret_cast<const void*>(ingest_chain_kernel<4>)
                                   : reinterpret_cast<const void*>(ingest_chain_kernel<3>);
  const cudaError_t rc = cudaLaunchCooperativeKernel(
      kernel, dim3(static_cast<unsigned>(plan[0])),
      dim3(repro::kThreads), args, static_cast<size_t>(plan[1]), static_cast<cudaStream_t>(stream));
  return rc != cudaSuccess ? static_cast<int>(rc) : repro::launch_status();
}

// Family F, bf16: flash-attention backward on Hopper's bf16 tensor cores,
// two kernels (repro_flash_dq_bf16, repro_flash_dkv_bf16).
//   dq kernel : one block per (b, h, 64-row query tile), looping over key tiles;
//   dkv kernel: one block per (b, query head or G / c of them, 64-row key
//               tile), looping over query tiles; the blocks of a KV head's
//               query heads form a thread-block cluster that sums their
//               dk/dv partials through distributed shared memory in rank
//               order.
//
// Replaces the TPU kernels src/repro/kernels/flash_attention_bwd.py::
// flash_attention_bwd (_dq_kernel, _dkv_kernel) for bf16 inputs, whose bodies
// cast q, k, v and do to fp32 (:70-73, :107-110) and write the gradients in
// the inputs' dtype (:188, :215-216); lse and D = rowsum(do * o) stay fp32
// (D is computed before the kernels, as the reference computes it outside its
// own, :169). The algorithm is flash_bwd.cu's: p = exp(s - lse) recomputed
// from the forward's log-sum-exp (masked and out-of-range entries 0), ds =
// p * (do·vᵀ - D) (times 1 - t² under a softcap), dq = scale * ds·k, dk =
// scale * dsᵀ·q and dv = pᵀ·do summed over the G query heads; tile skipping,
// the longest blocks first, no atomics, every sum in a fixed order, so a
// launch shape always gives the same bits.
//
// Bound: at (2, 32, 512, 64), KV 8, causal, 0.0063 ms for the bytes (q, k, v,
// do, o read once, dq, dk, dv written once) against 0.0044 ms for
// 2 * (3 * hd + 2 * dv) flops an allowed pair at the bf16 tensor-core peak;
// at 4,096 tokens the operations bound it (0.348 ms). Each kernel recomputes
// s and dp, so between them they execute 2 * (4 * hd + 3 * dv).
//
// Design (wgmma_bf16.cuh), as in flash_fwd_bf16.cu: one warpgroup a block,
// bf16 tiles in wgmma's swizzled layout, the streamed tiles (k/v in the dq
// kernel, q/do with their lse and D rows in the dkv kernel) in a ring of
// three stages filled by 16-byte cp.async (per element where a row is not
// 16-byte aligned). s and dp (dq kernel), sᵀ = k·qᵀ and dpᵀ = v·doᵀ (dkv
// kernel, its 64 key rows as M, so pᵀ and dsᵀ come out as accumulators) are
// wgmma with both operands in shared memory, exact bf16 products. ds (dq
// kernel), pᵀ and dsᵀ (dkv kernel) split into two bf16 parts whose A
// fragments are their accumulators' registers, and dq += ds·k, dv += pᵀ·do
// and dk += dsᵀ·q are two wgmma a k-step and panel with k, do and q
// MN-major B operands. The loop is the forward's wg::pipeline: the next
// tile's products and this tile's gradient products run on the tensor cores
// while the warps form the next tile's p and ds. Streamed tiles: the dq
// kernel's key tiles 64 rows (32 at E = 256); the dkv kernel's query tiles
// 32 rows up to E = 64 and 16 above (dk and dv take E registers a thread
// together). At E = 256 the dkv kernel runs as two launches (dk, then dv),
// as flash_bwd.cu does.
#include "flash_common.cuh"
#include "wgmma_bf16.cuh"

using namespace repro::flash;
namespace wg = repro::wg;
namespace cg = cooperative_groups;
using repro::bf16;

namespace {

// Rows of the dkv kernel's query tiles at bucket E (its dk and dv
// accumulators take E registers a thread together).
__host__ __device__ constexpr int query_rows(int e) { return e <= 64 ? 32 : 16; }

template <int E>
__global__ void __launch_bounds__(kThreads, min_blocks(E)) flash_dq_bf16_kernel(Params<bf16> p) {
  using L = wg::Tile<E>;
  constexpr int BK = bf16_key_rows(E), KS = BK / 16, C = L::C, NP = L::panels;
  constexpr int QB = L::template bytes<kRows>(), KB = L::template bytes<BK>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = wg::align1024(smem_raw);  // kRows x E
  uint8_t* dos = qs + QB;                 // kRows x E
  uint8_t* kbuf = dos + QB;               // kStages x BK x E
  uint8_t* vbuf = kbuf + kStages * KB;    // kStages x BK x E
  const uint32_t qa = wg::smem_addr(qs), da = wg::smem_addr(dos), ka = wg::smem_addr(kbuf),
                 va = wg::smem_addr(vbuf);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int64_t h = blockIdx.x, b = blockIdx.y;
  const int64_t q0 = static_cast<int64_t>(gridDim.z - 1 - blockIdx.z) * kRows;
  const int64_t kvh = h / (p.H / p.KV);
  const int64_t bh = b * p.H + h;
  const bf16* kg = p.k + (b * p.KV + kvh) * p.Sk * p.hd;
  const bf16* vg = p.v + (b * p.KV + kvh) * p.Sk * p.dv;
  const int64_t nq = p.Sq - q0 < kRows ? p.Sq - q0 : kRows;
  const int r0 = warp * 16;
  const int64_t qp0 = p.q_pos0 + q0, qp1 = qp0 + nq - 1;  // the block's first and last query positions
  const float c2 = p.scale * kLog2e;                       // a score to log2 units
  float lse2[2], d_r[2];                                   // the rows' lse in log2 units, and D
  int klo[2], khi[2];  // the keys each of the lane's two rows may see (none past Sq)
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int64_t row = q0 + r0 + g + j * 8;
    lse2[j] = row < p.Sq ? p.lse[bh * p.Sq + row] * kLog2e : 0.f;
    d_r[j] = row < p.Sq ? p.dsum[bh * p.Sq + row] : 0.f;
    key_range(p, p.q_pos0 + row, &klo[j], &khi[j]);
    if (row >= p.Sq) khi[j] = klo[j] - 1;
  }

  int64_t kt0, kt1;
  key_tiles(p, BK, qp0, qp1, &kt0, &kt1);
  // pipeline tile i is key tile kt0 + i, in stage i % kStages
  auto load_keys = [&](int64_t i) {
    const int st = static_cast<int>(i % kStages);
    wg::load_tile<E, BK>(kbuf + st * KB, kg, (kt0 + i) * BK, p.Sk, p.hd, p.vec);
    wg::load_tile<E, BK>(vbuf + st * KB, vg, (kt0 + i) * BK, p.Sk, p.dv, p.vec);
  };
  // issue s = q·kᵀ and dp = do·vᵀ of tile i (64 x BK)
  float s[BK / 2], dp[BK / 2];
  auto scores = [&](int64_t i) {
    const int st = static_cast<int>(i % kStages);
    const uint32_t kst = ka + st * KB, vst = va + st * KB;
#pragma unroll
    for (int kk = 0; kk < E / 16; ++kk) {
      wg::mma_ss<BK>(s, wg::desc_k<E, kRows>(qa, kk), wg::desc_k<E, BK>(kst, kk), kk > 0);
      wg::mma_ss<BK>(dp, wg::desc_k<E, kRows>(da, kk), wg::desc_k<E, BK>(vst, kk), kk > 0);
    }
  };
  // ds = p * (dp - D) * chain of tile i in place of s, p = exp2(s·log2(e) -
  // lse·log2(e)); entry j is row r0 + g (+8 where j & 2), key column (j / 4) *
  // 8 + 2t + (j & 1). A tile that every row sees whole takes no mask (a
  // uniform branch).
  auto grads = [&](int64_t i) {
    wg::hold(s);
    wg::hold(dp);
    const int k0 = static_cast<int>((kt0 + i) * BK);
    const bool whole = sees_all(p, qp0, qp1, k0, k0 + BK - 1);
    if (p.softcap > 0.f) {
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        float chain;
        const float x = logit(p, s[j], &chain);
        s[j] = exp2f(fmaf(x, kLog2e, -lse2[(j >> 1) & 1]));
        dp[j] = (dp[j] - d_r[(j >> 1) & 1]) * chain;
      }
    } else {
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        s[j] = exp2f(fmaf(s[j], c2, -lse2[(j >> 1) & 1]));
        dp[j] -= d_r[(j >> 1) & 1];
      }
    }
    if (!whole) {
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int kpos = k0 + (j >> 2) * 8 + 2 * t + (j & 1), r = (j >> 1) & 1;
        if (kpos < klo[r] || kpos > khi[r]) s[j] = 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) s[j] *= dp[j];
  };
  // ds of the tile whose ds·k runs next, in two bf16 parts
  uint32_t dhi[KS][4], dlo[KS][4];
  auto split = [&]() {
#pragma unroll
    for (int i = 0; i < KS; ++i) wg::split_a(s, i, dhi[i], dlo[i]);
  };
  // issue dq += ds · k of tile i, the small part of ds first
  float acc[NP][C / 2];
  auto dsk = [&](int64_t i) {
    const uint32_t kst = ka + static_cast<int>(i % kStages) * KB;
#pragma unroll
    for (int j = 0; j < KS; ++j) {
#pragma unroll
      for (int pn = 0; pn < NP; ++pn) {
        const uint64_t kd = wg::desc_mn<E, BK>(kst, j, pn);
        wg::mma_rs<C>(acc[pn], dlo[j], kd);
        wg::mma_rs<C>(acc[pn], dhi[j], kd);
      }
    }
  };
  auto settle = [&](bool) {
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) wg::hold(acc[pn]);
  };

#pragma unroll
  for (int pn = 0; pn < NP; ++pn)
#pragma unroll
    for (int i = 0; i < C / 2; ++i) acc[pn][i] = 0.f;
  wg::load_tile<E, kRows>(qs, p.q + bh * p.Sq * p.hd, q0, p.Sq, p.hd, p.vec);
  wg::load_tile<E, kRows>(dos, p.dout + bh * p.Sq * p.dv, q0, p.Sq, p.dv, p.vec);
  wg::pipeline(kt1 - kt0, load_keys, scores, grads, split, dsk, settle);

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int64_t row = q0 + r0 + g + j * 8;
    if (row >= p.Sq) continue;
    bf16* out = p.o + (bh * p.Sq + row) * p.hd;
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) {
#pragma unroll
      for (int n = 0; n < C / 8; ++n)
        wg::store2(out, pn * C + n * 8 + 2 * t, p.hd, acc[pn][4 * n + 2 * j] * p.scale,
                   acc[pn][4 * n + 2 * j + 1] * p.scale);
    }
  }
}

// Grid (KV * cluster, B, key tiles), clusters of (cluster, 1, 1) blocks.
// Block rank c of the cluster of KV head kvh handles query heads
// kvh * G + c * (G / cluster) + j for j < G / cluster.
template <int E, int WHAT>
__global__ void __launch_bounds__(kThreads, min_blocks(E)) flash_dkv_bf16_kernel(Params<bf16> p) {
  using L = wg::Tile<E>;
  constexpr int BQ = query_rows(E), NQ = BQ / 8, QS = BQ / 16, C = L::C, NP = L::panels;
  constexpr int KB = L::template bytes<kRows>(), QB = L::template bytes<BQ>();
  constexpr bool DK = WHAT & kDk, DV = WHAT & kDv;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = wg::align1024(smem_raw);
  uint8_t* ks = base;                                      // kRows x E
  uint8_t* vs = ks + KB;                                   // kRows x E
  uint8_t* qbuf = vs + KB;                                 // kStages x BQ x E
  uint8_t* dobuf = qbuf + kStages * QB;                    // kStages x BQ x E
  float* lbuf = reinterpret_cast<float*>(dobuf + kStages * QB);  // kStages x BQ log-sum-exps
  float* dbuf = lbuf + kStages * BQ;                             // kStages x BQ row sums D
  const uint32_t ka = wg::smem_addr(ks), va = wg::smem_addr(vs), qa = wg::smem_addr(qbuf),
                 da = wg::smem_addr(dobuf);
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int64_t G = p.H / p.KV, per = G / p.cluster;
  const int rank = static_cast<int>(blockIdx.x % p.cluster);
  const int64_t kvh = blockIdx.x / p.cluster, b = blockIdx.y;
  const int64_t k0 = static_cast<int64_t>(blockIdx.z) * kRows;  // causal: the first key tiles take longest
  const int64_t bkv = b * p.KV + kvh;
  const int64_t nk = p.Sk - k0 < kRows ? p.Sk - k0 : kRows;
  const int r0 = warp * 16;  // the warp's key rows r0 + g and r0 + g + 8
  const float c2 = p.scale * kLog2e;  // a score to log2 units
  int qlo[2], qhi[2];        // the query rows each of the lane's two keys is seen by
  query_range(p, k0 + r0 + g, &qlo[0], &qhi[0]);
  query_range(p, k0 + r0 + g + 8, &qlo[1], &qhi[1]);

  int64_t qt0, qt1;
  query_tiles(p, BQ, k0, k0 + nk - 1, &qt0, &qt1);
  const int64_t nqt = qt1 - qt0, iters = per * nqt;
  // iteration i: query head kvh * G + rank * per + i / nqt, query tile qt0 + i % nqt, stage i % kStages
  auto load_query = [&](int64_t i) {
    const int st = static_cast<int>(i % kStages);
    const int64_t bh = b * p.H + kvh * G + rank * per + i / nqt;
    const int64_t qr0 = (qt0 + i % nqt) * BQ;
    wg::load_tile<E, BQ>(qbuf + st * QB, p.q + bh * p.Sq * p.hd, qr0, p.Sq, p.hd, p.vec);
    wg::load_tile<E, BQ>(dobuf + st * QB, p.dout + bh * p.Sq * p.dv, qr0, p.Sq, p.dv, p.vec);
    load_vec<BQ>(lbuf + st * BQ, p.lse + bh * p.Sq, qr0, p.Sq);
    load_vec<BQ>(dbuf + st * BQ, p.dsum + bh * p.Sq, qr0, p.Sq);
  };
  // issue sᵀ = k·qᵀ and (for dk) dpᵀ = v·doᵀ of iteration i (64 keys x BQ queries)
  float s[BQ / 2], dp[BQ / 2];
  auto scores = [&](int64_t i) {
    const uint32_t qst = qa + static_cast<int>(i % kStages) * QB, dst = da + static_cast<int>(i % kStages) * QB;
#pragma unroll
    for (int kk = 0; kk < E / 16; ++kk) {
      wg::mma_ss<BQ>(s, wg::desc_k<E, kRows>(ka, kk), wg::desc_k<E, BQ>(qst, kk), kk > 0);
      if constexpr (DK) wg::mma_ss<BQ>(dp, wg::desc_k<E, kRows>(va, kk), wg::desc_k<E, BQ>(dst, kk), kk > 0);
    }
  };
  // pᵀ (for dv) in place of sᵀ and dsᵀ (for dk) in place of dpᵀ, iteration i:
  // entry j is key row r0 + g (+8 where j & 2), query column (j / 4) * 8 + 2t
  // + (j & 1); p = exp2(s·log2(e) - lse·log2(e)). A tile whose queries all
  // see all 64 keys takes no mask (a uniform branch).
  auto grads = [&](int64_t i) {
    wg::hold(s);
    if constexpr (DK) wg::hold(dp);
    const int st = static_cast<int>(i % kStages);
    const float* ls = lbuf + st * BQ;
    const float* dsm = dbuf + st * BQ;
    const int q0 = static_cast<int>((qt0 + i % nqt) * BQ);
    const bool whole = q0 + BQ <= p.Sq && sees_all(p, p.q_pos0 + q0, p.q_pos0 + q0 + BQ - 1, k0, k0 + kRows - 1);
    float lse2[NQ][2];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) lse2[n][c] = ls[n * 8 + 2 * t + c] * kLog2e;
    if (p.softcap > 0.f) {
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) {
        float chain;
        const float x = logit(p, s[j], &chain);
        s[j] = exp2f(fmaf(x, kLog2e, -lse2[j >> 2][j & 1]));
        if constexpr (DK) dp[j] = (dp[j] - dsm[(j >> 2) * 8 + 2 * t + (j & 1)]) * chain;
      }
    } else {
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) {
        s[j] = exp2f(fmaf(s[j], c2, -lse2[j >> 2][j & 1]));
        if constexpr (DK) dp[j] -= dsm[(j >> 2) * 8 + 2 * t + (j & 1)];
      }
    }
    if (!whole) {
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) {
        const int qrow = q0 + (j >> 2) * 8 + 2 * t + (j & 1), r = (j >> 1) & 1;
        if (qrow < qlo[r] || qrow > qhi[r]) s[j] = 0.f;
      }
    }
    if constexpr (DK) {
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) dp[j] *= s[j];
    }
  };
  // the A fragments of pᵀ·do and dsᵀ·q, each in two bf16 parts
  uint32_t phi[QS][4], plo[QS][4], shi[QS][4], slo[QS][4];
  auto split = [&]() {
#pragma unroll
    for (int j = 0; j < QS; ++j) {
      if constexpr (DV) wg::split_a(s, j, phi[j], plo[j]);
      if constexpr (DK) wg::split_a(dp, j, shi[j], slo[j]);
    }
  };

  float dk[NP][C / 2], dv[NP][C / 2];  // the one a launch does not accumulate is never used
#pragma unroll
  for (int pn = 0; pn < NP; ++pn)
#pragma unroll
    for (int j = 0; j < C / 2; ++j) dk[pn][j] = dv[pn][j] = 0.f;
  // issue dv += pᵀ · do and dk += dsᵀ · q of iteration i, the small parts first
  auto products = [&](int64_t i) {
    const uint32_t qst = qa + static_cast<int>(i % kStages) * QB, dst = da + static_cast<int>(i % kStages) * QB;
#pragma unroll
    for (int j = 0; j < QS; ++j) {
#pragma unroll
      for (int pn = 0; pn < NP; ++pn) {
        if constexpr (DV) {
          const uint64_t od = wg::desc_mn<E, BQ>(dst, j, pn);
          wg::mma_rs<C>(dv[pn], plo[j], od);
          wg::mma_rs<C>(dv[pn], phi[j], od);
        }
        if constexpr (DK) {
          const uint64_t qd = wg::desc_mn<E, BQ>(qst, j, pn);
          wg::mma_rs<C>(dk[pn], slo[j], qd);
          wg::mma_rs<C>(dk[pn], shi[j], qd);
        }
      }
    }
  };
  auto settle = [&](bool) {
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) {
      if constexpr (DV) wg::hold(dv[pn]);
      if constexpr (DK) wg::hold(dk[pn]);
    }
  };

  wg::load_tile<E, kRows>(ks, p.k + bkv * p.Sk * p.hd, k0, p.Sk, p.hd, p.vec);
  wg::load_tile<E, kRows>(vs, p.v + bkv * p.Sk * p.dv, k0, p.Sk, p.dv, p.vec);
  wg::pipeline(iters, load_query, scores, grads, split, products, settle);
  __syncthreads();  // every warp is done with the tiles: the partials overwrite them

  // This block's partials, kRows x E fp32 each, then their sum over the
  // cluster in rank order, each block summing an interleaved share of the
  // entries.
  float* part_k = reinterpret_cast<float*>(base);
  float* part_v = part_k + (DK ? kRows * E : 0);
#pragma unroll
  for (int pn = 0; pn < NP; ++pn) {
#pragma unroll
    for (int j = 0; j < C / 2; ++j) {
      const int idx = (r0 + g + ((j >> 1) & 1) * 8) * E + pn * C + (j >> 2) * 8 + 2 * t + (j & 1);
      if constexpr (DK) part_k[idx] = dk[pn][j];
      if constexpr (DV) part_v[idx] = dv[pn][j];
    }
  }
  cluster.sync();
  for (int idx = rank * kThreads + threadIdx.x; idx < kRows * E; idx += p.cluster * kThreads) {
    const int64_t key = k0 + idx / E;
    const int col = idx % E;
    if (key >= p.Sk) continue;
    if (DK && col < p.hd)
      p.o[(bkv * p.Sk + key) * p.hd + col] = __float2bfloat16_rn(cluster_sum(cluster, part_k, idx) * p.scale);
    if (DV && col < p.dv)
      static_cast<bf16*>(p.lse_out)[(bkv * p.Sk + key) * p.dv + col] =
          __float2bfloat16_rn(cluster_sum(cluster, part_v, idx));
  }
  cluster.sync();  // no block leaves while another still reads its partials
}

template <int E>
size_t dq_smem() {
  using L = wg::Tile<E>;
  return 1024 + 2 * L::template bytes<kRows>() + 2 * kStages * L::template bytes<bf16_key_rows(E)>();
}

// The tiles, or the partials that overwrite them, whichever is larger.
template <int E, int WHAT>
size_t dkv_smem() {
  using L = wg::Tile<E>;
  constexpr int BQ = query_rows(E);
  const size_t tiles =
      2 * L::template bytes<kRows>() + 2 * kStages * (L::template bytes<BQ>() + BQ * sizeof(float));
  const size_t parts = ((WHAT & kDk) ? 1 : 0) + ((WHAT & kDv) ? 1 : 0);
  const size_t partials = parts * kRows * E * sizeof(float);
  return 1024 + (tiles > partials ? tiles : partials);
}

int flash_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse, const float* dsum,
             bf16* dq, int64_t B, int64_t H, int64_t KV, int64_t Sq, int64_t Sk, int64_t hd, int64_t dv,
             float scale, int causal, int64_t window, float softcap, int64_t q_pos0, int device, void* stream) {
  repro::use_device(device);
  if (B <= 0 || H <= 0 || Sq <= 0) return repro::launch_status();
  Params<bf16> p{q, k, v, dout, lse, dsum, dq, nullptr, B, H, KV, Sq, Sk, hd, dv, q_pos0, window,
                 scale, softcap, causal, wg::vec_copies(q, k, v, dout, hd, dv), kStages, 1};
  return by_bucket(hd, dv, [&](auto e) {
    constexpr int E = decltype(e)::value;
    const size_t smem = dq_smem<E>();
    const cudaError_t attr = allow_smem(flash_dq_bf16_kernel<E>, smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid(static_cast<unsigned>(H), static_cast<unsigned>(B),
                    static_cast<unsigned>((Sq + kRows - 1) / kRows));
    flash_dq_bf16_kernel<E><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
    return repro::launch_status();
  });
}

int flash_dkv(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse, const float* dsum,
              bf16* dk, bf16* dv, int64_t B, int64_t H, int64_t KV, int64_t Sq, int64_t Sk, int64_t hd,
              int64_t dvd, float scale, int causal, int64_t window, float softcap, int64_t q_pos0, int device,
              void* stream) {
  repro::use_device(device);
  if (B <= 0 || KV <= 0 || Sk <= 0) return repro::launch_status();
  Params<bf16> p{q, k, v, dout, lse, dsum, dk, dv, B, H, KV, Sq, Sk, hd, dvd, q_pos0, window,
                 scale, softcap, causal, wg::vec_copies(q, k, v, dout, hd, dvd), kStages,
                 cluster_size(H / KV)};
  const auto st = static_cast<cudaStream_t>(stream);
  return by_bucket(hd, dvd, [&](auto e) {
    constexpr int E = decltype(e)::value;
    const dim3 grid(static_cast<unsigned>(KV * p.cluster), static_cast<unsigned>(B),
                    static_cast<unsigned>((Sk + kRows - 1) / kRows));
    if constexpr (E < 256) {
      return launch_cluster(flash_dkv_bf16_kernel<E, kDk | kDv>, p, dkv_smem<E, kDk | kDv>(), grid, st);
    } else {
      const int rc = launch_cluster(flash_dkv_bf16_kernel<E, kDk>, p, dkv_smem<E, kDk>(), grid, st);
      return rc != 0 ? rc : launch_cluster(flash_dkv_bf16_kernel<E, kDv>, p, dkv_smem<E, kDv>(), grid, st);
    }
  });
}

}  // namespace

REPRO_API int repro_flash_dq_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
                                  const float* dsum, bf16* dq, int64_t B, int64_t H, int64_t KV, int64_t Sq,
                                  int64_t Sk, int64_t hd, int64_t dv, float scale, int causal, int64_t window,
                                  float softcap, int64_t q_pos0, int device, void* stream) {
  return flash_dq(q, k, v, dout, lse, dsum, dq, B, H, KV, Sq, Sk, hd, dv, scale, causal, window, softcap,
                  q_pos0, device, stream);
}

REPRO_API int repro_flash_dkv_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                                   const float* lse, const float* dsum, bf16* dk, bf16* dv, int64_t B, int64_t H,
                                   int64_t KV, int64_t Sq, int64_t Sk, int64_t hd, int64_t dvd, float scale,
                                   int causal, int64_t window, float softcap, int64_t q_pos0, int device,
                                   void* stream) {
  return flash_dkv(q, k, v, dout, lse, dsum, dk, dv, B, H, KV, Sq, Sk, hd, dvd, scale, causal, window, softcap,
                   q_pos0, device, stream);
}

// Dynamic shared memory of a dq launch, and of a dkv launch (the larger of
// its two at E = 256), at these head widths (bytes).
REPRO_API int repro_flash_dq_bf16_smem(int64_t hd, int64_t dv) {
  return by_bucket(hd, dv, [](auto e) { return static_cast<int>(dq_smem<decltype(e)::value>()); });
}

REPRO_API int repro_flash_dkv_bf16_smem(int64_t hd, int64_t dv) {
  return by_bucket(hd, dv, [](auto e) {
    constexpr int E = decltype(e)::value;
    return static_cast<int>(E < 256 ? dkv_smem<E, kDk | kDv>() : dkv_smem<E, kDk>());
  });
}

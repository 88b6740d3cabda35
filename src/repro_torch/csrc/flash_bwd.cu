// Family F: flash-attention backward, two kernels.
//   dq kernel : one block per (b, h, 64-row query tile), looping over key tiles;
//   dkv kernel: one block per (b, h, 64-row key tile), looping over query
//               tiles; the G blocks of a KV head's query heads (or G / c
//               heads each) form a thread-block cluster that sums their
//               dk/dv partials through distributed shared memory.
//
// Replaces the TPU kernels src/repro/kernels/flash_attention_bwd.py::
// flash_attention_bwd (_dq_kernel, _dkv_kernel). As there, each tile's
// probabilities are recomputed from the forward's log-sum-exp,
// p = exp(s - lse) with masked and out-of-range entries 0, and
// ds = p * (do·v^T - D) (times 1 - t^2 under a softcap), with
// D = rowsum(do * o) computed before the kernels. dq = scale * ds·k;
// dk = scale * ds^T·q and dv = p^T·do summed over the G query heads. The
// TPU's sequential grid carried the dq and dk/dv sums in VMEM scratch; here
// the loop inside the block does. Every output element is written by
// exactly one block and every sum runs in a fixed order (the G partials in
// head order), so there are no atomics and a launch always gives the same
// bits.
//
// Bound: operations. Per allowed (q, k) pair the backward needs
// 2 * (3 * hd + 2 * dv) flops (s, dp, dv, dq and dk once each): at
// (4, 32, 256, 64) that is 0.040 ms on the CUDA cores' 67 TFLOP/s, and
// 0.016 ms as split TF32 on the tensor cores (three tf32 products each,
// 495 TFLOP/s). The two kernels each recompute s and dp, so between them
// they execute 2 * (4 * hd + 3 * dv). Design as in flash_fwd.cu: 4 warps of
// 16 rows, every product on mma.sync m16n8k8 in split TF32 (mma_tf32.cuh),
// p and ds fed from their C fragments into the next product through the
// permuted column order, cp.async tiles double-buffered where shared memory
// allows, rows padded to E + 4 floats. The dkv kernel gives each query head
// its own block (512 blocks at full width rather than 256 that each walk
// the G heads), launches the key tiles in order (under a causal mask the
// first key tiles see the most query tiles, so the longest blocks start
// first; the forward and dq kernels launch their query tiles last-first for
// the same reason), and at E = 256, where a warp's dk and
// dv accumulators would not both fit in registers, runs as two launches
// (dk, then dv).
//
// bf16 q, k, v and do (repro_flash_dq_bf16, repro_flash_dkv_bf16) take
// kernels of their own on the bf16 tensor cores, flash_bwd_bf16.cu.
#include "flash_common.cuh"

using namespace repro::flash;
namespace tc = repro::tc;
namespace cg = cooperative_groups;

namespace {

template <int E>
__global__ void __launch_bounds__(kThreads, min_blocks(E)) flash_dq_kernel(Params<float> p) {
  constexpr int S = stride<E>(), BK = kStream, NE = E / 8, NK = BK / 8;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                        // kRows x S
  float* dos = qs + kRows * S;             // kRows x S
  float* kbuf = dos + kRows * S;           // stages x BK x S
  float* vbuf = kbuf + p.stages * BK * S;  // stages x BK x S
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int64_t h = blockIdx.x, b = blockIdx.y;
  const int64_t q0 = static_cast<int64_t>(gridDim.z - 1 - blockIdx.z) * kRows;
  const int64_t kvh = h / (p.H / p.KV);
  const int64_t bh = b * p.H + h;
  const float* kg = p.k + (b * p.KV + kvh) * p.Sk * p.hd;
  const float* vg = p.v + (b * p.KV + kvh) * p.Sk * p.dv;
  const int64_t nq = p.Sq - q0 < kRows ? p.Sq - q0 : kRows;
  const int r0 = warp * 16;

  int64_t kt0, kt1;
  key_tiles(p, BK, p.q_pos0 + q0, p.q_pos0 + q0 + nq - 1, &kt0, &kt1);
  load_tile<E, kRows>(qs, p.q + bh * p.Sq * p.hd, q0, p.Sq, p.hd, p.vec);
  load_tile<E, kRows>(dos, p.dout + bh * p.Sq * p.dv, q0, p.Sq, p.dv, p.vec);
  if (kt0 < kt1) {
    load_tile<E, BK>(kbuf, kg, kt0 * BK, p.Sk, p.hd, p.vec);
    load_tile<E, BK>(vbuf, vg, kt0 * BK, p.Sk, p.dv, p.vec);
  }
  tc::cp_commit();

  float lse_r[2], d_r[2], acc[NE][4];
  int klo[2], khi[2];  // the keys each of the lane's two rows may see (none past Sq)
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int64_t row = q0 + r0 + g + j * 8;
    lse_r[j] = row < p.Sq ? p.lse[bh * p.Sq + row] : 0.f;
    d_r[j] = row < p.Sq ? p.dsum[bh * p.Sq + row] : 0.f;
    key_range(p, p.q_pos0 + row, &klo[j], &khi[j]);
    if (row >= p.Sq) khi[j] = klo[j] - 1;
  }
#pragma unroll
  for (int n = 0; n < NE; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int64_t kt = kt0; kt < kt1; ++kt) {
    const int cur = p.stages == 2 ? static_cast<int>((kt - kt0) & 1) : 0;
    if (p.stages == 2 && kt + 1 < kt1) {
      const int nxt = cur ^ 1;
      load_tile<E, BK>(kbuf + nxt * BK * S, kg, (kt + 1) * BK, p.Sk, p.hd, p.vec);
      load_tile<E, BK>(vbuf + nxt * BK * S, vg, (kt + 1) * BK, p.Sk, p.dv, p.vec);
      tc::cp_commit();
      tc::cp_wait<1>();
    } else {
      tc::cp_wait<0>();
    }
    __syncthreads();
    const float* ks = kbuf + cur * BK * S;
    const float* vs = vbuf + cur * BK * S;

    // s = q·kᵀ and dp = do·vᵀ (16 x BK per warp)
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < NE; ++kk) {
      uint32_t qhi[4], qlo[4], dhi[4], dlo[4];
      tc::load_a(qs + r0 * S + kk * 8, S, g, t, qhi, qlo);
      tc::load_a(dos + r0 * S + kk * 8, S, g, t, dhi, dlo);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        uint32_t bhi[2], blo[2];
        tc::load_b_nk(ks + n * 8 * S + kk * 8, S, g, t, bhi, blo);
        tc::mma3(s[n], qhi, qlo, bhi, blo);
        tc::load_b_nk(vs + n * 8 * S + kk * 8, S, g, t, bhi, blo);
        tc::mma3(dp[n], dhi, dlo, bhi, blo);
      }
    }

    // ds = p * (dp - D) * chain, in place of s
    const int k0 = static_cast<int>(kt * BK);
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + n * 8 + 2 * t + (e & 1);
        float chain;
        const float x = logit(p, s[n][e], &chain);
        const bool ok = kpos >= klo[e >> 1] && kpos <= khi[e >> 1];
        const float pr = ok ? expf(x - lse_r[e >> 1]) : 0.f;
        s[n][e] = pr * (dp[n][e] - d_r[e >> 1]) * chain;
      }
    }

    // dq += ds · k
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      uint32_t ahi[4], alo[4];
      tc::c_to_a(s[j], ahi, alo);
#pragma unroll
      for (int n = 0; n < NE; ++n) {
        uint32_t bhi[2], blo[2];
        tc::load_b_kn(ks + j * 8 * S + n * 8, S, g, t, bhi, blo);
        tc::mma3(acc[n], ahi, alo, bhi, blo);
      }
    }
    __syncthreads();
    if (p.stages == 1 && kt + 1 < kt1) {
      load_tile<E, BK>(kbuf, kg, (kt + 1) * BK, p.Sk, p.hd, p.vec);
      load_tile<E, BK>(vbuf, vg, (kt + 1) * BK, p.Sk, p.dv, p.vec);
      tc::cp_commit();
    }
  }
  tc::cp_wait<0>();

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int64_t row = q0 + r0 + g + j * 8;
    if (row >= p.Sq) continue;
    float* out = p.o + (bh * p.Sq + row) * p.hd;
#pragma unroll
    for (int n = 0; n < NE; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < p.hd) out[col] = acc[n][2 * j] * p.scale;
      if (col + 1 < p.hd) out[col + 1] = acc[n][2 * j + 1] * p.scale;
    }
  }
}

// Grid (KV * cluster, B, key tiles), clusters of (cluster, 1, 1) blocks.
// Block rank c of the cluster of KV head kvh handles query heads
// kvh * G + c * (G / cluster) + j for j < G / cluster.
template <int E, int WHAT>
__global__ void __launch_bounds__(kThreads, min_blocks(E)) flash_dkv_kernel(Params<float> p) {
  constexpr int S = stride<E>(), BQ = kStream, NE = E / 8, NQ = BQ / 8;
  constexpr bool DK = WHAT & kDk, DV = WHAT & kDv;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                         // kRows x S
  float* vs = ks + kRows * S;               // kRows x S
  float* qbuf = vs + kRows * S;             // stages x BQ x S
  float* dobuf = qbuf + p.stages * BQ * S;  // stages x BQ x S
  float* lbuf = dobuf + p.stages * BQ * S;  // stages x BQ log-sum-exps
  float* dbuf = lbuf + p.stages * BQ;       // stages x BQ row sums D
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int64_t G = p.H / p.KV, per = G / p.cluster;
  const int rank = static_cast<int>(blockIdx.x % p.cluster);
  const int64_t kvh = blockIdx.x / p.cluster, b = blockIdx.y;
  const int64_t k0 = static_cast<int64_t>(blockIdx.z) * kRows;  // causal: the first key tiles take longest
  const int64_t bkv = b * p.KV + kvh;
  const int64_t nk = p.Sk - k0 < kRows ? p.Sk - k0 : kRows;
  const int r0 = warp * 16;  // the warp's key rows r0 + g and r0 + g + 8
  int qlo[2], qhi[2];        // the query rows each of the lane's two keys is seen by
  query_range(p, k0 + r0 + g, &qlo[0], &qhi[0]);
  query_range(p, k0 + r0 + g + 8, &qlo[1], &qhi[1]);

  int64_t qt0, qt1;
  query_tiles(p, BQ, k0, k0 + nk - 1, &qt0, &qt1);
  const int64_t nqt = qt1 - qt0, iters = per * nqt;
  // iteration i: query head kvh * G + rank * per + i / nqt, query tile qt0 + i % nqt
  auto load_query = [&](int64_t i, int buf) {
    const int64_t bh = b * p.H + kvh * G + rank * per + i / nqt;
    const int64_t qr0 = (qt0 + i % nqt) * BQ;
    load_tile<E, BQ>(qbuf + buf * BQ * S, p.q + bh * p.Sq * p.hd, qr0, p.Sq, p.hd, p.vec);
    load_tile<E, BQ>(dobuf + buf * BQ * S, p.dout + bh * p.Sq * p.dv, qr0, p.Sq, p.dv, p.vec);
    load_vec<BQ>(lbuf + buf * BQ, p.lse + bh * p.Sq, qr0, p.Sq);
    load_vec<BQ>(dbuf + buf * BQ, p.dsum + bh * p.Sq, qr0, p.Sq);
  };
  load_tile<E, kRows>(ks, p.k + bkv * p.Sk * p.hd, k0, p.Sk, p.hd, p.vec);
  load_tile<E, kRows>(vs, p.v + bkv * p.Sk * p.dv, k0, p.Sk, p.dv, p.vec);
  if (iters > 0) load_query(0, 0);
  tc::cp_commit();

  float dk[NE][4], dv[NE][4];  // the one a launch does not accumulate is never used
#pragma unroll
  for (int n = 0; n < NE; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  for (int64_t i = 0; i < iters; ++i) {
    const int cur = p.stages == 2 ? static_cast<int>(i & 1) : 0;
    if (p.stages == 2 && i + 1 < iters) {
      load_query(i + 1, cur ^ 1);
      tc::cp_commit();
      tc::cp_wait<1>();
    } else {
      tc::cp_wait<0>();
    }
    __syncthreads();
    const float* qs = qbuf + cur * BQ * S;
    const float* dos = dobuf + cur * BQ * S;
    const float* ls = lbuf + cur * BQ;
    const float* dsm = dbuf + cur * BQ;
    const int q0 = static_cast<int>((qt0 + i % nqt) * BQ);

    // sᵀ = k·qᵀ and dpᵀ = v·doᵀ (16 keys x BQ queries per warp)
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < NE; ++kk) {
      uint32_t khi[4], klo[4];
      tc::load_a(ks + r0 * S + kk * 8, S, g, t, khi, klo);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        uint32_t bhi[2], blo[2];
        tc::load_b_nk(qs + n * 8 * S + kk * 8, S, g, t, bhi, blo);
        tc::mma3(s[n], khi, klo, bhi, blo);
      }
      if constexpr (DK) {
        uint32_t vhi[4], vlo[4];
        tc::load_a(vs + r0 * S + kk * 8, S, g, t, vhi, vlo);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          uint32_t bhi[2], blo[2];
          tc::load_b_nk(dos + n * 8 * S + kk * 8, S, g, t, bhi, blo);
          tc::mma3(dp[n], vhi, vlo, bhi, blo);
        }
      }
    }

    // pᵀ in s, dsᵀ in dp: entry e of s[n] is key row r0 + g (+8 for e >= 2),
    // query column n * 8 + 2t + (e & 1)
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = n * 8 + 2 * t + (e & 1);
        float chain;
        const float x = logit(p, s[n][e], &chain);
        const bool ok = q0 + qc >= qlo[e >> 1] && q0 + qc <= qhi[e >> 1];
        const float pr = ok ? expf(x - ls[qc]) : 0.f;
        s[n][e] = pr;
        if constexpr (DK) dp[n][e] = pr * (dp[n][e] - dsm[qc]) * chain;
      }
    }

    // dv += pᵀ · do and dk += dsᵀ · q
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      if constexpr (DV) {
        uint32_t ahi[4], alo[4];
        tc::c_to_a(s[j], ahi, alo);
#pragma unroll
        for (int n = 0; n < NE; ++n) {
          uint32_t bhi[2], blo[2];
          tc::load_b_kn(dos + j * 8 * S + n * 8, S, g, t, bhi, blo);
          tc::mma3(dv[n], ahi, alo, bhi, blo);
        }
      }
      if constexpr (DK) {
        uint32_t ahi[4], alo[4];
        tc::c_to_a(dp[j], ahi, alo);
#pragma unroll
        for (int n = 0; n < NE; ++n) {
          uint32_t bhi[2], blo[2];
          tc::load_b_kn(qs + j * 8 * S + n * 8, S, g, t, bhi, blo);
          tc::mma3(dk[n], ahi, alo, bhi, blo);
        }
      }
    }
    __syncthreads();
    if (p.stages == 1 && i + 1 < iters) {
      load_query(i + 1, 0);
      tc::cp_commit();
    }
  }
  tc::cp_wait<0>();
  __syncthreads();  // every warp is done with the tiles: the partials overwrite them

  // This block's partials, kRows x E each, then their sum over the cluster
  // in rank order, each block summing an interleaved share of the entries.
  float* part_k = smem;
  float* part_v = smem + (DK ? kRows * E : 0);
#pragma unroll
  for (int n = 0; n < NE; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = (r0 + g + (e >> 1) * 8) * E + n * 8 + 2 * t + (e & 1);
      if constexpr (DK) part_k[idx] = dk[n][e];
      if constexpr (DV) part_v[idx] = dv[n][e];
    }
  }
  cluster.sync();
  for (int idx = rank * kThreads + threadIdx.x; idx < kRows * E; idx += p.cluster * kThreads) {
    const int64_t key = k0 + idx / E;
    const int col = idx % E;
    if (key >= p.Sk) continue;
    if (DK && col < p.hd)
      p.o[(bkv * p.Sk + key) * p.hd + col] = cluster_sum(cluster, part_k, idx) * p.scale;
    if (DV && col < p.dv)
      static_cast<float*>(p.lse_out)[(bkv * p.Sk + key) * p.dv + col] = cluster_sum(cluster, part_v, idx);
  }
  cluster.sync();  // no block leaves while another still reads its partials
}

template <int E>
size_t dq_smem(int stages) {
  return sizeof(float) * stride<E>() * (2 * kRows + 2 * stages * kStream);
}

template <int E>
size_t dkv_smem(int stages) {
  return sizeof(float) * (stride<E>() * (2 * kRows + 2 * stages * kStream) +
                          2 * stages * kStream);
}

int flash_dq(const float* q, const float* k, const float* v, const float* dout, const float* lse,
             const float* dsum, float* dq, int64_t B, int64_t H, int64_t KV, int64_t Sq, int64_t Sk, int64_t hd, int64_t dv, float scale,
             int causal, int64_t window, float softcap, int64_t q_pos0, int device, void* stream) {
  repro::use_device(device);
  if (B <= 0 || H <= 0 || Sq <= 0) return repro::launch_status();
  const int vec = hd % 4 == 0 && dv % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                   aligned16(dout);
  Params<float> p{q, k, v, dout, lse, dsum, dq, nullptr, B, H, KV, Sq, Sk, hd, dv, q_pos0, window,
                  scale, softcap, causal, vec, 2, 1};
  return by_bucket(hd, dv, [&](auto e) {
    constexpr int E = decltype(e)::value;
    p.stages = dq_smem<E>(2) <= kMaxSmem ? 2 : 1;
    const size_t smem = dq_smem<E>(p.stages);
    const cudaError_t attr = allow_smem(flash_dq_kernel<E>, smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid(static_cast<unsigned>(H), static_cast<unsigned>(B),
                    static_cast<unsigned>((Sq + kRows - 1) / kRows));
    flash_dq_kernel<E><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
    return repro::launch_status();
  });
}

int flash_dkv(const float* q, const float* k, const float* v, const float* dout, const float* lse,
              const float* dsum, float* dk, float* dv, int64_t B, int64_t H, int64_t KV, int64_t Sq, int64_t Sk, int64_t hd, int64_t dvd,
              float scale, int causal, int64_t window, float softcap, int64_t q_pos0, int device,
              void* stream) {
  repro::use_device(device);
  if (B <= 0 || KV <= 0 || Sk <= 0) return repro::launch_status();
  const int vec = hd % 4 == 0 && dvd % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                   aligned16(dout);
  Params<float> p{q, k, v, dout, lse, dsum, dk, dv, B, H, KV, Sq, Sk, hd, dvd, q_pos0, window,
                  scale, softcap, causal, vec, 2, cluster_size(H / KV)};
  const auto st = static_cast<cudaStream_t>(stream);
  return by_bucket(hd, dvd, [&](auto e) {
    constexpr int E = decltype(e)::value;
    p.stages = dkv_smem<E>(2) <= kMaxSmem ? 2 : 1;
    const size_t smem = dkv_smem<E>(p.stages);
    const dim3 grid(static_cast<unsigned>(KV * p.cluster), static_cast<unsigned>(B),
                    static_cast<unsigned>((Sk + kRows - 1) / kRows));
    if constexpr (E < 256) {
      return launch_cluster(flash_dkv_kernel<E, kDk | kDv>, p, smem, grid, st);
    } else {
      const int rc = launch_cluster(flash_dkv_kernel<E, kDk>, p, smem, grid, st);
      return rc != 0 ? rc : launch_cluster(flash_dkv_kernel<E, kDv>, p, smem, grid, st);
    }
  });
}

}  // namespace

REPRO_API int repro_flash_dq(const float* q, const float* k, const float* v, const float* dout,
                             const float* lse, const float* dsum, float* dq, int64_t B, int64_t H,
                             int64_t KV, int64_t Sq, int64_t Sk, int64_t hd, int64_t dv, float scale,
                             int causal, int64_t window, float softcap, int64_t q_pos0, int device,
                             void* stream) {
  return flash_dq(q, k, v, dout, lse, dsum, dq, B, H, KV, Sq, Sk, hd, dv, scale, causal, window, softcap,
                  q_pos0, device, stream);
}

REPRO_API int repro_flash_dkv(const float* q, const float* k, const float* v, const float* dout,
                              const float* lse, const float* dsum, float* dk, float* dv, int64_t B,
                              int64_t H, int64_t KV, int64_t Sq, int64_t Sk, int64_t hd, int64_t dvd,
                              float scale, int causal, int64_t window, float softcap, int64_t q_pos0,
                              int device, void* stream) {
  return flash_dkv(q, k, v, dout, lse, dsum, dk, dv, B, H, KV, Sq, Sk, hd, dvd, scale, causal, window, softcap,
                   q_pos0, device, stream);
}

// Family F: flash-attention backward, two kernels.
//   dq kernel : one block per (b, h, 32-row query tile), looping over key tiles;
//   dkv kernel: one block per (b, kv, 32-row key tile), looping over the G
//               query heads of the KV head and their query tiles.
//
// Replaces the TPU kernels src/repro/kernels/flash_attention_bwd.py::
// flash_attention_bwd (_dq_kernel, _dkv_kernel). As there, each tile's
// probabilities are recomputed from the forward's log-sum-exp,
// p = exp(s - lse) with masked and out-of-range entries 0, and
// ds = p * (do·v^T - D) (times 1 - t^2 under a softcap), with
// D = rowsum(do * o) computed before the kernels. dq = scale * ds·k;
// dk = scale * ds^T·q and dv = p^T·do summed over the G query heads. The
// TPU's sequential grid carried the dq and dk/dv sums in VMEM scratch; here
// the loop inside the block does, and every dk/dv tile is written by exactly
// one block, so there are no atomics and a launch always gives the same bits.
//
// Bound: operations. Per allowed (q, k) pair the backward needs
// 2 * (3 * hd + 2 * dv) flops, counting s, dp, dv, dq and dk once each; the
// two kernels each recompute s and dp, so between them they execute
// 2 * (4 * hd + 3 * dv). Design as in flash_fwd.cu: fp32 on the CUDA cores;
// the warp's 4 rows are read as shared-memory broadcasts, the lane's own
// row at an odd stride; accumulators stay in registers.
#include "flash_common.cuh"

using namespace repro::flash;

namespace {

__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Params p) {
  extern __shared__ float smem[];
  const int64_t hs = odd_stride(p.hd), vsd = odd_stride(p.dv);
  float* qs = smem;                  // kTile x hd, broadcast reads
  float* dos = qs + kTile * p.hd;    // kTile x dv, broadcast reads
  float* ks = dos + kTile * p.dv;    // kTile x hs, one row per lane
  float* vs = ks + kTile * hs;       // kTile x vsd, one row per lane
  float* dss = vs + kTile * vsd;     // kTile x 32
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t b = blockIdx.z, h = blockIdx.y, q0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t kvh = h / (p.H / p.KV);
  const int64_t bh = b * p.H + h;
  const float* kg = p.k + (b * p.KV + kvh) * p.Sk * p.hd;
  const float* vg = p.v + (b * p.KV + kvh) * p.Sk * p.dv;
  const int64_t nq = p.Sq - q0 < kTile ? p.Sq - q0 : kTile;
  const int row0 = warp * kRowsPerWarp;

  load_tile(qs, p.hd, p.q + bh * p.Sq * p.hd, q0, p.Sq, p.hd);
  load_tile(dos, p.dv, p.dout + bh * p.Sq * p.dv, q0, p.Sq, p.dv);
  float lse_r[kRowsPerWarp], d_r[kRowsPerWarp], acc[kRowsPerWarp][kChunks];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int64_t row = q0 + row0 + r;
    lse_r[r] = row < p.Sq ? p.lse[bh * p.Sq + row] : 0.f;
    d_r[r] = row < p.Sq ? p.dsum[bh * p.Sq + row] : 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) acc[r][c] = 0.f;
  }
  int64_t kt0, kt1;
  key_tiles(p, p.q_pos0 + q0, p.q_pos0 + q0 + nq - 1, &kt0, &kt1);
  for (int64_t kt = kt0; kt < kt1; ++kt) {
    const int64_t k0 = kt * kTile;
    const int64_t nk = p.Sk - k0 < kTile ? p.Sk - k0 : kTile;
    __syncthreads();
    load_tile(ks, hs, kg, k0, p.Sk, p.hd);
    load_tile(vs, vsd, vg, k0, p.Sk, p.dv);
    __syncthreads();

    float s[kRowsPerWarp] = {0.f, 0.f, 0.f, 0.f};
    float dp[kRowsPerWarp] = {0.f, 0.f, 0.f, 0.f};
    dot_rows(qs + row0 * p.hd, p.hd, ks + lane * hs, p.hd, s);
    dot_rows(dos + row0 * p.dv, p.dv, vs + lane * vsd, p.dv, dp);
    const int64_t kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float chain;
      const float x = logit(p, s[r], &chain);
      const int64_t row = q0 + row0 + r;
      const bool ok = lane < nk && row < p.Sq && allowed(p, p.q_pos0 + row, kpos);
      const float pr = ok ? expf(x - lse_r[r]) : 0.f;
      dss[(row0 + r) * 32 + lane] = pr * (dp[r] - d_r[r]) * chain;
    }
    __syncwarp();
    for (int j = 0; j < nk; ++j) {
      float dsj[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) dsj[r] = dss[(row0 + r) * 32 + j];
      const float* krow = ks + j * hs;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int64_t col = c * 32 + lane;
        if (col < p.hd) {
          const float kk = krow[col];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) acc[r][c] = fmaf(dsj[r], kk, acc[r][c]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int64_t row = q0 + row0 + r;
    if (row >= p.Sq) continue;
    float* out = p.o + (bh * p.Sq + row) * p.hd;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int64_t col = c * 32 + lane;
      if (col < p.hd) out[col] = acc[r][c] * p.scale;
    }
  }
}

__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(Params p) {
  extern __shared__ float smem[];
  const int64_t hs = odd_stride(p.hd), vsd = odd_stride(p.dv);
  float* ks = smem;                  // kTile x hd, broadcast reads
  float* vs = ks + kTile * p.hd;     // kTile x dv, broadcast reads
  float* qs = vs + kTile * p.dv;     // kTile x hs, one row per lane
  float* dos = qs + kTile * hs;      // kTile x vsd, one row per lane
  float* pss = dos + kTile * vsd;    // kTile x 32 probabilities
  float* dss = pss + kTile * 32;     // kTile x 32 score gradients
  float* lses = dss + kTile * 32;    // kTile
  float* dsums = lses + kTile;       // kTile
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t b = blockIdx.z, kvh = blockIdx.y, k0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t G = p.H / p.KV;
  const int64_t bkv = b * p.KV + kvh;
  const int64_t nk = p.Sk - k0 < kTile ? p.Sk - k0 : kTile;
  const int row0 = warp * kRowsPerWarp;

  load_tile(ks, p.hd, p.k + bkv * p.Sk * p.hd, k0, p.Sk, p.hd);
  load_tile(vs, p.dv, p.v + bkv * p.Sk * p.dv, k0, p.Sk, p.dv);
  float dk[kRowsPerWarp][kChunks], dv[kRowsPerWarp][kChunks];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) dk[r][c] = dv[r][c] = 0.f;
  }
  int64_t qt0, qt1;
  query_tiles(p, k0, k0 + nk - 1, &qt0, &qt1);
  for (int64_t g = 0; g < G; ++g) {
    const int64_t bh = b * p.H + kvh * G + g;
    for (int64_t qt = qt0; qt < qt1; ++qt) {
      const int64_t q0 = qt * kTile;
      const int64_t nq = p.Sq - q0 < kTile ? p.Sq - q0 : kTile;
      __syncthreads();  // the previous query tile is consumed (and the k/v tiles are loaded)
      load_tile(qs, hs, p.q + bh * p.Sq * p.hd, q0, p.Sq, p.hd);
      load_tile(dos, vsd, p.dout + bh * p.Sq * p.dv, q0, p.Sq, p.dv);
      if (threadIdx.x < kTile) {
        const int64_t row = q0 + threadIdx.x;
        lses[threadIdx.x] = row < p.Sq ? p.lse[bh * p.Sq + row] : 0.f;
        dsums[threadIdx.x] = row < p.Sq ? p.dsum[bh * p.Sq + row] : 0.f;
      }
      __syncthreads();

      // lane i is query row q0 + i; the warp's rows are keys k0 + row0 + r
      float s[kRowsPerWarp] = {0.f, 0.f, 0.f, 0.f};
      float dp[kRowsPerWarp] = {0.f, 0.f, 0.f, 0.f};
      dot_rows(ks + row0 * p.hd, p.hd, qs + lane * hs, p.hd, s);
      dot_rows(vs + row0 * p.dv, p.dv, dos + lane * vsd, p.dv, dp);
      const int64_t qpos = p.q_pos0 + q0 + lane;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        float chain;
        const float x = logit(p, s[r], &chain);
        const bool ok = lane < nq && row0 + r < nk && allowed(p, qpos, k0 + row0 + r);
        const float pr = ok ? expf(x - lses[lane]) : 0.f;
        pss[(row0 + r) * 32 + lane] = pr;
        dss[(row0 + r) * 32 + lane] = pr * (dp[r] - dsums[lane]) * chain;
      }
      __syncwarp();
      for (int i = 0; i < nq; ++i) {
        float pi[kRowsPerWarp], dsi[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          pi[r] = pss[(row0 + r) * 32 + i];
          dsi[r] = dss[(row0 + r) * 32 + i];
        }
        const float* qrow = qs + i * hs;
        const float* dorow = dos + i * vsd;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const int64_t col = c * 32 + lane;
          if (col < p.dv) {
            const float dd = dorow[col];
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) dv[r][c] = fmaf(pi[r], dd, dv[r][c]);
          }
          if (col < p.hd) {
            const float qq = qrow[col];
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) dk[r][c] = fmaf(dsi[r], qq, dk[r][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int64_t key = k0 + row0 + r;
    if (key >= p.Sk) continue;
    float* dkrow = p.o + (bkv * p.Sk + key) * p.hd;
    float* dvrow = p.lse_out + (bkv * p.Sk + key) * p.dv;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int64_t col = c * 32 + lane;
      if (col < p.hd) dkrow[col] = dk[r][c] * p.scale;
      if (col < p.dv) dvrow[col] = dv[r][c];
    }
  }
}

}  // namespace

REPRO_API int repro_flash_dq(const float* q, const float* k, const float* v, const float* dout,
                             const float* lse, const float* dsum, float* dq, int64_t B, int64_t H,
                             int64_t KV, int64_t Sq, int64_t Sk, int64_t hd, int64_t dv, float scale,
                             int causal, int64_t window, float softcap, int64_t q_pos0, int device,
                             void* stream) {
  cudaSetDevice(device);
  if (B <= 0 || H <= 0 || Sq <= 0) return repro::launch_status();
  Params p{q, k, v, dout, lse, dsum, dq, nullptr, B, H, KV, Sq, Sk, hd, dv, q_pos0, window,
           scale, softcap, causal};
  const size_t smem =
      sizeof(float) * (kTile * (hd + dv + odd_stride(hd) + odd_stride(dv)) + kTile * 32);
  const cudaError_t attr = allow_smem(flash_dq_kernel, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>((Sq + kTile - 1) / kTile), static_cast<unsigned>(H),
                  static_cast<unsigned>(B));
  flash_dq_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return repro::launch_status();
}

REPRO_API int repro_flash_dkv(const float* q, const float* k, const float* v, const float* dout,
                              const float* lse, const float* dsum, float* dk, float* dv, int64_t B,
                              int64_t H, int64_t KV, int64_t Sq, int64_t Sk, int64_t hd, int64_t dvd,
                              float scale, int causal, int64_t window, float softcap, int64_t q_pos0,
                              int device, void* stream) {
  cudaSetDevice(device);
  if (B <= 0 || KV <= 0 || Sk <= 0) return repro::launch_status();
  Params p{q, k, v, dout, lse, dsum, dk, dv, B, H, KV, Sq, Sk, hd, dvd, q_pos0, window,
           scale, softcap, causal};
  const size_t smem =
      sizeof(float) * (kTile * (hd + dvd + odd_stride(hd) + odd_stride(dvd)) + 2 * kTile * 32 + 2 * kTile);
  const cudaError_t attr = allow_smem(flash_dkv_kernel, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>((Sk + kTile - 1) / kTile), static_cast<unsigned>(KV),
                  static_cast<unsigned>(B));
  flash_dkv_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return repro::launch_status();
}

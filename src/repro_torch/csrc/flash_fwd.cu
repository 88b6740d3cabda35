// Family E: flash-attention forward. (B, H, Sq, hd) x (B, KV, Sk, hd) x
// (B, KV, Sk, dv) -> o (B, H, Sq, dv), lse (B, H, Sq), fp32.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_with_lse (_flash_kernel). There the innermost grid axis
// walked the key blocks in order and carried the running max m, sum l and
// output accumulator in VMEM scratch; here one block owns a 32-row query
// tile of one (b, h) and walks the key tiles in a loop, with m, l and the
// accumulator in registers. Ragged edges are masked in the kernel (no
// padding of hd to 128 lanes or of S to blocks in memory), and key tiles
// that the causal mask or the window hide from every row of the block are
// skipped.
//
// Bound: operations. Per allowed (q, k) pair it does 2 * (hd + dv) flops on
// data that is read once per 32-row tile, far above the card's fp32
// flops-per-byte balance. Design: fp32 on the CUDA cores (no tensor cores
// in this first version); lane j of a warp scores key j of the tile against
// the warp's 4 query rows (q rows read as shared-memory broadcasts, k rows
// at an odd stride so the lanes hit distinct banks), the online softmax
// uses the warp's shuffles, and the p·v update reads p as a broadcast and v
// rows column-per-lane. Every sum runs in a fixed order, so a launch shape
// always gives the same bits.
#include "flash_common.cuh"

using namespace repro::flash;

namespace {

__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  const int64_t hs = odd_stride(p.hd);
  float* qs = smem;                  // kTile x hd, broadcast reads
  float* ks = qs + kTile * p.hd;     // kTile x hs, one row per lane
  float* vs = ks + kTile * hs;       // kTile x dv
  float* ps = vs + kTile * p.dv;     // kTile x 32 probabilities (4 rows per warp)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t b = blockIdx.z, h = blockIdx.y, q0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t kvh = h / (p.H / p.KV);
  const float* qg = p.q + (b * p.H + h) * p.Sq * p.hd;
  const float* kg = p.k + (b * p.KV + kvh) * p.Sk * p.hd;
  const float* vg = p.v + (b * p.KV + kvh) * p.Sk * p.dv;
  const int64_t nq = p.Sq - q0 < kTile ? p.Sq - q0 : kTile;
  const int row0 = warp * kRowsPerWarp;

  load_tile(qs, p.hd, qg, q0, p.Sq, p.hd);
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kChunks];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) acc[r][c] = 0.f;
  }
  int64_t kt0, kt1;
  key_tiles(p, p.q_pos0 + q0, p.q_pos0 + q0 + nq - 1, &kt0, &kt1);
  for (int64_t kt = kt0; kt < kt1; ++kt) {
    const int64_t k0 = kt * kTile;
    const int64_t nk = p.Sk - k0 < kTile ? p.Sk - k0 : kTile;
    __syncthreads();  // the previous tile is consumed (and the q tile is loaded)
    load_tile(ks, hs, kg, k0, p.Sk, p.hd);
    load_tile(vs, p.dv, vg, k0, p.Sk, p.dv);
    __syncthreads();

    float s[kRowsPerWarp] = {0.f, 0.f, 0.f, 0.f};
    dot_rows(qs + row0 * p.hd, p.hd, ks + lane * hs, p.hd, s);
    const bool kin = lane < nk;
    const int64_t kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float chain;
      float x = logit(p, s[r], &chain);
      if (!allowed(p, p.q_pos0 + q0 + row0 + r, kpos)) x = kNegInf;
      const float mt = repro::warp_max(kin ? x : kNegInf);
      const float mn = fmaxf(m[r], mt);
      const float alpha = expf(m[r] - mn);
      const float pr = kin ? expf(x - mn) : 0.f;
      l[r] = alpha * l[r] + repro::warp_sum(pr);
      m[r] = mn;
      ps[(row0 + r) * 32 + lane] = pr;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();
    for (int j = 0; j < nk; ++j) {
      float pj[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) pj[r] = ps[(row0 + r) * 32 + j];
      const float* vrow = vs + j * p.dv;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int64_t col = c * 32 + lane;
        if (col < p.dv) {
          const float vv = vrow[col];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) acc[r][c] = fmaf(pj[r], vv, acc[r][c]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int64_t row = q0 + row0 + r;
    if (row >= p.Sq) continue;
    const float l_safe = fmaxf(l[r], 1e-30f);
    float* orow = p.o + ((b * p.H + h) * p.Sq + row) * p.dv;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int64_t col = c * 32 + lane;
      if (col < p.dv) orow[col] = acc[r][c] / l_safe;
    }
    if (lane == 0) p.lse_out[(b * p.H + h) * p.Sq + row] = m[r] + logf(l_safe);
  }
}

}  // namespace

REPRO_API int repro_flash_fwd(const float* q, const float* k, const float* v, float* o, float* lse,
                              int64_t B, int64_t H, int64_t KV, int64_t Sq, int64_t Sk, int64_t hd,
                              int64_t dv, float scale, int causal, int64_t window, float softcap,
                              int64_t q_pos0, int device, void* stream) {
  cudaSetDevice(device);
  if (B <= 0 || H <= 0 || Sq <= 0) return repro::launch_status();
  Params p{q, k, v, nullptr, nullptr, nullptr, o, lse, B, H, KV, Sq, Sk, hd, dv, q_pos0, window,
           scale, softcap, causal};
  const size_t smem = sizeof(float) * (kTile * (hd + odd_stride(hd) + dv) + kTile * 32);
  const cudaError_t attr = allow_smem(flash_fwd_kernel, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>((Sq + kTile - 1) / kTile), static_cast<unsigned>(H),
                  static_cast<unsigned>(B));
  flash_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return repro::launch_status();
}

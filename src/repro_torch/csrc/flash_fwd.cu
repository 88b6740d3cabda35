// Family E: flash-attention forward. (B, H, Sq, hd) x (B, KV, Sk, hd) x
// (B, KV, Sk, dv) -> o (B, H, Sq, dv), lse (B, H, Sq), fp32.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_with_lse (_flash_kernel). There the innermost grid axis
// walked the key blocks in order and carried the running max m, sum l and
// output accumulator in VMEM scratch; here one block owns a 64-row query
// tile of one (b, h) and walks the key tiles in a loop, with m, l and the
// accumulator in registers. Ragged edges are zero-filled by the copies and
// masked in the kernel, and key tiles that the causal mask or the window
// hide from every row of the block are skipped.
//
// Bound: operations. Per allowed (q, k) pair it does 2 * (hd + dv) flops on
// data that is read once per 64-row tile: at fp32 on the CUDA cores
// (67 TFLOP/s) that is 0.016 ms at (4, 32, 256, 64); on the tensor cores in
// split TF32 (three tf32 products per product, 495 TFLOP/s) 0.0065 ms.
// Design (FlashAttention-2's shape): 4 warps of 16 query rows; s = q·kᵀ and
// o += p·v run on mma.sync m16n8k8 in split TF32 (mma_tf32.cuh), which keeps
// fp32-level accuracy; the online softmax runs on the s fragments (a row
// spans the 4 lanes of a quad: two shuffles for its max and sum), and the p
// fragment feeds the p·v product directly through the permuted column order.
// k/v tiles arrive by cp.async, double-buffered where shared memory allows,
// so tile n + 1 loads while tile n computes; rows are padded to E + 4
// floats so the fragment reads do not conflict on banks. Query tiles are
// launched last-first, so under a causal mask the longest blocks start
// first. Every sum runs in a fixed order: a launch shape always gives the
// same bits.
//
// bf16 q, k, v (repro_flash_fwd_bf16) take a kernel of their own on the bf16
// tensor cores, flash_fwd_bf16.cu.
#include "flash_common.cuh"

using namespace repro::flash;
namespace tc = repro::tc;

namespace {

template <int E>
__global__ void __launch_bounds__(kThreads, min_blocks(E)) flash_fwd_kernel(Params<float> p) {
  constexpr int S = stride<E>(), BK = kStream, NE = E / 8, NK = BK / 8;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                      // kRows x S
  float* kbuf = qs + kRows * S;          // stages x BK x S
  float* vbuf = kbuf + p.stages * BK * S;  // stages x BK x S
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int64_t h = blockIdx.x, b = blockIdx.y;
  const int64_t q0 = static_cast<int64_t>(gridDim.z - 1 - blockIdx.z) * kRows;
  const int64_t kvh = h / (p.H / p.KV);
  const float* qg = p.q + (b * p.H + h) * p.Sq * p.hd;
  const float* kg = p.k + (b * p.KV + kvh) * p.Sk * p.hd;
  const float* vg = p.v + (b * p.KV + kvh) * p.Sk * p.dv;
  const int64_t nq = p.Sq - q0 < kRows ? p.Sq - q0 : kRows;
  const int r0 = warp * 16;  // the warp's rows r0 + g and r0 + g + 8
  int klo[2], khi[2];        // the keys each of the lane's two rows may see
  key_range(p, p.q_pos0 + q0 + r0 + g, &klo[0], &khi[0]);
  key_range(p, p.q_pos0 + q0 + r0 + g + 8, &klo[1], &khi[1]);

  int64_t kt0, kt1;
  key_tiles(p, BK, p.q_pos0 + q0, p.q_pos0 + q0 + nq - 1, &kt0, &kt1);
  load_tile<E, kRows>(qs, qg, q0, p.Sq, p.hd, p.vec);
  if (kt0 < kt1) {
    load_tile<E, BK>(kbuf, kg, kt0 * BK, p.Sk, p.hd, p.vec);
    load_tile<E, BK>(vbuf, vg, kt0 * BK, p.Sk, p.dv, p.vec);
  }
  tc::cp_commit();

  float acc[NE][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
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

    // s = q · kᵀ (16 x BK per warp)
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NE; ++kk) {
      uint32_t ahi[4], alo[4];
      tc::load_a(qs + r0 * S + kk * 8, S, g, t, ahi, alo);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        uint32_t bhi[2], blo[2];
        tc::load_b_nk(ks + n * 8 * S + kk * 8, S, g, t, bhi, blo);
        tc::mma3(s[n], ahi, alo, bhi, blo);
      }
    }

    // online softmax on the fragments: entry e of s[n] is row r0 + g (+8 for
    // e >= 2), key column n * 8 + 2t + (e & 1)
    const int k0 = static_cast<int>(kt * BK);
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + n * 8 + 2 * t + (e & 1);
        float chain;
        float x = logit(p, s[n][e], &chain);
        if (kpos < klo[e >> 1] || kpos > khi[e >> 1]) x = kNegInf;
        s[n][e] = x;
        mt[e >> 1] = fmaxf(mt[e >> 1], x);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float mn = fmaxf(m[j], quad_max(mt[j]));
      alpha[j] = expf(m[j] - mn);
      m[j] = mn;
    }
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool kin = k0 + n * 8 + 2 * t + (e & 1) < p.Sk;
        const float pr = kin ? expf(s[n][e] - m[e >> 1]) : 0.f;
        s[n][e] = pr;
        rs[e >> 1] += pr;
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) l[j] = alpha[j] * l[j] + quad_sum(rs[j]);
#pragma unroll
    for (int n = 0; n < NE; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // o += p · v
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      uint32_t ahi[4], alo[4];
      tc::c_to_a(s[j], ahi, alo);
#pragma unroll
      for (int n = 0; n < NE; ++n) {
        uint32_t bhi[2], blo[2];
        tc::load_b_kn(vs + j * 8 * S + n * 8, S, g, t, bhi, blo);
        tc::mma3(acc[n], ahi, alo, bhi, blo);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
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
    const float l_safe = fmaxf(l[j], 1e-30f);
    float* orow = p.o + ((b * p.H + h) * p.Sq + row) * p.dv;
#pragma unroll
    for (int n = 0; n < NE; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < p.dv) orow[col] = acc[n][2 * j] / l_safe;
      if (col + 1 < p.dv) orow[col + 1] = acc[n][2 * j + 1] / l_safe;
    }
    if (t == 0) static_cast<float*>(p.lse_out)[(b * p.H + h) * p.Sq + row] = m[j] + logf(l_safe);
  }
}

template <int E>
size_t fwd_smem(int stages) {
  return sizeof(float) * stride<E>() * (kRows + 2 * stages * kStream);
}

int flash_fwd(const float* q, const float* k, const float* v, float* o, float* lse, int64_t B, int64_t H,
              int64_t KV, int64_t Sq, int64_t Sk, int64_t hd, int64_t dv, float scale, int causal, int64_t window,
              float softcap, int64_t q_pos0, int device, void* stream) {
  repro::use_device(device);
  if (B <= 0 || H <= 0 || Sq <= 0) return repro::launch_status();
  const int vec = hd % 4 == 0 && dv % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  Params<float> p{q, k, v, nullptr, nullptr, nullptr, o, lse, B, H, KV, Sq, Sk, hd, dv, q_pos0, window,
                  scale, softcap, causal, vec, 2, 1};
  return by_bucket(hd, dv, [&](auto e) {
    constexpr int E = decltype(e)::value;
    p.stages = fwd_smem<E>(2) <= kMaxSmem ? 2 : 1;
    const size_t smem = fwd_smem<E>(p.stages);
    const cudaError_t attr = allow_smem(flash_fwd_kernel<E>, smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid(static_cast<unsigned>(H), static_cast<unsigned>(B),
                    static_cast<unsigned>((Sq + kRows - 1) / kRows));
    flash_fwd_kernel<E><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
    return repro::launch_status();
  });
}

}  // namespace

REPRO_API int repro_flash_fwd(const float* q, const float* k, const float* v, float* o, float* lse,
                              int64_t B, int64_t H, int64_t KV, int64_t Sq, int64_t Sk, int64_t hd,
                              int64_t dv, float scale, int causal, int64_t window, float softcap,
                              int64_t q_pos0, int device, void* stream) {
  return flash_fwd(q, k, v, o, lse, B, H, KV, Sq, Sk, hd, dv, scale, causal, window, softcap, q_pos0, device,
                   stream);
}

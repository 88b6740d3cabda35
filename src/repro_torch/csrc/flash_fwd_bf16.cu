// Family E, bf16: flash-attention forward on Hopper's bf16 tensor cores.
// (B, H, Sq, hd) x (B, KV, Sk, hd) x (B, KV, Sk, dv), bf16 -> o (B, H, Sq, dv)
// bf16 and lse (B, H, Sq) fp32 (repro_flash_fwd_bf16).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_with_lse (_flash_kernel) for bf16 inputs, whose body casts
// q, k and v to fp32 (:46-48) and writes o in the inputs' dtype and the
// log-sum-exp in fp32 (:140). The algorithm is flash_fwd.cu's: one block a
// 64-row query tile of one (b, h), walking the key tiles with the running
// max, sum and output in registers; ragged edges zero-filled and masked; key
// tiles that the causal mask or the window hide from every row skipped;
// query tiles launched last-first; every sum in a fixed order, so a launch
// shape always gives the same bits.
//
// Bound: at (2, 32, 512, 64), KV 8, causal, 0.0032 ms for the bytes (q, k, v
// read once, o and lse written once) against 0.0022 ms for 2 * (hd + dv)
// flops an allowed pair at the bf16 tensor-core peak; at 4,096 tokens the
// operations bound it (0.139 ms).
//
// Design (wgmma_bf16.cuh). The block is one warpgroup. q and the key tiles
// stay bf16 in shared memory, in wgmma's swizzled layout; k and v tiles pass
// through a ring of three stages filled by 16-byte cp.async (rows that are
// not 16-byte aligned, hd or dv not a multiple of 8 or an offset base
// pointer, take the per-element path into the same layout). s = q·kᵀ is
// E / 16 wgmma m64nBKk16 with both operands in shared memory: bf16 x bf16
// products are exact in fp32, as accurate as flash_fwd.cu's split TF32 at a
// third of the products. The online softmax runs on s's accumulator
// registers, in log2 units (one exp2 a score). p, fp32, splits into two bf16
// parts whose A fragments are s's registers, and o += p·v is two wgmma
// m64nCk16 a k-step and value panel, p from registers and v an MN-major B
// operand. The loop is wg::pipeline, which the backward kernels share: tile
// n + 1's scores and tile n's p·v are in flight on the tensor cores while
// the warps run tile n + 1's softmax, and tile n + 2 copies meanwhile. Key
// tiles are 64 rows; 32 at E = 256, where o's accumulator alone takes 128
// registers a thread.
#include "flash_common.cuh"
#include "wgmma_bf16.cuh"

using namespace repro::flash;
namespace wg = repro::wg;
using repro::bf16;

namespace {

template <int E>
__global__ void __launch_bounds__(kThreads, min_blocks(E)) flash_fwd_bf16_kernel(Params<bf16> p) {
  using L = wg::Tile<E>;
  constexpr int BK = bf16_key_rows(E), KS = BK / 16, C = L::C, NP = L::panels;
  constexpr int QB = L::template bytes<kRows>(), KB = L::template bytes<BK>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = wg::align1024(smem_raw);  // kRows x E
  uint8_t* kbuf = qs + QB;                // kStages x BK x E
  uint8_t* vbuf = kbuf + kStages * KB;    // kStages x BK x E
  const uint32_t qa = wg::smem_addr(qs), ka = wg::smem_addr(kbuf), va = wg::smem_addr(vbuf);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int64_t h = blockIdx.x, b = blockIdx.y;
  const int64_t q0 = static_cast<int64_t>(gridDim.z - 1 - blockIdx.z) * kRows;
  const int64_t kvh = h / (p.H / p.KV);
  const bf16* qg = p.q + (b * p.H + h) * p.Sq * p.hd;
  const bf16* kg = p.k + (b * p.KV + kvh) * p.Sk * p.hd;
  const bf16* vg = p.v + (b * p.KV + kvh) * p.Sk * p.dv;
  const int64_t nq = p.Sq - q0 < kRows ? p.Sq - q0 : kRows;
  const int r0 = warp * 16;  // the warp's rows r0 + g and r0 + g + 8
  const int64_t qp0 = p.q_pos0 + q0, qp1 = qp0 + nq - 1;  // the block's first and last query positions
  const float c2 = p.scale * kLog2e;                       // a score to log2 units
  int klo[2], khi[2];        // the keys each of the lane's two rows may see
  key_range(p, qp0 + r0 + g, &klo[0], &khi[0]);
  key_range(p, qp0 + r0 + g + 8, &klo[1], &khi[1]);

  int64_t kt0, kt1;
  key_tiles(p, BK, qp0, qp1, &kt0, &kt1);
  // pipeline tile i is key tile kt0 + i, in stage i % kStages
  auto load_keys = [&](int64_t i) {
    const int st = static_cast<int>(i % kStages);
    wg::load_tile<E, BK>(kbuf + st * KB, kg, (kt0 + i) * BK, p.Sk, p.hd, p.vec);
    wg::load_tile<E, BK>(vbuf + st * KB, vg, (kt0 + i) * BK, p.Sk, p.dv, p.vec);
  };
  // issue s = q · kᵀ of tile i (64 x BK)
  float s[BK / 2];
  auto scores = [&](int64_t i) {
    const uint32_t kst = ka + static_cast<int>(i % kStages) * KB;
#pragma unroll
    for (int kk = 0; kk < E / 16; ++kk)
      wg::mma_ss<BK>(s, wg::desc_k<E, kRows>(qa, kk), wg::desc_k<E, BK>(kst, kk), kk > 0);
  };
  // the online softmax of tile i on s, in place, in log2 units: the running
  // max and sum, and the factor alpha that rescales o. Entry j of s is row r0
  // + g (+8 where j & 2), key column (j / 4) * 8 + 2t + (j & 1). A tile that
  // every row sees whole takes no mask (a uniform branch).
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  auto softmax = [&](int64_t i) {
    wg::hold(s);
    const int k0 = static_cast<int>((kt0 + i) * BK);
    const bool whole = sees_all(p, qp0, qp1, k0, k0 + BK - 1);
    if (p.softcap > 0.f) {
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        float chain;
        s[j] = logit(p, s[j], &chain) * kLog2e;
      }
    } else {
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) s[j] *= c2;
    }
    if (!whole) {
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int kpos = k0 + (j >> 2) * 8 + 2 * t + (j & 1), r = (j >> 1) & 1;
        if (kpos < klo[r] || kpos > khi[r]) s[j] = kNegInf;
      }
    }
    float mt[2] = {kNegInf, kNegInf}, rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) mt[(j >> 1) & 1] = fmaxf(mt[(j >> 1) & 1], s[j]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(mt[r]));
      alpha[r] = exp2f(m[r] - mn);
      m[r] = mn;
    }
    // masked scores stay finite: a row that sees no key yet gets exp2(0) here,
    // wiped by a later tile's alpha = 0, as in flash_fwd.cu
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) s[j] = exp2f(s[j] - m[(j >> 1) & 1]);
    if (!whole) {  // keys past Sk (they matter only to a row that sees no key yet)
#pragma unroll
      for (int j = 0; j < BK / 2; ++j)
        if (k0 + (j >> 2) * 8 + 2 * t + (j & 1) >= p.Sk) s[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) rs[(j >> 1) & 1] += s[j];
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + quad_sum(rs[r]);
  };
  // p of the tile whose p·v runs next, in two bf16 parts
  uint32_t phi[KS][4], plo[KS][4];
  auto split = [&]() {
#pragma unroll
    for (int i = 0; i < KS; ++i) wg::split_a(s, i, phi[i], plo[i]);
  };
  // issue o += p · v of tile i, the small part of p first
  float acc[NP][C / 2];
  auto pv = [&](int64_t i) {
    const uint32_t vst = va + static_cast<int>(i % kStages) * KB;
#pragma unroll
    for (int j = 0; j < KS; ++j) {
#pragma unroll
      for (int pn = 0; pn < NP; ++pn) {
        const uint64_t vd = wg::desc_mn<E, BK>(vst, j, pn);
        wg::mma_rs<C>(acc[pn], plo[j], vd);
        wg::mma_rs<C>(acc[pn], phi[j], vd);
      }
    }
  };
  // o once p·v is in, rescaled by the next tile's alpha (o is still 0 at the
  // first tile's softmax: nothing to rescale there)
  auto settle = [&](bool last) {
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) {
      wg::hold(acc[pn]);
      if (!last) {
#pragma unroll
        for (int i = 0; i < C / 2; ++i) acc[pn][i] *= alpha[(i >> 1) & 1];
      }
    }
  };

#pragma unroll
  for (int pn = 0; pn < NP; ++pn)
#pragma unroll
    for (int i = 0; i < C / 2; ++i) acc[pn][i] = 0.f;
  wg::load_tile<E, kRows>(qs, qg, q0, p.Sq, p.hd, p.vec);
  wg::pipeline(kt1 - kt0, load_keys, scores, softmax, split, pv, settle);

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int64_t row = q0 + r0 + g + j * 8;
    if (row >= p.Sq) continue;
    const float l_safe = fmaxf(l[j], 1e-30f);
    bf16* orow = p.o + ((b * p.H + h) * p.Sq + row) * p.dv;
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) {
#pragma unroll
      for (int n = 0; n < C / 8; ++n)
        wg::store2(orow, pn * C + n * 8 + 2 * t, p.dv, acc[pn][4 * n + 2 * j] / l_safe,
                   acc[pn][4 * n + 2 * j + 1] / l_safe);
    }
    if (t == 0) static_cast<float*>(p.lse_out)[(b * p.H + h) * p.Sq + row] = m[j] * kLn2 + logf(l_safe);
  }
}

template <int E>
size_t fwd_smem() {
  using L = wg::Tile<E>;
  return 1024 + L::template bytes<kRows>() + 2 * kStages * L::template bytes<bf16_key_rows(E)>();
}

int flash_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int64_t B, int64_t H, int64_t KV,
              int64_t Sq, int64_t Sk, int64_t hd, int64_t dv, float scale, int causal, int64_t window,
              float softcap, int64_t q_pos0, int device, void* stream) {
  repro::use_device(device);
  if (B <= 0 || H <= 0 || Sq <= 0) return repro::launch_status();
  Params<bf16> p{q, k, v, nullptr, nullptr, nullptr, o, lse, B, H, KV, Sq, Sk, hd, dv, q_pos0, window,
                 scale, softcap, causal, wg::vec_copies(q, k, v, nullptr, hd, dv), kStages, 1};
  return by_bucket(hd, dv, [&](auto e) {
    constexpr int E = decltype(e)::value;
    const size_t smem = fwd_smem<E>();
    const cudaError_t attr = allow_smem(flash_fwd_bf16_kernel<E>, smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid(static_cast<unsigned>(H), static_cast<unsigned>(B),
                    static_cast<unsigned>((Sq + kRows - 1) / kRows));
    flash_fwd_bf16_kernel<E><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
    return repro::launch_status();
  });
}

}  // namespace

REPRO_API int repro_flash_fwd_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int64_t B,
                                   int64_t H, int64_t KV, int64_t Sq, int64_t Sk, int64_t hd, int64_t dv,
                                   float scale, int causal, int64_t window, float softcap, int64_t q_pos0,
                                   int device, void* stream) {
  return flash_fwd(q, k, v, o, lse, B, H, KV, Sq, Sk, hd, dv, scale, causal, window, softcap, q_pos0, device,
                   stream);
}

// Whether bf16 flash launches on these operands copy their tiles by 16-byte
// cp.async (1) or element by element (0); dout may be null (the forward).
REPRO_API int repro_flash_bf16_vec(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, int64_t hd,
                                   int64_t dv) {
  return wg::vec_copies(q, k, v, dout, hd, dv);
}

// Dynamic shared memory of a forward launch at these head widths (bytes).
REPRO_API int repro_flash_fwd_bf16_smem(int64_t hd, int64_t dv) {
  return by_bucket(hd, dv, [](auto e) { return static_cast<int>(fwd_smem<decltype(e)::value>()); });
}

// Hopper building blocks of the bf16 flash-attention kernels
// (flash_fwd_bf16.cu, flash_bwd_bf16.cu): bf16 tiles in shared memory in the
// swizzled layout that wgmma's matrix descriptors read, their asynchronous
// copy, the descriptors, the wgmma products (A from shared memory or from
// registers), the split of an fp32 operand into two bf16 parts, and the
// pipelined loop that the three kernels share.
//
// Tile layout. An R x E bf16 tile (E a head-width bucket: 16, 32, 64, 128,
// 256) is kept as E / C panels of C = min(E, 64) columns. A panel holds its R
// rows at W = 2C bytes each (32, 64 or 128), and the byte offset a = r·W +
// 2·col within the panel is stored at a ^ (((a >> 7) & (W / 16 - 1)) << 4):
// each 16-byte chunk of a row moves by the row's phase in its group of rows.
// That is CUTLASS's Swizzle<log2(W / 16), 4, 3> on byte addresses, wgmma's
// (and TMA's) 32-, 64- and 128-byte swizzle. Every tile starts on a 1024-byte
// boundary, so the pattern's phase is the address's own (base offset 0).
//
// One layout serves both operand kinds, since 16-bit types allow either:
//   K-major (rows are M or N, columns K: q, k, v, do in s = q·kᵀ, dp = do·vᵀ,
//     sᵀ = k·qᵀ, dpᵀ = v·doᵀ): k-step kk starts 32·kk bytes into its
//     panel's rows;
//   MN-major, "transposed" B (rows are K, columns N: v, k, do, q in p·v,
//     ds·k, pᵀ·do, dsᵀ·q): k-step kk starts 16·kk rows down, and each panel
//     is a product of its own (N = C), so no instruction crosses a panel.
// Both step from one group of 8 rows to the next by the stride byte offset,
// 8·W.
//
// Products. One warpgroup (4 warps, 128 threads) owns 64 rows and issues
// wgmma.mma_async m64nNk16 with fp32 accumulators. Warp w's entry d[4j + e]
// is row 16w + g (+ 8 for e >= 2), column 8j + 2t + (e & 1), with g = lane / 4
// and t = lane % 4. The A fragment of a k16 step from registers is {row g,
// columns 2t, 2t + 1}, {row g + 8, the same}, {row g, columns 2t + 8, 2t + 9},
// {row g + 8, the same}: an accumulator's n-blocks 2i and 2i + 1 are the A
// fragment of k-step i, with no data movement (split_a).
//
// Split bf16. A product with an fp32 operand x (p or ds) runs as two bf16
// products into one accumulator: x = hi + lo, hi = bf16_rn(x), lo =
// bf16_rn(x - hi). bf16 products are exact in fp32, and what the split drops,
// x - hi - lo, is at most 2^-9 of lo: about 2^-17 of x.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_tf32.cuh"  // tc::cp_commit, tc::cp_wait

namespace repro {
namespace wg {

constexpr int kThreads = 128;  // one warpgroup

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after p (the dynamic shared memory's
// start is not promised to be one; launches ask for 1024 bytes more).
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// Geometry of a tile of bucket E.
template <int E>
struct Tile {
  static constexpr int C = E < 64 ? E : 64;  // columns a panel
  static constexpr int W = 2 * C;            // bytes a panel row
  static constexpr int panels = E / C;
  static constexpr int layout = W == 128 ? 1 : W == 64 ? 2 : 3;  // the descriptor's swizzle code
  template <int R>
  __host__ __device__ static constexpr int bytes() { return R * E * 2; }
  // byte offset of element (r, c) in an R-row tile
  template <int R>
  static __device__ __forceinline__ int offset(int r, int c) {
    const int a = r * W + (c % C) * 2;
    return (c / C) * (R * W) + (a ^ (((a >> 7) & (W / 16 - 1)) << 4));
  }
};

// A shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle code.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | static_cast<uint64_t>(layout) << 62;
}

// K-major operand: columns [16 kk, 16 kk + 16) of the R-row tile at shared
// address `tile` (the leading byte offset is unused by a swizzled K-major
// operand and set to 16 bytes, as CUTLASS sets it).
template <int E, int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  using L = Tile<E>;
  const int col = kk * 16;
  return desc(tile + (col / L::C) * (R * L::W) + (col % L::C) * 2, 16, 8 * L::W, L::layout);
}

// MN-major B operand: rows [16 kk, 16 kk + 16) of panel `panel`.
template <int E, int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk, int panel) {
  using L = Tile<E>;
  return desc(tile + panel * (R * L::W) + kk * 16 * L::W, R * L::W, 8 * L::W, L::layout);
}

// cp.async of 16 bytes, or 16 zero bytes when ok is false (nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

// Whether a launch copies its tiles by 16-byte cp.async (1) or element by
// element (0): every row a whole number of 16-byte chunks (hd and dv
// multiples of 8) and every base pointer 16-byte aligned (dout may be null).
// The one rule of the three kernels; repro_flash_bf16_vec reports it.
inline int vec_copies(const void* q, const void* k, const void* v, const void* dout, int64_t hd, int64_t dv) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout);
  return hd % 8 == 0 && dv % 8 == 0 && (bits & 15) == 0;
}

// Start the copy of rows [row0, row0 + R) of a (rows, width) bf16 matrix
// into an R-row tile; rows at or past `rows` and columns at or past `width`
// are zeros. vec: 16-byte cp.async (width a multiple of 8, src 16-byte
// aligned), the caller commits; each thread copies the same chunk of every
// kThreads / (E / 8)-th row, so its addresses are fixed but for the row.
// Else element by element with plain loads and stores, in place when the
// call returns. Either way the writer fences (fence_proxy) before the
// barrier that hands the tile to wgmma.
template <int E, int R>
__device__ __forceinline__ void load_tile(uint8_t* tile, const __nv_bfloat16* __restrict__ src, int64_t row0,
                                          int64_t rows, int64_t width, bool vec) {
  using L = Tile<E>;
  const __nv_bfloat16* first = src + row0 * width;
  const int left = rows - row0 < R ? static_cast<int>(rows - row0) : R;  // the tile's rows in the matrix
  const int w = static_cast<int>(width);
  if (vec) {
    constexpr int CH = E / 8, STEP = kThreads / CH;  // 16-byte chunks a row, rows a pass
    static_assert(kThreads % CH == 0 && (R % STEP == 0 || STEP % R == 0), "a pass covers whole rows");
    const int r = threadIdx.x / CH, c = (threadIdx.x % CH) * 8;
    const bool cin = c < w;
#pragma unroll
    for (int j = 0; j < (R + STEP - 1) / STEP; ++j) {
      const int row = r + j * STEP;
      if (STEP > R && row >= R) break;  // a pass longer than the tile
      const bool ok = cin && row < left;
      cp_async16(tile + L::template offset<R>(row, c), ok ? first + row * w + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < R * E; i += kThreads) {
      const int r = i / E, c = i % E;
      const bool ok = r < left && c < w;
      *reinterpret_cast<__nv_bfloat16*>(tile + L::template offset<R>(r, c)) =
          ok ? first[r * w + c] : __float2bfloat16_rn(0.f);
    }
  }
}

// Make this thread's generic-proxy shared-memory writes (cp.async once
// waited for, plain stores) visible to wgmma, which reads through the async
// proxy.
__device__ __forceinline__ void fence_proxy() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// wgmma ordering: fence before products whose registers were written since
// the last one, commit a group, wait until at most N groups are in flight.
__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the wait that completes it.
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The pipelined main loop of the three bf16 flash kernels over n streamed
// tiles, tile i in ring stage i % 3 (the caller's ring has three stages).
// The caller has started the copies of its resident tiles (they join tile
// 0's commit group) and passes:
//   load(i)         start the copies of tile i;
//   scores(i)       issue tile i's products from shared memory (s, dp);
//   elementwise(i)  once those are complete: hold their accumulators, then
//                   run the softmax or the gradients on them;
//   split()         the A fragments of the next register products, from
//                   those accumulators;
//   products(i)     issue tile i's products with A from registers (p·v,
//                   ds·k, pᵀ·do, dsᵀ·q);
//   settle(last)    once those are complete: hold their accumulators (and
//                   rescale them, where the forward must, unless last).
// The tensor cores run tile i + 1's scores and tile i's products while the
// warps run tile i + 1's elementwise step; tile i + 2 copies meanwhile. The
// order is what keeps the products asynchronous: every pass issues the same
// two groups, the fragments are written only after the wait (none while a
// product is in flight) and the last tile's products are peeled. Else ptxas
// serializes every wgmma (its advisories C7513, C7514).
template <class Load, class Scores, class Elementwise, class Split, class Products, class Settle>
__device__ __forceinline__ void pipeline(int64_t n, Load&& load, Scores&& scores, Elementwise&& elementwise,
                                         Split&& split, Products&& products, Settle&& settle) {
  if (n > 0) load(0);
  tc::cp_commit();
  if (n > 1) load(1);
  tc::cp_commit();
  if (n > 0) {
    tc::cp_wait<1>();  // tile 0 is in
    fence_proxy();
    __syncthreads();  // ... for every warp
    fence();
    scores(0);
    commit();
    wait<0>();
    elementwise(0);
    split();
  }
  int64_t i = 0;
  for (; i + 1 < n; ++i) {
    tc::cp_wait<0>();  // tile i + 1 is in
    fence_proxy();
    __syncthreads();             // ... for every warp, and every warp is done with tile i - 1
    if (i + 2 < n) load(i + 2);  // into tile i - 1's stage
    tc::cp_commit();
    fence();
    scores(i + 1);
    commit();
    products(i);
    commit();
    wait<1>();  // the scores are in; the products may still run
    elementwise(i + 1);
    wait<0>();
    settle(false);
    split();
  }
  if (i < n) {  // the last tile's products
    fence();
    products(i);
    commit();
    wait<0>();
    settle(true);
  }
  tc::cp_wait<0>();
}

// The hi and lo bf16 parts of the A fragment of k-step i, taken from the
// accumulator entries of n-blocks 2i and 2i + 1, a pair of columns at a
// time: hi = bf16_rn(x), lo = bf16_rn(x - hi).
template <int N>
__device__ __forceinline__ void split_a(const float (&s)[N], int i, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float a = s[8 * i + 2 * r], b = s[8 * i + 2 * r + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
    hi[r] = *reinterpret_cast<const uint32_t*>(&h);
    lo[r] = *reinterpret_cast<const uint32_t*>(&l);
  }
}

// Two outputs of one row at columns col, col + 1 (< width), rounded to
// bf16: one 4-byte store where the pair is whole and 4-byte aligned.
__device__ __forceinline__ void store2(__nv_bfloat16* row, int col, int64_t width, float a, float b) {
  if (col + 1 < width && (width & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(a, b);
  } else {
    if (col < width) row[col] = __float2bfloat16_rn(a);
    if (col + 1 < width) row[col + 1] = __float2bfloat16_rn(b);
  }
}

// d (+)= a·b, m64nNk16, bf16 inputs, fp32 accumulators. mma_ss: A and B
// K-major in shared memory, d = a·b + (scale_d ? d : 0). mma_rs: A from
// registers, B MN-major in shared memory, d += a·b.
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d);
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void mma_ss<16>(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, %8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_ss<32>(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_ss<64>(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

}  // namespace wg
}  // namespace repro

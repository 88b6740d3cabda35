// Tensor-core building blocks of the flash-attention kernels: split-TF32
// products on mma.sync (m16n8k8, tf32 inputs, fp32 accumulators) and
// 16- or 4-byte cp.async copies into shared memory.
//
// Split TF32 ("3xTF32"). A float x is split as x = hi + lo with
// hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi); a product is
// a·b ≈ hi_a·hi_b + hi_a·lo_b + lo_a·hi_b. Each tf32 product is exact in
// fp32 and the dropped lo_a·lo_b term is about 2^-22 of a·b, so the result
// has fp32-level accuracy at three tensor-core products per fp32 product.
// The two small cross terms go into the accumulator first, then hi·hi.
//
// Fragment layouts of mma.m16n8k8 (PTX ISA), with g = lane / 4 and
// t = lane % 4:
//   A (16 x 8, row-major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B ( 8 x 8, col-major): b0 (t, g), b1 (t + 4, g)
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// A C fragment is reused as the A operand of the next product without any
// data movement by reading its 8 columns in the order (0, 2, 4, 6, 1, 3, 5,
// 7): then a0 = c0, a1 = c2, a2 = c1, a3 = c3, and the B operand's rows are
// read in the same order (b0 = row 2t, b1 = row 2t + 1 of the 8-row step).
#pragma once

#include <stdint.h>

namespace repro {
namespace tc {

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

template <int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&hi)[N], uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split(x[i], hi[i], lo[i]);
}

// d += a * b on the tensor cores, one m16n8k8 tf32 product.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b at fp32-level accuracy: lo·hi, hi·lo, then hi·hi.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ahi)[4], const uint32_t (&alo)[4],
                                     const uint32_t (&bhi)[2], const uint32_t (&blo)[2]) {
  mma(d, alo, bhi);
  mma(d, ahi, blo);
  mma(d, ahi, bhi);
}

// B fragment of rows (r0 .. r0 + 7) x 8 columns held as an (n, k) row-major
// tile: b0 = src[g * stride + t], b1 = src[g * stride + t + 4], split.
__device__ __forceinline__ void load_b_nk(const float* src, int stride, int g, int t, uint32_t (&hi)[2],
                                          uint32_t (&lo)[2]) {
  split(src[g * stride + t], hi[0], lo[0]);
  split(src[g * stride + t + 4], hi[1], lo[1]);
}

// B fragment of an 8-row step of a (k, n) row-major tile, rows in the
// permuted order above: b0 = src[2t * stride + g], b1 = src[(2t + 1) * stride + g].
__device__ __forceinline__ void load_b_kn(const float* src, int stride, int g, int t, uint32_t (&hi)[2],
                                          uint32_t (&lo)[2]) {
  split(src[2 * t * stride + g], hi[0], lo[0]);
  split(src[(2 * t + 1) * stride + g], hi[1], lo[1]);
}

// A fragment of 16 rows x 8 columns of a row-major tile, split.
__device__ __forceinline__ void load_a(const float* src, int stride, int g, int t, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const float a[4] = {src[g * stride + t], src[(g + 8) * stride + t], src[g * stride + t + 4],
                      src[(g + 8) * stride + t + 4]};
  split(a, hi, lo);
}

// A fragment taken from a C fragment (columns in the permuted order), split.
__device__ __forceinline__ void c_to_a(const float (&c)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float a[4] = {c[0], c[2], c[1], c[3]};
  split(a, hi, lo);
}

// cp.async: copy `bytes` (16 or 4) from global to shared memory, or write
// zeros there when ok is false (src-size 0: nothing is read from src).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tc
}  // namespace repro

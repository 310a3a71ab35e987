// 3xTF32 products on mma.sync.m16n8k8 and the cp.async copies that feed
// them, for the port's tensor-core tile kernels.
//
// Each fp32 operand x is split into hi = x rounded to TF32 and lo = x - hi
// (exact in fp32), and a product accumulates lo*hi + hi*lo + hi*hi in fp32,
// dropping lo*lo: each operand keeps ~21 of its 24 significand bits.  The
// instruction reads only the top 19 bits of a register: hi is rounded
// first (to nearest, ties away from zero, as `cvt.rna` rounds), lo is left
// for the tensor core to truncate, which costs at most 2^-21 |x| of either
// sign (|lo| <= 2^-11 |x|).  `cvt.rna.tf32.f32` compiles to four
// instructions on sm_90a (a finiteness test, an add, a select, a mask);
// the split here takes three per element, and a NaN x still reaches the
// products through lo.  An infinite x gives NaN (lo = inf - inf), as
// `cvt.rna` does.
// The tensor core truncates as it aligns and normalises its accumulator, so
// a long chain of products on one accumulator drifts toward zero; callers
// keep chains short and join them to their running sums by fp32 adds.
// (csrc/flash_attention.cu carries its own copies of these helpers.)
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace repro {

// ---------------------------------------------------------------- cp.async --

// 16 bytes from `src` into shared memory at `dst`; zeros where !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0) : "memory");
}

// One float from `src` into shared memory at `dst`; zero where !valid.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------ 3xTF32 mma --

// A fragment of m16n8k8 (rows g, g + 8 x columns t, t + 4) and a B fragment
// (rows t, t + 4 x column g), each split in hi and lo.
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// a0 = A[g][t], a1 = A[g + 8][t], a2 = A[g][t + 4], a3 = A[g + 8][t + 4]
__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split_tf32(a0, f.hi[0], f.lo[0]);
  split_tf32(a1, f.hi[1], f.lo[1]);
  split_tf32(a2, f.hi[2], f.lo[2]);
  split_tf32(a3, f.hi[3], f.lo[3]);
  return f;
}

// b0 = B[t][g], b1 = B[t + 4][g]
__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split_tf32(b0, f.hi[0], f.lo[0]);
  split_tf32(b1, f.hi[1], f.lo[1]);
  return f;
}

// c += a b (one TF32 product)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b (one TF32 product, from a zero accumulator)
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  const float z = 0.f;
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(z));
}

// d = a * b in 3xTF32 from a zero accumulator, the small terms first: a
// chain of three products, short enough that the tensor core's truncation
// stays at fp32's own rounding.
__device__ __forceinline__ void mma3_zero(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32_zero(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

}  // namespace repro

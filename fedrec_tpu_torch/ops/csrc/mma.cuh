// Tensor-core building blocks for kernels A (the additive pool's logits), C
// and D (the text head), E (the user tower's backward) and F1 and F3 (flash
// forward, dk/dv backward): cp.async staging with zero fill, the TF32 split,
// and warp-level mma.sync.
//
// Precision. An f32 operand a is split as a_hi = tf32(a) (cvt.rna's rounding:
// nearest, ties away, 10 mantissa bits) and a_lo = tf32(a - a_hi); a product is then
// a_lo b_hi + a_hi b_lo + a_hi b_hi (three TF32 passes, the small terms
// first), and only a_lo b_lo (about 2^-22 |a b|) is dropped: about 2^-21
// relative per product, against TF32's 2^-11 for one pass. A bf16 value is
// exact in TF32 (8 mantissa bits), so it needs no low part.
//
// The tensor cores add each mma's products into the accumulator with
// truncation, not round-to-nearest, so a long sum kept in one accumulator
// drifts toward zero by up to an ulp of the running sum per mma. The callers
// therefore sum each staged chunk (32 products deep) in a fresh accumulator
// and add it into an f32 total with an ordinary round-to-nearest add
// (promote()): the drift is bounded by a chunk's partial sum, not the total.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace fedrec {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy 4 elements of T (8 or 16 bytes) to shared memory; zeros where !valid
template <typename T>
__device__ __forceinline__ void cp_async4(T* dst, const T* src, bool valid) {
  constexpr int kBytes = 4 * sizeof(T);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)), "l"(src),
               "n"(kBytes), "r"(valid ? kBytes : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// copy one 4-byte element (f32) to shared memory; zero where !valid
__device__ __forceinline__ void cp_async1(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// cvt.rna.tf32.f32's rounding (nearest, ties away from zero: add half of the
// dropped 13 bits' range to the magnitude, then clear them) in two integer
// ops. Bit-identical to the instruction for finite inputs (checked on the
// card, tests/test_torch_gpu.py), which ptxas expands into a longer sequence
// with special-value checks; the split runs for every fragment element.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// the instruction itself, for that check
__device__ __forceinline__ uint32_t tf32_cvt_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// An operand element for the TF32 mma: hi and lo parts (lo = 0 when exact).
struct Tf32Pair {
  uint32_t hi, lo;
};

__device__ __forceinline__ Tf32Pair split_tf32(float x) {
  const uint32_t hi = tf32_rna(x);
  return {hi, tf32_rna(x - __uint_as_float(hi))};
}

// d += a b, m16n8k8, TF32 operands, f32 accumulator. Not volatile: the
// compiler may interleave independent mmas.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b, m16n8k8, bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// d += a b, m16n8k16, bf16 operands (a: 4 registers of bf16 pairs, b: 2),
// f32 accumulator
__device__ __forceinline__ void mma_bf16_k16(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Pass p of a product in TF32 passes, small terms first: p = 0 a_lo b_hi,
// 1 a_hi b_lo, 2 a_hi b_hi. Three passes for f32 a and b; with a exact in
// TF32 (lo = 0) passes 1 and 2 alone. Callers run one pass over all their
// tiles before the next, so consecutive mmas do not wait on one accumulator.
__device__ __forceinline__ void mma_pass(float* d, const Tf32Pair* a, const Tf32Pair* b, int p) {
  const uint32_t av[4] = {p == 0 ? a[0].lo : a[0].hi, p == 0 ? a[1].lo : a[1].hi,
                          p == 0 ? a[2].lo : a[2].hi, p == 0 ? a[3].lo : a[3].hi};
  const uint32_t bv[2] = {p == 1 ? b[0].lo : b[0].hi, p == 1 ? b[1].lo : b[1].hi};
  mma_tf32(d, av, bv);
}

// total += chunk, then clear the chunk (round-to-nearest f32 adds)
template <int N>
__device__ __forceinline__ void promote(float (&total)[N], float (&chunk)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    total[i] += chunk[i];
    chunk[i] = 0.f;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// the f32 bits of a bf16 value: already a TF32 operand, exactly
__device__ __forceinline__ uint32_t bf16_tf32(__nv_bfloat16 v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(v)) << 16;
}

// An operand element from a staged value: an f32 value split into hi and
// lo; with EXACT (an f32 value known to be exact in TF32, such as one
// rounded to bf16) or a bf16 value, its bits and no low part.
template <bool EXACT = false>
__device__ __forceinline__ Tf32Pair tf32_op(float v) {
  if constexpr (EXACT) {
    return {__float_as_uint(v), 0u};
  } else {
    return split_tf32(v);
  }
}

template <bool EXACT = false>
__device__ __forceinline__ Tf32Pair tf32_op(__nv_bfloat16 v) {
  return {bf16_tf32(v), 0u};
}

}  // namespace fedrec

// TF32 tensor-core products at f32 accuracy (3xTF32), shared by the
// prefill flash kernel (flash_attention.cu) and the paged decode kernel
// (paged_attention.cu).
//
// Each f32 operand splits into big (x cut to TF32's 10 mantissa bits, exact
// in TF32) and small = x - big (exact in f32; the tensor core reads its top
// 10 bits), so big + small carries ~21 bits of x's mantissa and the product
// sums small * big + big * small + big * big. An operand that is exact in
// TF32 (a widened bf16 value) has small = 0, and its small term may be left
// out. Cutting instead of rounding with cvt.rna takes two instructions
// instead of three for an error of the same order.
#pragma once

#include <stdint.h>

namespace tc {

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// c += a * b, m16n8k8, TF32 operands, f32 accumulator
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b in 3xTF32 (the small terms first)
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
  mma_tf32(c, as, bb);
  mma_tf32(c, ab, bs);
  mma_tf32(c, ab, bb);
}

}  // namespace tc

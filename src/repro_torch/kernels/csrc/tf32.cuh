// Split-precision TF32 on the tensor cores: the helpers shared by the kernels
// that run f32 products as 2xTF32 or 3xTF32 mma.sync (retention_chunkwise.cu,
// flash_decode.cu's MLA mode).
#pragma once

#include <stdint.h>

namespace {

// x = hi + lo: hi is x rounded to TF32 (11 significant bits), lo the exact
// remainder.  The tensor cores read the top 19 bits of a TF32 operand, so lo
// carries half a TF32 ulp added and is rounded by that truncation.  Integer
// and f32 ALU ops only (no conversion-pipe cvt).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(x - __uint_as_float(h)) + 0x1000u;
}

// d += a . b, one m16n8k8 TF32 product (A row-major, B column-major).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a . b, into a fresh fragment (a zero accumulator operand).
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

}  // namespace

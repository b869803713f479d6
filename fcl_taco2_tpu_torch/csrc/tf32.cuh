// 3xTF32 products on Hopper's tensor cores: fp32 operands multiplied at
// about fp32 accuracy with mma.sync m16n8k8 TF32, shared by the port's
// kernels (csrc/pwg_stream.cu, csrc/ar_decode.cu).
//
// Each operand is split into TF32 halves, x ~ hi + lo: hi is x with the low
// 13 mantissa bits cleared (x truncated to TF32, so the tensor cores see an
// exact TF32 value whatever they do with low bits), x - hi is exact in fp32,
// and lo is that remainder truncated likewise (x to 2^-20 relative).  Then
// a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, three mma into one fp32
// accumulator, the two small terms first.  tests/test_torch_pwg_tf32.py and
// tests/test_torch_decoder_schedule.py emulate exactly this split.
#pragma once

#include <stdint.h>

constexpr uint32_t TF32_MASK = 0xffffe000u;

static __device__ __forceinline__ void split(float x, uint32_t& hi,
                                             uint32_t& lo) {
  hi = __float_as_uint(x) & TF32_MASK;
  lo = __float_as_uint(x - __uint_as_float(hi)) & TF32_MASK;
}

// c += a.b, one m16n8k8 TF32 tensor-core product (fp32 accumulate)
static __device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                                uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a.b in 3xTF32: the two small terms first, then hi.hi
static __device__ __forceinline__ void mma3(float c[4], const uint32_t ah[4],
                                            const uint32_t al[4],
                                            const uint32_t bh[2],
                                            const uint32_t bl[2]) {
  mma_tf32(c, al, bh[0], bh[1]);
  mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, ah, bh[0], bh[1]);
}

// Device code the port's recurrent kernels share (csrc/ar_decode.cu,
// csrc/attn_decode.cu): the activation layout, the prenet dropout's Philox,
// the cell's sigmoid and tanh, fragment loads, a warp's mma loop over K and
// the grid barrier.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "tf32.cuh"

namespace {

__host__ __device__ constexpr int r16(int x) { return (x + 15) / 16 * 16; }
__host__ __device__ constexpr int r32(int x) { return (x + 31) / 32 * 32; }

using bf16 = __nv_bfloat16;

// the activation type of a weight type: fp32 weights multiply fp32
// activations (3xTF32), bf16 weights and int8 codes bf16 ones
template <typename WT>
struct Act {
  using T = bf16;
};
template <>
struct Act<float> {
  using T = float;
};

// Position of logical column k in the fragment-ordered activation layout:
// within each group of 16, lane t's four values of a k16 step are adjacent
// at 4t..4t+3 (bf16: columns 2t, 2t+1, 2t+8, 2t+9; fp32, two k8 steps:
// t, t+4, t+8, t+12).  decoder_cuda.act_positions is the same map.
template <typename AT>
__device__ __forceinline__ int apos(int k);
template <>
__device__ __forceinline__ int apos<bf16>(int k) {
  const int r = k & 15, q = r & 7;
  return (k & ~15) + 4 * (q >> 1) + 2 * (r >> 3) + (q & 1);
}
template <>
__device__ __forceinline__ int apos<float>(int k) {
  const int r = k & 15;
  return (k & ~15) + 4 * (r & 3) + (r >> 2);
}

template <typename AT>
__device__ __forceinline__ AT to_act(float x);
template <>
__device__ __forceinline__ bf16 to_act<bf16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ float to_act<float>(float x) {
  return x;
}

// Philox4x32-10, first output word.
__device__ __forceinline__ uint32_t philox_bits(uint32_t seed, uint32_t c0,
                                                uint32_t c1, uint32_t c2) {
  uint32_t x0 = c0, x1 = c1, x2 = c2, x3 = 0u;
  uint32_t k0 = seed, k1 = 0x5BD1E995u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, x0), lo0 = 0xD2511F53u * x0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, x2), lo1 = 0xCD9E8D57u * x2;
    const uint32_t y0 = hi1 ^ x1 ^ k0, y2 = hi0 ^ x3 ^ k1;
    x0 = y0;
    x1 = lo1;
    x2 = y2;
    x3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return x0;
}

// Unsigned compare against floor((1-rate) * 2^32): keep probability 1-rate
// (rate 0 keeps everything, since no 32-bit value reaches 2^32).
__device__ __noinline__ bool prenet_keep(uint32_t seed, uint64_t thr,
                                            int row, int step, int layer,
                                            int unit, int units) {
  const uint32_t bits = philox_bits(seed, (uint32_t)row, (uint32_t)step,
                                    (uint32_t)(layer * units + unit));
  return (uint64_t)bits < thr;
}

// sigmoid and tanh from the fast exponential and divide: a few ulp, and
// little code in the cell update that every step runs once
__device__ __forceinline__ float sigmoid_f(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}
__device__ __forceinline__ float tanh_f(float x) {
  return 2.0f * sigmoid_f(2.0f * x) - 1.0f;
}

// ---- fragment loads -------------------------------------------------------

// A lane's four activations of one row and k16 step.  G: written by other
// blocks during this launch, so read through L2 (never the non-coherent L1).
template <typename AT, bool G>
struct ALoad;
template <bool G>
struct ALoad<bf16, G> {
  using F = uint2;
  static __device__ __forceinline__ F ld(const bf16* p) {
    if constexpr (G) return __ldcg(reinterpret_cast<const uint2*>(p));
    return *reinterpret_cast<const uint2*>(p);
  }
};
template <bool G>
struct ALoad<float, G> {
  using F = uint4;
  static __device__ __forceinline__ F ld(const float* p) {
    if constexpr (G) return __ldcg(reinterpret_cast<const uint4*>(p));
    return *reinterpret_cast<const uint4*>(p);
  }
};

// bf16 bits of two int8 codes (exact)
__device__ __forceinline__ uint32_t i8_pair(uint32_t w, int sh) {
  const int lo = (int)(w << (24 - sh)) >> 24;
  const int hi = (int)(w << (16 - sh)) >> 24;
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn((float)lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn((float)hi))
          << 16);
}

// A lane's B fragment of one n-tile and k16 step, from shared or global
// memory (weights are never written during a launch).
template <typename BT>
struct BLoad;
template <>
struct BLoad<bf16> {
  using F = uint2;
  static __device__ __forceinline__ F ld(const bf16* p) {
    return *reinterpret_cast<const uint2*>(p);
  }
};
template <>
struct BLoad<int8_t> {
  using F = uint2;
  static __device__ __forceinline__ F ld(const int8_t* p) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    return make_uint2(i8_pair(w, 0), i8_pair(w, 16));
  }
};
template <>
struct BLoad<float> {
  using F = uint4;
  static __device__ __forceinline__ F ld(const float* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// one k16 step of one m16 x n8 tile: bf16 ...
__device__ __forceinline__ void mma_step(float (&c)[4], uint2 lo, uint2 hi,
                                         uint2 b) {
  mma_bf16(c, lo.x, hi.x, lo.y, hi.y, b.x, b.y);
}
// ... or 3xTF32, two k8 steps (columns t, t+4 then t+8, t+12)
__device__ __forceinline__ void mma_step(float (&c)[4], uint4 lo, uint4 hi,
                                         uint4 b) {
  uint32_t ah[4], al[4], bh[2], bl[2];
  split(__uint_as_float(lo.x), ah[0], al[0]);
  split(__uint_as_float(hi.x), ah[1], al[1]);
  split(__uint_as_float(lo.y), ah[2], al[2]);
  split(__uint_as_float(hi.y), ah[3], al[3]);
  split(__uint_as_float(b.x), bh[0], bl[0]);
  split(__uint_as_float(b.y), bh[1], bl[1]);
  mma3(c, ah, al, bh, bl);
  split(__uint_as_float(lo.z), ah[0], al[0]);
  split(__uint_as_float(hi.z), ah[1], al[1]);
  split(__uint_as_float(lo.w), ah[2], al[2]);
  split(__uint_as_float(hi.w), ah[3], al[3]);
  split(__uint_as_float(b.z), bh[0], bl[0]);
  split(__uint_as_float(b.w), bh[1], bl[1]);
  mma3(c, ah, al, bh, bl);
}

// acc[n] += A . B(n-tile n) for one m16 tile over k16 steps [0, kgn), in
// step order.  A: the tile's fragment-ordered rows, lda elements apart.
// B: packed, n-tile n at B + n * bstride; tiles from nvalid on repeat tile
// nvalid - 1 (the caller drops their sums).  UNR steps of loads are issued
// before their products; the loops stay rolled so the code a phase runs
// once a step stays small.
template <typename AT, typename BT, int NT, int UNR, bool AG>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const AT* A,
                                         int lda, const BT* B, long bstride,
                                         int kgn, int nvalid = NT) {
  using AF = typename ALoad<AT, AG>::F;
  using BF = typename BLoad<BT>::F;
  const int lane = threadIdx.x & 31;
  const AT* pa = A + (long)(lane >> 2) * lda + 4 * (lane & 3);
  const BT* pb[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    pb[n] = B + (n < nvalid ? n : nvalid - 1) * bstride + lane * 4;
  int kg = 0;
#pragma unroll 1
  for (; kg + UNR <= kgn; kg += UNR) {
    AF a[UNR][2];
    BF b[UNR][NT];
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      a[u][0] = ALoad<AT, AG>::ld(pa + 16 * (kg + u));
      a[u][1] = ALoad<AT, AG>::ld(pa + 8L * lda + 16 * (kg + u));
#pragma unroll
      for (int n = 0; n < NT; ++n)
        b[u][n] = BLoad<BT>::ld(pb[n] + (long)(kg + u) * 128);
    }
#pragma unroll
    for (int u = 0; u < UNR; ++u)
#pragma unroll
      for (int n = 0; n < NT; ++n) mma_step(acc[n], a[u][0], a[u][1], b[u][n]);
  }
#pragma unroll 1
  for (; kg < kgn; ++kg) {
    const AF a0 = ALoad<AT, AG>::ld(pa + 16 * kg);
    const AF a1 = ALoad<AT, AG>::ld(pa + 8L * lda + 16 * kg);
#pragma unroll
    for (int n = 0; n < NT; ++n)
      mma_step(acc[n], a0, a1, BLoad<BT>::ld(pb[n] + (long)kg * 128));
  }
}

// ---- the grid barrier ------------------------------------------------------

// Every block adds one to the counter; barrier k of the launch waits for
// k * gridDim.x arrivals.  The block barrier orders the block's writes
// before thread 0's release add; its acquire load orders the other blocks'
// writes before the block barrier that ends the wait.
__device__ __forceinline__ void grid_sync(unsigned int* bar,
                                          unsigned int& target) {
  __syncthreads();
  target += gridDim.x;
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(bar)
                 : "memory");
    unsigned int v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(v)
                   : "l"(bar)
                   : "memory");
    } while (v < target);
  }
  __syncthreads();
}

}  // namespace

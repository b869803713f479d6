// Fused eval-mode AR decoder loop of FCL-taco2 for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of fcl_taco2_tpu/ops/decoder_pallas.py:
//   fused_ar_decode      (_kernel,     weights resident in VMEM, student)
//   fused_ar_decode_hbm  (_kernel_hbm, recurrent weights streamed, teacher,
//                         optional per-column int8 codes)
// Both compute the same step math; on Hopper neither model's decoder
// weights fit one SM's 227 KB of shared memory and both fit the 50 MB L2,
// so one kernel serves both entry points.  They differ only where the TPU
// kernels differ: the resident entry computes the step-invariant
// enc @ wx0_enc + bx0 and enc @ wf_enc itself (a prologue phase), the
// streaming entry receives them precomputed.
//
// Per step t (all P rows, dropout from a counter-based Philox keyed on
// (seed, row, step, layer, unit), so the draws do not depend on the tiling):
//   S1  p1 = drop(relu(prev @ W1 + b1))             prev = out[:, t-1] or 0
//   S2  p2 = drop(relu(p1 @ W2 + b2))
//   S3  g0 = enc_gates + p2 @ wx0_pre + pos_t * wx0_pos + h0 @ wh0 + bh0
//       (h0, c0) <- zoneout-blended LSTM update
//   S4  g1 = h0 @ wx1 + h1 @ wh1 + bx1 + bh1;  (h1, c1) <- update
//   S5  out[:, t] = h1 @ wf_z + enc_out
// One cooperative launch runs the whole loop; a grid-wide barrier separates
// the dependent phases.  Each phase is cut into tiles of TM rows x TU output
// columns; in S3/S4 a tile is TU hidden units with all four gate columns
// {j, H+j, 2H+j, 3H+j}, so each thread owns whole (row, unit) cells and
// updates c and h in registers.  Activations are rounded to the weight type
// before each product and accumulated in fp32, as the Pallas kernels' `mm`
// does; int8 codes ride as exact bf16 values and each matrix's sum is scaled
// once by its per-column scale.  Ragged mode: a row tile stops at its bound
// (bounds[row / 128], decoder_cuda.TILE) and its frames past the bound are
// zero.
//
// What bounds it on the H100.  Teacher (H=1024, prenet 256, odim 80) at the
// main path's P=96: a step reads 25.2 MB of streamed bf16 weights (12.6 MB
// as int8) plus 2.4 MB of resident ones and does 2.7 GFLOP; at 3.35 TB/s
// and 989 TFLOP/s bf16 that is 8.2 us of bytes against 2.7 us of tensor-core
// work, so the ideal kernel is bound by weight bytes (50 MB of L2 can hold
// the bf16 set across steps).  Student (H=256) at P=96: 2.9 MB (bf16) or
// 5.8 MB (fp32) of weights and 0.28 GFLOP a step, bound by bytes too.
// What the design does about it: no per-step launches and no activation
// round trips through the host; each block reads a weight chunk once per
// row tile and step, 16 bytes a thread with cp.async into a two-stage
// shared-memory ring, so the copy of chunk c+1 overlaps the products of
// chunk c instead of every thread waiting on its own L2 loads.  With bf16
// (or int8) weights the LSTM gate products, nearly all of a step's work,
// run on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate);
// fp32 weights, the small prenet and feat_out products stay on the CUDA
// cores.  What is left between this kernel and its bound is mostly the
// per-chunk barriers and the weight re-reads from L2 at every step and row
// tile; wider chunks, wgmma and keeping each block's slice of the streamed
// matrices in shared memory across steps are the next levers (PERF.md has
// the measured times).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

extern "C" {
// Field order and types mirror _DecodeArgs in ops/decoder_cuda.py.
struct DecodeArgs {
  const void* enc;        // (P, idim) f32, resident entry only
  void* enc_gates;        // (P, 4H) f32: input (streaming) or scratch (resident)
  void* enc_out;          // (P, odim) f32: likewise
  const void* pos;        // (P, D) f32
  const void* bounds;     // (ceil(P/128),) i32, ragged only
  const void* pre_w1;     // (odim, units) WT
  const void* pre_b1;     // (units,) f32
  const void* pre_w2;     // (units, units) WT
  const void* pre_b2;
  const void* wx0_pre;    // (units, 4H) WT
  const void* wx0_pos;    // (4H,) WT
  const void* bh0;        // (4H,) f32
  const void* wh0;        // (H, 4H) BT
  const void* wx1;        // (H, 4H) BT
  const void* wh1;        // (H, 4H) BT
  const void* bx1;
  const void* bh1;
  const void* wf_z;       // (H, odim) WT
  const void* wx0_enc;    // (idim, 4H) WT, resident only
  const void* bx0;        // (4H,) f32, resident only
  const void* wf_enc;     // (idim, odim) WT, resident only
  const void* scales;     // (3, 4H) f32, int8 only
  void* out;              // (P, D, odim) f32
  void* scratch;          // p1, p2 (P, units); h0 x2, c0, h1 x2, c1 (P, H)
  int P, D, idim, odim, units, H;
  int ragged, resident, quantized;
  float zoneout, dropout;
  unsigned int seed;
};
}

namespace {

constexpr int TU = 32;          // output columns (or units) per tile: a warp
constexpr int RG = 4;           // warps per block
constexpr int R = 4;            // rows per thread
constexpr int TM = RG * R;      // rows per tile
constexpr int KC = 32;          // contraction chunk staged in shared memory
constexpr int NT = TU * RG;     // threads per block
constexpr int BOUND_TILE = 128; // rows per ragged bound (decoder_cuda.TILE)

template <typename T>
__device__ __forceinline__ float load_w(const T* p, size_t i);
template <>
__device__ __forceinline__ float load_w<float>(const float* p, size_t i) {
  return p[i];
}
template <>
__device__ __forceinline__ float load_w<__nv_bfloat16>(const __nv_bfloat16* p,
                                                       size_t i) {
  return __bfloat162float(p[i]);
}
template <>
__device__ __forceinline__ float load_w<int8_t>(const int8_t* p, size_t i) {
  return static_cast<float>(p[i]);
}

// activation rounded to the (resident) weight type before a product
template <typename T>
__device__ __forceinline__ float act_cast(float x) {
  return x;
}
template <>
__device__ __forceinline__ float act_cast<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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
__device__ __forceinline__ bool prenet_keep(uint32_t seed, uint64_t thr,
                                            int row, int step, int layer,
                                            int unit, int units) {
  const uint32_t bits = philox_bits(seed, (uint32_t)row, (uint32_t)step,
                                    (uint32_t)(layer * units + unit));
  return (uint64_t)bits < thr;
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared memory of one block: two stages of an A chunk (TM x KC fp32,
// rows KA apart so the tensor-core fragment loads spread over the banks),
// two stages of a W chunk (KC x NG x TU elements, at most fp32 with
// NG = 4), and the gate tile that the tensor-core path hands back
// (TM x 4 x TU fp32).
constexpr int KA = KC + 4;
struct Smem {
  alignas(16) float a[2][TM * KA];
  alignas(16) unsigned char w[2][KC * 4 * TU * 4];
  float c[TM * 4 * TU];
};

// True when every 16-byte copy of stage_chunk is aligned.
template <typename WT>
__device__ __forceinline__ bool vec_ok(const float* A, long lda, int K,
                                       const WT* W, int ldw, int ncols,
                                       int gstride) {
  constexpr int VEC = 16 / sizeof(WT);
  return ((reinterpret_cast<uintptr_t>(W) & 15) == 0) && ldw % VEC == 0 &&
         gstride % VEC == 0 && ncols % VEC == 0 &&
         ((reinterpret_cast<uintptr_t>(A) & 15) == 0) && lda % 4 == 0 &&
         K % 4 == 0;
}

// Stage chunk c (rows k0 .. k0+KC of A's tile rows and of W's tile
// columns col0 + [0, TU) in each of NG groups gstride apart) into buffer
// buf, with cp.async through L2 (A was written by earlier phases, so never
// through the non-coherent L1) or, where not 16-byte aligned, plain loads.
// Entries past nrows, K or ncols are left as they were.
template <int NG, typename WT>
__device__ __forceinline__ void stage_chunk(Smem& sm, int buf, int c,
                                            const float* A, long lda,
                                            int row0, int nrows, int K,
                                            const WT* W, int ldw, int col0,
                                            int ncols, int gstride,
                                            bool vec) {
  constexpr int VEC = 16 / sizeof(WT);  // W elements per 16-byte copy
  constexpr int SEG = TU / VEC;         // copies per (k, g) row segment
  const int k0 = c * KC, kc = min(KC, K - k0);
  WT* sw = reinterpret_cast<WT*>(sm.w[buf]);
  float* sa = sm.a[buf];
  if (vec) {
    for (int i = threadIdx.x; i < KC * NG * SEG; i += NT) {
      const int k = i / (NG * SEG), g = (i / SEG) % NG, v = i % SEG;
      const int cc = col0 + v * VEC;
      if (k < kc && cc < ncols)
        cp_async16(sw + (k * NG + g) * TU + v * VEC,
                   W + (size_t)(k0 + k) * ldw + (size_t)g * gstride + cc);
    }
    for (int i = threadIdx.x; i < TM * (KC / 4); i += NT) {
      const int r = i / (KC / 4), v = i % (KC / 4);
      if (r < nrows && v * 4 < kc)
        cp_async16(sa + r * KA + v * 4,
                   A + (long)(row0 + r) * lda + k0 + v * 4);
    }
  } else {
    for (int i = threadIdx.x; i < KC * NG * TU; i += NT) {
      const int k = i / (NG * TU), g = (i / TU) % NG, l = i % TU;
      if (k < kc && col0 + l < ncols)
        sw[i] = W[(size_t)(k0 + k) * ldw + (size_t)g * gstride + col0 + l];
    }
    for (int i = threadIdx.x; i < TM * KC; i += NT) {
      const int r = i / KC, k = i % KC;
      if (r < nrows && k < kc)
        sa[r * KA + k] = __ldcg(A + (long)(row0 + r) * lda + k0 + k);
    }
  }
  cp_async_commit();
}

// Wait for chunk c, staged two deep: chunk c+1 is in flight while the
// block multiplies chunk c.  The caller closes each chunk with a barrier,
// after which the other buffer may be overwritten.
template <int NG, typename WT>
__device__ __forceinline__ void next_chunk(Smem& sm, int c, int nchunks,
                                           const float* A, long lda,
                                           int row0, int nrows, int K,
                                           const WT* W, int ldw, int col0,
                                           int ncols, int gstride,
                                           bool vec) {
  if (c == 0)
    stage_chunk<NG, WT>(sm, 0, 0, A, lda, row0, nrows, K, W, ldw, col0,
                        ncols, gstride, vec);
  if (c + 1 < nchunks) {
    stage_chunk<NG, WT>(sm, (c + 1) & 1, c + 1, A, lda, row0, nrows, K, W,
                        ldw, col0, ncols, gstride, vec);
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
}

// acc[g][r] += sum_k cast(A[row0 + warp*R + r, k]) * W[k, col0 + lane +
// g*gstride] for k < K, on the CUDA cores in fp32.  Every thread of the
// block must call it (it holds __syncthreads); columns past ncols are
// never read and their sums are garbage the caller drops.
template <int NG, typename AT, typename WT>
__device__ __forceinline__ void mm_tile(float (&acc)[NG][R], Smem& sm,
                                        const float* A, long lda, int row0,
                                        int nrows, int K, const WT* W,
                                        int ldw, int col0, int ncols,
                                        int gstride) {
  const int lane = threadIdx.x % TU, warp = threadIdx.x / TU;
  const bool col_ok = col0 + lane < ncols;
  const bool vec = vec_ok(A, lda, K, W, ldw, ncols, gstride);
  const int nchunks = (K + KC - 1) / KC;
  for (int c = 0; c < nchunks; ++c) {
    next_chunk<NG, WT>(sm, c, nchunks, A, lda, row0, nrows, K, W, ldw, col0,
                       ncols, gstride, vec);
    if (col_ok) {
      const int kc = min(KC, K - c * KC);
      const WT* sw = reinterpret_cast<const WT*>(sm.w[c & 1]);
      const float* sa = sm.a[c & 1];
#pragma unroll 4
      for (int k = 0; k < kc; ++k) {
        float w[NG];
#pragma unroll
        for (int g = 0; g < NG; ++g)
          w[g] = load_w<WT>(sw, (k * NG + g) * TU + lane);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float a = act_cast<AT>(sa[(warp * R + r) * KA + k]);
#pragma unroll
          for (int g = 0; g < NG; ++g) acc[g][r] = fmaf(a, w[g], acc[g][r]);
        }
      }
    }
    __syncthreads();
  }
}

// bf16 bits of a staged weight (int8 codes are exact in bf16)
template <typename WT>
__device__ __forceinline__ uint32_t w_bits(const WT* sw, int i);
template <>
__device__ __forceinline__ uint32_t w_bits<__nv_bfloat16>(
    const __nv_bfloat16* sw, int i) {
  return __bfloat16_as_ushort(sw[i]);
}
template <>
__device__ __forceinline__ uint32_t w_bits<int8_t>(const int8_t* sw, int i) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(static_cast<float>(sw[i])));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// True when the gate products can take the tensor-core path: K in whole
// k16 steps and aligned 16-byte staging.
template <typename WT>
__device__ __forceinline__ bool tc_ok(const float* A, long lda, int K,
                                      const WT* W, int ldw, int ncols,
                                      int gstride) {
  return K % 16 == 0 && vec_ok(A, lda, K, W, ldw, ncols, gstride);
}

// The LSTM gate tile of mm_tile<4> on the tensor cores: bf16 x bf16
// products (activations rounded to bf16 as in mm_tile, int8 codes exact),
// fp32 accumulation with mma.sync m16n8k16.  Warp w computes gate w's 32
// columns for all TM = 16 rows (four n8 blocks); the tile goes through
// shared memory to the (row, unit) layout of mm_tile, so the caller's LSTM
// update is the same on both paths.  Needs tc_ok().
template <typename WT>
__device__ __forceinline__ void mm_tile_tc(float (&acc)[4][R], Smem& sm,
                                           const float* A, long lda,
                                           int row0, int nrows, int K,
                                           const WT* W, int ldw, int col0,
                                           int ncols, int gstride) {
  const int lane = threadIdx.x % TU, warp = threadIdx.x / TU;
  const int gid = lane >> 2, tig = lane & 3;
  const int nchunks = (K + KC - 1) / KC;
  float c[4][4] = {};
  for (int ch = 0; ch < nchunks; ++ch) {
    next_chunk<4, WT>(sm, ch, nchunks, A, lda, row0, nrows, K, W, ldw, col0,
                      ncols, gstride, true);
    const int kc = min(KC, K - ch * KC);
    const WT* sw = reinterpret_cast<const WT*>(sm.w[ch & 1]);
    const float* sa = sm.a[ch & 1];
    for (int ks = 0; ks < kc; ks += 16) {
      const float* a_lo = sa + gid * KA + ks + tig * 2;
      const float* a_hi = a_lo + 8 * KA;
      const uint32_t a[4] = {pack_bf16(a_lo[0], a_lo[1]),
                             pack_bf16(a_hi[0], a_hi[1]),
                             pack_bf16(a_lo[8], a_lo[9]),
                             pack_bf16(a_hi[8], a_hi[9])};
      const int k0 = ks + tig * 2;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const int n = nb * 8 + gid;
        auto at = [&](int k) { return (k * 4 + warp) * TU + n; };
        const uint32_t b0 = w_bits<WT>(sw, at(k0)) |
                            (w_bits<WT>(sw, at(k0 + 1)) << 16);
        const uint32_t b1 = w_bits<WT>(sw, at(k0 + 8)) |
                            (w_bits<WT>(sw, at(k0 + 9)) << 16);
        mma_bf16(c[nb], a, b0, b1);
      }
    }
    __syncthreads();
  }
  // C fragment (row gid / gid+8, column nb*8 + tig*2 + {0,1}) -> sm.c
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) {
    const int col = nb * 8 + tig * 2;
    sm.c[(gid * 4 + warp) * TU + col] = c[nb][0];
    sm.c[(gid * 4 + warp) * TU + col + 1] = c[nb][1];
    sm.c[((gid + 8) * 4 + warp) * TU + col] = c[nb][2];
    sm.c[((gid + 8) * 4 + warp) * TU + col + 1] = c[nb][3];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int r = 0; r < R; ++r)
      acc[g][r] += sm.c[((warp * R + r) * 4 + g) * TU + lane];
  __syncthreads();
}

// The gate products of the LSTM phases: tensor cores for bf16 resident
// weights (activations are rounded to bf16 either way), CUDA cores for
// fp32 weights or operands the tensor-core staging cannot take.
template <typename WT, typename BT>
__device__ __forceinline__ void mm_gates(float (&acc)[4][R], Smem& sm,
                                         const float* A, long lda, int row0,
                                         int nrows, int K, const BT* W,
                                         int ldw, int col0, int ncols,
                                         int gstride) {
  if constexpr (std::is_same<WT, __nv_bfloat16>::value) {
    if (tc_ok(A, lda, K, W, ldw, ncols, gstride)) {
      mm_tile_tc<BT>(acc, sm, A, lda, row0, nrows, K, W, ldw, col0, ncols,
                     gstride);
      return;
    }
  }
  mm_tile<4, WT, BT>(acc, sm, A, lda, row0, nrows, K, W, ldw, col0, ncols,
                     gstride);
}

// zoneout-blended LSTM cell update of one (row, unit); gt = (i, f, g, o)
__device__ __forceinline__ void lstm_update(const float (&gt)[4], float zo,
                                            float h_old, float* c,
                                            float* h_new) {
  const float c_old = *c;
  const float c_n = sigmoid_f(gt[1]) * c_old + sigmoid_f(gt[0]) * tanhf(gt[2]);
  const float h_n = sigmoid_f(gt[3]) * tanhf(c_n);
  const float keep = 1.0f - zo;
  *h_new = zo * h_old + keep * h_n;
  *c = zo * c_old + keep * c_n;
}

// WT: resident weight type (float or bf16), also the activation cast.
// BT: type of the three recurrent matrices wh0, wx1, wh1 (WT, or int8).
template <typename WT, typename BT>
__global__ void __launch_bounds__(NT) ar_decode_kernel(DecodeArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ Smem sm;

  const int P = a.P, D = a.D, H = a.H, G = 4 * H, U = a.units, O = a.odim;
  const int lane = threadIdx.x % TU, warp = threadIdx.x / TU;
  const long PH = (long)P * H;
  float* p1 = static_cast<float*>(a.scratch);
  float* p2 = p1 + (long)P * U;
  float* h0buf = p2 + (long)P * U;
  float* c0 = h0buf + 2 * PH;
  float* h1buf = c0 + PH;
  float* c1 = h1buf + 2 * PH;
  float* out = static_cast<float*>(a.out);
  float* enc_gates = static_cast<float*>(a.enc_gates);
  float* enc_out = static_cast<float*>(a.enc_out);
  const float* pos = static_cast<const float*>(a.pos);
  const int* bounds = static_cast<const int*>(a.bounds);
  const float* pre_b1 = static_cast<const float*>(a.pre_b1);
  const float* pre_b2 = static_cast<const float*>(a.pre_b2);
  const float* bh0 = static_cast<const float*>(a.bh0);
  const float* bx1 = static_cast<const float*>(a.bx1);
  const float* bh1 = static_cast<const float*>(a.bh1);
  const float* scales = static_cast<const float*>(a.scales);
  const WT* pre_w1 = static_cast<const WT*>(a.pre_w1);
  const WT* pre_w2 = static_cast<const WT*>(a.pre_w2);
  const WT* wx0_pre = static_cast<const WT*>(a.wx0_pre);
  const WT* wx0_pos = static_cast<const WT*>(a.wx0_pos);
  const WT* wf_z = static_cast<const WT*>(a.wf_z);
  const BT* wh0 = static_cast<const BT*>(a.wh0);
  const BT* wx1 = static_cast<const BT*>(a.wx1);
  const BT* wh1 = static_cast<const BT*>(a.wh1);

  const float drop_scale = 1.0f / (1.0f - a.dropout);
  const uint64_t drop_thr =
      (uint64_t)((1.0 - (double)a.dropout) * 4294967296.0);
  const bool use_drop = a.dropout > 0.0f;

  const int n_rt = (P + TM - 1) / TM;
  // a row tile lies inside one 128-row bound group (TM divides 128)
  auto rt_bound = [&](int rt) -> int {
    return a.ragged ? min(bounds[(rt * TM) / BOUND_TILE], D) : D;
  };
  int T = D;
  if (a.ragged) {
    T = 0;
    for (int b = 0; b < (P + BOUND_TILE - 1) / BOUND_TILE; ++b)
      T = max(T, min(bounds[b], D));
  }

  // ---- prologue: zero state and never-reached frames; enc projections
  const long gtid = (long)blockIdx.x * NT + threadIdx.x;
  const long gsize = (long)gridDim.x * NT;
  for (long i = gtid; i < PH; i += gsize) {
    h0buf[i] = 0.0f;
    c0[i] = 0.0f;
    h1buf[i] = 0.0f;
    c1[i] = 0.0f;
  }
  for (long i = gtid; i < (long)P * D * O; i += gsize) {
    const int r = (int)(i / ((long)D * O));
    const int t = (int)((i / O) % D);
    if (t >= rt_bound(r / TM)) out[i] = 0.0f;
  }
  if (a.resident) {
    const WT* wx0_enc = static_cast<const WT*>(a.wx0_enc);
    const WT* wf_enc = static_cast<const WT*>(a.wf_enc);
    const float* bx0 = static_cast<const float*>(a.bx0);
    const float* enc = static_cast<const float*>(a.enc);
    const int nct_g = (G + TU - 1) / TU, nct_o = (O + TU - 1) / TU;
    const int nct = nct_g + nct_o;
    for (int tile = blockIdx.x; tile < n_rt * nct; tile += gridDim.x) {
      const int rt = tile / nct, ct = tile % nct;
      const int row0 = rt * TM, nrows = min(TM, P - row0);
      const bool is_g = ct < nct_g;
      const int ncol = is_g ? G : O;
      const int col0 = (is_g ? ct : ct - nct_g) * TU, col = col0 + lane;
      const bool ok = col < ncol;
      float acc[1][R] = {};
      mm_tile<1, WT, WT>(acc, sm, enc, a.idim, row0, nrows, a.idim,
                         is_g ? wx0_enc : wf_enc, ncol, col0, ncol, 0);
      if (ok) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int row = row0 + warp * R + r;
          if (row >= P) continue;
          if (is_g)
            enc_gates[(long)row * G + col] = acc[0][r] + bx0[col];
          else
            enc_out[(long)row * O + col] = acc[0][r];
        }
      }
    }
  }
  grid.sync();

  const int nct_u = (U + TU - 1) / TU;
  const int nct_h = (H + TU - 1) / TU;
  const int nct_o = (O + TU - 1) / TU;
  for (int t = 0; t < T; ++t) {
    const float* h0_old = h0buf + (t & 1) * PH;
    float* h0_new = h0buf + ((t + 1) & 1) * PH;
    const float* h1_old = h1buf + (t & 1) * PH;
    float* h1_new = h1buf + ((t + 1) & 1) * PH;

    // S1, S2: prenet layers (always-on dropout)
    for (int layer = 0; layer < 2; ++layer) {
      const float* A = layer == 0 ? out + (long)(t - 1) * O : p1;
      const long lda = layer == 0 ? (long)D * O : U;
      const int K = layer == 0 ? O : U;
      const WT* W = layer == 0 ? pre_w1 : pre_w2;
      const float* b = layer == 0 ? pre_b1 : pre_b2;
      float* dst = layer == 0 ? p1 : p2;
      for (int tile = blockIdx.x; tile < n_rt * nct_u; tile += gridDim.x) {
        const int rt = tile / nct_u;
        if (t >= rt_bound(rt)) continue;  // block-uniform
        const int row0 = rt * TM, nrows = min(TM, P - row0);
        const int col0 = (tile % nct_u) * TU, col = col0 + lane;
        const bool ok = col < U;
        float acc[1][R] = {};
        if (layer == 1 || t > 0)  // prev is all zeros at t = 0
          mm_tile<1, WT, WT>(acc, sm, A, lda, row0, nrows, K, W, U, col0, U,
                             0);
        if (!ok) continue;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int row = row0 + warp * R + r;
          if (row >= P) continue;
          float v = fmaxf(acc[0][r] + b[col], 0.0f);
          if (use_drop)
            v *= prenet_keep(a.seed, drop_thr, row, t, layer, col, U)
                     ? drop_scale
                     : 0.0f;
          dst[(long)row * U + col] = v;
        }
      }
      grid.sync();
    }

    // S3, S4: the two zoneout-LSTM layers
    for (int layer = 0; layer < 2; ++layer) {
      for (int tile = blockIdx.x; tile < n_rt * nct_h; tile += gridDim.x) {
        const int rt = tile / nct_h;
        if (t >= rt_bound(rt)) continue;  // block-uniform
        const int row0 = rt * TM, nrows = min(TM, P - row0);
        const int j0 = (tile % nct_h) * TU, j = j0 + lane;
        const bool ok = j < H;
        float acc[4][R] = {};
        float accb[4][R] = {};
        if (layer == 0) {
          mm_gates<WT, WT>(acc, sm, p2, U, row0, nrows, U, wx0_pre, G, j0,
                             H, H);
          mm_gates<WT, BT>(accb, sm, h0_old, H, row0, nrows, H, wh0, G, j0,
                             H, H);
        } else {
          mm_gates<WT, BT>(acc, sm, h0_new, H, row0, nrows, H, wx1, G, j0,
                             H, H);
          mm_gates<WT, BT>(accb, sm, h1_old, H, row0, nrows, H, wh1, G, j0,
                             H, H);
        }
        if (!ok) continue;
        float sa[4], sb[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const int cg_ = g * H + j;
          sa[g] = (a.quantized && layer == 1) ? scales[G + cg_] : 1.0f;
          sb[g] = a.quantized ? scales[(layer == 0 ? 0 : 2) * G + cg_] : 1.0f;
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int row = row0 + warp * R + r;
          if (row >= P) continue;
          float gt[4];
          if (layer == 0) {
            const float pt = pos[(long)row * D + t];
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              const int cg_ = g * H + j;
              gt[g] = __ldcg(enc_gates + (long)row * G + cg_) + acc[g][r] +
                      pt * load_w<WT>(wx0_pos, cg_) + accb[g][r] * sb[g] +
                      bh0[cg_];
            }
            lstm_update(gt, a.zoneout, h0_old[(long)row * H + j],
                        c0 + (long)row * H + j, h0_new + (long)row * H + j);
          } else {
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              const int cg_ = g * H + j;
              gt[g] = bx1[cg_] + bh1[cg_] + acc[g][r] * sa[g] +
                      accb[g][r] * sb[g];
            }
            lstm_update(gt, a.zoneout, h1_old[(long)row * H + j],
                        c1 + (long)row * H + j, h1_new + (long)row * H + j);
          }
        }
      }
      grid.sync();
    }

    // S5: feat_out; the frame is the next step's prenet input
    for (int tile = blockIdx.x; tile < n_rt * nct_o; tile += gridDim.x) {
      const int rt = tile / nct_o;
      if (t >= rt_bound(rt)) continue;  // block-uniform
      const int row0 = rt * TM, nrows = min(TM, P - row0);
      const int col0 = (tile % nct_o) * TU, col = col0 + lane;
      const bool ok = col < O;
      float acc[1][R] = {};
      mm_tile<1, WT, WT>(acc, sm, h1_new, H, row0, nrows, H, wf_z, O, col0, O,
                         0);
      if (!ok) continue;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = row0 + warp * R + r;
        if (row >= P) continue;
        out[(long)row * D * O + (long)t * O + col] =
            acc[0][r] + __ldcg(enc_out + (long)row * O + col);
      }
    }
    grid.sync();
  }
}

__global__ void dropout_mask_kernel(uint32_t seed, float rate, int rows,
                                    int units, int step, int layer,
                                    float* out) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)rows * units) return;
  const uint64_t thr = (uint64_t)((1.0 - (double)rate) * 4294967296.0);
  const int row = (int)(i / units), unit = (int)(i % units);
  out[i] = prenet_keep(seed, thr, row, step, layer, unit, units)
               ? 1.0f / (1.0f - rate)
               : 0.0f;
}

template <typename WT, typename BT>
int launch(const DecodeArgs* a, cudaStream_t stream, int* grid_out) {
  auto kern = ar_decode_kernel<WT, BT>;
  int dev = 0, sms = 0, coop = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  // cooperative launch needs every block co-resident: size the grid from
  // the occupancy calculator, capped at the widest phase's tile count
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, NT, 0);
  if (e != cudaSuccess) return e;
  if (occ < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int n_rt = (a->P + TM - 1) / TM;
  const int tiles = n_rt * ((a->H + TU - 1) / TU);
  const int grid = max(1, min(min(occ, 4) * sms, tiles));
  *grid_out = grid;
  void* params[] = {const_cast<DecodeArgs*>(a)};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                  dim3(grid), dim3(NT), params, 0, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// wkind: 0 = fp32 weights, 1 = bf16 weights, 2 = bf16 resident + int8
// streamed.  Returns a cudaError_t (0 on success); *grid_out gets the
// number of blocks launched.
int ar_decode_launch(const DecodeArgs* a, int wkind, void* stream,
                     int* grid_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (wkind) {
    case 0:
      return launch<float, float>(a, s, grid_out);
    case 1:
      return launch<__nv_bfloat16, __nv_bfloat16>(a, s, grid_out);
    case 2:
      return launch<__nv_bfloat16, int8_t>(a, s, grid_out);
    default:
      return cudaErrorInvalidValue;
  }
}

// The kernel's prenet keep mask, scaled by 1/(1-rate), for one (step,
// layer): (rows, units) f32.  For statistics checks of the dropout.
int dropout_mask_launch(unsigned int seed, float rate, int rows, int units,
                        int step, int layer, float* out, void* stream) {
  const long n = (long)rows * units;
  const int threads = 256;
  const int blocks = (int)((n + threads - 1) / threads);
  dropout_mask_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(
                                                stream)>>>(
      seed, rate, rows, units, step, layer, out);
  return cudaGetLastError();
}

}  // extern "C"

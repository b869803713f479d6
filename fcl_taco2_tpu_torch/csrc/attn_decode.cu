// Tacotron2's attention decoder loop for Hopper (sm_90a): every step of a
// call's utterances, attention included, in one launch.
//
// Replaces no TPU kernel: the JAX package has no attention decoder.  It is
// the loop of models/tacotron2.py (espnet's Tacotron2 with location-
// sensitive attention), behind ops/attn_decode_cuda.py, whose docstring
// gives the per-step equations and whose attn_decode_plain is the same
// arithmetic in PyTorch.
//
// What bounds it on the H100.  A step is a chain of dependent reductions:
// the query (h0 of the last step, 1024 -> 512), the energies over every
// position (the folded location filter, tanh, the dot with gvec), each
// row's softmax, the context, then LSTM 0, whose input holds the context,
// so nothing of the attention can be hoisted out of the loop (the SA
// kernel, csrc/ar_decode.cu, hoists enc @ wx0_enc).  At batch 16 a step is
// ~0.56 GFLOP (0.6 us at the bf16 peak) over ~33 MB of bf16 weights, and
// the loop runs the whole utterance (up to ~950 steps), so its time is the
// latency of that chain, not the card's rates.
//
// What the design does about it:
// - One block a slice of UB = 8 hidden units (128 blocks at dunits 1024,
//   one an SM, a cooperative launch).  A block keeps its slice of wh0, wx1
//   and wh1 (all four gates of its units, 3 x 64 KB bf16) in shared memory
//   for the whole launch.  The rest does not fit beside them: LSTM 0's
//   input matrix ([att_c | p], 768 x 4096, 6 MB) and the query projection
//   (1 MB) are read from global memory every step, where they stay in L2
//   (50 MB), each block its own columns.
// - A block multiplies a 16-row tile with the K dimension split evenly
//   over its 8 warps, and adds the warps' sums in warp order, so a row's
//   result depends on neither the timing nor the other rows.  A warp's
//   share is a few k16 steps, so it issues the loads of up to 8 steps
//   before their products: a phase waits on L2 once or twice, not once a
//   step.  The jobs of a phase that do not wait on each other go to
//   different blocks (energies from the first block, the frame's and the
//   prenet's jobs from the last).  The gate columns of a slice are
//   unit-major (ops/decoder_cuda.py::gate_order), so a lane holds two gates
//   of one unit and one shuffle completes the cell.
// - Four grid barriers a step, the chain's reductions between them, the
//   work that does not wait on the chain beside it:
//     1. LSTM 1 of step t-1 | the query q(t) = h0(t-1) @ W_dec
//     2. the energies e(t) (a job a row and 16 positions: the location
//        term as a Toeplitz product of w_cum with the folded filter on the
//        tensor cores, then tanh and gvec) | out(t-1) and the stop logit
//        | the prenet's dropout bits of step t (a word a warp)
//     3. each row's softmax and context (a job a row and 128 channels),
//        the w_cum update | the prenet of step t | the stop decisions
//     4. LSTM 0 of step t
//   The softmax is the per-row barrier: a row's context waits for all its
//   energies (barrier 2), and LSTM 0 for every row's context (barrier 3).
// - The loop ends when every row has: rows end at their stop token within
//   their length bounds, or at a pinned length.  Every block decides the
//   same rows from the same stop logits after barrier 2, so all leave the
//   loop at the same step; block 0 alone records the lengths.
// - bf16 weights and activations in every product (mma.sync m16n8k16),
//   fp32 sums, fp32 h and c, fp32 energies, softmax and context.  The
//   prenet dropout is csrc/mma_common.cuh's Philox keyed on (seed, row,
//   step, layer, unit), the row being the utterance's index in the call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

extern "C" {
// Field order and types mirror AttnArgs in ops/attn_decode_cuda.py.
// Packed matrices are [n-tile][k16 step][lane][4] bf16 (decoder_cuda.pack_b).
struct AttnArgs {
  const void* enc;     // (B, T, E) bf16: the encoder's output
  const void* pe;      // (B, T, A) f32: enc @ W_enc + b_enc
  const void* ilens;   // (B,) i32
  const void* lo;      // (B,) i32: a row may end once it has lo frames
  const void* hi;      // (B,) i32: a row ends at hi frames (<= D)
  const void* seed;    // (1,) i32: the prenet dropout's seed
  const void* w_dec;   // W_dec^T (H x Ap) packed
  const void* m_loc;   // the folded location filter (taps x Ap) packed
  const void* g;       // (A,) f32: gvec
  const void* b_g;     // (1,) f32
  const void* w1;      // prenet (Op x Up) packed
  const void* b1;      // (U,) f32
  const void* w2;      // prenet (Up x Up) packed
  const void* b2;
  const void* wx0;     // LSTM 0's [att_c | p] rows ((Ep + Up) x 4H), gate order
  const void* wh0;     // (H x 4H) packed, gate order
  const void* wx1;
  const void* wh1;
  const void* bias0;   // (4H,) f32: bias_ih + bias_hh, PyTorch's gate order
  const void* bias1;
  const void* w_z;     // [W_feat; w_prob]^T rows [h1 | att_c] ((H + Ep) x Zp)
  const void* b_prob;  // (1,) f32
  void* hx0;           // bf16 2 x Bp x H: h0 by step parity, fragment order
  void* hx1;           // likewise h1
  void* xa;            // bf16 Bp x (Ep + Up): [att_c | p] of the step
  void* fa;            // bf16 Bp x Op: the last frame
  void* state;         // f32 4 x Bp x H: h0, c0, h1, c1
  void* q;             // f32 Bp x Ap
  void* e;             // f32 B x Tp: the energies
  void* w_cum;         // f32 B x Tp: the weights' running sum, set up
  void* len;           // (B,) i32: a row's frames once decided, else SENT
  void* barrier;       // u32, zero at launch
  void* out;           // (B, D, O) f32, zero at launch
  void* stop;          // (B, D) f32, zero at launch
  void* att;           // null, or (B, D, T) f32, zero at launch
  void* olens;         // (B,) i32
  void* steps;         // (1,) i32: the loop's steps
  void* kbits;         // u32 2 x Bp x Up / 32: the prenet's dropout bits
  int B, T, D, E, A, U, O, H, taps;
  float zoneout, dropout, thr_logit;
};

// What a launch did (the wrapper names the grid when a launch fails).
struct AttnLaunchInfo {
  int grid, block_threads, smem_bytes, barriers_per_step;
};
}

namespace {

constexpr int NW = 8;             // warps a block
constexpr int NTH = NW * 32;      // threads a block
constexpr int UB = 8;             // hidden units a block owns
constexpr int NTS = UB / 2;       // n-tiles of its gate columns (4 UB / 8)
constexpr int PJ = 8;             // prenet jobs a 16-row tile
constexpr int CCH = 128;          // context channels a job
constexpr int SENT = 0x7fffffff;  // a length not decided yet
constexpr int MAX_ROWS = NTH;     // one thread a row in the stop decisions
constexpr int MAX_POS = 256;      // positions (shared fp32 a position)
static_assert(NTH % CCH == 0, "the context's parts split the block");

struct Ctx {
  int B, T, Tp, D, E, Ep, A, Ap, U, Up, O, Op, H, n16, ldx;
  int kh, kx0, kz, kt, nz, pad;
  const bf16* enc;
  const float* pe;
  const int *ilens, *lo, *hi;
  uint32_t seed;
  uint64_t drop_thr;
  float drop_scale, zoneout, thr_logit;
  bool use_drop;
  const bf16 *w_dec, *m_loc, *w1, *w2, *wx0, *w_z;
  const bf16 *wh0, *wx1, *wh1;  // this block's slices, in shared memory
  const float *g, *b_g, *b1, *b2, *bias0, *bias1, *b_prob;
  bf16 *hx0, *hx1, *xa, *fa;
  float *h0f, *c0, *h1f, *c1, *q, *e, *wcum;
  int* len;
  float *out, *stop, *att;
  int *olens, *steps;
  float* red;           // shared: NW x NTS x 4 x 32 partial sums
  int* live;            // shared: MAX_ROWS flags
  uint32_t* kbits;      // the prenet's dropout bits: 2 x Bp x Up / 32
  uint32_t* keep;       // shared: a prenet job's rows of them, 2 x 16 x Up
  unsigned char* work;  // shared: a phase's scratch
};

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// acc[n] += A . B(n-tile n) over k16 steps [0, kgn) in step order, in
// rounds of UNR steps whose loads are all issued before their products
// (the last round predicated, so no step waits alone on its loads: a
// warp's few steps a phase are bound by the latency of L2, not by issue).
// A: fragment-ordered rows (AG: written in this launch, read through L2);
// B: packed, n-tile n at B + n * bstride, tiles from nvalid on repeating
// tile nvalid - 1.
template <int NT, int UNR, bool AG>
__device__ __forceinline__ void warp_rounds(float (&acc)[NT][4], const bf16* A,
                                            int lda, const bf16* B,
                                            long bstride, int kgn,
                                            int nvalid = NT) {
  const int lane = threadIdx.x & 31;
  const bf16* pa = A + (long)(lane >> 2) * lda + 4 * (lane & 3);
  const bf16* pb[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    pb[n] = B + (n < nvalid ? n : nvalid - 1) * bstride + lane * 4;
#pragma unroll 1
  for (int kg = 0; kg < kgn; kg += UNR) {
    uint2 a[UNR][2], b[UNR][NT];
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      if (kg + u < kgn) {
        a[u][0] = ALoad<bf16, AG>::ld(pa + 16 * (kg + u));
        a[u][1] = ALoad<bf16, AG>::ld(pa + 8L * lda + 16 * (kg + u));
#pragma unroll
        for (int n = 0; n < NT; ++n)
          b[u][n] = BLoad<bf16>::ld(pb[n] + (long)(kg + u) * 128);
      }
    }
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      if (kg + u < kgn) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
          mma_step(acc[n], a[u][0], a[u][1], b[u][n]);
      }
    }
  }
}

// acc += this warp's share of [A1 . B1 (k16 steps [0, n1)) ++ A2 . B2
// (n2)]: the concatenated steps split evenly over the warps, in order.
template <int NT, bool AG = true>
__device__ __forceinline__ void warp_share(float (&acc)[NT][4], const bf16* A1,
                                           int lda1, const bf16* B1, long bs1,
                                           int n1, const bf16* A2, int lda2,
                                           const bf16* B2, long bs2, int n2,
                                           int nvalid = NT) {
  const int w = threadIdx.x >> 5, n = n1 + n2;
  const int k0 = w * n / NW, k1 = (w + 1) * n / NW;
  const int e1 = min(k1, n1);
  if (k0 < e1)
    warp_rounds<NT, 8, AG>(acc, A1 + 16 * k0, lda1,
                                         B1 + (long)k0 * 128, bs1, e1 - k0,
                                         nvalid);
  const int s2 = max(k0, n1) - n1, e2 = k1 - n1;
  if (s2 < e2)
    warp_rounds<NT, 8, AG>(acc, A2 + 16 * s2, lda2,
                                         B2 + (long)s2 * 128, bs2, e2 - s2,
                                         nvalid);
}

// the warps' partial sums to shared memory, and one lane's sum over them
template <int NT>
__device__ __forceinline__ void stash(float* red, const float (&acc)[NT][4]) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e4 = 0; e4 < 4; ++e4)
      red[((w * NT + n) * 4 + e4) * 32 + lane] = acc[n][e4];
}
template <int NT>
__device__ __forceinline__ float gather(const float* red, int n, int e4) {
  const int lane = threadIdx.x & 31;
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < NW; ++w) s += red[((w * NT + n) * 4 + e4) * 32 + lane];
  return s;
}

// One LSTM layer for this block's UB units, every 16-row tile: the gates
// x @ Wx + h @ Wh + bias (x: kx k16 steps of Ax, Wx its slice at Bx; h: the
// layer's last state, Wh its slice in shared memory), then the zoneout
// cell update of (row, unit) by one lane, as ar_decode.cu's lstm_pair.
__device__ void lstm_slice(const Ctx& c, const bf16* Ax, int ldax,
                           const bf16* Bx, long bsx, int kx, const bf16* Ah,
                           const bf16* Bh, const float* bias, float* hf,
                           float* cf, bf16* hx_new) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  for (int mt = 0; mt < c.n16; ++mt) {
    const int row0 = mt * 16;
    float acc[NTS][4] = {};
    warp_share<NTS>(acc, Ax + (long)row0 * ldax, ldax, Bx, bsx, kx,
                    Ah + (long)row0 * c.H, c.H, Bh, (long)c.kh * 128, c.kh);
    stash<NTS>(c.red, acc);
    __syncthreads();
    if (warp < NTS) {
      // n-tile `warp` of the slice: units 2 warp, 2 warp + 1; a lane holds
      // gates 2 (tig & 1) + {0, 1} of unit (tig >> 1), rows gid, gid + 8
      const int j = blockIdx.x * UB + 2 * warp + (tig >> 1);
      float g[4];
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4)
        g[e4] = gather<NTS>(c.red, warp, e4) +
                bias[(2 * (tig & 1) + (e4 & 1)) * c.H + j];
      // even tig holds (i, f), odd tig (g, o): swap so the even lane
      // updates row gid and the odd lane row gid + 8
      const bool odd = tig & 1;
      const float s0 = __shfl_xor_sync(0xffffffffu, odd ? g[0] : g[2], 1);
      const float s1 = __shfl_xor_sync(0xffffffffu, odd ? g[1] : g[3], 1);
      const float gi = odd ? s0 : g[0], gf = odd ? s1 : g[1];
      const float gg = odd ? g[2] : s0, go = odd ? g[3] : s1;
      const int row = row0 + gid + (odd ? 8 : 0);
      if (row < c.B) {
        const long at = (long)row * c.H + j;
        const float c_old = cf[at], h_old = hf[at];
        const float c_n = sigmoid_f(gf) * c_old + sigmoid_f(gi) * tanh_f(gg);
        const float h_n = sigmoid_f(go) * tanh_f(c_n);
        const float keep = 1.0f - c.zoneout;
        const float h = c.zoneout * h_old + keep * h_n;
        cf[at] = c.zoneout * c_old + keep * c_n;
        hf[at] = h;
        hx_new[(long)row * c.H + apos<bf16>(j)] = to_act<bf16>(h);
      }
    }
    __syncthreads();
  }
}

// q = h0 @ W_dec: a job a (16-row tile, 8 columns)
__device__ void query_jobs(const Ctx& c, const bf16* h0) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int nq = c.Ap / 8, jobs = c.n16 * nq;
  for (int jb = blockIdx.x; jb < jobs; jb += gridDim.x) {
    const int row0 = jb / nq * 16, nt = jb % nq;
    float acc[1][4] = {};
    warp_share<1>(acc, h0 + (long)row0 * c.H, c.H,
                  c.w_dec + (long)nt * c.kh * 128, 0, c.kh, nullptr, 0,
                  c.w_dec, 0, 0);
    stash<1>(c.red, acc);
    __syncthreads();
    if (threadIdx.x < 32) {
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        const int row = row0 + gid + (e4 >> 1) * 8;
        const int col = nt * 8 + 2 * tig + (e4 & 1);
        const float v = gather<1>(c.red, 0, e4);
        if (row < c.B && col < c.A) c.q[(long)row * c.Ap + col] = v;
      }
    }
    __syncthreads();
  }
}

// e(t): a job a (row, 16 positions) of a row live at t - 1, placed chunk
// by chunk (positions 0-15 of every row on the first blocks), so the last
// blocks, which take the frame's jobs, see few.  The location term of
// position j0 + r is sum_k w_cum[j0 + r + k - pad] M[k]: a 16 x taps
// Toeplitz tile of one window of w_cum, read straight from shared memory
// into the A fragments, times the folded filter.  A warp takes ENT
// n-tiles of the attention's width at once, its pe, q and gvec loads
// issued before its products.
constexpr int ENT = 4;
__device__ void energy_jobs(const Ctx& c, int t) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nc = c.Tp / 16, jobs = c.B * nc, nwin = 16 + 16 * c.kt;
  const int nq = c.Ap / 8;
  bf16* win = reinterpret_cast<bf16*>(c.work);
  float* ered = reinterpret_cast<float*>(c.work + r16(2 * nwin));
  for (int jb = blockIdx.x; jb < jobs; jb += gridDim.x) {
    const int b = jb % c.B, j0 = jb / c.B * 16, il = c.ilens[b];
    if (j0 >= il || __ldcg(c.len + b) <= t - 1) continue;  // block-uniform
    for (int i = threadIdx.x; i < nwin; i += NTH) {
      const int pos = j0 - c.pad + i;
      win[i] = to_act<bf16>(pos >= 0 && pos < il
                                ? __ldcg(c.wcum + (long)b * c.Tp + pos)
                                : 0.0f);
    }
    __syncthreads();
    float part[2] = {0.0f, 0.0f};  // rows gid, gid + 8
    const float* qb = c.q + (long)b * c.Ap;
    const float* pr0 = c.pe + ((long)b * c.T + j0 + gid) * c.A;
    const float* pr1 = pr0 + 8L * c.A;
    const bool v0 = j0 + gid < il, v1 = j0 + gid + 8 < il;
    for (int nb = warp * ENT; nb < nq; nb += NW * ENT) {
      float acc[ENT][4] = {}, pv[ENT][4], qv[ENT][2], gv[ENT][2];
#pragma unroll
      for (int i = 0; i < ENT; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = (nb + i) * 8 + 2 * tig + e;
          const bool ok = nb + i < nq && d < c.A;
          qv[i][e] = ok ? __ldcg(qb + d) : 0.0f;
          gv[i][e] = ok ? c.g[d] : 0.0f;  // no weight: no share of e
          pv[i][e] = ok && v0 ? pr0[d] : 0.0f;
          pv[i][2 + e] = ok && v1 ? pr1[d] : 0.0f;
        }
      for (int kk = 0; kk < c.kt; ++kk) {
        const int k = 16 * kk + 2 * tig;
        // A[r][k] = win[r + k]: rows gid + 8 share the columns + 8
        const uint32_t a0 = pack_bf16(win[gid + k], win[gid + k + 1]);
        const uint32_t a1 = pack_bf16(win[gid + k + 8], win[gid + k + 9]);
        const uint32_t a3 = pack_bf16(win[gid + k + 16], win[gid + k + 17]);
#pragma unroll
        for (int i = 0; i < ENT; ++i) {
          const int nt = min(nb + i, nq - 1);
          const uint2 bw = *reinterpret_cast<const uint2*>(
              c.m_loc + ((long)nt * c.kt + kk) * 128 + lane * 4);
          mma_bf16(acc[i], a0, a1, a1, a3, bw.x, bw.y);
        }
      }
#pragma unroll
      for (int i = 0; i < ENT; ++i)
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4)
          part[e4 >> 1] += gv[i][e4 & 1] *
                           tanh_f(acc[i][e4] + pv[i][e4] + qv[i][e4 & 1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      part[h] += __shfl_xor_sync(0xffffffffu, part[h], 1);
      part[h] += __shfl_xor_sync(0xffffffffu, part[h], 2);
    }
    if (tig == 0) {
      ered[warp * 16 + gid] = part[0];
      ered[warp * 16 + gid + 8] = part[1];
    }
    __syncthreads();
    if (threadIdx.x < 16 && j0 + (int)threadIdx.x < il) {
      float s = 0.0f;
      for (int w = 0; w < NW; ++w) s += ered[w * 16 + threadIdx.x];
      c.e[(long)b * c.Tp + j0 + threadIdx.x] = s + c.b_g[0];
    }
    __syncthreads();
  }
}

// out(s) and stop(s) of step s = t - 1: a job a (16-row tile, 8 columns of
// [W_feat; w_prob]) over K = [h1 | att_c]; the frame also goes to the
// prenet's input, live rows' frames and logits to the outputs
__device__ void frame_jobs(const Ctx& c, int t) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int s = t - 1, jobs = c.n16 * c.nz;
  const bf16* h1 = c.hx1 + (long)(s & 1) * c.n16 * 16 * c.H;
  for (int jb = gridDim.x - 1 - blockIdx.x; jb < jobs; jb += gridDim.x) {
    const int row0 = jb / c.nz * 16, nt = jb % c.nz;
    const bf16* Bz = c.w_z + (long)nt * c.kz * 128;
    float acc[1][4] = {};
    warp_share<1>(acc, h1 + (long)row0 * c.H, c.H, Bz, 0, c.kh,
                  c.xa + (long)row0 * c.ldx, c.ldx, Bz + (long)c.kh * 128, 0,
                  c.Ep / 16);
    stash<1>(c.red, acc);
    __syncthreads();
    if (threadIdx.x < 32) {
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        const int row = row0 + gid + (e4 >> 1) * 8;
        const int col = nt * 8 + 2 * tig + (e4 & 1);
        const float v = gather<1>(c.red, 0, e4);
        if (row >= c.B) continue;
        const bool live = __ldcg(c.len + row) > s;
        if (col < c.O) {
          c.fa[(long)row * c.Op + apos<bf16>(col)] = to_act<bf16>(v);
          if (live) c.out[((long)row * c.D + s) * c.O + col] = v;
        } else if (col == c.O && live) {
          c.stop[(long)row * c.D + s] = v + c.b_prob[0];
        }
      }
    }
    __syncthreads();
  }
}

// The rows live at step t, into c.live; block 0 records the rows that end
// after step t - 1 (every block decides the same from the same logits).
// Returns how many are live.
__device__ int decide(const Ctx& c, int t) {
  const int b = threadIdx.x;
  bool live = false;
  if (b < c.B) {
    // a length < t was decided before; SENT or t (block 0 writing it now)
    // means the row was live at t - 1
    if (__ldcg(c.len + b) > t - 1) {
      const bool ends =
          t == 0 ? c.hi[b] <= 0
                 : t >= c.hi[b] ||
                       (t >= c.lo[b] &&
                        __ldcg(c.stop + (long)b * c.D + t - 1) >= c.thr_logit);
      live = !ends;
      if (ends && blockIdx.x == 0) c.len[b] = t;
    }
    c.live[b] = live;
  }
  return __syncthreads_count(live);
}

// alpha(t) = softmax(2 e(t)) of a live row and its context: a job a (row,
// CCH channels); the row's first job also updates w_cum and the weights'
// output
__device__ void context_jobs(const Ctx& c, int t) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int nch = (c.E + CCH - 1) / CCH, jobs = c.B * nch;
  float* al = reinterpret_cast<float*>(c.work);  // Tp
  float* cp = al + c.Tp;                         // NTH / CCH x CCH
  float* tot = cp + NTH;
  for (int jb = blockIdx.x; jb < jobs; jb += gridDim.x) {
    const int b = jb / nch, ch = jb % nch;
    if (!c.live[b]) continue;  // block-uniform
    const int il = c.ilens[b];
    for (int j = tid; j < il; j += NTH)
      al[j] = 2.0f * __ldcg(c.e + (long)b * c.Tp + j);
    __syncthreads();
    if (tid < 32) {
      float m = -__int_as_float(0x7f800000);  // -inf
      for (int j = lane; j < il; j += 32) m = fmaxf(m, al[j]);
      for (int o = 16; o; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float s = 0.0f;
      for (int j = lane; j < il; j += 32) {
        const float x = expf(al[j] - m);
        al[j] = x;
        s += x;
      }
      for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) tot[0] = s;
    }
    __syncthreads();
    const float sum = tot[0];
    for (int j = tid; j < il; j += NTH) al[j] = al[j] / sum;
    __syncthreads();
    if (ch == 0) {
      for (int j = tid; j < il; j += NTH) {
        const float a = al[j];
        float* w = c.wcum + (long)b * c.Tp + j;
        *w = t == 0 ? a : __ldcg(w) + a;
        if (c.att != nullptr) c.att[((long)b * c.D + t) * c.T + j] = a;
      }
    }
    const int dd = tid % CCH, part = tid / CCH, d = ch * CCH + dd;
    float acc = 0.0f;
    if (d < c.E) {
      const bf16* ep = c.enc + (long)b * c.T * c.E + d;
#pragma unroll 8
      for (int j = part; j < il; j += NTH / CCH)
        acc += al[j] * __bfloat162float(ep[(long)j * c.E]);
    }
    cp[part * CCH + dd] = acc;
    __syncthreads();
    if (tid < CCH && d < c.E) {
      float s = 0.0f;
      for (int p = 0; p < NTH / CCH; ++p) s += cp[p * CCH + tid];
      c.xa[(long)b * c.ldx + apos<bf16>(d)] = to_act<bf16>(s);
    }
    __syncthreads();
  }
}

// The prenet's dropout bits of step t for every row and both layers (bit
// u % 32 of word (layer, row, u / 32)), drawn in phase 2 a word a warp over
// the whole grid, so the prenet of phase 3 only tests them.
__device__ void dropout_bits(const Ctx& c, int t) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wpr = (c.Up + 31) / 32, words = 2 * c.n16 * 16 * wpr;
  if (!c.use_drop) return;
  for (int w = blockIdx.x * NW + warp; w < words; w += gridDim.x * NW) {
    const int layer = w / (c.n16 * 16 * wpr), row = w / wpr % (c.n16 * 16);
    const int u = w % wpr * 32 + lane;
    const bool kept =
        u < c.U && prenet_keep(c.seed, c.drop_thr, row, t, layer, u, c.U);
    const uint32_t bits = __ballot_sync(0xffffffffu, kept);
    if (lane == 0) c.kbits[w] = bits;
  }
}

// p(t) of a 16-row tile from the last frame: layer 1 whole in every job of
// the tile (shared memory; a warp's n-tiles w, w + NW, .. four at once),
// layer 2's n-tiles split over the PJ jobs, NTS at a time with K split
// over the warps
__device__ void prenet_jobs(const Ctx& c, int t) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int ko = c.Op / 16, ku = c.Up / 16, nu = c.Up / 8;
  bf16* sp1 = reinterpret_cast<bf16*>(c.work);  // 16 x Up
  const int wpr = (c.Up + 31) / 32;

  // relu, the dropout of (row, t, layer, col), and the bf16 store
  auto epi = [&](int layer, int row0, int nt, int e4, float acc) {
    const int r = gid + (e4 >> 1) * 8, row = row0 + r;
    const int col = nt * 8 + 2 * tig + (e4 & 1);
    float v = 0.0f;  // padded columns stay zero
    if (col < c.U) {
      v = fmaxf(acc + (layer ? c.b2 : c.b1)[col], 0.0f);
      if (c.use_drop)
        v *= (c.keep[(layer * 16 + r) * wpr + col / 32] >>
              (col % 32)) & 1u
                 ? c.drop_scale
                 : 0.0f;
    }
    if (layer)
      c.xa[(long)row * c.ldx + apos<bf16>(c.Ep + col)] = to_act<bf16>(v);
    else
      sp1[r * c.Up + apos<bf16>(col)] = to_act<bf16>(v);
  };
  for (int jb = gridDim.x - 1 - blockIdx.x; jb < c.n16 * PJ;
       jb += gridDim.x) {
    const int row0 = jb / PJ * 16, part = jb % PJ;
    if (c.use_drop) {  // the tile's dropout bits, both layers
      for (int i = threadIdx.x; i < 2 * 16 * wpr; i += NTH) {
        const int layer = i / (16 * wpr), r = i / wpr % 16;
        c.keep[i] = __ldcg(c.kbits + ((long)layer * c.n16 * 16 + row0 + r) *
                                         wpr + i % wpr);
      }
      __syncthreads();
    }
    for (int n0 = warp; n0 < nu; n0 += NW * 4) {
      const int nv = min(4, (nu - n0 + NW - 1) / NW);
      float acc[4][4] = {};
      warp_rounds<4, 8, true>(acc, c.fa + (long)row0 * c.Op, c.Op,
                              c.w1 + (long)n0 * ko * 128, (long)NW * ko * 128,
                              ko, nv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i < nv)
#pragma unroll
          for (int e4 = 0; e4 < 4; ++e4) epi(0, row0, n0 + NW * i, e4,
                                             acc[i][e4]);
    }
    __syncthreads();
    const int n1 = (part + 1) * nu / PJ;
    for (int nb = part * nu / PJ; nb < n1; nb += NTS) {
      const int nv = min(NTS, n1 - nb);
      float acc[NTS][4] = {};
      warp_share<NTS, false>(acc, sp1, c.Up, c.w2 + (long)nb * ku * 128,
                             (long)ku * 128, ku, nullptr, 0, c.w2, 0, 0, nv);
      stash<NTS>(c.red, acc);
      __syncthreads();
      if (warp < nv)
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4)
          epi(1, row0, nb + warp, e4, gather<NTS>(c.red, warp, e4));
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(NTH, 1) attn_decode_kernel(AttnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Ctx c;
  c.B = a.B;
  c.T = a.T;
  c.Tp = r16(a.T);
  c.D = a.D;
  c.E = a.E;
  c.Ep = r16(a.E);
  c.A = a.A;
  c.Ap = r16(a.A);
  c.U = a.U;
  c.Up = r16(a.U);
  c.O = a.O;
  c.Op = r16(a.O);
  c.H = a.H;
  c.n16 = (a.B + 15) / 16;
  c.ldx = c.Ep + c.Up;
  c.kh = a.H / 16;
  c.kx0 = c.ldx / 16;
  c.kz = (a.H + c.Ep) / 16;
  c.kt = r16(a.taps) / 16;
  c.nz = (a.O + 1 + 7) / 8;
  c.pad = (a.taps - 1) / 2;
  c.enc = static_cast<const bf16*>(a.enc);
  c.pe = static_cast<const float*>(a.pe);
  c.ilens = static_cast<const int*>(a.ilens);
  c.lo = static_cast<const int*>(a.lo);
  c.hi = static_cast<const int*>(a.hi);
  c.seed = (uint32_t)*static_cast<const int*>(a.seed);
  c.drop_thr = (uint64_t)((1.0 - (double)a.dropout) * 4294967296.0);
  c.drop_scale = 1.0f / (1.0f - a.dropout);
  c.use_drop = a.dropout > 0.0f;
  c.zoneout = a.zoneout;
  c.thr_logit = a.thr_logit;
  c.w_dec = static_cast<const bf16*>(a.w_dec);
  c.m_loc = static_cast<const bf16*>(a.m_loc);
  c.w1 = static_cast<const bf16*>(a.w1);
  c.w2 = static_cast<const bf16*>(a.w2);
  c.wx0 = static_cast<const bf16*>(a.wx0);
  c.w_z = static_cast<const bf16*>(a.w_z);
  c.g = static_cast<const float*>(a.g);
  c.b_g = static_cast<const float*>(a.b_g);
  c.b1 = static_cast<const float*>(a.b1);
  c.b2 = static_cast<const float*>(a.b2);
  c.bias0 = static_cast<const float*>(a.bias0);
  c.bias1 = static_cast<const float*>(a.bias1);
  c.b_prob = static_cast<const float*>(a.b_prob);
  c.hx0 = static_cast<bf16*>(a.hx0);
  c.hx1 = static_cast<bf16*>(a.hx1);
  c.xa = static_cast<bf16*>(a.xa);
  c.fa = static_cast<bf16*>(a.fa);
  const long PH = (long)c.n16 * 16 * c.H;
  float* st = static_cast<float*>(a.state);
  c.h0f = st;
  c.c0 = st + PH;
  c.h1f = st + 2 * PH;
  c.c1 = st + 3 * PH;
  c.q = static_cast<float*>(a.q);
  c.e = static_cast<float*>(a.e);
  c.wcum = static_cast<float*>(a.w_cum);
  c.len = static_cast<int*>(a.len);
  c.kbits = static_cast<uint32_t*>(a.kbits);
  c.out = static_cast<float*>(a.out);
  c.stop = static_cast<float*>(a.stop);
  c.att = static_cast<float*>(a.att);
  c.olens = static_cast<int*>(a.olens);
  c.steps = static_cast<int*>(a.steps);

  // this block's slices of wh0, wx1, wh1 ([n-tile][k16 step][lane][4], its
  // NTS n-tiles contiguous in the pack): shared memory for the launch
  const long wsz = (long)NTS * c.kh * 128;  // elements a matrix
  bf16* sw = reinterpret_cast<bf16*>(smem);
  const bf16* packs[3] = {static_cast<const bf16*>(a.wh0),
                          static_cast<const bf16*>(a.wx1),
                          static_cast<const bf16*>(a.wh1)};
  for (int m = 0; m < 3; ++m) {
    const uint4* src =
        reinterpret_cast<const uint4*>(packs[m] + blockIdx.x * wsz);
    uint4* dst = reinterpret_cast<uint4*>(sw + m * wsz);
    for (long i = threadIdx.x; i < wsz / 8; i += NTH) dst[i] = src[i];
  }
  c.wh0 = sw;
  c.wx1 = sw + wsz;
  c.wh1 = sw + 2 * wsz;
  c.red = reinterpret_cast<float*>(sw + 3 * wsz);
  c.live = reinterpret_cast<int*>(c.red + NW * NTS * 4 * 32);
  c.keep = reinterpret_cast<uint32_t*>(c.live + MAX_ROWS);
  // 2 x 16 rows of (Up + 31) / 32 words
  c.work = reinterpret_cast<unsigned char*>(c.keep + 32 * ((c.Up + 31) / 32));
  __syncthreads();

  unsigned int* bar = static_cast<unsigned int*>(a.barrier);
  unsigned int target = 0;
  const bf16* wx0 = c.wx0 + (long)NTS * blockIdx.x * c.kx0 * 128;
  for (int t = 0;; ++t) {
    const bf16* h0 = c.hx0 + (long)((t + 1) & 1) * PH;  // h0 of step t - 1
    // 1. LSTM 1 of step t - 1 | the query of step t
    if (t > 0)
      lstm_slice(c, h0, c.H, c.wx1, (long)c.kh * 128, c.kh,
                 c.hx1 + (long)(t & 1) * PH, c.wh1, c.bias1, c.h1f, c.c1,
                 c.hx1 + (long)((t + 1) & 1) * PH);
    query_jobs(c, h0);
    grid_sync(bar, target);
    // 2. the energies of step t | the frame and stop logit of step t - 1 |
    // the prenet's dropout bits of step t
    dropout_bits(c, t);
    energy_jobs(c, t);
    if (t > 0) frame_jobs(c, t);
    grid_sync(bar, target);
    // 3. the stop decisions; softmax and context | the prenet of step t
    if (decide(c, t) == 0) {
      if (blockIdx.x == 0) {
        // every row has ended: its thread wrote its length, or it was
        // written before
        for (int b = threadIdx.x; b < c.B; b += NTH) c.olens[b] = c.len[b];
        if (threadIdx.x == 0) c.steps[0] = t;
      }
      break;
    }
    context_jobs(c, t);
    prenet_jobs(c, t);
    grid_sync(bar, target);
    // 4. LSTM 0 of step t
    lstm_slice(c, c.xa, c.ldx, wx0, (long)c.kx0 * 128, c.kx0, h0, c.wh0,
               c.bias0, c.h0f, c.c0, c.hx0 + (long)(t & 1) * PH);
    grid_sync(bar, target);
  }
}

// Shared memory a block: its three weight slices, the warps' sums, the
// row flags, the prenet's dropout bits and the largest phase scratch
// (energies: the w_cum window and the warps' row sums; context: the
// weights and the parts' sums; prenet: one tile's p1).
size_t smem_bytes(const AttnArgs* a) {
  const size_t w = (size_t)3 * NTS * (a->H / 16) * 128 * sizeof(bf16);
  const size_t red = (size_t)NW * NTS * 4 * 32 * sizeof(float);
  const size_t live = (size_t)MAX_ROWS * sizeof(int) +
                      (size_t)32 * ((r16(a->U) + 31) / 32) * sizeof(uint32_t);
  const int nwin = 16 + r16(a->taps);
  size_t work = r16(2 * nwin) + NW * 16 * sizeof(float);
  const size_t ctx = ((size_t)r16(a->T) + NTH + 4) * sizeof(float);
  const size_t pre = (size_t)16 * r16(a->U) * sizeof(bf16);
  if (ctx > work) work = ctx;
  if (pre > work) work = pre;
  return w + red + live + work;
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success); *info describes the launch.
int attn_decode_launch(const AttnArgs* a, void* stream,
                       AttnLaunchInfo* info) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kern = attn_decode_kernel;
  if (a->H % 16 != 0 || a->B < 1 || a->B > MAX_ROWS || a->T < 1 ||
      r16(a->T) > MAX_POS || a->taps % 2 != 1)
    return cudaErrorInvalidValue;
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const size_t smem = smem_bytes(a);
  const int grid = a->H / UB;
  info->grid = grid;
  info->block_threads = NTH;
  info->smem_bytes = (int)smem;
  info->barriers_per_step = 4;
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NTH, smem);
  if (e != cudaSuccess) return e;
  // every block resident, the grid barrier's premise
  if (per_sm * sms < grid) return cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(NTH);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  AttnArgs args = *a;
  void* params[] = {&args};
  // the grid barriers need every block resident at once, which only the
  // cooperative launch guarantees: its error is the caller's
  e = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kern), params);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // extern "C"

// Fused eval-mode AR decoder loop of FCL-taco2 for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of fcl_taco2_tpu/ops/decoder_pallas.py:
//   fused_ar_decode      (_kernel :66, pallas_call :582; weights resident in
//                         VMEM, the student)
//   fused_ar_decode_hbm  (_kernel_hbm :170, pallas_call :485; recurrent
//                         weights streamed, the teacher, optional
//                         per-column int8 codes)
// One kernel serves both.  They differ only where the TPU kernels differ:
// the resident entry computes the step-invariant enc @ wx0_enc + bx0 and
// enc @ wf_enc itself (a prologue), the streaming entry receives them.
//
// Per step t (all P rows; dropout from a counter-based Philox keyed on
// (seed, row, step, layer, unit), so the draws do not depend on the tiling):
//   p1 = drop(relu(prev @ W1 + b1))              prev = out[:, t-1] or 0
//   p2 = drop(relu(p1 @ W2 + b2))
//   g0 = enc_gates + p2 @ wx0_pre + pos_t * wx0_pos + h0 @ wh0 + bh0
//        (h0, c0) <- zoneout-blended LSTM update
//   g1 = h0 @ wx1 + h1 @ wh1 + bx1 + bh1;  (h1, c1) <- update
//   out[:, t] = h1 @ wf_z + enc_out
// Activations are rounded to the weight type before each product and the
// products accumulate in fp32, as the Pallas kernels' `mm` does; int8 codes
// ride as exact bf16 values and each matrix's sum is scaled once by its
// per-column scale.  Ragged mode: rows stop at their tile's bound
// (bounds[row / 128], decoder_cuda.TILE) and frames past it are zero.
//
// What bounds it on the H100.  A step is a chain of five dependent
// products, so the loop is bound by the latency of moving each step's
// operands, not by the card's peak rates: the teacher (H = 1024, prenet
// 256, odim 80) does 2.7 GFLOP a step at P = 96 (2.7 us at the bf16 peak)
// and needs its 27 MB of bf16 gate weights every step.  Streaming them from
// L2 for every 16-row tile and step made the previous design ~100x slower
// than its bound.  The grid's 132 SMs hold 132 x 227 KB ~ 30 MB of shared
// memory together, Hopper's counterpart of the TPU's VMEM residency, and
// that is enough for the recurrent matrices.
//
// What the design does about it:
// - Weight-stationary: the blocks run as clusters of two, and a cluster
//   owns 2 UB hidden units of both LSTM layers, all four gate columns of
//   each.  Block rank r of the cluster keeps the K half r of its pair's
//   wx0_pre, wh0, wx1 and wh1 columns in shared memory for the whole launch
//   (teacher bf16: UB = 8, 128 blocks, 208 KB a block; int8 codes 112 KB;
//   student fp32: UB = 2, 32 KB), and reads only that half of the
//   activations, so each activation row crosses L2 once a pair, not once a
//   block.  The pair adds its halves through distributed shared memory:
//   each rank sends the partner the sums of the partner's units and
//   completes the cell update of its own, half 0 + half 1 in that order.
//   Where the halves do not fit (fp32 teacher weights, 416 KB a block) the
//   same code reads them from global memory each step ("streamed" mode).
//   Weights are packed by ops/decoder_cuda.py in mma B-fragment order, so
//   a lane reads its fragment of a k16 step with one 4-16 byte load.
// - Every product on tensor cores: bf16 mma.sync m16n8k16 for bf16 weights
//   and int8 codes (converted to exact bf16 in the fragment load), 3xTF32
//   m16n8k8 for fp32 weights (csrc/tf32.cuh), fp32 accumulation.
// - Activations are written once, in the type they are multiplied in and in
//   fragment order (each 16-column group permuted so a lane's four values
//   of a k16 step are adjacent): one 8 or 16 byte load a row and k16 step.
//   h and c stay fp32 beside them for the zoneout blend.
// - The gate columns of a slice are ordered unit-major (i, f, g, o of unit
//   0, then unit 1, ...), so a lane's accumulators hold two gates of one
//   unit and one shuffle with its neighbour completes the cell update in
//   registers.
// - Three grid-wide barriers a step: feat_out of step t-1 and the two
//   prenet layers of step t are row-local (h1 row -> frame -> p1 -> p2) and
//   run as one phase partitioned by 16-row tiles (feat_out's K split over
//   four warp pairs, added in a fixed order); LSTM 0 needs whole p2 rows
//   and LSTM 1 whole h0 rows.  The barrier is one arriving thread a block
//   (release add on a counter, acquire spin); every block is resident: a
//   cooperative launch with clusters where the driver takes one, and an
//   occupancy check always.  Data written by other blocks is read through
//   L2 (ld.global.cg).
// - A warp multiplies one m16 tile over its K half in a fixed order, so a
//   row's result does not depend on P or on its neighbours (StreamTTS's
//   chunked decode equals the one-shot path).  The k loops stay rolled:
//   the code a phase runs once a step has to come through the instruction
//   cache every step.
// What is left (PERF.md, scripts/torch_decoder_ablation.py): each step is
// a chain of L2 round trips, and the fused phase runs on one block per
// 16-row tile (6 of 128 blocks at P = 96); no wgmma.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_common.cuh"

extern "C" {
// Field order and types mirror DecodeArgs in ops/decoder_cuda.py.  Packed
// matrices are [n-tile][k16 step][lane][4] (decoder_cuda.pack_b): a K x N
// matrix with K padded to 16 and N to 8.
struct DecodeArgs {
  const void* enc;        // (P, idim) f32, resident entry only
  void* enc_gates;        // (P, 4H) f32: input (streaming) or output (resident)
  void* enc_out;          // (P, odim) f32: likewise
  const void* pos;        // (P, D) f32
  const void* bounds;     // (ceil(P/128),) i32, ragged only
  const void* w1k;        // pre_w1 (Op x Up) packed, WT
  const void* pre_b1;     // (units,) f32
  const void* w2k;        // pre_w2 (Up x Up) packed, WT
  const void* pre_b2;
  const void* wx0k;       // wx0_pre (Up x 4Hp) packed in gate order, WT
  const void* wx0_pos;    // (4H,) f32 (the WT-rounded weights)
  const void* bh0;        // (4H,) f32
  const void* wh0k;       // wh0 (Hp x 4Hp) packed in gate order, BT
  const void* wx1k;       // wx1, likewise
  const void* wh1k;       // wh1, likewise
  const void* bx1;
  const void* bh1;
  const void* wfk;        // wf_z (Hp x Op) packed, WT
  const void* wx0ek;      // wx0_enc (Ip x 4H) packed, WT, resident only
  const void* bx0;        // (4H,) f32, resident only
  const void* wfek;       // wf_enc (Ip x O) packed, WT, resident only
  const void* scales;     // (3, 4H) f32, int8 only
  void* out;              // (P, D, odim) f32
  void* scratch;          // activations and state (decoder_cuda._scratch_bytes)
  void* barrier;          // one u32, zero at launch
  void* trace;            // null, or (steps + 1) x 7 x grid u64 phase times
  const void* seed;       // (1,) i32: the prenet dropout's seed, read on the
                          // device (as the Pallas kernels read seed_ref), so
                          // a CUDA graph replays the seed drawn before it
  int P, D, idim, odim, units, H;
  int ragged, resident, quantized;
  int units_per_block;    // UB: 2, 4 or 8 (the pack's gate order)
  float zoneout, dropout;
};

// What a launch did, for the wrapper's log (decoder_cuda.last_launch).
struct LaunchInfo {
  int grid, block_threads, units_per_block, stationary, smem_bytes,
      barriers_per_step, prologue_barriers, cluster, cooperative, captured;
};
}

namespace cg = cooperative_groups;

namespace {

constexpr int NW = 8;            // warps a block
constexpr int NTH = NW * 32;     // threads a block
constexpr int BOUND_TILE = 128;  // rows per ragged bound (decoder_cuda.TILE)
constexpr int FEAT_NT = 10;      // feat_out n-tiles a round: 5 a warp half
static_assert(NW == 8, "feat_out splits K over 4 warp pairs");

// Shared memory before the weight halves: in the fused phase one 16-row
// tile's frame and p1 (AT) and the frame's fp32 sums; in the LSTM phases
// the sums a cluster's partner sends (NT8 n-tiles a warp).
__host__ __device__ inline int work_smem(int Op, int Up, int asize, int nt8) {
  const int row = 16 * (Op + Up) * asize + 16 * 8 * FEAT_NT * 4;
  const int pair = NW * nt8 * 4 * 32 * 4;
  return row > pair ? row : pair;
}

// Phase times for the ablation script's breakdown: event e of step t of
// this block (0 step start, 1 fused phase done, 2 after barrier 1, 3 LSTM 0
// done, 4 after barrier 2, 5 LSTM 1 done, 6 after barrier 3), in ns.
__device__ __forceinline__ void mark(unsigned long long* trace, int t,
                                     int e) {
  if (trace == nullptr) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    trace[((long)t * 7 + e) * gridDim.x + blockIdx.x] = ns;
  }
}

// ---- the kernel ------------------------------------------------------------

template <typename WT, typename BT>
struct Ctx {
  using AT = typename Act<WT>::T;
  int P, D, H, U, O, G, Hp, Up, Op, Ip, Pp, n16, T, UB;
  const int* bounds;
  bool ragged, quantized;
  float zoneout, drop_scale;
  uint64_t drop_thr;
  bool use_drop;
  uint32_t seed;
  const float *pos, *pre_b1, *pre_b2, *wx0_pos, *bh0, *bx1, *bh1, *scales;
  const WT *w1k, *w2k, *wfk;
  const float* enc_gates;
  const float* enc_out;
  float* out;
  AT *encA, *p2, *hx0, *hx1;  // hx*: two parity buffers of Pp x Hp
  float *h0f, *c0, *h1f, *c1;
  AT *sF, *sP1;  // shared: one 16-row tile's frame and p1
  float* sRed;   // shared: the frame's fp32 sums (16 x 8 FEAT_NT)

  __device__ int bound(int row) const {
    return ragged ? min(bounds[row / BOUND_TILE], D) : D;
  }
};

// One 16-row tile times a packed (K x 8 ntiles) matrix, the n-tiles dealt
// to the warps (warp w: w, w + NW, .., NTW of them in one pass over K, so
// they share its A fragments).  epi(n-tile, e4, sum) takes C element e4 of
// the lane's fragment.
template <typename AT, typename WT, int NTW, bool AG, typename Epi>
__device__ __forceinline__ void tile_product(const AT* A, int lda,
                                             const WT* B, int kg, int ntiles,
                                             Epi epi) {
  constexpr int UNR = sizeof(AT) == 4 ? 2 : 4;
  for (int n0 = threadIdx.x >> 5; n0 < ntiles; n0 += NW * NTW) {
    const int nv = min(NTW, (ntiles - n0 + NW - 1) / NW);
    float acc[NTW][4] = {};
    warp_mma<AT, WT, NTW, UNR, AG>(acc, A, lda, B + (long)n0 * kg * 128,
                                      (long)NW * kg * 128, kg, nv);
#pragma unroll
    for (int i = 0; i < NTW; ++i)
      if (i < nv)
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4) epi(n0 + NW * i, e4, acc[i][e4]);
  }
}

// feat_out of step t-1 (t > 0) and the prenet of step t (t < T) for 16-row
// tiles dealt round-robin to the blocks; all NW warps split the columns.
template <typename WT, typename BT>
__device__ void row_phase(const Ctx<WT, BT>& c, int t) {
  using AT = typename Act<WT>::T;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const AT* h1 = c.hx1 + (long)(t & 1) * c.Pp * c.Hp;  // h1 of step t-1
  for (int rt = blockIdx.x; rt < c.n16; rt += gridDim.x) {
    const int row0 = rt * 16, bnd = c.bound(row0);
    const bool feat = t > 0 && t - 1 < bnd;
    const bool pre = t < c.T && t < bnd;
    if (!feat && !pre) continue;  // block-uniform
    if (feat) {
      // 4 warp pairs split K in quarters, the two warps of a pair the
      // n-tiles of a round; the quarters' sums are added in quarter order
      // through shared memory, so the result does not depend on timing
      constexpr int UNR = sizeof(AT) == 4 ? 2 : 4;
      const int warp = threadIdx.x >> 5, q = warp >> 1, half = warp & 1;
      const int kg = c.Hp / 16, kq0 = q * kg / 4, kq1 = (q + 1) * kg / 4;
      for (int nb = 0; nb < c.Op / 8; nb += FEAT_NT) {
        const int n0 = nb + half * (FEAT_NT / 2);
        const int nv = min(FEAT_NT / 2, c.Op / 8 - n0);
        float acc[FEAT_NT / 2][4] = {};
        if (nv > 0)
          warp_mma<AT, WT, FEAT_NT / 2, UNR, true>(
              acc, h1 + (long)row0 * c.Hp + 16 * kq0, c.Hp,
              c.wfk + ((long)n0 * kg + kq0) * 128, (long)kg * 128, kq1 - kq0,
              nv);
        for (int qq = 0; qq < 4; ++qq) {
          if (q == qq) {
#pragma unroll
            for (int i = 0; i < FEAT_NT / 2; ++i) {
              if (i >= nv) break;
#pragma unroll
              for (int e4 = 0; e4 < 4; ++e4) {
                const int r = gid + (e4 >> 1) * 8;
                const int cl = (n0 - nb + i) * 8 + 2 * tig + (e4 & 1);
                float* dst = c.sRed + r * (8 * FEAT_NT) + cl;
                *dst = qq == 0 ? acc[i][e4] : *dst + acc[i][e4];
              }
            }
          }
          __syncthreads();
        }
        for (int i = threadIdx.x; i < 16 * 8 * FEAT_NT; i += NTH) {
          const int r = i / (8 * FEAT_NT), col = nb * 8 + i % (8 * FEAT_NT);
          const int row = row0 + r;
          if (col >= c.Op) continue;
          float v = 0.0f;  // padded columns and rows stay zero
          if (row < c.P && col < c.O) {
            v = c.sRed[i] + __ldcg(c.enc_out + (long)row * c.O + col);
            c.out[((long)row * c.D + t - 1) * c.O + col] = v;
          }
          c.sF[r * c.Op + apos<AT>(col)] = to_act<AT>(v);
        }
        __syncthreads();
      }
    }
    __syncthreads();
    if (pre) {
      for (int layer = 0; layer < 2; ++layer) {
        const float* b = layer == 0 ? c.pre_b1 : c.pre_b2;
        auto epi = [&](int nt, int e4, float acc) {
          const int r = gid + (e4 >> 1) * 8, row = row0 + r;
          const int col = nt * 8 + 2 * tig + (e4 & 1);
          if (col >= c.U) {  // zero: the LSTM phases reuse this buffer
            if (layer == 0) c.sP1[r * c.Up + apos<AT>(col)] = to_act<AT>(0.0f);
            return;
          }
          float v = fmaxf(acc + b[col], 0.0f);
          if (c.use_drop)
            v *= prenet_keep(c.seed, c.drop_thr, row, t, layer, col, c.U)
                     ? c.drop_scale
                     : 0.0f;
          if (layer == 0)
            c.sP1[r * c.Up + apos<AT>(col)] = to_act<AT>(v);
          else
            c.p2[(long)row * c.Up + apos<AT>(col)] = to_act<AT>(v);
        };
        if (layer == 1)
          tile_product<AT, WT, 4, false>(c.sP1, c.Up, c.w2k, c.Up / 16,
                                         c.Up / 8, epi);
        else if (t > 0)
          tile_product<AT, WT, 4, false>(c.sF, c.Op, c.w1k, c.Op / 16,
                                         c.Up / 8, epi);
        else  // prev is all zeros at t = 0
          for (int nt = threadIdx.x >> 5; nt < c.Up / 8; nt += NW)
            for (int e4 = 0; e4 < 4; ++e4) epi(nt, e4, 0.0f);
        __syncthreads();
      }
    }
  }
}

// K range of a cluster rank: rank 0 takes k16 steps [0, kg/2), rank 1
// [kg/2, kg).
__device__ __forceinline__ int half_start(int kg, int rank) {
  return rank ? kg / 2 : 0;
}
__device__ __forceinline__ int half_len(int kg, int rank) {
  return rank ? kg - kg / 2 : kg / 2;
}

// One LSTM layer at step t for the unit slices 2 pair and 2 pair + 1 of a
// cluster of two blocks: rank r multiplies the K half r of both slices'
// gate columns (2 NT8 n-tiles) with the same half of the activations, so
// each block reads half of them; the sums of the partner's slice go to the
// partner's shared memory (xbuf), and each rank completes the zoneout
// cell update of its own slice in registers, half 0 + half 1 in that order
// whatever the rank.  Warp w takes m16 tiles w, w + NW, ..; both ranks
// walk the same tiles, one round of NW a cluster barrier pair.
template <typename WT, typename BT, int NT8, typename XT>
__device__ void lstm_pair(const Ctx<WT, BT>& c, int layer, int t, int pair,
                          int rank, const XT* Bx, long bsx, const BT* Bh,
                          long bsh, float* xbuf, float* xbuf_peer) {
  using AT = typename Act<WT>::T;
  constexpr bool Q = std::is_same<BT, int8_t>::value;  // scaled apart
  constexpr int UNR = sizeof(AT) == 4 ? 2 : 4;
  constexpr int NT = 2 * NT8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const long PH = (long)c.Pp * c.Hp;
  const int Kx = layer == 0 ? c.Up : c.Hp;
  const AT* Ax = layer == 0 ? c.p2 : c.hx0 + (long)((t + 1) & 1) * PH;
  const AT* Ah = layer == 0 ? c.hx0 + (long)(t & 1) * PH
                            : c.hx1 + (long)(t & 1) * PH;
  AT* hx_new = (layer == 0 ? c.hx0 : c.hx1) + (long)((t + 1) & 1) * PH;
  float* hf = layer == 0 ? c.h0f : c.h1f;
  float* cf = layer == 0 ? c.c0 : c.c1;
  const int x0 = half_start(Kx / 16, rank), xn = half_len(Kx / 16, rank);
  const int h0 = half_start(c.Hp / 16, rank), hn = half_len(c.Hp / 16, rank);
  const int G = c.G, s = 2 * pair + rank;
  float* mine = xbuf + warp * (NT8 * 4 * 32);
  float* theirs = xbuf_peer + warp * (NT8 * 4 * 32);
  cg::cluster_group cluster = cg::this_cluster();
  for (int r0 = 0; r0 < c.n16; r0 += NW) {
    const int row0 = (r0 + warp) * 16;
    const bool live = row0 < c.Pp && t < c.bound(row0);
    float v[NT][4];
    if (live) {
      float ax[NT][4] = {}, ah[NT][4] = {};
      warp_mma<AT, XT, NT, UNR, true>(ax, Ax + (long)row0 * Kx + 16 * x0,
                                         Kx, Bx, bsx, xn);
      if constexpr (Q)
        warp_mma<AT, BT, NT, UNR, true>(
            ah, Ah + (long)row0 * c.Hp + 16 * h0, c.Hp, Bh, bsh, hn);
      else  // unscaled: one sum
        warp_mma<AT, BT, NT, UNR, true>(
            ax, Ah + (long)row0 * c.Hp + 16 * h0, c.Hp, Bh, bsh, hn);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        // lane (gid, tig) of n-tile n: unit j of slice 2 pair + n / NT8,
        // gates 2(tig&1) + {0,1}, rows gid, gid + 8
        const int j = (2 * pair + n / NT8) * c.UB + 2 * (n % NT8) + (tig >> 1);
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4) {
          v[n][e4] = ax[n][e4];
          if constexpr (Q) {
            const int col = (2 * (tig & 1) + (e4 & 1)) * c.H + j;
            float sx = 1.0f, sh = 0.0f;
            if (j < c.H) {
              sx = layer == 0 ? 1.0f : c.scales[G + col];
              sh = c.scales[(layer == 0 ? 0 : 2) * G + col];
            }
            v[n][e4] = ax[n][e4] * sx + ah[n][e4] * sh;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NT8; ++i)
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4)
          theirs[(i * 4 + e4) * 32 + lane] = v[(1 - rank) * NT8 + i][e4];
    }
    cluster.sync();  // the partner's sums of this rank's slice are here
    if (live) {
#pragma unroll
      for (int i = 0; i < NT8; ++i) {
        const int j = s * c.UB + 2 * i + (tig >> 1);
        float g[4];
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4) {
          const int row = row0 + gid + (e4 >> 1) * 8;
          const int col = (2 * (tig & 1) + (e4 & 1)) * c.H + j;
          const float own = v[rank * NT8 + i][e4];
          const float peer = mine[(i * 4 + e4) * 32 + lane];
          const float prod = rank == 0 ? own + peer : peer + own;
          g[e4] = 0.0f;
          if (j < c.H && row < c.P) {
            if (layer == 0)
              g[e4] = __ldcg(c.enc_gates + (long)row * G + col) + prod +
                      c.pos[(long)row * c.D + t] * c.wx0_pos[col] +
                      c.bh0[col];
            else
              g[e4] = c.bx1[col] + c.bh1[col] + prod;
          }
        }
        // even tig holds (i, f), odd tig (g, o): swap so the even lane
        // updates row gid and the odd lane row gid + 8
        const bool odd = tig & 1;
        const float s0 = __shfl_xor_sync(0xffffffffu, odd ? g[0] : g[2], 1);
        const float s1 = __shfl_xor_sync(0xffffffffu, odd ? g[1] : g[3], 1);
        const float gi = odd ? s0 : g[0], gf = odd ? s1 : g[1];
        const float gg = odd ? g[2] : s0, go = odd ? g[3] : s1;
        const int row = row0 + gid + (odd ? 8 : 0);
        if (j < c.H && row < c.P) {
          const long at = (long)row * c.Hp + j;
          const float c_old = cf[at], h_old = hf[at];
          const float c_n = sigmoid_f(gf) * c_old + sigmoid_f(gi) * tanh_f(gg);
          const float h_n = sigmoid_f(go) * tanh_f(c_n);
          const float keep = 1.0f - c.zoneout;
          const float h = c.zoneout * h_old + keep * h_n;
          cf[at] = c.zoneout * c_old + keep * c_n;
          hf[at] = h;
          hx_new[(long)row * c.Hp + apos<AT>(j)] = to_act<AT>(h);
        }
      }
    }
    cluster.sync();  // xbuf is free for the next round
  }
}

// The block's weight halves: in shared memory, [2 NT8 n-tiles][the larger
// half's k16 steps][32][4] a matrix; streamed, in place in the pack.
template <typename WT, typename BT>
struct Halves {
  const WT* wx0;
  const BT *wh0, *wx1, *wh1;
  long sx0, sh;  // n-tile strides (elements)
};

template <typename WT, typename BT, int NT8>
__device__ void lstm_phase(const Ctx<WT, BT>& c, int layer, int t,
                           const Halves<WT, BT>& w, int stationary,
                           int n_pairs, float* xbuf) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  float* xbuf_peer = cluster.map_shared_rank(xbuf, rank ^ 1);
  const int kx0 = c.Up / 16, kh = c.Hp / 16;
  const int n_clusters = gridDim.x / 2;
  for (int p = blockIdx.x / 2; p < n_pairs; p += n_clusters) {
    // streamed: the pair's n-tiles and this rank's first k16 step
    const long ox = stationary ? 0
                               : (long)2 * NT8 * p * kx0 * 128 +
                                     half_start(kx0, rank) * 128;
    const long oh = stationary ? 0
                               : (long)2 * NT8 * p * kh * 128 +
                                     half_start(kh, rank) * 128;
    if (layer == 0)
      lstm_pair<WT, BT, NT8>(c, 0, t, p, rank, w.wx0 + ox, w.sx0,
                             w.wh0 + oh, w.sh, xbuf, xbuf_peer);
    else
      lstm_pair<WT, BT, NT8>(c, 1, t, p, rank, w.wx1 + oh, w.sh,
                             w.wh1 + oh, w.sh, xbuf, xbuf_peer);
  }
}

// WT: weight type of the prenet, wx0_pre and feat_out (float or bf16), also
// the activation type; BT: type of wh0, wx1, wh1 (WT, or int8 codes).
// NT8 = UB / 2 n-tiles of gate columns a slice.
template <typename WT, typename BT, int NT8>
__global__ void __launch_bounds__(NTH, 1)
    ar_decode_kernel(DecodeArgs a, int stationary) {
  using AT = typename Act<WT>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  Ctx<WT, BT> c;
  c.P = a.P;
  c.D = a.D;
  c.H = a.H;
  c.U = a.units;
  c.O = a.odim;
  c.G = 4 * a.H;
  c.Hp = r16(a.H);
  c.Up = r16(a.units);
  c.Op = r16(a.odim);
  c.Ip = r16(a.idim);
  c.Pp = r32(a.P);
  c.n16 = c.Pp / 16;
  c.UB = 2 * NT8;
  c.ragged = a.ragged;
  c.bounds = static_cast<const int*>(a.bounds);
  c.quantized = a.quantized;
  c.zoneout = a.zoneout;
  c.drop_scale = 1.0f / (1.0f - a.dropout);
  c.drop_thr = (uint64_t)((1.0 - (double)a.dropout) * 4294967296.0);
  c.use_drop = a.dropout > 0.0f;
  c.seed = (uint32_t)*static_cast<const int*>(a.seed);
  c.pos = static_cast<const float*>(a.pos);
  c.pre_b1 = static_cast<const float*>(a.pre_b1);
  c.pre_b2 = static_cast<const float*>(a.pre_b2);
  c.wx0_pos = static_cast<const float*>(a.wx0_pos);
  c.bh0 = static_cast<const float*>(a.bh0);
  c.bx1 = static_cast<const float*>(a.bx1);
  c.bh1 = static_cast<const float*>(a.bh1);
  c.scales = static_cast<const float*>(a.scales);
  c.w1k = static_cast<const WT*>(a.w1k);
  c.w2k = static_cast<const WT*>(a.w2k);
  c.wfk = static_cast<const WT*>(a.wfk);
  c.enc_gates = static_cast<const float*>(a.enc_gates);
  c.enc_out = static_cast<const float*>(a.enc_out);
  c.out = static_cast<float*>(a.out);
  const long PH = (long)c.Pp * c.Hp;
  AT* act = static_cast<AT*>(a.scratch);
  c.encA = act;
  c.p2 = c.encA + (long)c.Pp * c.Ip;
  c.hx0 = c.p2 + (long)c.Pp * c.Up;
  c.hx1 = c.hx0 + 2 * PH;
  float* st = reinterpret_cast<float*>(c.hx1 + 2 * PH);
  c.h0f = st;
  c.c0 = st + PH;
  c.h1f = st + 2 * PH;
  c.c1 = st + 3 * PH;
  c.sF = reinterpret_cast<AT*>(smem);
  c.sP1 = c.sF + 16 * c.Op;
  c.sRed = reinterpret_cast<float*>(c.sP1 + 16 * c.Up);
  c.T = c.D;
  if (c.ragged) {
    c.T = 0;
    for (int b = 0; b < (c.P + BOUND_TILE - 1) / BOUND_TILE; ++b)
      c.T = max(c.T, min(c.bounds[b], c.D));
  }
  unsigned int* bar = static_cast<unsigned int*>(a.barrier);
  unsigned int target = 0;
  float* xbuf = reinterpret_cast<float*>(smem);

  // this block's K halves of its pair's gate columns: shared memory once
  // a launch, or read in place from the pack each step
  const int n_pairs = c.Hp / c.UB / 2;
  Halves<WT, BT> w;
  w.wx0 = static_cast<const WT*>(a.wx0k);
  w.wh0 = static_cast<const BT*>(a.wh0k);
  w.wx1 = static_cast<const BT*>(a.wx1k);
  w.wh1 = static_cast<const BT*>(a.wh1k);
  w.sx0 = (long)(c.Up / 16) * 128;
  w.sh = (long)(c.Hp / 16) * 128;
  if (stationary) {
    const int rank = (int)cg::this_cluster().block_rank();
    const int pair = blockIdx.x / 2, kx0 = c.Up / 16, kh = c.Hp / 16;
    const long mx = (long)(kx0 - kx0 / 2) * 128;  // the larger half
    const long mh = (long)(kh - kh / 2) * 128;
    WT* s_wx0 = reinterpret_cast<WT*>(smem + work_smem(c.Op, c.Up,
                                                       (int)sizeof(AT), NT8));
    BT* s_wh0 = reinterpret_cast<BT*>(s_wx0 + 2 * NT8 * mx);
    BT* s_wx1 = s_wh0 + 2 * NT8 * mh;
    BT* s_wh1 = s_wx1 + 2 * NT8 * mh;
    // n-tile n of the pair: k16 steps [half_start, + half_len) in 16-byte
    // copies
    auto copy = [&](auto* dst, const auto* src, int kg, long m) {
      using E = std::remove_cv_t<std::remove_pointer_t<decltype(src)>>;
      constexpr int V = 16 / sizeof(E);
      const long per = (long)half_len(kg, rank) * 128 / V;
      for (long i = threadIdx.x; i < 2 * NT8 * per; i += NTH) {
        const long n = i / per, k = i % per;
        const uint4* from = reinterpret_cast<const uint4*>(
            src + ((long)(2 * NT8 * pair + n) * kg + half_start(kg, rank)) *
                      128) + k;
        reinterpret_cast<uint4*>(dst + n * m)[k] = *from;
      }
    };
    copy(s_wx0, w.wx0, kx0, mx);
    copy(s_wh0, w.wh0, kh, mh);
    copy(s_wx1, w.wx1, kh, mh);
    copy(s_wh1, w.wh1, kh, mh);
    w.wx0 = s_wx0;
    w.wh0 = s_wh0;
    w.wx1 = s_wx1;
    w.wh1 = s_wh1;
    w.sx0 = mx;
    w.sh = mh;
  }

  // ---- prologue: zero state and never-reached frames;
  // the resident entry's enc operand in fragment order
  const long gtid = (long)blockIdx.x * NTH + threadIdx.x;
  const long gsize = (long)gridDim.x * NTH;
  {
    const long n_act = (long)c.Pp * c.Up + 4 * PH;  // p2, hx0 x2, hx1 x2
    for (long i = gtid; i < n_act; i += gsize) c.p2[i] = to_act<AT>(0.0f);
    for (long i = gtid; i < 4 * PH; i += gsize) st[i] = 0.0f;
    for (long i = gtid; i < (long)c.P * c.D * c.O; i += gsize) {
      const int r = (int)(i / ((long)c.D * c.O));
      const int tt = (int)((i / c.O) % c.D);
      if (tt >= c.bound(r)) c.out[i] = 0.0f;
    }
    if (a.resident) {
      const float* enc = static_cast<const float*>(a.enc);
      for (long i = gtid; i < (long)c.Pp * c.Ip; i += gsize) {
        const int r = (int)(i / c.Ip), k = (int)(i % c.Ip);
        const float v =
            (r < c.P && k < a.idim) ? enc[(long)r * a.idim + k] : 0.0f;
        c.encA[(long)r * c.Ip + apos<AT>(k)] = to_act<AT>(v);
      }
    }
  }
  grid_sync(bar, target);
  if (a.resident) {
    // enc_gates = enc @ wx0_enc + bx0, enc_out = enc @ wf_enc: (m16 tile,
    // n-tile) jobs over every warp of the grid
    constexpr int UNR = sizeof(AT) == 4 ? 4 : 8;
    const WT* wx0e = static_cast<const WT*>(a.wx0ek);
    const WT* wfe = static_cast<const WT*>(a.wfek);
    const float* bx0 = static_cast<const float*>(a.bx0);
    float* eg = static_cast<float*>(a.enc_gates);
    float* eo = static_cast<float*>(a.enc_out);
    const int ng = (c.G + 7) / 8, no = (c.O + 7) / 8, kg = c.Ip / 16;
    const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
    const long jobs = (long)c.n16 * (ng + no);
    for (long job = gtid >> 5; job < jobs; job += gsize >> 5) {
      const int rt = (int)(job / (ng + no)), nt = (int)(job % (ng + no));
      const bool is_g = nt < ng;
      const int n0 = is_g ? nt : nt - ng;
      float acc[1][4] = {};
      warp_mma<AT, WT, 1, UNR, true>(
          acc, c.encA + (long)rt * 16 * c.Ip, c.Ip,
          (is_g ? wx0e : wfe) + (long)n0 * kg * 128, 0, kg);
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        const int row = rt * 16 + gid + (e4 >> 1) * 8;
        const int col = n0 * 8 + 2 * tig + (e4 & 1);
        if (row >= c.P) continue;
        if (is_g && col < c.G)
          eg[(long)row * c.G + col] = acc[0][e4] + bx0[col];
        else if (!is_g && col < c.O)
          eo[(long)row * c.O + col] = acc[0][e4];
      }
    }
    grid_sync(bar, target);
  }

  // ---- the step loop: [feat_out(t-1) + prenet(t)] | LSTM 0 | LSTM 1
  unsigned long long* trace = static_cast<unsigned long long*>(a.trace);
  for (int t = 0; t < c.T; ++t) {
    mark(trace, t, 0);
    row_phase(c, t);
    mark(trace, t, 1);
    grid_sync(bar, target);
    mark(trace, t, 2);
    lstm_phase<WT, BT, NT8>(c, 0, t, w, stationary, n_pairs, xbuf);
    mark(trace, t, 3);
    grid_sync(bar, target);
    mark(trace, t, 4);
    lstm_phase<WT, BT, NT8>(c, 1, t, w, stationary, n_pairs, xbuf);
    mark(trace, t, 5);
    grid_sync(bar, target);
    mark(trace, t, 6);
  }
  row_phase(c, c.T);  // the last frame
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

template <typename WT, typename BT, int NT8>
int launch(const DecodeArgs* a, cudaStream_t stream, LaunchInfo* info) {
  using AT = typename Act<WT>::T;
  auto kern = ar_decode_kernel<WT, BT, NT8>;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  const int Hp = r16(a->H), Up = r16(a->units), Op = r16(a->odim);
  const int n_slices = Hp / (2 * NT8);  // even: Hp is a multiple of 16
  const int kx0 = Up / 16, kh = Hp / 16;
  const size_t work = work_smem(Op, Up, (int)sizeof(AT), NT8);
  const size_t w_smem = ((size_t)(kx0 - kx0 / 2) * sizeof(WT) +
                         (size_t)3 * (kh - kh / 2) * sizeof(BT)) *
                        128 * 2 * NT8;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = 2;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(NTH);
  cfg.stream = stream;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;  // the occupancy queries take the cluster only
  // how many 2-block clusters can be resident at once with smem bytes
  auto resident_clusters = [&](size_t smem, int* n) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    cfg.gridDim = dim3(n_slices);
    cfg.dynamicSmemBytes = smem;
    return cudaOccupancyMaxActiveClusters(n, kern, &cfg);
  };
  // stationary when every slice gets a resident block whose shared memory
  // holds its halves
  int stationary = 0, nc = 0;
  size_t smem = work;
  if (work + w_smem <= (size_t)optin) {
    e = resident_clusters(work + w_smem, &nc);
    if (e != cudaSuccess) return e;
    if (2 * nc >= n_slices) {
      stationary = 1;
      smem = work + w_smem;
    }
  }
  if (!stationary) {
    e = resident_clusters(smem, &nc);
    if (e != cudaSuccess) return e;
    if (nc < 1) return cudaErrorCooperativeLaunchTooLarge;
  }
  // every block is resident, the grid barrier's premise: the occupancy
  // check above, and a cooperative launch where the driver takes one with
  // clusters
  const int grid = stationary ? n_slices : min(n_slices, 2 * nc);
  info->grid = grid;
  info->block_threads = NTH;
  info->units_per_block = 2 * NT8;
  info->stationary = stationary;
  info->smem_bytes = (int)smem;
  info->barriers_per_step = 3;
  info->prologue_barriers = 1 + a->resident;
  info->cluster = 2;
  cfg.gridDim = dim3(grid);
  cfg.dynamicSmemBytes = smem;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  DecodeArgs args = *a;
  void* params[] = {&args, &stationary};
  // inside a CUDA graph capture the launch becomes a kernel node with the
  // same attributes; a refused launch there ends the capture, so it is
  // reported, not retried
  cudaStreamCaptureStatus capture = cudaStreamCaptureStatusNone;
  e = cudaStreamIsCapturing(stream, &capture);
  if (e != cudaSuccess) return e;
  info->captured = capture == cudaStreamCaptureStatusActive;
  cfg.numAttrs = 2;
  info->cooperative = 1;
  e = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kern), params);
  if (e != cudaSuccess && !info->captured) {
    cudaGetLastError();  // not sticky: retry without the cooperative flag
    cfg.numAttrs = 1;
    info->cooperative = 0;
    e = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kern),
                            params);
  }
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}
template <typename WT, typename BT>
int launch_ub(const DecodeArgs* a, cudaStream_t s, LaunchInfo* info) {
  switch (a->units_per_block) {
    case 2:
      return launch<WT, BT, 1>(a, s, info);
    case 4:
      return launch<WT, BT, 2>(a, s, info);
    case 8:
      return launch<WT, BT, 4>(a, s, info);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// wkind: 0 = fp32 weights, 1 = bf16 weights, 2 = bf16 + int8 codes for
// wh0, wx1, wh1.  Returns a cudaError_t (0 on success); *info describes the
// launch.
int ar_decode_launch(const DecodeArgs* a, int wkind, void* stream,
                     LaunchInfo* info) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (wkind) {
    case 0:
      return launch_ub<float, float>(a, s, info);
    case 1:
      return launch_ub<bf16, bf16>(a, s, info);
    case 2:
      return launch_ub<bf16, int8_t>(a, s, info);
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

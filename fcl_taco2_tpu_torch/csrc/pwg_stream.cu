// Streaming Parallel-WaveGAN generator for Hopper (sm_90a): fp32 data,
// products on the TF32 tensor cores at fp32 accuracy (3xTF32).
//
// Replaces the two Pallas TPU kernels of fcl_taco2_tpu/vocoder/pwg_pallas.py:
//   pwg_generate_streaming (_kernel :109, pallas_call :227)  one-shot, zero
//                                                            state
//   pwg_stream_step (_stream_kernel :266, pallas_call :409)  one chunk,
//                                                            state in and out
// Both run the causal reformulation of the 30-layer generator: layer i reads
// its input stream x_i at positions p-2d, p-d, p, the upsampled mel at
// p - cum_i, adds its skip output at p + delay - cum_i, and masks its output
// to [cum_i, W + cum_i); x_0 = noise * first_w + first_b masked to p < W.
// The entries differ only where the TPU kernels differ: the stream entry
// reads its state at the first tile and writes it after the last, and takes
// start and W at run time, from the device (as the Pallas kernel reads
// start_ref), so a CUDA graph of a stream step replays with the position
// its caller wrote before the replay.
//
// What bounds it on the H100.  PWG v1 does 1,294,400 multiply-adds per
// output sample (3*64*128 + 80*128 + 64*128 per layer, 30 layers, plus the
// head).  The JAX kernel multiplies fp32 operands into fp32 sums, and the
// port holds this kernel to 1e-4 of an fp32 plain version, so every product
// is split into TF32 halves, x ~ hi + lo with hi = x truncated to TF32 and
// lo = (x - hi) truncated likewise (2^-20 relative), and
// a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, three m16n8k8 TF32 mma into one
// fp32 accumulator (3xTF32): 3 x 2.59 MFLOP a sample at the 495 TFLOP/s
// TF32 peak is 15.7 ns a sample, 6.17 ms for the 393,216 samples of a
// 96-phoneme utterance's frame budget (15.19 ms in fp32 on the CUDA cores),
// against about 0.2 ms for its bytes.  So the ideal kernel is bound by
// tensor-core operations.  mma.sync is used, not wgmma: wgmma wants 64-row
// warpgroup tiles and B in shared memory in its own layout, so the hi/lo
// halves of the weights would have to sit in shared memory twice over
// (278 KB for one layer's w1 alone), beyond the 227 KB a block has.
// mma.sync takes both operands from registers, so the halves are formed as
// the operands are loaded.  Measured on the card, mma.sync reaches about
// half the TF32 peak, so this design's own floor is about 12.5 ms there.
// No thread-block cluster: one layer's fp32 weights (172 KB) fit in one
// block beside two 16-row A tiles, so the 128 gate columns need no split
// across blocks; a 2-block cluster (64 columns a block, g exchanged through
// distributed shared memory) is what would make room for the hi/lo halves
// that wgmma needs.
//
// Schedule.  One cooperative launch walks the time tiles in order.  Per
// tile of n positions (all B rows): phases 0..L-1 run the layers; phase H
// reads the skip sum, runs the head (relu, last1, relu, last2) and writes
// x_0 of the next tile.  A grid-wide barrier separates the phases (1 +
// tiles * (L + 1) a call; the launcher reports the count).  Inside a phase
// the B*n rows are cut into 16-row block tiles, dealt to the warp groups of
// persistent blocks, one block per SM: two groups of 8 warps a block, each
// with its own A tile and g tile and its own named barrier, so one group's
// gather, gate and stores overlap the other's products (one group where the
// aux width leaves no room for two).  Tiles go to the groups group-major,
// so a batch-1 stream step of 4096 samples (256 tiles) still puts work on
// all 132 SMs.  A block loads its layer's weights once a phase with
// cp.async into shared memory, w1 (K1p x 128, 139 KB at PWG v1) and w2
// (64 x 128), both packed in m16n8k8 B-fragment order so a lane reads its
// four values of a k step as one 16-byte load.  Each of a group's 8 warps
// owns 8 tanh columns and the matching 8 sigmoid columns, so the gate forms
// in registers; g goes through shared memory to the second product
// (K = 64, N = 128: [skip | out]).  The gather of a group's next A tile
// ([x(p-2d) x(p-d) x(p) aux], K1p = 3*64 + A padded to 8) is in flight
// while the other group multiplies.
//
// Where the data lives.  The current tile's activations pass between layers
// in a ping-pong buffer of one tile (2 x B x tile x 64 fp32, 8.4 MB at
// B * tile = 16,384 rows); each layer keeps only the 2d-row history its taps
// need (max(8, 2d) rows, the JAX state's layout) in two buffers that
// alternate by tile parity (3.2 MB a batch row at PWG v1); the skip sums
// sit in a ring of pow2(tile + delay) rows (8.4 MB).  At B=1 that is about
// 20 MB besides the aux (5.2 MB a tile, re-read by every layer), within the
// 50 MB L2.  The JAX state layout appears only at the ends: the first tile
// reads the layer histories from bufs_in and the last one writes them to
// bufs_out.
//
// Exactness.  Every output element sums its products in one fixed order
// (K steps of 8, three mma each, in order) whatever the row tile or the
// time tile, and the head's column sums reduce in a fixed tree; so chained
// stream steps equal the one-shot call bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32.cuh"

namespace cg = cooperative_groups;

#define MAX_LAYERS 64

extern "C" {
// Field order and types mirror PwgArgs in vocoder/pwg_cuda.py.
struct PwgArgs {
  const float* noise;    // (B, n_noise): positions [start, start + n_noise)
  const float* aux;      // (B, n_aux, A): positions [start, start + n_aux)
  const float* w1k;      // (L, K1p/8, 8, 32, 4): w1 (K1p, 128) as the B
                         // fragments of each k step, warp and lane
  const float* b1;       // (L, 128)
  const float* w2k;      // (L, 8, 8, 32, 4): w2 (64, 128) = [skip | out]
                         // in the same fragment order
  const float* b2;       // (L, 128)
  const float* first_w;  // (64,)
  const float* first_b;  // (64,)
  const float* last1_w;  // (64, 64) as (in, out)
  const float* last1_b;  // (64,)
  const float* last2_w;  // (64,)
  const float* last2_b;  // (1,)
  const float* ah_in;    // (B, delay, A) or null (zero state)
  const float* acc_in;   // (B, delay, 64) or null
  const float* bufs_in;  // (B, sum_bw, 64) or null
  float* wav;            // (B, N): positions [start, start + N)
  float* ah_out;         // (B, delay, A) or null (no state out)
  float* acc_out;        // (B, delay, 64) or null
  float* bufs_out;       // (B, sum_bw, 64) or null
  float* xbuf;           // (2, B, tile, 64) ping-pong of one time tile
  float* hbuf;           // (2, B, sum_bw, 64) layer histories by tile parity
  float* ring_acc;       // (B, ra, 64) skip sums
  const int* pos;        // (2,) i32 on the device: start, W; or null: the
                         // start and W fields below
  int B, N, n_aux, n_noise, start, W, A, K1p, L, delay, tile, ra, sum_bw;
  float z_scale;         // sqrt(1 / L)
  int dil[MAX_LAYERS];
  int cum[MAX_LAYERS];     // d_0 + .. + d_i
  int bw[MAX_LAYERS];      // max(8, 2 d_i)
  int buf_off[MAX_LAYERS]; // row offset of layer i in the history arrays
};

// What a launch did, for the wrapper's log (pwg_cuda.last_launch): the
// blocks launched, the rows of a block tile, the block tiles of the first
// phase, the grid-wide barriers of the call, the warp groups of a block
// and the dynamic shared memory of a block in bytes.
struct PwgLaunchInfo {
  int grid, block_rows, block_tiles, barriers, groups, smem_bytes;
};
}

namespace {

constexpr int C = 64;     // residual channels (= skip channels = gates / 2)
constexpr int NC = 128;   // output columns of the layer products
constexpr int GW = 8;     // warps of a group: 8 x (8 tanh + 8 sigmoid) columns
constexpr int TM = 16;    // rows (stream positions) of a block tile
constexpr int GS = C + 4;   // g / z tile row stride (no bank conflicts)
constexpr float SQRT_HALF = 0.70710678118654752f;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void st2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}

__device__ __forceinline__ void cp16(float* smem, const float* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The A fragment of m16n8k8 (rows g, g+8; columns t, t+4) from a
// row-major tile with row stride ld, split into TF32 halves.
__device__ __forceinline__ void load_a(const float* p, int ld, uint32_t ah[4],
                                       uint32_t al[4]) {
  split(p[0], ah[0], al[0]);
  split(p[8 * ld], ah[1], al[1]);
  split(p[4], ah[2], al[2]);
  split(p[8 * ld + 4], ah[3], al[3]);
}

// The B fragment (rows t, t+4 of a row-major K x N matrix, column col)
__device__ __forceinline__ void load_b(const float* p, int ld, uint32_t bh[2],
                                       uint32_t bl[2]) {
  split(p[0], bh[0], bl[0]);
  split(p[4 * ld], bh[1], bl[1]);
}

// Conditioning row at stream position q: the caller's aux from start on,
// the state's history before it; null (zero) past the aux's end or with
// no state.
__device__ __forceinline__ const float* aux_row(const PwgArgs& a, int start,
                                                int b, int q) {
  const int j = q - start;
  if (j >= 0)
    return j < a.n_aux ? a.aux + ((size_t)b * a.n_aux + j) * a.A : nullptr;
  return a.ah_in ? a.ah_in + ((size_t)b * a.delay + j + a.delay) * a.A
                 : nullptr;
}

__device__ __forceinline__ float* accrow(const PwgArgs& a, int b, int q) {
  return a.ring_acc + ((size_t)b * a.ra + (q & (a.ra - 1))) * C;
}

__device__ __forceinline__ float* xcur(const PwgArgs& a, int par, int b,
                                       int r) {
  return a.xbuf + (((size_t)par * a.B + b) * a.tile + r) * C;
}

// One time tile: positions [s0, s0 + n); the layer histories are read from
// hread (positions [s0 - bw_i, s0)) and written to hwrite (positions
// [s0 + n - bw_i, s0 + n)); either may be null (zero state / none kept).
// start and W: the call's stream position and real sample count.
struct Tile {
  int s0, n, start, W;
  const float* hread;
  float* hwrite;
};

// Offset of row r of layer i's history (batch row b) in a history array.
__device__ __forceinline__ size_t hrow(const PwgArgs& a, int b, int i,
                                       int r) {
  return ((size_t)b * a.sum_bw + a.buf_off[i] + r) * C;
}

// Load the state's skip sums into the ring (zero elsewhere).
__device__ void prologue(const PwgArgs& a, int start, size_t gtid,
                         size_t gstride) {
  const size_t nacc = (size_t)a.B * a.ra * C;
  for (size_t e = gtid; e < nacc; e += gstride) {
    const int c = e % C;
    const int k = (e / C) % a.ra;
    const int b = e / ((size_t)C * a.ra);
    float v = 0.f;
    if (a.acc_in != nullptr && k < a.delay)
      v = a.acc_in[((size_t)b * a.delay + k) * C + c];
    accrow(a, b, start + k)[c] = v;
  }
}

// Store the aux history and the skip sums after the last tile (stream
// entry only; the layer histories were written by the last tile).
__device__ void epilogue(const PwgArgs& a, int start, size_t gtid,
                         size_t gstride) {
  const int end = start + a.N;
  const int A4 = a.A / 4;
  const size_t nah = (size_t)a.B * a.delay * A4;
  for (size_t e = gtid; e < nah; e += gstride) {
    const int c4 = e % A4;
    const int j = (e / A4) % a.delay;
    const int b = e / ((size_t)A4 * a.delay);
    const float* src = aux_row(a, start, b, end - a.delay + j);
    st4(a.ah_out + ((size_t)b * a.delay + j) * a.A + 4 * c4,
        src ? ld4(src + 4 * c4) : make_float4(0.f, 0.f, 0.f, 0.f));
  }
  const size_t nacc = (size_t)a.B * a.delay * C;
  for (size_t e = gtid; e < nacc; e += gstride) {
    const int c = e % C;
    const int j = (e / C) % a.delay;
    const int b = e / ((size_t)C * a.delay);
    a.acc_out[e] = accrow(a, b, end + j)[c];
  }
}

// x_0 at positions [s0, s0 + n) of every row into ping-pong buffer 0.
__device__ void first_conv(const PwgArgs& a, int start, int W, int s0, int n,
                           size_t gtid, size_t gstride) {
  const size_t total = (size_t)a.B * n * (C / 4);
  for (size_t e = gtid; e < total; e += gstride) {
    const int c = 4 * (e % (C / 4));
    const int r = (e / (C / 4)) % n;
    const int b = e / ((size_t)(C / 4) * n);
    const int p = s0 + r;
    const int j = p - start;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p < W) {
      const float nz = j < a.n_noise ? a.noise[(size_t)b * a.n_noise + j] : 0.f;
      const float4 w = ld4(a.first_w + c), bb = ld4(a.first_b + c);
      v = make_float4(nz * w.x + bb.x, nz * w.y + bb.y, nz * w.z + bb.z,
                      nz * w.w + bb.w);
    }
    st4(xcur(a, 0, b, r) + c, v);
  }
}

// Layer i's history for the next tile: x_i at [s0 + n - bw, s0 + n), from
// the current tile's buffer or, where n < bw, the older history.
__device__ void write_history(const PwgArgs& a, int i, const Tile& tl,
                              size_t gtid, size_t gstride) {
  if (tl.hwrite == nullptr) return;
  const int bw = a.bw[i];
  const size_t total = (size_t)a.B * bw * (C / 4);
  for (size_t e = gtid; e < total; e += gstride) {
    const int c = 4 * (e % (C / 4));
    const int r = (e / (C / 4)) % bw;
    const int b = e / ((size_t)(C / 4) * bw);
    const int q = tl.s0 + tl.n - bw + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q >= tl.s0)
      v = ld4(xcur(a, i & 1, b, q - tl.s0) + c);
    else if (tl.hread != nullptr)
      v = ld4(tl.hread + hrow(a, b, i, r + tl.n) + c);
    st4(tl.hwrite + hrow(a, b, i, r) + c, v);
  }
}

// Gather block tile rt of layer i into a group's A tile (TM x KA):
// [x_i(p-2d) x_i(p-d) x_i(p) aux(p-cum) 0-pad], a row per warp, 16-byte
// cp.async per piece, zeros stored where there is no source.
__device__ void gather(const PwgArgs& a, int i, const Tile& tl, int rt,
                       float* as, int wid, int lane) {
  const int rows = a.B * tl.n;
  const int KQ = a.K1p / 4, KA = a.K1p + 4;
  const int d = a.dil[i], cum = a.cum[i], bw = a.bw[i];
  const int aux_end = 3 * (C / 4) + a.A / 4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int m = wid; m < TM; m += GW) {
    float* dst = as + m * KA;
    const int jg = rt * TM + m;
    if (jg >= rows) {
      for (int c4 = lane; c4 < KQ; c4 += 32) st4(dst + 4 * c4, zero);
      continue;
    }
    const int b = jg / tl.n, p = tl.s0 + (jg - b * tl.n);
    const float* arow = aux_row(a, tl.start, b, p - cum);
    for (int c4 = lane; c4 < KQ; c4 += 32) {
      const float* src = nullptr;
      if (c4 < 3 * (C / 4)) {
        const int tap = c4 >> 4, col = 4 * (c4 & 15);
        const int q = p - (2 - tap) * d;
        if (q >= tl.s0)
          src = xcur(a, i & 1, b, q - tl.s0) + col;
        else if (tl.hread != nullptr)
          src = tl.hread + hrow(a, b, i, bw - (tl.s0 - q)) + col;
      } else if (c4 < aux_end && arow != nullptr) {
        src = arow + 4 * (c4 - 3 * (C / 4));
      }
      if (src != nullptr)
        cp16(dst + 4 * c4, src);
      else
        st4(dst + 4 * c4, zero);
    }
  }
}

// The per-thread view of a block: NG groups of GW warps; each group works
// on its own block tiles with its own A tile and g tile, synchronised by
// its own named barrier, so one group's gather, gate and stores overlap
// the other's products.  Tiles go to groups group-major (tile rt to
// group rt / grid of block rt % grid), so a phase of fewer tiles than
// groups still puts work on every block.
struct Lanes {
  int grp, wid, lane, g, t;
};

__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "r"(GW * 32)
               : "memory");
}

// Phase i: layer i over the rows [s0, s0 + n) of every batch row.
template <int NG>
__device__ void layer(const PwgArgs& a, int i, const Tile& tl, float* w_s,
                      float* w2_s, float* a_s, float* g_s, const Lanes& q,
                      size_t gtid, size_t gstride) {
  write_history(a, i, tl, gtid, gstride);
  const int rows = a.B * tl.n;
  const int n_rt = (rows + TM - 1) / TM;
  if ((int)blockIdx.x >= n_rt) return;
  const int tid = threadIdx.x;
  const int KA = a.K1p + 4;
  const int wid = q.wid, lane = q.lane, g = q.g, t = q.t;
  const int cum = a.cum[i];
  const int n_groups = gridDim.x * NG;
  float* const as = a_s + q.grp * TM * KA;
  float* const gs = g_s + q.grp * TM * GS;

  // this layer's weights into shared memory, with each group's first tile
  const float* w1 = a.w1k + (size_t)i * a.K1p * NC;
  for (int e = tid; e < a.K1p * (NC / 4); e += NG * GW * 32)
    cp16(w_s + 4 * e, w1 + 4 * e);
  const float* w2 = a.w2k + (size_t)i * C * NC;
  for (int e = tid; e < C * (NC / 4); e += NG * GW * 32)
    cp16(w2_s + 4 * e, w2 + 4 * e);
  int rt = q.grp * gridDim.x + blockIdx.x;  // group-major: all SMs busy
  if (rt < n_rt) gather(a, i, tl, rt, as, wid, lane);
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  const float* b1 = a.b1 + i * NC;
  const float* b2 = a.b2 + i * NC;
  const int ccol = 8 * wid + 2 * t;  // C-fragment columns ccol, ccol + 1
  const float2 b1t = ld2(b1 + ccol), b1s = ld2(b1 + 64 + ccol);
  const float2 b2s = ld2(b2 + ccol), b2o = ld2(b2 + 64 + ccol);
  const bool xnext = i + 1 < a.L;

  for (; rt < n_rt; rt += n_groups) {
    // h = A @ w1: this warp's 8 tanh columns and their sigmoid partners
    float acc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
#pragma unroll 4
    for (int s = 0; s < a.K1p / 8; ++s) {
      uint32_t bh[2][2], bl[2][2], ah[4], al[4];
      const float4 bv = ld4(w_s + ((s * GW + wid) * 32 + lane) * 4);
      split(bv.x, bh[0][0], bl[0][0]);
      split(bv.y, bh[0][1], bl[0][1]);
      split(bv.z, bh[1][0], bl[1][0]);
      split(bv.w, bh[1][1], bl[1][1]);
      load_a(as + g * KA + 8 * s + t, KA, ah, al);
      mma3(acc[0], ah, al, bh[0], bl[0]);
      mma3(acc[1], ah, al, bh[1], bl[1]);
    }
    // gated activation into the g tile (rows g, g + 8)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float t0 = acc[0][2 * h] + b1t.x;
      const float t1 = acc[0][2 * h + 1] + b1t.y;
      const float s0 = acc[1][2 * h] + b1s.x;
      const float s1 = acc[1][2 * h + 1] + b1s.y;
      float2 gv;
      gv.x = tanhf(t0) * (1.f / (1.f + expf(-s0)));
      gv.y = tanhf(t1) * (1.f / (1.f + expf(-s1)));
      st2(gs + (g + 8 * h) * GS + ccol, gv);
    }
    // the skip sums this tile adds to, loaded while g @ w2 runs, and the
    // residual x_i(p - d) from the A tile, which is then free
    float2 sk[2], center[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int jg = rt * TM + g + 8 * h;
      sk[h] = make_float2(0.f, 0.f);
      if (jg < rows) {
        const int b = jg / tl.n, p = tl.s0 + (jg - b * tl.n);
        sk[h] = ld2(accrow(a, b, p + a.delay - cum) + ccol);
      }
      center[h] = ld2(as + (g + 8 * h) * KA + C + ccol);
    }
    group_sync(q.grp);
    // the next tile's gather runs under this tile's second product
    if (rt + n_groups < n_rt) gather(a, i, tl, rt + n_groups, as, wid, lane);
    cp_commit();
    // [skip | out] = g @ w2
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
#pragma unroll
    for (int s = 0; s < C / 8; ++s) {
      uint32_t bh[2][2], bl[2][2], ah[4], al[4];
      const float4 bv = ld4(w2_s + ((s * GW + wid) * 32 + lane) * 4);
      split(bv.x, bh[0][0], bl[0][0]);
      split(bv.y, bh[0][1], bl[0][1]);
      split(bv.z, bh[1][0], bl[1][0]);
      split(bv.w, bh[1][1], bl[1][1]);
      load_a(gs + g * GS + 8 * s + t, GS, ah, al);
      mma3(acc[0], ah, al, bh[0], bl[0]);
      mma3(acc[1], ah, al, bh[1], bl[1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = g + 8 * h;
      const int jg = rt * TM + m;
      if (jg >= rows) continue;
      const int b = jg / tl.n, r = jg - b * tl.n, p = tl.s0 + r;
      float2 sum = sk[h];
      sum.x = sum.x + acc[0][2 * h] + b2s.x;
      sum.y = sum.y + acc[0][2 * h + 1] + b2s.y;
      st2(accrow(a, b, p + a.delay - cum) + ccol, sum);
      if (xnext) {
        const bool keep = p >= cum && p < tl.W + cum;
        float2 xo = make_float2(0.f, 0.f);
        if (keep) {
          xo.x = ((acc[1][2 * h] + b2o.x) + center[h].x) * SQRT_HALF;
          xo.y = ((acc[1][2 * h + 1] + b2o.y) + center[h].y) * SQRT_HALF;
        }
        st2(xcur(a, (i + 1) & 1, b, r) + ccol, xo);
      }
    }
    cp_wait<0>();
    group_sync(q.grp);  // the next A tile is in, the g tile is free
  }
}

// Phase H: wav at positions [s0, s0 + n); the read skip slots are zeroed
// for their reuse ra positions later.
template <int NG>
__device__ void head(const PwgArgs& a, const Tile& tl, float* a_s,
                     float* g_s, const Lanes& q) {
  const int rows = a.B * tl.n;
  const int n_rt = (rows + TM - 1) / TM;
  const int wid = q.wid, lane = q.lane, g = q.g, t = q.t;
  const int gl = wid * 32 + lane;  // thread in the group
  const int col = 8 * wid + g, ccol = 8 * wid + 2 * t;
  uint32_t lh[8][2], ll[8][2];
#pragma unroll
  for (int s = 0; s < 8; ++s)
    load_b(a.last1_w + (8 * s + t) * C + col, C, lh[s], ll[s]);
  const float2 l1b = ld2(a.last1_b + ccol), l2w = ld2(a.last2_w + ccol);
  float* const red = a_s + q.grp * TM * (a.K1p + 4);  // (TM, GW) partials
  float* const zs = g_s + q.grp * TM * GS;
  const int n_groups = gridDim.x * NG;
  for (int rt = q.grp * gridDim.x + blockIdx.x; rt < n_rt;
       rt += n_groups) {
    for (int e = gl; e < TM * (C / 4); e += GW * 32) {
      const int m = e / (C / 4), c = 4 * (e % (C / 4));
      const int jg = rt * TM + m;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (jg < rows) {
        const int b = jg / tl.n, p = tl.s0 + (jg - b * tl.n);
        float* ap = accrow(a, b, p) + c;
        v = ld4(ap);
        st4(ap, make_float4(0.f, 0.f, 0.f, 0.f));
        v.x = fmaxf(v.x * a.z_scale, 0.f);
        v.y = fmaxf(v.y * a.z_scale, 0.f);
        v.z = fmaxf(v.z * a.z_scale, 0.f);
        v.w = fmaxf(v.w * a.z_scale, 0.f);
      }
      st4(zs + m * GS + c, v);
    }
    group_sync(q.grp);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      uint32_t ah[4], al[4];
      load_a(zs + g * GS + 8 * s + t, GS, ah, al);
      mma3(acc, ah, al, lh[s], ll[s]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float z0 = fmaxf(acc[2 * h] + l1b.x, 0.f);
      const float z1 = fmaxf(acc[2 * h + 1] + l1b.y, 0.f);
      float part = fmaf(z1, l2w.y, z0 * l2w.x);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (t == 0) red[(g + 8 * h) * GW + wid] = part;
    }
    group_sync(q.grp);
    if (gl < TM) {
      const int jg = rt * TM + gl;
      if (jg < rows) {
        const float* pr = red + gl * GW;
        const float sum = ((pr[0] + pr[1]) + (pr[2] + pr[3])) +
                          ((pr[4] + pr[5]) + (pr[6] + pr[7]));
        const int b = jg / tl.n, p = tl.s0 + (jg - b * tl.n);
        a.wav[(size_t)b * a.N + (p - tl.start)] = sum + a.last2_b[0];
      }
    }
    group_sync(q.grp);  // red and the z tile are reused by the next tile
  }
}

template <int NG>
__global__ void __launch_bounds__(NG * GW * 32, 1)
    pwg_stream_kernel(PwgArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);   // (K1p * 128) w1k
  float* w2_s = w_s + (size_t)a.K1p * NC;         // (64 * 128) w2k
  float* a_s = w2_s + C * NC;                     // (NG, TM, K1p + 4)
  float* g_s = a_s + NG * TM * (a.K1p + 4);       // (NG, TM, GS)
  Lanes q;
  q.grp = threadIdx.x / (GW * 32);
  q.wid = (threadIdx.x / 32) % GW;
  q.lane = threadIdx.x & 31;
  q.g = q.lane >> 2;
  q.t = q.lane & 3;
  const size_t gtid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t gstride = (size_t)gridDim.x * blockDim.x;
  const size_t hsize = (size_t)a.B * a.sum_bw * C;

  const int start = a.pos != nullptr ? a.pos[0] : a.start;
  const int W = a.pos != nullptr ? a.pos[1] : a.W;
  prologue(a, start, gtid, gstride);
  const int end = start + a.N;
  first_conv(a, start, W, start, min(a.tile, a.N), gtid, gstride);
  grid.sync();
  int t = 0;
  for (int s0 = start; s0 < end; s0 += a.tile, ++t) {
    const bool last = s0 + a.tile >= end;
    Tile tl;
    tl.s0 = s0;
    tl.n = min(a.tile, end - s0);
    tl.start = start;
    tl.W = W;
    tl.hread = t == 0 ? a.bufs_in : a.hbuf + (t & 1) * hsize;
    tl.hwrite = last ? a.bufs_out : a.hbuf + ((t + 1) & 1) * hsize;
    for (int i = 0; i < a.L; ++i) {
      layer<NG>(a, i, tl, w_s, w2_s, a_s, g_s, q, gtid, gstride);
      grid.sync();
    }
    head<NG>(a, tl, a_s, g_s, q);
    if (!last)
      first_conv(a, start, W, s0 + a.tile, min(a.tile, end - s0 - a.tile),
                 gtid, gstride);
    grid.sync();
  }
  if (a.ah_out != nullptr) epilogue(a, start, gtid, gstride);
}

size_t smem_bytes(int NG, int K1p) {
  return ((size_t)K1p * NC + C * NC + NG * TM * (K1p + 4 + GS)) *
         sizeof(float);
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success); *info describes the launch.
int pwg_stream_launch(const PwgArgs* a, void* stream, PwgLaunchInfo* info) {
  int dev = 0, sms = 0, coop = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  if (a->K1p % 8 || a->K1p < 3 * C + a->A || a->A % 4 || a->L > MAX_LAYERS ||
      a->N < 1 || a->tile < 1 || (a->ra & (a->ra - 1)))
    return cudaErrorInvalidValue;
  // two groups of 8 warps where both groups' tiles fit beside the
  // weights (aux up to 104 channels), one group otherwise
  const int NG = smem_bytes(2, a->K1p) <= (size_t)optin ? 2 : 1;
  const size_t smem = smem_bytes(NG, a->K1p);
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  const void* kern = NG == 2 ? reinterpret_cast<const void*>(
                                   pwg_stream_kernel<2>)
                             : reinterpret_cast<const void*>(
                                   pwg_stream_kernel<1>);
  const int threads = NG * GW * 32;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  // cooperative launch needs every block co-resident: size the grid from
  // the occupancy calculator, capped at the block tiles of one phase
  int occ = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, threads,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (occ < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int rows = a->B * min(a->tile, a->N);
  const int n_rt = (rows + TM - 1) / TM;
  const int grid = max(1, min(occ * sms, n_rt));
  const int n_tiles = (a->N + a->tile - 1) / a->tile;
  info->grid = grid;
  info->block_rows = TM;
  info->block_tiles = n_rt;
  info->barriers = 1 + n_tiles * (a->L + 1);
  info->groups = NG;
  info->smem_bytes = (int)smem;
  void* params[] = {const_cast<PwgArgs*>(a)};
  // the cooperative launch as cudaLaunchKernelExC with the cooperative
  // attribute: the same launch, in the form a CUDA graph capture records
  // as a kernel node
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelExC(&cfg, kern, params);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // extern "C"

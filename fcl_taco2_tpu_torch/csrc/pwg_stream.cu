// Streaming Parallel-WaveGAN generator for Hopper (sm_90a), fp32.
//
// Replaces the two Pallas TPU kernels of fcl_taco2_tpu/vocoder/pwg_pallas.py:
//   pwg_generate_streaming (_kernel)         one-shot, zero state
//   pwg_stream_step        (_stream_kernel)  one chunk, state in and out
// Both run the causal reformulation of the 30-layer generator: layer i reads
// its input stream x_i at positions p-2d, p-d, p, the upsampled mel at
// p - cum_i, adds its skip output at p + delay - cum_i, and masks its output
// to [cum_i, W + cum_i); x_0 = noise * first_w + first_b masked to p < W.
// The entries differ only where the TPU kernels differ: the stream entry
// loads its state before the first tile and stores it after the last, and
// takes start and W at run time.
//
// The TPU grid walks the tiles in order and carries the state in VMEM
// scratch; Hopper blocks run in no order, and at PWG v1 the state is about
// 3.6 MB a row (layer rings, aux history, skip accumulator), far beyond one
// block's 227 KB.  So the state lives in device memory, indexed by absolute
// stream position: one ring per layer input (slot = p & (rx - 1)) and one
// for the skip accumulator (slot = q & (ra - 1)); the aux history is read
// in place from the caller's aux (positions >= start) or the state's
// aux_hist (positions < start).  A ring needs no shift between tiles, and
// the JAX state layout appears only in the prologue and epilogue.
//
// One cooperative launch walks the time tiles in order.  Per tile of n
// positions (all B rows): phase F writes x_0; phases 0..L-1 run the layers;
// phase H reads the skip sum and runs the head (relu, last1, relu, last2).
// A grid-wide barrier separates the phases; inside a phase the B*n rows are
// cut into 64-row block tiles spread over all blocks, so batch 1 fills the
// card as batch 8 does.  Each block tile is two register-blocked fp32
// products staged through shared memory: h = [x(p-2d) x(p-d) x(p) aux] @ w1
// (K = 3*64 + A padded to 16, N = 128 gate columns), then
// [skip | out] = g @ w2 (K = 64, N = 128).  Every output element sums its
// products in one fixed order whatever the tiling, so chained stream steps
// equal the one-shot call bit for bit.
//
// What bounds it on the H100.  PWG v1 does 1.29 M multiply-adds per output
// sample (3*64*128 + 80*128 + 64*64 + 64*64 per layer, 30 layers, plus the
// head); in fp32 on the CUDA cores (67 TFLOP/s) that is 38.6 ns a sample,
// 15.2 ms for the 393,216 samples of a 96-phoneme utterance's frame budget,
// while its bytes (weights 5.2 MB once, aux 126 MB, noise and wav) take
// 39 us at 3.35 TB/s.  So the ideal kernel is bound by fp32 operations.
// What the design does about it: the whole layer stack runs in one launch;
// activations, rings and the 5.2 MB of weights stay in the 50 MB L2 at the
// chosen tile (B * tile = 16,384 rows a phase); each thread computes a 4 x 8
// block of outputs from 16-byte shared-memory loads (3 vector loads per 32
// FMAs).  Left for later PRs: tensor cores (TF32 or bf16x3 would change the
// numbers and need a tolerance decision), cp.async/TMA staging of the weight
// chunks, and fusing the upsampler so the 126 MB aux never leaves the chip.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define MAX_LAYERS 64

extern "C" {
// Field order and types mirror _PwgArgs in vocoder/pwg_cuda.py.
struct PwgArgs {
  const float* noise;    // (B, n_noise): positions [start, start + n_noise)
  const float* aux;      // (B, n_aux, A): positions [start, start + n_aux)
  const float* w1;       // (L, K1p, 128)
  const float* b1;       // (L, 128)
  const float* w2;       // (L, 64, 128): [skip | out]
  const float* b2;       // (L, 128)
  const float* first_w;  // (64,)
  const float* first_b;  // (64,)
  const float* last1_w;  // (64, 128), columns 64.. zero
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
  float* ring_x;         // (B, L, rx, 64) scratch
  float* ring_acc;       // (B, ra, 64) scratch
  int B, N, n_aux, n_noise, start, W, A, K1p, L, delay, tile, rx, ra, sum_bw;
  float z_scale;         // sqrt(1 / L)
  int dil[MAX_LAYERS];
  int cum[MAX_LAYERS];     // d_0 + .. + d_i
  int bw[MAX_LAYERS];      // max(8, 2 d_i)
  int buf_off[MAX_LAYERS]; // row offset of layer i in bufs_in / bufs_out
};
}

namespace {

constexpr int C = 64;     // residual channels (= skip channels = gates / 2)
constexpr int NC = 128;   // output columns of every product
constexpr int NT = 256;   // threads: 16 column groups x 16 row groups
constexpr int TM = 64;    // rows (stream positions) per block tile
constexpr int KC = 16;    // contraction rows per staged weight chunk
constexpr float SQRT_HALF = 0.70710678118654752f;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Conditioning at stream position q, columns col..col+3: the caller's aux
// from start on, the state's history before it, zero past the aux's end.
__device__ __forceinline__ float4 aux4(const PwgArgs& a, int b, int q,
                                       int col) {
  const int j = q - a.start;
  if (j >= 0) {
    if (j < a.n_aux)
      return ld4(a.aux + ((size_t)b * a.n_aux + j) * a.A + col);
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (a.ah_in != nullptr)
    return ld4(a.ah_in + ((size_t)b * a.delay + j + a.delay) * a.A + col);
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float* xrow(const PwgArgs& a, int b, int layer,
                                       int p) {
  return a.ring_x + (((size_t)b * a.L + layer) * a.rx + (p & (a.rx - 1))) * C;
}

__device__ __forceinline__ float* accrow(const PwgArgs& a, int b, int q) {
  return a.ring_acc + ((size_t)b * a.ra + (q & (a.ra - 1))) * C;
}

// acc[r][c] = sum_k a_s[k][4ty + r] * W[k][col(c)], k in [0, K), where
// col(c) = 4tx + c for c < 4 and 64 + 4tx + (c - 4) otherwise.  W (K, 128)
// is read from global memory in KC-row chunks, double-buffered in w_s; the
// next chunk's loads are in flight while the current one is multiplied.
// Ends with a barrier, so w_s and a_s are free on return.
__device__ __forceinline__ void block_gemm(const float* __restrict__ w, int K,
                                           const float* a_s, float* w_s,
                                           float acc[4][8], int tx, int ty,
                                           int tid) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  const int nch = K / KC;
  // a chunk is KC x 128 floats = 512 float4: two per thread
  const int e0 = tid, e1 = tid + NT;
  float4 pre0 = ld4(w + (size_t)(e0 / 32) * NC + (e0 % 32) * 4);
  float4 pre1 = ld4(w + (size_t)(e1 / 32) * NC + (e1 % 32) * 4);
  st4(w_s + (e0 / 32) * NC + (e0 % 32) * 4, pre0);
  st4(w_s + (e1 / 32) * NC + (e1 % 32) * 4, pre1);
  __syncthreads();
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) {
      const float* wc = w + (size_t)(ch + 1) * KC * NC;
      pre0 = ld4(wc + (e0 / 32) * NC + (e0 % 32) * 4);
      pre1 = ld4(wc + (e1 / 32) * NC + (e1 % 32) * 4);
    }
    const float* wb = w_s + (ch & 1) * KC * NC;
    const float* ab = a_s + ch * KC * TM;
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const float4 av = ld4(ab + kk * TM + 4 * ty);
      const float4 w0 = ld4(wb + kk * NC + 4 * tx);
      const float4 w1 = ld4(wb + kk * NC + 64 + 4 * tx);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float wr[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(ar[r], wr[c], acc[r][c]);
    }
    if (ch + 1 < nch) {
      float* wn = w_s + ((ch + 1) & 1) * KC * NC;
      st4(wn + (e0 / 32) * NC + (e0 % 32) * 4, pre0);
      st4(wn + (e1 / 32) * NC + (e1 % 32) * 4, pre1);
    }
    __syncthreads();
  }
}

// Load the state into the rings (zero where there is none).
__device__ void prologue(const PwgArgs& a, size_t gtid, size_t gstride) {
  const size_t nbuf = (size_t)a.B * a.sum_bw * C;
  for (size_t e = gtid; e < nbuf; e += gstride) {
    const int c = e % C;
    const int row = (e / C) % a.sum_bw;
    const int b = e / ((size_t)C * a.sum_bw);
    int i = 0;
    while (row >= a.buf_off[i] + a.bw[i]) ++i;
    const int p = a.start - a.bw[i] + (row - a.buf_off[i]);
    xrow(a, b, i, p)[c] = a.bufs_in ? a.bufs_in[e] : 0.f;
  }
  const size_t nacc = (size_t)a.B * a.ra * C;
  for (size_t e = gtid; e < nacc; e += gstride) {
    const int c = e % C;
    const int k = (e / C) % a.ra;
    const int b = e / ((size_t)C * a.ra);
    float v = 0.f;
    if (a.acc_in != nullptr && k < a.delay)
      v = a.acc_in[((size_t)b * a.delay + k) * C + c];
    accrow(a, b, a.start + k)[c] = v;
  }
}

// Store the state after the last tile (stream entry only).
__device__ void epilogue(const PwgArgs& a, size_t gtid, size_t gstride) {
  const int end = a.start + a.N;
  const size_t nah = (size_t)a.B * a.delay * (a.A / 4);
  for (size_t e = gtid; e < nah; e += gstride) {
    const int c4 = e % (a.A / 4);
    const int j = (e / (a.A / 4)) % a.delay;
    const int b = e / ((size_t)(a.A / 4) * a.delay);
    st4(a.ah_out + ((size_t)b * a.delay + j) * a.A + 4 * c4,
        aux4(a, b, end - a.delay + j, 4 * c4));
  }
  const size_t nacc = (size_t)a.B * a.delay * C;
  for (size_t e = gtid; e < nacc; e += gstride) {
    const int c = e % C;
    const int j = (e / C) % a.delay;
    const int b = e / ((size_t)C * a.delay);
    a.acc_out[e] = accrow(a, b, end + j)[c];
  }
  const size_t nbuf = (size_t)a.B * a.sum_bw * C;
  for (size_t e = gtid; e < nbuf; e += gstride) {
    const int c = e % C;
    const int row = (e / C) % a.sum_bw;
    const int b = e / ((size_t)C * a.sum_bw);
    int i = 0;
    while (row >= a.buf_off[i] + a.bw[i]) ++i;
    a.bufs_out[e] = xrow(a, b, i, end - a.bw[i] + (row - a.buf_off[i]))[c];
  }
}

// Phase F: x_0 at positions [s0, s0 + n) of every row.
__device__ void first_conv(const PwgArgs& a, int s0, int n, size_t gtid,
                           size_t gstride) {
  const size_t total = (size_t)a.B * n * C;
  for (size_t e = gtid; e < total; e += gstride) {
    const int c = e % C;
    const int r = (e / C) % n;
    const int b = e / ((size_t)C * n);
    const int p = s0 + r;
    const int j = p - a.start;
    float v = 0.f;
    if (p < a.W) {
      const float nz = j < a.n_noise ? a.noise[(size_t)b * a.n_noise + j] : 0.f;
      v = nz * a.first_w[c] + a.first_b[c];
    }
    xrow(a, b, 0, p)[c] = v;
  }
}

// Phase i: layer i over the rows [s0, s0 + n) of every batch row.
__device__ void layer(const PwgArgs& a, int i, int s0, int n, float* a_s,
                      float* w_s, float* g_s, int tx, int ty, int tid) {
  const int rows = a.B * n;
  const int n_rt = (rows + TM - 1) / TM;
  const int d = a.dil[i], cum = a.cum[i];
  const int k_aux = 3 * C, k_end = 3 * C + a.A;
  const float* w1 = a.w1 + (size_t)i * a.K1p * NC;
  const float* w2 = a.w2 + (size_t)i * C * NC;
  for (int rt = blockIdx.x; rt < n_rt; rt += gridDim.x) {
    // A tile, k-major: a_s[k][m]
    for (int e = tid; e < (a.K1p / 4) * TM; e += NT) {
      const int m = e % TM, k = 4 * (e / TM);
      const int jg = rt * TM + m;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (jg < rows) {
        const int b = jg / n, p = s0 + jg % n;
        if (k < k_aux) {
          const int t = k / C;
          v = ld4(xrow(a, b, i, p - (2 - t) * d) + (k % C));
        } else if (k < k_end) {
          v = aux4(a, b, p - cum, k - k_aux);
        }
      }
      a_s[(k + 0) * TM + m] = v.x;
      a_s[(k + 1) * TM + m] = v.y;
      a_s[(k + 2) * TM + m] = v.z;
      a_s[(k + 3) * TM + m] = v.w;
    }
    __syncthreads();
    float acc[4][8];
    block_gemm(w1, a.K1p, a_s, w_s, acc, tx, ty, tid);
    // gated activation; g_s[k][m] is the second product's A tile
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float ht = acc[r][c] + a.b1[i * NC + 4 * tx + c];
        const float hs = acc[r][4 + c] + a.b1[i * NC + 64 + 4 * tx + c];
        g_s[(4 * tx + c) * TM + 4 * ty + r] =
            tanhf(ht) * (1.f / (1.f + expf(-hs)));
      }
    __syncthreads();
    block_gemm(w2, C, g_s, w_s, acc, tx, ty, tid);
    const float* b2 = a.b2 + i * NC;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = 4 * ty + r;
      const int jg = rt * TM + m;
      if (jg >= rows) continue;
      const int b = jg / n, p = s0 + jg % n;
      float* ap = accrow(a, b, p + a.delay - cum) + 4 * tx;
      float4 s = ld4(ap);
      s.x = s.x + acc[r][0] + b2[4 * tx + 0];
      s.y = s.y + acc[r][1] + b2[4 * tx + 1];
      s.z = s.z + acc[r][2] + b2[4 * tx + 2];
      s.w = s.w + acc[r][3] + b2[4 * tx + 3];
      st4(ap, s);
      if (i + 1 < a.L) {
        const bool keep = p >= cum && p < a.W + cum;
        float xo[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float center = a_s[(C + 4 * tx + c) * TM + m];  // x_i(p - d)
          xo[c] = keep ? ((acc[r][4 + c] + b2[64 + 4 * tx + c]) + center) *
                             SQRT_HALF
                       : 0.f;
        }
        st4(xrow(a, b, i + 1, p) + 4 * tx,
            make_float4(xo[0], xo[1], xo[2], xo[3]));
      }
    }
    __syncthreads();  // a_s and g_s are reused by the next block tile
  }
}

// Phase H: wav at positions [s0, s0 + n); the read skip slots are zeroed
// for their reuse ra positions later.
__device__ void head(const PwgArgs& a, int s0, int n, float* a_s, float* w_s,
                     int tx, int ty, int tid) {
  const int rows = a.B * n;
  const int n_rt = (rows + TM - 1) / TM;
  for (int rt = blockIdx.x; rt < n_rt; rt += gridDim.x) {
    for (int e = tid; e < (C / 4) * TM; e += NT) {
      const int m = e % TM, k = 4 * (e / TM);
      const int jg = rt * TM + m;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (jg < rows) {
        const int b = jg / n, p = s0 + jg % n;
        float* ap = accrow(a, b, p) + k;
        v = ld4(ap);
        st4(ap, make_float4(0.f, 0.f, 0.f, 0.f));
        v.x = fmaxf(v.x * a.z_scale, 0.f);
        v.y = fmaxf(v.y * a.z_scale, 0.f);
        v.z = fmaxf(v.z * a.z_scale, 0.f);
        v.w = fmaxf(v.w * a.z_scale, 0.f);
      }
      a_s[(k + 0) * TM + m] = v.x;
      a_s[(k + 1) * TM + m] = v.y;
      a_s[(k + 2) * TM + m] = v.z;
      a_s[(k + 3) * TM + m] = v.w;
    }
    __syncthreads();
    float acc[4][8];
    block_gemm(a.last1_w, C, a_s, w_s, acc, tx, ty, tid);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float z = fmaxf(acc[r][c] + a.last1_b[4 * tx + c], 0.f);
        part = fmaf(z, a.last2_w[4 * tx + c], part);
      }
      // the 16 column groups of a row sit in one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      const int jg = rt * TM + 4 * ty + r;
      if (tx == 0 && jg < rows) {
        const int b = jg / n, p = s0 + jg % n;
        a.wav[(size_t)b * a.N + (p - a.start)] = part + a.last2_b[0];
      }
    }
  }
}

__global__ void __launch_bounds__(NT, 2) pwg_stream_kernel(PwgArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);  // (K1p, TM)
  float* w_s = a_s + (size_t)a.K1p * TM;         // (2, KC, 128)
  float* g_s = w_s + 2 * KC * NC;                 // (64, TM)
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const size_t gtid = (size_t)blockIdx.x * NT + tid;
  const size_t gstride = (size_t)gridDim.x * NT;

  prologue(a, gtid, gstride);
  grid.sync();
  const int end = a.start + a.N;
  for (int s0 = a.start; s0 < end; s0 += a.tile) {
    const int n = min(a.tile, end - s0);
    first_conv(a, s0, n, gtid, gstride);
    grid.sync();
    for (int i = 0; i < a.L; ++i) {
      layer(a, i, s0, n, a_s, w_s, g_s, tx, ty, tid);
      grid.sync();
    }
    head(a, s0, n, a_s, w_s, tx, ty, tid);
    grid.sync();
  }
  if (a.ah_out != nullptr) epilogue(a, gtid, gstride);
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success); *grid_out gets the blocks launched.
int pwg_stream_launch(const PwgArgs* a, void* stream, int* grid_out) {
  const size_t smem =
      ((size_t)a->K1p * TM + 2 * KC * NC + (size_t)C * TM) * sizeof(float);
  auto kern = pwg_stream_kernel;
  int dev = 0, sms = 0, coop = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  if (a->K1p % KC || a->A % 4 || a->L > MAX_LAYERS || a->N < 1 ||
      (a->rx & (a->rx - 1)) || (a->ra & (a->ra - 1)))
    return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  // cooperative launch needs every block co-resident: size the grid from
  // the occupancy calculator, capped at the block tiles of one phase
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, NT, smem);
  if (e != cudaSuccess) return e;
  if (occ < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int n_rt = (a->B * a->tile + TM - 1) / TM;
  const int grid = max(1, min(occ * sms, n_rt));
  *grid_out = grid;
  void* params[] = {const_cast<PwgArgs*>(a)};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                  dim3(grid), dim3(NT), params, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // extern "C"

// The serving encoder's bidirectional LSTM for Hopper (sm_90a): one launch
// runs the whole recurrence, both directions and every group of rows
// (ops/blstm_cuda.py::bilstm_infer; models/encoder.py::encoder_apply takes
// it when serving).
//
// Replaces no TPU kernel: the JAX package runs this recurrence under
// jax.lax.scan (fcl_taco2_tpu/ops/rnn.py:154), which XLA compiles into one
// device loop.  The port ran it as a Python loop of ~13 small PyTorch
// kernels a token and direction (ops/rnn.py::lstm_scan), the directions one
// after the other to the bucket's Tmax: at batch 16 some 3,000 graph nodes
// of 1-3 us a call, most of their time the gaps between them.
//
// Bound: the chain of dependent steps.  One step of one direction at batch
// 16 and H = 256 is 16 x 256 x 1024 multiply-adds (~10 ns of the card's
// bf16 peak) and W_hh is 512 KB a direction; the bytes once (W_hh, xproj,
// the output) take ~2 us of HBM a call.  What sets the time is the
// max(ilens) steps, each waiting for the whole h of the step before.
//
// What the design does about it:
// - Persistent: the time loop runs inside the kernel.  A cluster of CS
//   blocks runs one direction of one group of 16 rows (one mma m16 tile);
//   the directions and the row groups run side by side as clusters of their
//   own (grid = 2 x groups x CS), so any batch works.  The loop runs to the
//   batch's longest row, read on the card, and a CUDA graph replays it for
//   any lengths.
// - Weight-stationary: block r of a cluster owns the hidden units
//   [r UB, (r+1) UB) with all four of their gate rows, so a unit's gates,
//   cell update and state stay in one block.  Its slice of W_hh (Kp x 4 UB,
//   columns gate-major: q UB + u) is read once a launch from the cell's own
//   (4H, H) weight and written into shared memory in mma B-fragment order
//   (bf16 H = 256: UB = 32, CS = 8, 64 KB a block), so no packed copy of the
//   weights exists.  A warp multiplies its n-tiles over the whole K, in k
//   order.
// - One cluster barrier a step: each block writes its units' h_t into its
//   own copy of h (fragment order, double-buffered), copies that slice
//   into every peer's copy through distributed shared memory (16-byte
//   stores), and arrives; the next step's xproj values are loaded while it
//   waits for the peers.
// - Exact at any width: the slice is zero-padded to CS x UB units, so K is
//   Kp = CS x UB (a multiple of 16).  A padded unit sees zero weights, bias
//   and input: its gates are 0, and its c and h stay exactly 0.
// - The loop's rounding points: h @ W_hh^T summed in fp32 (bf16 mma.sync
//   m16n8k16, or 3xTF32 m16n8k8 for fp32 weights) plus b_hh, rounded to
//   the storage type; plus xproj_t, rounded; each sigmoid, tanh, product
//   and sum rounded, with the float functions of PyTorch's own kernels
//   (expf, tanhf, IEEE division and _rn operations, so nothing contracts
//   into an fma); h and c held in the storage type.  Only the product's
//   summation order differs from the loop's cuBLAS call.
// - Packed-sequence semantics: past a row's length its state holds and its
//   output is zero, so the reverse direction starts at the row's last
//   token.  The kernel writes every output value (zeros past a row's length
//   and past the longest row), so the output needs no fill.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

extern "C" {
// Field order and types mirror BlstmArgs in ops/blstm_cuda.py.
struct BlstmArgs {
  const void* xf;    // (B, T, 4H): x @ W_ih^T + b_ih of the forward cell
  const void* xb;    // (B, T, 4H): the same of the reverse cell
  const void* wf;    // (4H, H): W_hh of the forward cell, gates i, f, g, o
  const void* wb;    // (4H, H): W_hh of the reverse cell
  const void* bf;    // (4H,): b_hh of the forward cell
  const void* bb;    // (4H,): b_hh of the reverse cell
  const void* lens;  // (B,) i32
  void* out;         // (B, T, 2H): [forward | reverse]
  void* steps;       // (1,) i32: the loop's steps, max(lens) within T
  int B, T, H, UB, CS;
};

// What a launch did, for the wrapper's log (blstm_cuda.last_launch).
struct BlstmLaunchInfo {
  int grid, cluster, units_per_block, block_threads, smem_bytes;
};
}

namespace cg = cooperative_groups;

namespace {

constexpr int NTH = 256;  // threads a block
constexpr int NW = NTH / 32;
constexpr int ROWS = 16;  // rows a cluster: one m16 tile

template <typename T>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<bf16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <>
__device__ __forceinline__ float rnd<float>(float x) {
  return x;
}

template <typename T>
__device__ __forceinline__ float ld(const T* p);
template <>
__device__ __forceinline__ float ld<bf16>(const bf16* p) {
  return __bfloat162float(*p);
}
template <>
__device__ __forceinline__ float ld<float>(const float* p) {
  return *p;
}

// PyTorch's sigmoid of a float: 1 / (1 + exp(-x)), IEEE division
__device__ __forceinline__ float sigmoid_ref(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// shared memory of a block: the W_hh slice, two copies of h (16 rows of
// Kp + 16, fragment order), the gate sums (16 x 4 UB f32), the row lengths
// and the warps' maxima
template <typename T>
__host__ __device__ size_t smem_bytes(int UB, int CS) {
  const int Kp = CS * UB;
  return (size_t)4 * UB * Kp * sizeof(T) +
         (size_t)2 * ROWS * (Kp + 16) * sizeof(T) +
         (size_t)ROWS * 4 * UB * sizeof(float) + (size_t)(ROWS + NW) * 4;
}

// Block `rank`'s slice of a (4H, H) W_hh into shared memory `wsm` (zeroed
// before), in fragment order.  Its column n = q UB + u is gate q of unit
// rank UB + u.  A job is one column's 16 k values of one k16 step: read
// from the row of W_hh (16-byte vectors where H allows), permuted by
// apos, and stored as the 32 (bf16) or 64 (f32) contiguous bytes that
// lane 4 (n % 8) + t's fragments take (n-tile n / 8, k16 step k / 16).
// Eight neighbouring threads take the eight columns of an n-tile, so their
// stores fill whole lines of shared memory; NB jobs are read before any
// is stored.  Units and K rows past H stay zero.
template <typename T>
__device__ __forceinline__ void load_slice(T* wsm, const T* w, int H, int UB,
                                           int rank, int KG) {
  constexpr int VJ = sizeof(T), NB = 4;  // 16-byte vectors a job
  const int units = min(UB, H - rank * UB), jobs = 4 * UB * KG;
  const bool vec = H % 16 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  for (int base = threadIdx.x; base < jobs; base += NB * NTH) {
    uint4 raw[NB][VJ];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int i = base + b * NTH, n = (i >> 3) / KG * 8 + (i & 7);
      const int u = n % UB, k0 = (i >> 3) % KG * 16;
      T* v = reinterpret_cast<T*>(raw[b]);
      if (i >= jobs || u >= units || k0 >= H) continue;
      const T* src = w + (size_t)((n / UB) * H + rank * UB + u) * H + k0;
      if (vec) {
#pragma unroll
        for (int j = 0; j < VJ; ++j)
          raw[b][j] = __ldg(reinterpret_cast<const uint4*>(src) + j);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) v[e] = k0 + e < H ? src[e] : T(0.0f);
      }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int i = base + b * NTH, n = (i >> 3) / KG * 8 + (i & 7);
      const int u = n % UB, kg = (i >> 3) % KG;
      if (i >= jobs || u >= units || kg * 16 >= H) continue;
      const T* v = reinterpret_cast<const T*>(raw[b]);
      uint4 perm[VJ];
      T* o = reinterpret_cast<T*>(perm);
#pragma unroll
      for (int e = 0; e < 16; ++e) o[apos<T>(e)] = v[e];
      uint4* dst = reinterpret_cast<uint4*>(
          wsm + ((size_t)(n >> 3) * KG + kg) * 128 + (n & 7) * 16);
#pragma unroll
      for (int j = 0; j < VJ; ++j) dst[j] = perm[j];
    }
  }
}

// NTW: n-tiles a warp (UB = 16: 1, UB = 32: 2); T: bf16 or f32 (weights,
// activations, state and output alike)
template <typename T, int NTW>
__global__ void __launch_bounds__(NTH, 1) blstm_kernel(const BlstmArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int UB = a.UB, CS = a.CS, H = a.H, B = a.B, Tn = a.T;
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / CS;
  const int dir = cid & 1, grp = cid >> 1;
  const int Kp = CS * UB, KG = Kp / 16, NC = 4 * UB, lda = Kp + 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  extern __shared__ __align__(16) unsigned char smem[];
  const size_t wn = (size_t)NC * Kp;
  T* wsm = reinterpret_cast<T*>(smem);
  T* hbuf = wsm + wn;  // [2][ROWS][lda]
  float* gsm = reinterpret_cast<float*>(hbuf + 2 * ROWS * lda);  // [ROWS][NC]
  int* lsm = reinterpret_cast<int*>(gsm + ROWS * NC);  // [ROWS + NW]

  // zeroed slice and copies of h, then the slice, the lengths
  {
    uint4* z = reinterpret_cast<uint4*>(smem);
    const int nz = (int)((wn + 2 * ROWS * lda) * sizeof(T) / 16);
    for (int i = threadIdx.x; i < nz; i += NTH) z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  load_slice<T>(wsm, static_cast<const T*>(dir ? a.wb : a.wf), H, UB, rank,
                KG);
  const int* lens = static_cast<const int*>(a.lens);
  int mx = 0;
  for (int b = threadIdx.x; b < B; b += NTH)
    mx = max(mx, min(max(lens[b], 0), Tn));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = max(mx, __shfl_xor_sync(~0u, mx, o));
  if (lane == 0) lsm[ROWS + warp] = mx;
  if (threadIdx.x < ROWS) {
    const int b = grp * ROWS + threadIdx.x;
    lsm[threadIdx.x] = b < B ? min(max(lens[b], 0), Tn) : 0;
  }
  __syncthreads();
  int steps = 0;
  for (int w = 0; w < NW; ++w) steps = max(steps, lsm[ROWS + w]);
  if (blockIdx.x == 0 && threadIdx.x == 0)
    *static_cast<int*>(a.steps) = steps;

  // this thread's cells: units j, j + 1 of row r (8 UB threads take part)
  const bool cell = threadIdx.x < 8 * UB;
  const int r = threadIdx.x / (UB / 2), u = 2 * (threadIdx.x % (UB / 2));
  const int b = grp * ROWS + r, j = rank * UB + u;
  const bool live = cell && b < B;
  const int L = live ? lsm[r] : 0;
  const T* xp = static_cast<const T*>(dir ? a.xb : a.xf);
  T* out = static_cast<T*>(a.out);
  const int H4 = 4 * H, H2 = 2 * H;
  float hs[2] = {0.0f, 0.0f}, cs[2] = {0.0f, 0.0f};
  float xn[2][4];
  auto load_x = [&](int s) {
    const int t = dir ? steps - 1 - s : s;
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int q = 0; q < 4; ++q) xn[e][q] = 0.0f;
    if (live && s < steps && t < L) {
      const T* p = xp + ((size_t)b * Tn + t) * H4 + j;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (j + e < H)
#pragma unroll
          for (int q = 0; q < 4; ++q) xn[e][q] = ld<T>(p + q * H + e);
    }
  };
  load_x(0);

  // b_hh of this lane's accumulator columns (zero past H)
  const T* bias = static_cast<const T*>(dir ? a.bb : a.bf);
  float bcol[NTW][2];
#pragma unroll
  for (int i = 0; i < NTW; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = (warp * NTW + i) * 8 + 2 * (lane & 3) + e;
      const int q = n / UB, unit = rank * UB + n % UB;
      bcol[i][e] = unit < H ? ld<T>(bias + q * H + unit) : 0.0f;
    }
  const T* wwarp = wsm + (size_t)warp * NTW * KG * 128;
  cluster.sync();  // every copy of h is zero before a peer writes one

  for (int s = 0; s < steps; ++s) {
    const int t = dir ? steps - 1 - s : s;
    const T* hprev = hbuf + ((s + 1) & 1) * ROWS * lda;
    T* hcur = hbuf + (s & 1) * ROWS * lda;

    // gh = round(h_{s-1} @ W_hh^T + b_hh) of this warp's columns
    float acc[NTW][4];
#pragma unroll
    for (int i = 0; i < NTW; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][k] = 0.0f;
    warp_mma<T, T, NTW, 4, false>(acc, hprev, lda, wwarp, (long)KG * 128,
                                  KG);
#pragma unroll
    for (int i = 0; i < NTW; ++i) {
      const int col = (warp * NTW + i) * 8 + 2 * (lane & 3);
      const int row = lane >> 2;
      gsm[row * NC + col] = rnd<T>(__fadd_rn(acc[i][0], bcol[i][0]));
      gsm[row * NC + col + 1] = rnd<T>(__fadd_rn(acc[i][1], bcol[i][1]));
      gsm[(row + 8) * NC + col] = rnd<T>(__fadd_rn(acc[i][2], bcol[i][0]));
      gsm[(row + 8) * NC + col + 1] =
          rnd<T>(__fadd_rn(acc[i][3], bcol[i][1]));
    }
    __syncthreads();

    // the cell update of units j, j + 1 (rounded as the loop rounds)
    if (cell) {
      const bool valid = t < L;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float* g = gsm + r * NC + u + e;
        const float gi = rnd<T>(__fadd_rn(xn[e][0], g[0]));
        const float gf = rnd<T>(__fadd_rn(xn[e][1], g[UB]));
        const float gg = rnd<T>(__fadd_rn(xn[e][2], g[2 * UB]));
        const float go = rnd<T>(__fadd_rn(xn[e][3], g[3 * UB]));
        const float si = rnd<T>(sigmoid_ref(gi));
        const float sf = rnd<T>(sigmoid_ref(gf));
        const float tg = rnd<T>(tanhf(gg));
        const float so = rnd<T>(sigmoid_ref(go));
        const float cn = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(sf, cs[e])),
                                          rnd<T>(__fmul_rn(si, tg))));
        const float hn = rnd<T>(__fmul_rn(so, rnd<T>(tanhf(cn))));
        if (valid) {
          cs[e] = cn;
          hs[e] = hn;
        }
        if (live && j + e < H)
          out[((size_t)b * Tn + t) * H2 + dir * H + j + e] =
              T(valid ? hs[e] : 0.0f);
        hcur[r * lda + apos<T>(j + e)] = T(hs[e]);
      }
    }
    __syncthreads();

    // this block's slice of h_t into every peer's copy
    const int vrow = UB * (int)sizeof(T) / 16;  // 16-byte vectors a row
    const int nv = ROWS * vrow;
    for (int i = threadIdx.x; i < (CS - 1) * nv; i += NTH) {
      const int p = i / nv, v = i - p * nv;
      const int peer = p < rank ? p : p + 1;
      T* at = hcur + (v / vrow) * lda + rank * UB;
      const uint4 val = reinterpret_cast<const uint4*>(at)[v % vrow];
      reinterpret_cast<uint4*>(cluster.map_shared_rank(at, peer))[v % vrow] =
          val;
    }
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    load_x(s + 1);
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }

  // zeros past the longest row
  if (live)
    for (int t = steps; t < Tn; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (j + e < H)
          out[((size_t)b * Tn + t) * H2 + dir * H + j + e] = T(0.0f);
}

template <typename T, int NTW>
int launch(const BlstmArgs* a, cudaStream_t stream, BlstmLaunchInfo* info) {
  auto kern = blstm_kernel<T, NTW>;
  const size_t smem = smem_bytes<T>(a->UB, a->CS);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int groups = (a->B + ROWS - 1) / ROWS;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = a->CS;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * groups * a->CS);
  cfg.blockDim = dim3(NTH);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  info->grid = 2 * groups * a->CS;
  info->cluster = a->CS;
  info->units_per_block = a->UB;
  info->block_threads = NTH;
  info->smem_bytes = (int)smem;
  BlstmArgs args = *a;
  void* params[] = {&args};
  e = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kern), params);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
int launch_ub(const BlstmArgs* a, cudaStream_t s, BlstmLaunchInfo* info) {
  switch (a->UB) {
    case 16:
      return launch<T, 1>(a, s, info);
    case 32:
      return launch<T, 2>(a, s, info);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16.  Returns a cudaError_t (0 on success); *info
// describes the launch.
int blstm_launch(const BlstmArgs* a, int dtype, void* stream,
                 BlstmLaunchInfo* info) {
  if (a->B < 1 || a->T < 1 || a->CS < 1 || a->CS > 8 ||
      a->H > a->CS * a->UB)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_ub<float>(a, s, info);
    case 1:
      return launch_ub<bf16>(a, s, info);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"

// The backward of the port's regroup gathers (ops/regroup.py::_gather,
// launched by ops/regroup_cuda.py::gather_backward): the gradient of
// x[target] taken as a gather through the plan's inverse map.
//
// Replaces no TPU kernel: the JAX package leaves this transpose to XLA's
// scatter-add.  It was added because autograd's indexing backward sorts
// the indices and gives each run of equal indices to one warp, which walks
// the run serially, and every plan the port builds aims all its padded
// positions at one sentinel row (row 0 of the class flats, or token (0, 0)
// of the token grid): at batch 64 one warp walked ~29k rows a gather.
//
// Bound: bytes.  The gradient is a copy: each source row is read once (a
// valid one into its destination, a padded one into the sentinel's sum)
// and each destination row is written once, 16 bytes a thread.  No sort,
// no atomics, no zero fill, no warp that walks duplicates.
//
// Contract (the plan builders hold it; tests/test_torch_port_regroup.py
// checks them): the valid positions' targets are distinct and in
// [0, rows), and every position that is not valid aims at `sentinel`.
// Then
//   grad_x[r]         = g[i] for the valid i with target(i) = r, else 0,
//   grad_x[sentinel] += the sum of g[i] over the positions not valid
// is the whole transpose, with target(i) = idx0[i] * stride0 + idx1[i]
// (idx1 null: idx0[i] * stride0).
//
// Four steps on the caller's stream:
//   1. inv[0:rows] = -1 (a memset);
//   2. regroup_invert_pad: inv[target(i)] = i for each valid i, and each
//      block's fp32 sum of the padded rows of its strip of positions;
//   3. regroup_write: grad_x[r] = inv[r] >= 0 ? g[inv[r]] + 0 : 0, one
//      16-byte vector a thread (+0 makes -0 into +0, as autograd's 0 + g);
//   4. regroup_sentinel: grad_x[sentinel] += the strips' sums, in fp32,
//      rounded once.
// Every sum runs in an order that the shapes fix (positions in a warp in
// order, then the warps, then the strips), so a replay repeats its bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" {
// Field order and types mirror RegroupArgs in ops/regroup_cuda.py.
struct RegroupArgs {
  const void* g;         // (n, cols) f32 or bf16: the gather's output's grad
  const int* idx0;       // (n,)
  const int* idx1;       // (n,), or null: target(i) = idx0[i] * stride0
  const uint8_t* valid;  // n at stride vstride: the positions not padding
  int* inv;              // rows of scratch
  float* partial;        // ceil(n / strip) * cols of scratch
  void* out;             // (rows, cols), g's type: grad_x
  long long vstride;
  int stride0, n, rows, cols, sentinel, strip;
};

// What a launch did (regroup_cuda.last_launch): the blocks' threads,
// regroup_invert_pad's grid (strips x col_groups), the blocks of
// regroup_write and of regroup_sentinel.
struct RegroupLaunchInfo {
  int block_threads, strips, col_groups, write_blocks, sentinel_blocks;
};
}

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // padded rows a warp has in flight

template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int kVec = 4;  // elements in 16 bytes
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  __device__ static float get(float x) { return x; }
  __device__ static float put(float x) { return x; }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 p = __bfloat1622float2(h[k]);
      f[2 * k] = p.x;
      f[2 * k + 1] = p.y;
    }
  }
  __device__ static uint4 pack(const float* f) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
    return u;
  }
  __device__ static float get(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 put(float x) {
    return __float2bfloat16_rn(x);
  }
};

__device__ __forceinline__ int target(const int* idx0, const int* idx1,
                                      int stride0, int i) {
  return idx0[i] * stride0 + (idx1 != nullptr ? idx1[i] : 0);
}

// grid (strips, ceil(vectors a row / 32)): block (s, y) takes positions
// [s * strip, s * strip + strip) and the 32 vectors of columns from y * 32;
// the blocks of y = 0 also write the inverse map of their strip.
template <typename T>
__global__ void __launch_bounds__(kThreads) regroup_invert_pad(
    const T* __restrict__ g, const int* __restrict__ idx0,
    const int* __restrict__ idx1, int stride0,
    const uint8_t* __restrict__ valid, long long vstride, int n, int rows,
    int cols, int strip, int* __restrict__ inv,
    float* __restrict__ partial) {
  using P = Pack<T>;
  constexpr int V = P::kVec;
  const int lo = blockIdx.x * strip;
  const int hi = min(n, lo + strip);
  if (blockIdx.y == 0) {
    for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
      if (valid[i * vstride]) {
        const int t = target(idx0, idx1, stride0, i);
        if (t >= 0 && t < rows) inv[t] = i;
      }
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int vec = blockIdx.y * 32 + lane;  // this lane's 16 bytes of a row
  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;
  if (vec * V < cols) {
    for (int i0 = lo + warp; i0 < hi; i0 += kUnroll * kWarps) {
      uint4 u[kUnroll];
      bool pad[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const int i = i0 + q * kWarps;
        pad[q] = i < hi && !valid[i * vstride];
        u[q] = pad[q] ? *reinterpret_cast<const uint4*>(
                            g + (long long)i * cols + vec * V)
                      : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        if (pad[q]) {
          float f[V];
          P::unpack(u[q], f);
#pragma unroll
          for (int k = 0; k < V; ++k) acc[k] += f[k];
        }
      }
    }
  }
  __shared__ float red[kWarps][32 * 8];
#pragma unroll
  for (int k = 0; k < V; ++k) red[warp][lane * V + k] = acc[k];
  __syncthreads();
  for (int e = threadIdx.x; e < 32 * V; e += kThreads) {
    const int col = blockIdx.y * 32 * V + e;
    if (col < cols) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w][e];
      partial[(long long)blockIdx.x * cols + col] = s;
    }
  }
}

// One thread a 16-byte vector of grad_x: rows * cols / V threads.
template <typename T>
__global__ void __launch_bounds__(kThreads) regroup_write(
    const T* __restrict__ g, const int* __restrict__ inv, unsigned units,
    int cols, T* __restrict__ out) {
  using P = Pack<T>;
  constexpr int V = P::kVec;
  const unsigned u = blockIdx.x * kThreads + threadIdx.x;
  if (u >= units) return;
  const unsigned per_row = cols / V;
  const unsigned r = u / per_row, v = u - r * per_row;
  const int j = inv[r];
  uint4 o = make_uint4(0u, 0u, 0u, 0u);
  if (j >= 0) {
    float f[V];
    P::unpack(*reinterpret_cast<const uint4*>(g + (long long)j * cols +
                                              v * V), f);
#pragma unroll
    for (int k = 0; k < V; ++k) f[k] += 0.f;
    o = P::pack(f);
  }
  *reinterpret_cast<uint4*>(out + (long long)r * cols + v * V) = o;
}

// grid ceil(cols / 32): warp w sums strips w, w + 8, ... of 32 columns,
// then warp 0 adds the warps' sums in order to the sentinel row.
template <typename T>
__global__ void __launch_bounds__(kThreads) regroup_sentinel(
    const float* __restrict__ partial, int strips, int cols, int sentinel,
    T* __restrict__ out) {
  using P = Pack<T>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (col < cols) {
#pragma unroll 8
    for (int s = warp; s < strips; s += kWarps)
      acc += partial[(long long)s * cols + col];
  }
  __shared__ float red[kWarps][32];
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < cols) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[w][lane];
    T* p = out + (long long)sentinel * cols + col;
    *p = P::put(P::get(*p) + sum);
  }
}

template <typename T>
int run(const RegroupArgs* a, cudaStream_t stream, RegroupLaunchInfo* info) {
  const auto* g = static_cast<const T*>(a->g);
  auto* out = static_cast<T*>(a->out);
  const int per_row = a->cols / Pack<T>::kVec;
  const int strips = (a->n + a->strip - 1) / a->strip;
  const unsigned units = (unsigned)a->rows * (unsigned)per_row;
  *info = RegroupLaunchInfo{kThreads, strips, (per_row + 31) / 32,
                            (int)((units + kThreads - 1) / kThreads),
                            strips > 0 ? (a->cols + 31) / 32 : 0};
  cudaError_t err = cudaMemsetAsync(a->inv, 0xff,
                                    sizeof(int) * (size_t)a->rows, stream);
  if (err != cudaSuccess) return err;
  if (strips > 0) {
    regroup_invert_pad<T><<<dim3(strips, info->col_groups), kThreads, 0,
                            stream>>>(g, a->idx0, a->idx1, a->stride0,
                                      a->valid, a->vstride, a->n, a->rows,
                                      a->cols, a->strip, a->inv, a->partial);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (units == 0) return cudaSuccess;
  regroup_write<T><<<info->write_blocks, kThreads, 0, stream>>>(
      g, a->inv, units, a->cols, out);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (strips > 0) {
    regroup_sentinel<T><<<info->sentinel_blocks, kThreads, 0, stream>>>(
        a->partial, strips, a->cols, a->sentinel, out);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// grad_x (rows, cols) of the gather x.view(rows, cols)[target], every
// position that is not valid aiming at row sentinel.  g and out 16-byte
// aligned, cols a whole number of 16-byte vectors, rows * cols and
// n * cols < 2^31 (the wrapper checks).  kind: 0 = f32, 1 = bf16.
// Returns the first CUDA error of the launches (0: none).
int regroup_gather_bwd_launch(const RegroupArgs* a, int kind, void* stream,
                              RegroupLaunchInfo* info) {
  auto s = static_cast<cudaStream_t>(stream);
  if (kind == 1) return run<__nv_bfloat16>(a, s, info);
  return kind == 0 ? run<float>(a, s, info) : cudaErrorInvalidValue;
}

}  // extern "C"

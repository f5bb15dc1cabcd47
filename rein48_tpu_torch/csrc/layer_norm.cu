// Copyright 2026 The rein48-tpu Authors.
// SPDX-License-Identifier: Apache-2.0
//
// The ResNet's layer norm and the ReLU after it in one pass, forward and
// backward, for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel. In the JAX package Flax's nn.LayerNorm
// (rein48_tpu/models/nets.py, ResBlock and ResNetPolicy) is left to XLA,
// which fuses the statistics, the affine, the cast and the ReLU into the
// ops around them. Run eagerly, the same function is about 12 float32
// launches a norm (the cast, two means, x*x, mean*mean, the subtraction,
// the clamp, +eps, rsqrt, rsqrt*scale, x-mean, the product, +bias, the
// cast back, the ReLU) and autograd's backward about as many again. The
// plain PyTorch version is rein48_tpu_torch/ops/layer_norm.py::
// layer_norm_reference followed by the ReLU.
//
// Per row of C channels (x, out, dy and dx all float32 or all bf16, the
// type the model computes in; statistics in float32):
//
//   mean = sum(x) / C                  var = max(sum(x*x) / C - mean^2, 0)
//   rstd = rsqrt(var + eps)            y   = (x - mean) * (rstd * scale) + bias
//   out  = relu(round_to_type(y))
//
// Backward, with g = dy * [out > 0] * scale and xhat = (x - mean) * rstd:
//
//   dx     = rstd * (g - mean(g) - xhat * mean(g * xhat))    (rounded to the type)
//   dscale = sum over rows of dy * [out > 0] * xhat          dbias = sum of dy * [out > 0]
//
// On a row whose raw variance the clamp cut (below 0), the xhat term is
// dropped: the clamp passes no gradient there, as autograd's clamp does.
// The ReLU is always applied: in the ResNet every layer norm is followed by
// one. Every product and sum is rounded on its own (__fmul_rn, __fadd_rn:
// no fused multiply-add) in the plain version's order, so only the order
// of the row sums differs from the plain version.
//
// What bounds it on this card: bytes. At the PPO minibatch (65,536 boards,
// 1,048,576 rows of 64 bf16 channels) the forward reads 128 MB and writes
// 128 MB and 8 MB of statistics, 0.083 ms at 3.35 TB/s; the backward reads
// x, dy and the statistics and writes dx, 0.123 ms. So the design moves
// each byte once and keeps every intermediate in registers:
//
// * A row lies in one group of L lanes (L a power of two up to 32): at
//   C = 64 in bf16 a row is 128 B, eight 16-byte loads, so 8 lanes take a
//   row and a warp takes 4 rows at a time, 8 with the two rows each group
//   keeps in flight. Channels that do not split into 16-byte chunks take a
//   generic layout, a warp a row and a channel a lane, up to 256 channels.
//   Each lane keeps its channels' scale and bias in registers.
// * The row sums are a lane's own values in order, then a butterfly of
//   shuffles inside the group, which leaves the same bits in every lane.
// * Persistent blocks, as many as are resident at once, stride over the
//   rows in a fixed order.
// * The forward writes the per-row mean and rstd only when autograd
//   records; a cut row's rstd is stored negated, which is how the backward
//   knows it. The backward recomputes xhat and the ReLU's mask with the
//   forward's own arithmetic, so the mask is the forward's bit for bit.
// * dscale and dbias: each block sums its rows into registers, its warps in
//   shared memory in a fixed order, and writes one float32 partial row
//   [2, C]; a second launch of one block sums the partial rows in a fixed
//   order. No float atomics, so the backward is the same bits on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxValues = 8;                 // channels of a row that one lane holds
constexpr int kMaxChannels = 32 * kMaxValues;  // ops/layer_norm.py MAX_CHANNELS
constexpr int kMaxCtas = 1024;                // partial rows of a backward; ops/layer_norm.py MAX_CTAS
constexpr int kSumThreads = 1024;
constexpr int kUnroll = 2;                    // rows a lane group keeps in flight
constexpr unsigned kAll = 0xffffffffu;

enum DType { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// How the rows are cut over the lanes.
struct Shape {
  long long rows;
  int c;
  int lanes;     // lanes per row, a power of two up to 32
  int chunks;    // chunks of VEC channels per lane
  float inv_c;   // 1.0f / c
  float eps;
};

// Lane j's chunk k holds channels (k * lanes + j) * VEC + [0, VEC).
template <int VEC>
__device__ __forceinline__ bool chunk_ok(const Shape& s, int k, int j) {
  return k < s.chunks && (k * s.lanes + j) * VEC < s.c;
}

template <int VEC>
__device__ __forceinline__ void load_params(const Shape& s, int j, const float* __restrict__ scale,
                                            const float* __restrict__ bias, float* sc, float* bi) {
  constexpr int K = kMaxValues / VEC;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int ch = (k * s.lanes + j) * VEC + e;
      const bool ok = chunk_ok<VEC>(s, k, j);
      sc[k * VEC + e] = ok ? scale[ch] : 0.0f;
      bi[k * VEC + e] = ok ? bias[ch] : 0.0f;
    }
  }
}

// Sum over the lanes of one row's group, the same bits in each lane.
__device__ __forceinline__ float group_sum(float v, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kAll, v, off));
  return v;
}

// y = (x - mean) * (rstd * scale) + bias, each operation rounded on its own.
__device__ __forceinline__ float affine(float x, float mean, float rstd, float sc, float bi) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mean), __fmul_rn(rstd, sc)), bi);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    layer_norm_relu_forward(const T* __restrict__ x, Shape s, const float* __restrict__ scale,
                            const float* __restrict__ bias, T* __restrict__ out, float* __restrict__ mean_out,
                            float* __restrict__ rstd_out) {
  constexpr int K = kMaxValues / VEC;
  const int lane = threadIdx.x & 31;
  const int j = lane & (s.lanes - 1);
  const int groups = 32 / s.lanes;
  const int group = lane / s.lanes;
  float sc[kMaxValues], bi[kMaxValues];
  load_params<VEC>(s, j, scale, bias, sc, bi);
  const long long warp = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const long long per_warp = static_cast<long long>(groups) * kUnroll;
  const long long step = static_cast<long long>(gridDim.x) * kWarps * per_warp;
  for (long long base = warp * per_warp; base < s.rows; base += step) {
    Vec<T, VEC> v[kUnroll][K];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = base + u * groups + group;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (row < s.rows && chunk_ok<VEC>(s, k, j)) {
          v[u][k] = *reinterpret_cast<const Vec<T, VEC>*>(x + row * s.c + (k * s.lanes + j) * VEC);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) v[u][k].v[e] = from_float<T>(0.0f);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = base + u * groups + group;
      float sum = 0.0f, sq = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xv = to_float(v[u][k].v[e]);
          sum = __fadd_rn(sum, xv);
          sq = __fadd_rn(sq, __fmul_rn(xv, xv));
        }
      }
      sum = group_sum(sum, s.lanes);
      sq = group_sum(sq, s.lanes);
      const float mean = __fmul_rn(sum, s.inv_c);
      const float var_raw = __fsub_rn(__fmul_rn(sq, s.inv_c), __fmul_rn(mean, mean));
      const float rstd = rsqrtf(__fadd_rn(var_raw < 0.0f ? 0.0f : var_raw, s.eps));
      if (row >= s.rows) continue;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (!chunk_ok<VEC>(s, k, j)) continue;
        Vec<T, VEC> o;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const T y = from_float<T>(affine(to_float(v[u][k].v[e]), mean, rstd, sc[k * VEC + e], bi[k * VEC + e]));
          o.v[e] = to_float(y) <= 0.0f ? from_float<T>(0.0f) : y;
        }
        *reinterpret_cast<Vec<T, VEC>*>(out + row * s.c + (k * s.lanes + j) * VEC) = o;
      }
      if (mean_out != nullptr && j == 0) {
        mean_out[row] = mean;
        rstd_out[row] = var_raw < 0.0f ? -rstd : rstd;
      }
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    layer_norm_relu_backward(const T* __restrict__ x, const T* __restrict__ dy, Shape s,
                             const float* __restrict__ scale, const float* __restrict__ bias,
                             const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
                             T* __restrict__ dx, float* __restrict__ partials) {
  constexpr int K = kMaxValues / VEC;
  __shared__ float red[kWarps][2][kMaxChannels];
  const int lane = threadIdx.x & 31;
  const int warp_in_block = threadIdx.x / 32;
  const int j = lane & (s.lanes - 1);
  const int groups = 32 / s.lanes;
  const int group = lane / s.lanes;
  float sc[kMaxValues], bi[kMaxValues];
  load_params<VEC>(s, j, scale, bias, sc, bi);
  float dscale[kMaxValues], dbias[kMaxValues];
#pragma unroll
  for (int i = 0; i < kMaxValues; ++i) dscale[i] = dbias[i] = 0.0f;
  const long long warp = static_cast<long long>(blockIdx.x) * kWarps + warp_in_block;
  const long long per_warp = static_cast<long long>(groups) * kUnroll;
  const long long step = static_cast<long long>(gridDim.x) * kWarps * per_warp;
  for (long long base = warp * per_warp; base < s.rows; base += step) {
    Vec<T, VEC> v[kUnroll][K];
    Vec<T, VEC> d[kUnroll][K];
    float mean[kUnroll], rs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = base + u * groups + group;
      const bool live = row < s.rows;
      mean[u] = live ? mean_in[row] : 0.0f;
      rs[u] = live ? rstd_in[row] : 1.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int ch = (k * s.lanes + j) * VEC;
        if (live && chunk_ok<VEC>(s, k, j)) {
          v[u][k] = *reinterpret_cast<const Vec<T, VEC>*>(x + row * s.c + ch);
          d[u][k] = *reinterpret_cast<const Vec<T, VEC>*>(dy + row * s.c + ch);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) v[u][k].v[e] = d[u][k].v[e] = from_float<T>(0.0f);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = base + u * groups + group;
      const bool cut = rs[u] < 0.0f;
      const float rstd = fabsf(rs[u]);
      float g[kMaxValues], xhat[kMaxValues];
      float sg = 0.0f, sgx = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int i = k * VEC + e;
          const float xv = to_float(v[u][k].v[e]);
          const float y = to_float(from_float<T>(affine(xv, mean[u], rstd, sc[i], bi[i])));
          const float dm = y <= 0.0f ? 0.0f : to_float(d[u][k].v[e]);
          g[i] = __fmul_rn(dm, sc[i]);
          xhat[i] = __fmul_rn(__fsub_rn(xv, mean[u]), rstd);
          sg = __fadd_rn(sg, g[i]);
          sgx = __fadd_rn(sgx, __fmul_rn(g[i], xhat[i]));
          dscale[i] = __fadd_rn(dscale[i], __fmul_rn(dm, xhat[i]));
          dbias[i] = __fadd_rn(dbias[i], dm);
        }
      }
      sg = group_sum(sg, s.lanes);
      sgx = group_sum(sgx, s.lanes);
      const float mg = __fmul_rn(sg, s.inv_c);
      const float mgx = cut ? 0.0f : __fmul_rn(sgx, s.inv_c);
      if (row >= s.rows) continue;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (!chunk_ok<VEC>(s, k, j)) continue;
        Vec<T, VEC> o;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int i = k * VEC + e;
          o.v[e] = from_float<T>(__fmul_rn(rstd, __fsub_rn(__fsub_rn(g[i], mg), __fmul_rn(xhat[i], mgx))));
        }
        *reinterpret_cast<Vec<T, VEC>*>(dx + row * s.c + (k * s.lanes + j) * VEC) = o;
      }
    }
  }
  // The groups of a warp hold the same channels: add them, then the warps.
#pragma unroll
  for (int i = 0; i < kMaxValues; ++i) {
    for (int off = s.lanes; off < 32; off <<= 1) {
      dscale[i] = __fadd_rn(dscale[i], __shfl_xor_sync(kAll, dscale[i], off));
      dbias[i] = __fadd_rn(dbias[i], __shfl_xor_sync(kAll, dbias[i], off));
    }
  }
  if (group == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        if (chunk_ok<VEC>(s, k, j)) {
          const int ch = (k * s.lanes + j) * VEC + e;
          red[warp_in_block][0][ch] = dscale[k * VEC + e];
          red[warp_in_block][1][ch] = dbias[k * VEC + e];
        }
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 2 * s.c; t += kThreads) {
    const int which = t / s.c, ch = t % s.c;
    float total = 0.0f;
    for (int w = 0; w < kWarps; ++w) total = __fadd_rn(total, red[w][which][ch]);
    partials[static_cast<long long>(blockIdx.x) * 2 * s.c + t] = total;
  }
}

// dscale[t] and dbias[t] = the sums over i of partials[i][0][t] and
// partials[i][1][t], i in order of slices: thread (slice, t) adds rows
// slice, slice + slices, ...; then the slices in order.
__global__ void __launch_bounds__(kSumThreads)
    layer_norm_relu_sum(const float* __restrict__ partials, int ctas, int c, float* __restrict__ dscale,
                        float* __restrict__ dbias) {
  __shared__ float part[kSumThreads];
  const int n = 2 * c;
  const int slices = kSumThreads / n;
  const int t = threadIdx.x % n, slice = threadIdx.x / n;
  float acc = 0.0f;
  if (slice < slices) {
    for (int i = slice; i < ctas; i += slices) acc = __fadd_rn(acc, partials[static_cast<long long>(i) * n + t]);
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < n) {
    float total = 0.0f;
    for (int i = 0; i < slices; ++i) total = __fadd_rn(total, part[i * n + threadIdx.x]);
    if (threadIdx.x < c) {
      dscale[threadIdx.x] = total;
    } else {
      dbias[threadIdx.x - c] = total;
    }
  }
}

// Blocks of ``kernel`` resident on the current device at once; ``per_sm``
// caches the kernel's occupancy (0 until the first call).
int resident_blocks(const void* kernel, int* per_sm, int* blocks) {
  if (*per_sm == 0) {
    int n = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    *per_sm = n < 1 ? 1 : n;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *blocks = *per_sm * sms;
  return static_cast<int>(err);
}

// The grid: enough blocks for the rows, at most what is resident at once.
int grid_for(const Shape& s, int resident, int cap) {
  const long long rows_per_block = static_cast<long long>(kWarps) * (32 / s.lanes) * kUnroll;
  long long blocks = (s.rows + rows_per_block - 1) / rows_per_block;
  if (blocks > resident) blocks = resident;
  if (blocks > cap) blocks = cap;
  return static_cast<int>(blocks);
}

template <typename T, int VEC>
int launch_forward(const void* x, const Shape& s, const void* scale, const void* bias, void* out, void* mean,
                   void* rstd, cudaStream_t stream) {
  static int per_sm = 0;
  int resident = 0;
  int err = resident_blocks(reinterpret_cast<const void*>(layer_norm_relu_forward<T, VEC>), &per_sm, &resident);
  if (err) return err;
  layer_norm_relu_forward<T, VEC><<<grid_for(s, resident, 1 << 30), kThreads, 0, stream>>>(
      static_cast<const T*>(x), s, static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<T*>(out), static_cast<float*>(mean), static_cast<float*>(rstd));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_backward(const void* x, const void* dy, const Shape& s, const void* scale, const void* bias, const void* mean,
                    const void* rstd, void* dx, void* partials, void* dscale, void* dbias, cudaStream_t stream) {
  static int per_sm = 0;
  int resident = 0;
  int err = resident_blocks(reinterpret_cast<const void*>(layer_norm_relu_backward<T, VEC>), &per_sm, &resident);
  if (err) return err;
  const int ctas = grid_for(s, resident, kMaxCtas);
  layer_norm_relu_backward<T, VEC><<<ctas, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), s, static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<T*>(dx), static_cast<float*>(partials));
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  layer_norm_relu_sum<<<1, kSumThreads, 0, stream>>>(static_cast<const float*>(partials), ctas, s.c,
                                                     static_cast<float*>(dscale), static_cast<float*>(dbias));
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The layout of the rows: 16-byte chunks where the rows and pointers
// allow them (the chunks of a row a power of two up to 32, or a multiple
// of 32 that fits a lane's registers), else one channel a lane.
// Returns VEC (1 for the generic layout) and fills lanes and chunks.
int plan(Shape* s, int type, bool aligned) {
  const int size = type == kFloat32 ? 4 : 2;
  const int vec = 16 / size;
  if (aligned && (s->c * size) % 16 == 0) {
    const int chunks = s->c / vec;
    if (chunks <= 32 && (chunks & (chunks - 1)) == 0) {
      s->lanes = chunks;
      s->chunks = 1;
      return vec;
    }
    if (chunks % 32 == 0 && chunks / 32 <= kMaxValues / vec) {
      s->lanes = 32;
      s->chunks = chunks / 32;
      return vec;
    }
  }
  s->lanes = 32;
  s->chunks = (s->c + 31) / 32;
  return 1;
}

bool valid(long long rows, int c, int type) {
  return rows >= 1 && c >= 1 && c <= kMaxChannels && (type == kFloat32 || type == kBFloat16);
}

Shape make_shape(long long rows, int c, float eps) {
  Shape s;
  s.rows = rows;
  s.c = c;
  s.lanes = 32;
  s.chunks = 1;
  s.inv_c = 1.0f / static_cast<float>(c);
  s.eps = eps;
  return s;
}

}  // namespace

// out[rows, c] = relu(layer_norm(x[rows, c])), in x's type;
// ``mean`` and ``rstd`` (float32[rows]) are written when not null.
extern "C" int rein48_layer_norm_relu_forward(const void* x, long long rows, int c, int type, const void* scale,
                                              const void* bias, float eps, void* out, void* mean, void* rstd,
                                              void* stream) {
  if (!valid(rows, c, type) || (mean == nullptr) != (rstd == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Shape s = make_shape(rows, c, eps);
  const int vec = plan(&s, type, aligned16(x) && aligned16(out));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (type == kBFloat16) {
    return vec == 1 ? launch_forward<__nv_bfloat16, 1>(x, s, scale, bias, out, mean, rstd, st)
                    : launch_forward<__nv_bfloat16, 8>(x, s, scale, bias, out, mean, rstd, st);
  }
  return vec == 1 ? launch_forward<float, 1>(x, s, scale, bias, out, mean, rstd, st)
                  : launch_forward<float, 4>(x, s, scale, bias, out, mean, rstd, st);
}

// dx[rows, c], dscale and dbias (float32[c]) from x and dy (both [rows, c]
// in one type) and the forward's mean and rstd. ``partials`` holds
// float32[MAX_CTAS, 2, c]. Two launches: the rows, then the sum of the
// blocks' partial rows.
extern "C" int rein48_layer_norm_relu_backward(const void* x, const void* dy, long long rows, int c, int type,
                                               const void* scale, const void* bias, const void* mean,
                                               const void* rstd, void* dx, void* partials, void* dscale,
                                               void* dbias, void* stream) {
  if (!valid(rows, c, type)) return static_cast<int>(cudaErrorInvalidValue);
  Shape s = make_shape(rows, c, 0.0f);
  const int vec = plan(&s, type, aligned16(x) && aligned16(dy) && aligned16(dx));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (type == kBFloat16) {
    return vec == 1
               ? launch_backward<__nv_bfloat16, 1>(x, dy, s, scale, bias, mean, rstd, dx, partials, dscale, dbias, st)
               : launch_backward<__nv_bfloat16, 8>(x, dy, s, scale, bias, mean, rstd, dx, partials, dscale, dbias, st);
  }
  return vec == 1 ? launch_backward<float, 1>(x, dy, s, scale, bias, mean, rstd, dx, partials, dscale, dbias, st)
                  : launch_backward<float, 4>(x, dy, s, scale, bias, mean, rstd, dx, partials, dscale, dbias, st);
}

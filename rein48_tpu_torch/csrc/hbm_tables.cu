// Copyright 2026 The rein48-tpu Authors.
// SPDX-License-Identifier: Apache-2.0
//
// Hot-prefix permuted table gather and scatter statistics for NVIDIA Hopper
// (sm_90a).
//
// Replaces: rein48_tpu/ops/hbm_tables.py::_gather_kernel (behind
// cached_gather) and rein48_tpu/ops/hbm_tables.py::_scatter_kernel (behind
// cached_scatter_stats), the Pallas TPU kernels of the n-tuple network's
// "cached" backend. The plain PyTorch versions are in
// rein48_tpu_torch/ops/hbm_tables.py.
//
// A "cached" table is stored physically permuted by 128-entry rows: rowmap
// maps a logical row to its physical row, and the K hottest rows form the
// prefix table[:K * 128]. The TPU kernels keep that prefix in VMEM, find an
// element's slot by comparing its row with all K hot rows and turn the
// matches into values and sums with bf16 matrix products over three exact
// limbs, and compact the cold elements with triangular-matmul prefix sums,
// because Mosaic has no gather, scatter or sort. Hopper has real loads,
// atomics and warp ballots, so these kernels compute the same functions
// directly:
//
// * cached_gather_kernel: out[i] = table[rowmap[idx[i] >> 7] * 128 +
//   (idx[i] & 127)]; one thread per index, grid-stride, two dependent loads
//   through the read-only path. Bit-exact, as the TPU kernel is. The
//   permuted layout itself does the caching: the hot prefix (1 MiB per
//   table at K = 2048) and the row map (512 KiB per table at 131,072 rows)
//   stay resident in the 50 MB L2, and a block's 227 KB of shared memory
//   could not hold the prefix anyway. Every element goes through the row
//   map, so this kernel has no cold residue, no capacity and no overflow:
//   those are internal to the TPU kernel, whose wrapper returns only the
//   values. Bound: bytes (4 B index read and 4 B value written per element,
//   4 B per touched row-map entry and per touched table entry read once),
//   about 0.08 us at the trainer's 32,768 indices, so launch latency decides
//   its time.
// * cached_scatter_kernel: one block of 1024 threads per 16,384-element
//   block of the input, so that the cold residue has the JAX layout slot
//   for slot. Membership is by hot_rows, as in JAX (the scatter takes no
//   row map): the wrapper sorts hot_rows once per call and each element
//   binary-searches its row among them (K = 2048 rows: 11 steps over 8 KB
//   that stay in L1). A hot element with err != 0 atomicAdds err, |err| and
//   1 into the [K, 128] outputs (zeroed by the wrapper) at slot * 128 +
//   lane; a hot element with err == 0 (either sign) adds nothing and counts
//   no hit. Every other element is cold, its error 0 or not: the block
//   walks its elements 1024 at a time in element order, ranks its cold ones
//   by warp ballots and a sum of the warp totals, and writes (idx, err) to
//   slot rank of its Cr * 128 slots; those past the capacity are dropped.
//   The block then writes (0, 0.0) to its unused slots and its count of
//   cold elements, dropped ones included. Bound: bytes (8 B per element
//   read, the three [K, 128] float32 outputs and the residue written once),
//   about 1.1 us for one delayed window of 65,536 elements at K = 2048;
//   the 4 blocks of such a call use 4 of the 132 SMs, which this first
//   version accepts.
//
// The sums are reassociated against a sequential scatter-add (the TPU
// kernel's limb fold reassociates them too), and atomics make their order
// change from run to run; hits and the residue are exact.
//
// Out-of-range indices cannot come from NTupleNetwork.indices; the kernels
// do not check them.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRow = 128;
constexpr int kBlockElems = 128 * kRow;  // one block of the residue layout
constexpr int kGatherThreads = 256;
constexpr long long kMaxGatherBlocks = 132 * 16;  // 16 blocks per SM cover any n by grid-stride
constexpr int kScatterThreads = 1024;
constexpr int kWarps = kScatterThreads / 32;

__global__ void __launch_bounds__(kGatherThreads) cached_gather_kernel(const float* __restrict__ table,
                                                                       const int32_t* __restrict__ rowmap,
                                                                       const int32_t* __restrict__ idx,
                                                                       float* __restrict__ out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * kGatherThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kGatherThreads + threadIdx.x; i < n; i += stride) {
    const int32_t j = idx[i];
    const int32_t phys = __ldg(rowmap + (j >> 7)) * kRow + (j & (kRow - 1));
    out[i] = __ldg(table + phys);
  }
}

// The slot of a hot row, or -1: lower bound of row in sorted_rows[0, k).
__device__ __forceinline__ int find_slot(const int32_t* __restrict__ sorted_rows,
                                         const int32_t* __restrict__ slot_of, int k, int32_t row) {
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(sorted_rows + mid) < row) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return (lo < k && __ldg(sorted_rows + lo) == row) ? __ldg(slot_of + lo) : -1;
}

__global__ void __launch_bounds__(kScatterThreads)
    cached_scatter_kernel(const int32_t* __restrict__ idx, const float* __restrict__ err, long long n,
                          const int32_t* __restrict__ sorted_rows, const int32_t* __restrict__ slot_of, int k,
                          float* __restrict__ err_sum, float* __restrict__ abs_sum, float* __restrict__ hits,
                          int32_t* __restrict__ cold_idx, float* __restrict__ cold_err, int capacity,
                          int32_t* __restrict__ counts) {
  __shared__ int warp_cold[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * kBlockElems;
  int32_t* out_idx = cold_idx + static_cast<long long>(blockIdx.x) * capacity;
  float* out_err = cold_err + static_cast<long long>(blockIdx.x) * capacity;
  int placed = 0;  // cold elements of this block before the current chunk; the same in every thread
  for (int chunk = 0; chunk < kBlockElems && base + chunk < n; chunk += kScatterThreads) {
    const long long e = base + chunk + threadIdx.x;
    bool cold = false;
    int32_t j = 0;
    float v = 0.0f;
    if (e < n) {
      j = idx[e];
      v = err[e];
      const int slot = find_slot(sorted_rows, slot_of, k, j >> 7);
      if (slot < 0) {
        cold = true;
      } else if (v != 0.0f) {
        const long long o = static_cast<long long>(slot) * kRow + (j & (kRow - 1));
        atomicAdd(err_sum + o, v);
        atomicAdd(abs_sum + o, fabsf(v));
        atomicAdd(hits + o, 1.0f);
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, cold);
    if (lane == 0) warp_cold[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_cold[w];
      before += w < warp ? c : 0;
      total += c;
    }
    if (cold) {
      const int pos = placed + before + __popc(ballot & ((1u << lane) - 1u));
      if (pos < capacity) {
        out_idx[pos] = j;
        out_err[pos] = v;
      }
    }
    placed += total;
    __syncthreads();  // warp_cold is written again by the next chunk
  }
  for (int p = placed + threadIdx.x; p < capacity; p += kScatterThreads) {
    out_idx[p] = 0;
    out_err[p] = 0.0f;
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = placed;
}

}  // namespace

// out[i] = table[rowmap[idx[i] >> 7] * 128 + (idx[i] & 127)] for i < n.
// Returns the CUDA error of the launch.
extern "C" int rein48_cached_gather(const void* table, const void* rowmap, const void* idx, void* out, long long n,
                                    void* stream) {
  const long long want = (n + kGatherThreads - 1) / kGatherThreads;
  const int blocks = static_cast<int>(want < kMaxGatherBlocks ? want : kMaxGatherBlocks);
  cached_gather_kernel<<<blocks, kGatherThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int32_t*>(rowmap), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// Hot statistics and the cold residue of n elements (idx, err); see
// cached_scatter_kernel. sorted_rows holds hot_rows in ascending order and
// slot_of[r] the slot of sorted_rows[r]. err_sum, abs_sum and hits
// (float32[k * 128] each) must be zeroed by the caller; cold_idx and
// cold_err hold ceil(n / 16384) * capacity slots and counts ceil(n / 16384)
// entries, all written here. Returns the CUDA error of the launch.
extern "C" int rein48_cached_scatter(const void* idx, const void* err, long long n, const void* sorted_rows,
                                     const void* slot_of, int k, void* err_sum, void* abs_sum, void* hits,
                                     void* cold_idx, void* cold_err, int capacity, void* counts, void* stream) {
  const long long blocks = (n + kBlockElems - 1) / kBlockElems;
  cached_scatter_kernel<<<static_cast<unsigned>(blocks), kScatterThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(err), n, static_cast<const int32_t*>(sorted_rows),
      static_cast<const int32_t*>(slot_of), k, static_cast<float*>(err_sum), static_cast<float*>(abs_sum),
      static_cast<float*>(hits), static_cast<int32_t*>(cold_idx), static_cast<float*>(cold_err), capacity,
      static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

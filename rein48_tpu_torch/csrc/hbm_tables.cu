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
// atomics and warp votes, so these kernels compute the same functions
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
// * cached_scatter_kernel: hot statistics and the cold residue. Bound:
//   bytes (8 B per element read, the three [K, 128] float32 outputs and the
//   residue written once), about 1.1 us for one delayed window of 65,536
//   elements at K = 2048. The residue must equal JAX's slot for slot: block
//   b of 16,384 elements writes its cold elements in element order to its
//   Cr * 128 slots, drops those past the capacity, fills the rest with
//   (0, 0.0) and counts them all. The design spreads that over many SMs in
//   one launch:
//   - Each 16,384-element block is one thread-block cluster of 16 CTAs
//     (the non-portable cluster size, which measured faster than the
//     portable 8 on the H100), each CTA a contiguous 1,024-element piece,
//     one element per thread, in element order across the threads. A CTA
//     counts its cold elements,
//     ranks them by a block scan, publishes its count in shared memory and
//     meets the others at cluster.sync(); it then reads the counts of the
//     lower-ranked CTAs through distributed shared memory, writes its
//     elements to slots (their sum) + rank, and shares the (0, 0.0) fill
//     of the unused slots. A second cluster.sync() keeps every CTA's shared
//     memory alive until the others have read it; a CTA whose piece lies
//     past n (the ragged last block) still reaches both. Rank 0 writes the
//     block's count, dropped elements included, and sets the overflow byte
//     (zeroed by the wrapper with the sums) when it exceeds the capacity.
//     At n = 65,536 that is 64 CTAs on 64 SMs, where one block per residue
//     block used 4.
//   - Membership by hot_rows, as in JAX (the scatter takes no row map).
//     For K <= 8,192 every CTA first builds an open-addressing hash of
//     hot_rows, as given (row -> slot, -1 empty, a power of two at least
//     2K entries: at most half full) in dynamic shared memory, 32 KB at K
//     = 2,048 and 128 KB at K = 8,192 (above the default 48 KB, hence
//     cudaFuncAttributeMaxDynamicSharedMemorySize); an element then finds
//     its slot in one or two probes, and the wrapper sorts nothing. Above
//     8,192 rows such a table would need 256 KB, more than a block's 227
//     KB, so the same kernel takes its second path: a binary search over
//     the rows that the wrapper sorted (slot_of[r] the slot of
//     sorted_rows[r]). The wrapper alone owns that threshold: the entry
//     point takes the search path when it is given slot_of. hot_rows must be distinct, as refresh_cache makes
//     them and convert.ntuple_params_from_jax checks: the hash keeps one
//     slot per row.
//   - A hot element with err != 0 adds err, |err| and 1 into the [K, 128]
//     outputs (zeroed by the wrapper) at slot * 128 + (idx & 127), first
//     combined with the lanes of its warp that add to the same entry
//     (warp_aggregate.cuh), so the hottest entries take one add per warp.
//     A hot element with err == 0 (either sign) adds nothing and counts no
//     hit. Every other element is cold, its error 0 or not.
//
// The sums are reassociated against a sequential scatter-add (the TPU
// kernel's limb fold reassociates them too), and atomics make their order
// change from run to run; hits and the residue are exact.
//
// Out-of-range indices cannot come from NTupleNetwork.indices; the kernels
// do not check them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "warp_aggregate.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRow = 128;
constexpr int kBlockElems = 128 * kRow;  // one block of the residue layout
constexpr int kGatherThreads = 256;
constexpr long long kMaxGatherBlocks = 132 * 16;  // 16 blocks per SM cover any n by grid-stride
constexpr int kScatterThreads = 1024;
constexpr int kWarps = kScatterThreads / 32;
constexpr int kCtas = 16;         // CTAs per cluster, one cluster per residue block
constexpr int kHashMaxBits = 14;  // 16,384 entries of (row, slot): 128 KB, the hash of 8,192 hot rows
constexpr unsigned kAll = 0xffffffffu;

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

__device__ __forceinline__ unsigned hash_of(int32_t row, int bits) {
  return (static_cast<unsigned>(row) * 0x9E3779B1u) >> (32 - bits);  // Fibonacci hashing
}

// The slot of a hot row, or -1, from the shared-memory hash.
__device__ __forceinline__ int hash_slot(const int32_t* keys, const int32_t* slots, int bits, int32_t row) {
  const unsigned mask = (1u << bits) - 1u;
  for (unsigned h = hash_of(row, bits);; h = (h + 1u) & mask) {
    const int32_t key = keys[h];
    if (key == row) return slots[h];
    if (key < 0) return -1;
  }
}

// The slot of a hot row, or -1: lower bound of row in sorted_rows[0, k).
__device__ __forceinline__ int search_slot(const int32_t* __restrict__ sorted_rows,
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

// One cluster of kCtas CTAs per 16,384-element block. kHash: rows holds
// hot_rows as given and the hash takes 2 << bits int32 of dynamic shared
// memory; else rows holds them sorted and slot_of their slots.
template <bool kHash>
__global__ void __launch_bounds__(kScatterThreads)
    cached_scatter_kernel(const int32_t* __restrict__ idx, const float* __restrict__ err, long long n,
                          const int32_t* __restrict__ rows, const int32_t* __restrict__ slot_of, int k, int bits,
                          float* __restrict__ err_sum, float* __restrict__ abs_sum, float* __restrict__ hits,
                          int32_t* __restrict__ cold_idx, float* __restrict__ cold_err, int capacity,
                          int32_t* __restrict__ counts, unsigned char* __restrict__ overflow) {
  constexpr int kPerThread = kBlockElems / kCtas / kScatterThreads;
  static_assert(kPerThread * kCtas * kScatterThreads == kBlockElems, "a cluster covers one residue block");
  extern __shared__ int32_t hash[];  // kHash: keys[1 << bits], then slots[1 << bits]
  __shared__ int warp_cold[kWarps];
  __shared__ int cta_cold;
  __shared__ int cluster_placed, cluster_total;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long block = blockIdx.x / kCtas;  // clusters are consecutive runs of kCtas CTAs
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // This thread's elements, in element order, loaded before the hash is
  // built so that their latency hides behind it.
  const long long first = block * kBlockElems + (static_cast<long long>(rank) * kScatterThreads + threadIdx.x) * kPerThread;
  int32_t j[kPerThread];
  float v[kPerThread];
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const bool valid = first + e < n;
    j[e] = valid ? idx[first + e] : 0;
    v[e] = valid ? err[first + e] : 0.0f;
  }

  int32_t* keys = hash;
  int32_t* slots = hash + (1 << bits);
  if (kHash) {
    for (int h = threadIdx.x; h < (1 << bits); h += kScatterThreads) keys[h] = -1;
    __syncthreads();
    const unsigned mask = (1u << bits) - 1u;
    for (int s = threadIdx.x; s < k; s += kScatterThreads) {
      const int32_t row = rows[s];
      unsigned h = hash_of(row, bits);
      while (atomicCAS(keys + h, -1, row) != -1) h = (h + 1u) & mask;
      slots[h] = s;
    }
    __syncthreads();
  }

  int slot[kPerThread];
  bool cold[kPerThread];
  int mine = 0;
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const bool valid = first + e < n;
    slot[e] = !valid ? -1 : kHash ? hash_slot(keys, slots, bits, j[e] >> 7) : search_slot(rows, slot_of, k, j[e] >> 7);
    cold[e] = valid && slot[e] < 0;
    mine += cold[e];
  }

  // Hot statistics; every lane reaches each vote. The adds' results are
  // unused, so they compile to reductions (RED) that the SM does not wait on.
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int key = slot[e] >= 0 && v[e] != 0.0f ? slot[e] * kRow + (j[e] & (kRow - 1)) : -1;
    const rein48::GroupSums g = rein48::warp_group_sums<true>(key, v[e]);
    if (g.leader) {
      atomicAdd(err_sum + key, g.sum);
      atomicAdd(abs_sum + key, g.abs_sum);
      atomicAdd(hits + key, static_cast<float>(g.count));
    }
  }

  // Rank the cold elements within the CTA: an inclusive scan of the
  // per-thread counts over the warp, then over the warps' totals.
  int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kAll, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_cold[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_cold[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kAll, w, d);
      if (lane >= d) w += y;
    }
    warp_cold[lane] = w;
    if (lane == 31) cta_cold = w;
  }
  cluster.sync();  // every CTA's count is published

  // The cold elements of the lower-ranked CTAs, and of the whole block.
  if (warp == 0) {
    const int c = lane < kCtas ? *cluster.map_shared_rank(&cta_cold, lane) : 0;
    int below = lane < rank ? c : 0;
    int all = c;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      below += __shfl_xor_sync(kAll, below, d);
      all += __shfl_xor_sync(kAll, all, d);
    }
    if (lane == 0) {
      cluster_placed = below;
      cluster_total = all;
    }
  }
  cluster.sync();  // the remote reads are done, and the sums are in place for the whole CTA

  const int total = cluster_total;
  int pos = cluster_placed + (warp > 0 ? warp_cold[warp - 1] : 0) + incl - mine;
  int32_t* out_idx = cold_idx + block * capacity;
  float* out_err = cold_err + block * capacity;
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    if (cold[e]) {
      if (pos < capacity) {
        out_idx[pos] = j[e];
        out_err[pos] = v[e];
      }
      ++pos;
    }
  }
  for (int p = total + rank * kScatterThreads + threadIdx.x; p < capacity; p += kCtas * kScatterThreads) {
    out_idx[p] = 0;
    out_err[p] = 0.0f;
  }
  if (rank == 0 && threadIdx.x == 0) {
    counts[block] = total;
    if (total > capacity) *overflow = 1;
  }
}

template <bool kHash>
cudaError_t launch_scatter(long long blocks, int bits, cudaStream_t stream, const int32_t* idx, const float* err,
                           long long n, const int32_t* rows, const int32_t* slot_of, int k, float* err_sum,
                           float* abs_sum, float* hits, int32_t* cold_idx, float* cold_err, int capacity,
                           int32_t* counts, unsigned char* overflow) {
  auto* kernel = &cached_scatter_kernel<kHash>;
  const int smem = kHash ? static_cast<int>(2 * sizeof(int32_t)) << bits : 0;
  static bool configured = false;  // the attributes are set once per instantiation
  if (!configured) {
    if (kHash) {
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(2 * sizeof(int32_t)) << kHashMaxBits);
    }
    cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    configured = true;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(blocks * kCtas));
  config.blockDim = dim3(kScatterThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = kCtas;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&config, kernel, idx, err, n, rows, slot_of, k, bits, err_sum, abs_sum,
                                           hits, cold_idx, cold_err, capacity, counts, overflow);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
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

// Hot statistics and the cold residue of n > 0 elements (idx, err); see
// cached_scatter_kernel. With slot_of null, rows holds the k <= 8192 hot
// rows as given and the kernel hashes them; else rows holds them in
// ascending order, slot_of[r] the slot of rows[r], and the kernel searches
// them. err_sum, abs_sum and hits (float32[k * 128] each) and the overflow
// byte must be zeroed by the caller; cold_idx and cold_err hold
// ceil(n / 16384) * capacity slots and counts ceil(n / 16384) entries, all
// written here. Returns the CUDA error of the launch.
extern "C" int rein48_cached_scatter(const void* idx, const void* err, long long n, const void* rows,
                                     const void* slot_of, int k, void* err_sum, void* abs_sum, void* hits,
                                     void* cold_idx, void* cold_err, int capacity, void* counts, void* overflow,
                                     void* stream) {
  const long long blocks = (n + kBlockElems - 1) / kBlockElems;
  int bits = 6;
  while ((1 << bits) < 2 * k) ++bits;
  if (slot_of == nullptr && bits > kHashMaxBits) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* i = static_cast<const int32_t*>(idx);
  const auto* e = static_cast<const float*>(err);
  const auto* r = static_cast<const int32_t*>(rows);
  const auto* so = static_cast<const int32_t*>(slot_of);
  auto* es = static_cast<float*>(err_sum);
  auto* ab = static_cast<float*>(abs_sum);
  auto* h = static_cast<float*>(hits);
  auto* ci = static_cast<int32_t*>(cold_idx);
  auto* ce = static_cast<float*>(cold_err);
  auto* c = static_cast<int32_t*>(counts);
  auto* o = static_cast<unsigned char*>(overflow);
  const cudaError_t status =
      so == nullptr ? launch_scatter<true>(blocks, bits, s, i, e, n, r, so, k, es, ab, h, ci, ce, capacity, c, o)
                    : launch_scatter<false>(blocks, bits, s, i, e, n, r, so, k, es, ab, h, ci, ce, capacity, c, o);
  return static_cast<int>(status);
}

// Copyright 2026 The rein48-tpu Authors.
// SPDX-License-Identifier: Apache-2.0
//
// Value-table gather and scatter for NVIDIA Hopper (sm_90a).
//
// Replaces: rein48_tpu/ops/tables.py::_gather_kernel (behind mxu_gather)
// and rein48_tpu/ops/tables.py::_scatter_kernel (behind mxu_scatter_sum and
// mxu_scatter_stats), the Pallas TPU kernels of the n-tuple network's "mxu"
// backend. The plain PyTorch versions are in rein48_tpu_torch/ops/tables.py.
//
// The TPU kernels turn a gather into a one-hot bf16 matrix product (three
// exact bf16 limbs per float32 value) because the TPU core has no fast
// random access into its VMEM. Hopper has real loads and real atomics, so
// these kernels compute the same functions directly:
//
// * table_gather: out[i] = table[idx[i]]; one thread per index, grid-stride.
//   Bit-exact, as the TPU kernel is. Bound: bytes (n x 4 B of indices read,
//   n x 4 B written, the touched table entries read once), a fraction of a
//   microsecond at the trainer's 32,768 indices, so launch latency decides
//   its time. A table of 65,536 float32 entries is 256 KB, more than the
//   227 KB of shared memory a block can have, so the table is read through
//   the read-only path and stays resident in the 50 MB L2 instead of being
//   staged in shared memory.
// * table_scatter: dense sums of vals scattered at idx, one thread per
//   element, by atomicAdd into outputs that the wrapper has zeroed. The sum
//   form adds v; the stats form adds v, |v| and 1 into err, abs and hits.
//   Elements with v == 0 (0 and -0: the trainer's masked backups) are
//   skipped: they change no sum and must not count as hits. hits is exact
//   (integer counts far below 2^24). Bound: bytes (n x 8 B read, the dense
//   outputs written once). Many early-game boards hit the same few entries
//   (the all-empty tuple is index 0), so same-address atomics serialise in
//   L2; this first version takes that cost (no warp aggregation).
//
// The float sums are reassociated against a sequential scatter-add, as the
// TPU kernel's limb fold also reassociates them, and atomics make their
// order change from run to run: two runs on the same inputs may differ in
// the last bits. Callers compare with a tolerance (rtol 1e-5, atol 1e-6).
//
// Out-of-range indices cannot come from NTupleNetwork.indices; the
// kernels do not check them.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;  // 16 blocks per SM cover any n by grid-stride

int blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

__global__ void __launch_bounds__(kThreads) gather_kernel(const float* __restrict__ table,
                                                          const int32_t* __restrict__ idx,
                                                          float* __restrict__ out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n; i += stride) {
    out[i] = __ldg(table + idx[i]);
  }
}

template <bool kStats>
__global__ void __launch_bounds__(kThreads) scatter_kernel(const int32_t* __restrict__ idx,
                                                           const float* __restrict__ vals,
                                                           float* __restrict__ err,
                                                           float* __restrict__ abs_sum,
                                                           float* __restrict__ hits, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n; i += stride) {
    const float v = vals[i];
    if (v == 0.0f) continue;
    const int32_t j = idx[i];
    atomicAdd(err + j, v);
    if (kStats) {
      atomicAdd(abs_sum + j, fabsf(v));
      atomicAdd(hits + j, 1.0f);
    }
  }
}

}  // namespace

// out[i] = table[idx[i]] for i < n. Returns the CUDA error of the launch.
extern "C" int rein48_table_gather(const void* table, const void* idx, void* out, long long n,
                                   void* stream) {
  gather_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int32_t*>(idx), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// err[idx[i]] += vals[i] and, with stats != 0, abs_sum[idx[i]] += |vals[i]|,
// hits[idx[i]] += 1, over the i < n with vals[i] != 0. The outputs must be
// zeroed by the caller; abs_sum and hits are not touched without stats.
// Returns the CUDA error of the launch.
extern "C" int rein48_table_scatter(const void* idx, const void* vals, void* err, void* abs_sum, void* hits,
                                    long long n, int stats, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* i = static_cast<const int32_t*>(idx);
  const auto* v = static_cast<const float*>(vals);
  if (stats) {
    scatter_kernel<true><<<blocks_for(n), kThreads, 0, s>>>(i, v, static_cast<float*>(err),
                                                            static_cast<float*>(abs_sum),
                                                            static_cast<float*>(hits), n);
  } else {
    scatter_kernel<false><<<blocks_for(n), kThreads, 0, s>>>(i, v, static_cast<float*>(err), nullptr, nullptr, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// Copyright 2026 The rein48-tpu Authors.
// SPDX-License-Identifier: Apache-2.0
//
// Fused random-policy 2048 rollout for NVIDIA Hopper (sm_90a).
//
// Replaces: rein48_tpu/engine/fused.py::_rollout_kernel (the Pallas TPU
// kernel behind rollout_random_fused). Same function: num_steps
// uniform-random autoreset steps per board (move, spawn iff the move
// changed the board, game over, in-place reset) and per-env episode
// statistics. The plain PyTorch version is rein48_tpu_torch/engine/fused.py
// (fused_step_soa, rollout_bits_reference); the two agree bit for bit.
//
// What bounds it on this card: the INT32 pipe. The Philox-mode main loop
// runs about 550 SASS instructions per env-step (move, spawn, game over,
// reset, and 1.25 Philox4x32-10 blocks), about 420 of them compares,
// selects, logic and adds on the INT32 pipe, which has 64 lanes per SM
// against an issue rate of 128 per SM (chip_smoke.py counts both from the
// built library). No memory moves inside the loop: a board is 16 bytes
// read once and written once per rollout, the stats 16 bytes. At B=65536,
// T=2048 the INT32 pipe bounds the kernel at about 3.4 ms (132 SMs x 64
// lanes x 1.98 GHz on the H100 SXM), the issue rate at about 2.2 ms, the
// bytes at about 1 us.
//
// What the design does about it: one thread owns one env for the whole
// rollout. Its 16 cells, score, steps and the four statistics live in
// registers; every cell index is a compile-time constant (the network is
// fully unrolled, as the Pallas kernel's structure-of-arrays planes are),
// so nothing spills to local memory and there is no data-dependent branch:
// the four directions are selects, as in fused_step_soa. Random words come
// from Philox4x32-10 in registers, five 4-word blocks per group of four
// steps (20 words = 4 steps x 5 words), so no bits touch device memory.
// The injected-bits mode reads [T, 5, B] words instead, coalesced across
// the warp, so the kernel can be held against the plain version.
//
// Left for later work: packing the 16 nibbles into one 64-bit word and
// moving whole rows with SIMD-within-a-register, and occupancy tuning.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCells = 16;
constexpr int kWords = 5;  // action, spawn rank, spawn value, reset rank, reset value
constexpr int kStepsPerGroup = 4;
constexpr int kMaxExponent = 15;
constexpr uint32_t kSpawn4Threshold24 = 1677722u;  // round(0.1 * 2**24)
constexpr int kThreads = 128;

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

// Philox4x32-10 on counter c with key (k0, k1), in place.
__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t lo0 = kPhiloxM0 * c[0];
    const uint32_t hi0 = __umulhi(kPhiloxM0, c[0]);
    const uint32_t lo1 = kPhiloxM1 * c[2];
    const uint32_t hi1 = __umulhi(kPhiloxM1, c[2]);
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

__device__ __forceinline__ int spawn_rank(uint32_t bits, int n) {
  return static_cast<int>(((bits >> 8) * static_cast<uint32_t>(n)) >> 24);
}

__device__ __forceinline__ int spawn_exp(uint32_t bits) {
  return (bits >> 8) < kSpawn4Threshold24 ? 2 : 1;
}

__device__ __forceinline__ int bump(int e) { return min(e + 1, kMaxExponent); }

// Compare-exchange of the stable left compaction: a nonzero b moves left
// past a zero a.
__device__ __forceinline__ void compact_pair(int& a, int& b) {
  const bool sw = (a == 0) & (b != 0);
  const int na = sw ? b : a;
  b = sw ? 0 : b;
  a = na;
}

// core.merge_cells_left: merge one line toward c0; returns the merge score.
__device__ __forceinline__ int merge_line(int& c0, int& c1, int& c2, int& c3) {
  compact_pair(c0, c1);
  compact_pair(c1, c2);
  compact_pair(c2, c3);
  compact_pair(c0, c1);
  compact_pair(c1, c2);
  compact_pair(c0, c1);

  const bool m01 = (c0 != 0) & (c0 == c1);
  const bool m12 = (c1 != 0) & (c1 == c2) & !m01;
  const bool m23 = (c2 != 0) & (c2 == c3) & !m12;

  const int o0 = m01 ? bump(c0) : c0;
  const int o1 = m01 ? (m23 ? bump(c2) : c2) : (m12 ? bump(c1) : c1);
  const int o2 = m01 ? (m23 ? 0 : c3) : (m12 ? c3 : (m23 ? bump(c2) : c2));
  const int o3 = (m01 | m12 | m23) ? 0 : c3;
  const int score = (m01 ? 1 << (c0 + 1) : 0) + (m12 ? 1 << (c1 + 1) : 0) +
                    (m23 ? 1 << (c2 + 1) : 0);
  c0 = o0;
  c1 = o1;
  c2 = o2;
  c3 = o3;
  return score;
}

struct EnvRegs {
  int cell[kCells];
  int score, steps;
  int episodes, length_sum, score_sum, max_exp;
};

// fused.py::fused_step_soa for one env; w points at its five words.
__device__ __forceinline__ void env_step(EnvRegs& s, const uint32_t* w) {
  const int action = static_cast<int>(w[0] & 3u);
  const bool is_vert = action <= 1;  // UP = 0, DOWN = 1
  const bool is_rev = (action & 1) == 1;  // DOWN = 1, RIGHT = 3

  // Orient toward merge-left: line l, position p. Every array index below
  // is a compile-time constant; the direction only picks between arms.
  int line[4][4];
#pragma unroll
  for (int l = 0; l < 4; ++l) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int fwd = is_vert ? s.cell[4 * p + l] : s.cell[4 * l + p];
      const int rev = is_vert ? s.cell[4 * (3 - p) + l] : s.cell[4 * l + 3 - p];
      line[l][p] = is_rev ? rev : fwd;
    }
  }
  int merge_score = 0;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    merge_score += merge_line(line[l][0], line[l][1], line[l][2], line[l][3]);
  }
  // Un-orient: cell i = 4r + c sits in line c at position r when vertical.
  int moved[kCells];
#pragma unroll
  for (int i = 0; i < kCells; ++i) {
    const int v = is_rev ? line[i % 4][3 - i / 4] : line[i % 4][i / 4];
    const int h = is_rev ? line[i / 4][3 - i % 4] : line[i / 4][i % 4];
    moved[i] = is_vert ? v : h;
  }

  bool changed = false;
  int n_blanks = 0;
#pragma unroll
  for (int i = 0; i < kCells; ++i) {
    changed |= moved[i] != s.cell[i];
    n_blanks += moved[i] == 0;
  }
  const int rank = spawn_rank(w[1], n_blanks);
  const int value = spawn_exp(w[2]);
  const bool enabled = changed & (n_blanks > 0);
  const int rank1 = enabled ? rank + 1 : 0;
  int spawned[kCells];
  int csum = 0;
#pragma unroll
  for (int i = 0; i < kCells; ++i) {
    const bool blank = moved[i] == 0;
    csum += blank;
    spawned[i] = (blank & (csum == rank1)) ? value : moved[i];
  }

  const bool full = n_blanks == static_cast<int>(enabled);
  bool neigh = false;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) neigh |= spawned[4 * r + c] == spawned[4 * r + c + 1];
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) neigh |= spawned[4 * r + c] == spawned[4 * (r + 1) + c];
  }
  const bool done = full & !neigh;

  const int episode_score = s.score + merge_score;
  const int episode_length = s.steps + 1;
  int board_max = spawned[0];
#pragma unroll
  for (int i = 1; i < kCells; ++i) board_max = max(board_max, spawned[i]);

  const int r_rank = spawn_rank(w[3], kCells);
  const int r_val = spawn_exp(w[4]);
#pragma unroll
  for (int i = 0; i < kCells; ++i) {
    s.cell[i] = done ? (r_rank == i ? r_val : 0) : spawned[i];
  }
  s.score = done ? 0 : episode_score;
  s.steps = done ? 0 : episode_length;
  s.episodes += done;
  s.length_sum += done ? episode_length : 0;
  s.score_sum += done ? episode_score : 0;
  s.max_exp = max(s.max_exp, board_max);
}

template <bool kInjected>
__global__ void __launch_bounds__(kThreads)
    rollout_kernel(const uint8_t* __restrict__ boards_in, const int32_t* __restrict__ score_in,
                   const int32_t* __restrict__ steps_in, const uint32_t* __restrict__ bits,
                   uint8_t* __restrict__ boards_out, int32_t* __restrict__ score_out,
                   int32_t* __restrict__ steps_out, int32_t* __restrict__ stats, int64_t n,
                   int num_steps, uint32_t key0, uint32_t key1, int64_t env_base) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  // The env's stream: its index in the whole batch, of which this launch
  // may hold a slice from env_base on (one rank's share).
  const uint64_t env = static_cast<uint64_t>(env_base + e);

  EnvRegs s;
  const uint4 raw = reinterpret_cast<const uint4*>(boards_in)[e];
  const uint32_t packed_in[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < kCells; ++i) s.cell[i] = (packed_in[i / 4] >> (8 * (i % 4))) & 0xFFu;
  s.score = score_in[e];
  s.steps = steps_in[e];
  s.episodes = s.length_sum = s.score_sum = s.max_exp = 0;

  for (int t0 = 0; t0 < num_steps; t0 += kStepsPerGroup) {
    uint32_t w[kStepsPerGroup * kWords];
    if constexpr (kInjected) {
#pragma unroll
      for (int j = 0; j < kStepsPerGroup; ++j) {
#pragma unroll
        for (int k = 0; k < kWords; ++k) {
          w[kWords * j + k] =
              t0 + j < num_steps ? bits[(static_cast<int64_t>(t0 + j) * kWords + k) * n + e] : 0u;
        }
      }
    } else {
      // Words 20q .. 20q+19 of stream (seed, env) are blocks 5q .. 5q+4.
      const uint64_t block0 = static_cast<uint64_t>(t0 / kStepsPerGroup) * kWords;
#pragma unroll
      for (int b = 0; b < kWords; ++b) {
        const uint64_t block = block0 + b;
        uint32_t c[4] = {static_cast<uint32_t>(block), static_cast<uint32_t>(block >> 32),
                         static_cast<uint32_t>(env), static_cast<uint32_t>(env >> 32)};
        philox4x32_10(c, key0, key1);
#pragma unroll
        for (int k = 0; k < 4; ++k) w[4 * b + k] = c[k];
      }
    }
#pragma unroll
    for (int j = 0; j < kStepsPerGroup; ++j) {
      if (t0 + j < num_steps) env_step(s, w + kWords * j);
    }
  }

  uint32_t packed_out[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < kCells; ++i) packed_out[i / 4] |= static_cast<uint32_t>(s.cell[i]) << (8 * (i % 4));
  reinterpret_cast<uint4*>(boards_out)[e] =
      make_uint4(packed_out[0], packed_out[1], packed_out[2], packed_out[3]);
  score_out[e] = s.score;
  steps_out[e] = s.steps;
  stats[e] = s.episodes;
  stats[n + e] = s.length_sum;
  stats[2 * n + e] = s.score_sum;
  stats[3 * n + e] = s.max_exp;
}

}  // namespace

// Launches the rollout on `stream` and returns cudaGetLastError() as an int.
// boards: uint8[n, 16]; score, steps: int32[n]; bits: uint32[T, 5, n] or
// null for Philox mode, where env i draws from stream (seed, env_base + i);
// stats: int32[4, n] (episodes, length sum, score sum, max exponent).
extern "C" int rein48_rollout(const void* boards_in, const void* score_in, const void* steps_in,
                              const void* bits, void* boards_out, void* score_out,
                              void* steps_out, void* stats, long long n, int num_steps,
                              unsigned long long seed, long long env_base, void* stream) {
  if (n <= 0) return 0;
  const unsigned int blocks = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  const uint32_t key0 = static_cast<uint32_t>(seed);
  const uint32_t key1 = static_cast<uint32_t>(seed >> 32);
  const auto* b_in = static_cast<const uint8_t*>(boards_in);
  const auto* sc_in = static_cast<const int32_t*>(score_in);
  const auto* st_in = static_cast<const int32_t*>(steps_in);
  auto* b_out = static_cast<uint8_t*>(boards_out);
  auto* sc_out = static_cast<int32_t*>(score_out);
  auto* st_out = static_cast<int32_t*>(steps_out);
  auto* st = static_cast<int32_t*>(stats);
  if (bits != nullptr) {
    rollout_kernel<true><<<blocks, kThreads, 0, s>>>(b_in, sc_in, st_in,
                                                     static_cast<const uint32_t*>(bits), b_out,
                                                     sc_out, st_out, st, n, num_steps, key0, key1,
                                                     env_base);
  } else {
    rollout_kernel<false><<<blocks, kThreads, 0, s>>>(b_in, sc_in, st_in, nullptr, b_out, sc_out,
                                                      st_out, st, n, num_steps, key0, key1, env_base);
  }
  return static_cast<int>(cudaGetLastError());
}

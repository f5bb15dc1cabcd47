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
// What bounds it: operations, not bytes. A board is 16 bytes read once and
// written once per rollout, the row table (196,864 bytes) read once per block;
// inside the loop nothing touches device memory. The work any design must
// do per env-step is the five Philox words of the stream contract (1.25
// Philox4x32-10 blocks, 50 multiplies and XORs) and four row-table reads;
// at B=65,536, T=2,048 the words alone take 0.2 ms at the H100's issue
// rate. This design adds about 150 instructions per step on the
// packed board, and its loop is bound by the INT32 pipe (64 lanes per SM
// against 128 issue slots): chip_smoke.py counts the loop's SASS per
// env-step and its INT32-pipe share from the built library and prints them
// beside the work bound.
//
// The design:
// - One 64-bit board per thread, as two 32-bit words: lo holds rows 0-1,
//   hi rows 2-3, cell i = 4r + c in bits 4i..4i+3 (engine/lut.py's row
//   code, so row r is bits 16r..16r+15). Exponents never exceed 15.
// - Only the drawn direction is computed, with no divergent branch: the
//   board is oriented toward merge-left (UP: transpose; DOWN: transpose
//   then reverse each row; RIGHT: reverse each row), the four row codes
//   are looked up in the merge-left table, and the result is oriented
//   back. The action picks the byte-permute selectors and delta-swap masks
//   (identity ones for the directions that skip a stage), so every thread
//   runs the same instructions: a transpose is two byte permutes and a
//   nibble delta swap per word, a row reversal a byte permute and a nibble
//   swap per word.
// - The row table lives in shared memory, one copy per block, filled from
//   device memory at block start: the uint16 merged code of each of the
//   65,536 rows (128 KiB), a one-byte offset of its merge score (64 KiB)
//   into the list of the 122 distinct scores / 4 as uint16 (256 B): 196,864 B
//   of the 227 KiB a block may hold. The packed uint32 table (code | score/4
//   << 16) is 256 KiB and does not fit. Two other layouts were tried once
//   on the H100 and were no faster (PERF.md): the score half of the packed
//   table read through L1, and the whole packed table through L1 and L2.
//   This one keeps its speed whatever the boards' codes, since its reads
//   never leave shared memory. One block per SM, 64 to 512
//   threads (at B=65,536 about 496 envs per SM, as any one-thread-per-env
//   design has).
// - Blanks are a popcount of a zero-nibble mask; the spawn goes to the
//   rank-th blank in cell order through a running count of blanks, one per
//   nibble (a multiply by 0x11111111), compared with the target rank;
//   neighbours are zero nibbles of b ^ (b >> 4) inside rows and of
//   b ^ (b >> 16). The board's largest exponent never falls within an
//   episode, so max_exponent is taken once per episode (at game over, a
//   rare branch) and once at the end, not every step.
// - Random words come from Philox4x32-10 in registers, five 4-word blocks
//   per group of four steps (20 words = 4 steps x 5 words); the round keys
//   depend only on the seed and are computed once. The injected-bits mode
//   reads [T, 5, B] words instead, coalesced across the warp.
//
// Left for later work: the INT32 pipe. About 45 of the step's integer
// instructions orient the board and back; a second table for merge-right
// would save the row reversals but does not fit beside the first. Drawing
// the next group's words while the current steps run (to fill their
// dependent chains) was slower: the unrolled loop spilled to the stack.
// Small batches (under ~128 envs per SM) are latency-bound.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWords = 5;  // action, spawn rank, spawn value, reset rank, reset value
constexpr int kStepsPerGroup = 4;
constexpr int kPhiloxRounds = 10;
// spawn_exp: (bits >> 8) < round(0.1 * 2**24), i.e. bits < that * 2**8.
constexpr uint32_t kSpawn4Threshold = 1677722u << 8;
constexpr int kMaxThreads = 512;
constexpr int kMinThreads = 64;

// The row table in shared memory (and in device memory, in this layout).
constexpr int kRowCodes = 1 << 16;
constexpr int kIndexOffset = 2 * kRowCodes;             // after uint16 codes[65536]
constexpr int kScoreOffset = kIndexOffset + kRowCodes;  // after uint8 offsets[65536]
constexpr int kTableBytes = kScoreOffset + 2 * 128;     // uint16 quarter_scores[128]

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

// Philox4x32-10 on counter c with the round keys rk0/rk1, in place.
__device__ __forceinline__ void philox4x32_10(uint32_t c[4], const uint32_t rk0[kPhiloxRounds],
                                              const uint32_t rk1[kPhiloxRounds]) {
#pragma unroll
  for (int r = 0; r < kPhiloxRounds; ++r) {
    const uint32_t lo0 = kPhiloxM0 * c[0];
    const uint32_t hi0 = __umulhi(kPhiloxM0, c[0]);
    const uint32_t lo1 = kPhiloxM1 * c[2];
    const uint32_t hi1 = __umulhi(kPhiloxM1, c[2]);
    const uint32_t n0 = hi1 ^ c[1] ^ rk0[r];
    const uint32_t n2 = hi0 ^ c[3] ^ rk1[r];
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

// Bit 4i+3 is set where nibble i of x is 0, for the nibbles that `mask`
// (bits at 4i+3 only) keeps: a nibble's low three bits plus 7 carry into
// its bit 3 unless they are all 0, and stay inside the nibble.
__device__ __forceinline__ uint32_t zero_nibbles(uint32_t x, uint32_t mask) {
  return ~(((x & 0x77777777u) + 0x77777777u) | x) & mask;
}

// Transpose (cell (r, c) <-> (c, r)) when the selectors say so: the byte
// permutes sel0/sel1 swap the off-diagonal 2x2 blocks (0x6240/0x7351; keep:
// 0x3210/0x7654), the nibble delta swap under m (0xF0F0; keep: 0)
// transposes inside each block.
__device__ __forceinline__ void transpose_if(uint32_t& lo, uint32_t& hi, uint32_t sel0, uint32_t sel1,
                                             uint32_t m) {
  const uint32_t a = __byte_perm(lo, hi, sel0), b = __byte_perm(lo, hi, sel1);
  const uint32_t ta = (a ^ (a >> 12)) & m, tb = (b ^ (b >> 12)) & m;
  lo = a ^ (ta * 0x1001u);  // ta | ta << 12
  hi = b ^ (tb * 0x1001u);
}

// Reverse the cells of both rows in x (cell c <-> 3 - c) when the selectors
// say so: swap the two bytes of each row (sel 0x2301; keep: 0x3210), then
// the two nibbles of each byte (m 0x0F0F0F0F; keep: 0).
__device__ __forceinline__ uint32_t reverse_if(uint32_t x, uint32_t sel, uint32_t m) {
  x = __byte_perm(x, 0, sel);
  const uint32_t t = (x ^ (x >> 4)) & m;
  return x ^ (t * 0x11u);  // t | t << 4
}

// The largest exponent on the board.
__device__ __forceinline__ int board_max(uint32_t lo, uint32_t hi) {
  uint32_t m = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) m = max(m, max((lo >> (4 * i)) & 15u, (hi >> (4 * i)) & 15u));
  return static_cast<int>(m);
}

// Four 8-bit cells (one per byte, each < 16) -> a 16-bit row code.
__device__ __forceinline__ uint32_t pack_row(uint32_t bytes) {
  return __byte_perm(bytes | (bytes >> 4), 0, 0x4420);
}

// A 16-bit row code (bits 16*half..) -> four 8-bit cells.
__device__ __forceinline__ uint32_t unpack_row(uint32_t word, int half) {
  const uint32_t y = __byte_perm(word, 0, half ? 0x4342 : 0x4140);
  return (y & 0x000F000Fu) | ((y & 0x00F000F0u) << 4);
}

struct Env {
  uint32_t lo, hi;  // the packed board
  int score, steps;
  int episodes, length_sum, score_sum, max_exp;
};

// fused.py::fused_step_soa for one env; w points at its five words.
__device__ __forceinline__ void env_step(Env& s, const uint32_t* w, const uint16_t* codes,
                                         const uint8_t* offsets, const uint8_t* quarter_scores) {
  const uint32_t action = w[0] & 3u;
  const uint32_t vert = action < 2u;  // UP = 0, DOWN = 1
  const uint32_t rev = action & 1u;   // DOWN = 1, RIGHT = 3
  const uint32_t sel0 = 0x3210u + vert * (0x6240u - 0x3210u);
  const uint32_t sel1 = 0x7654u - vert * (0x7654u - 0x7351u);
  const uint32_t m_t = vert * 0xF0F0u;
  const uint32_t sel_r = 0x3210u - rev * (0x3210u - 0x2301u);
  const uint32_t m_r = rev * 0x0F0F0F0Fu;

  // Orient toward merge-left, merge the four rows by table, orient back.
  uint32_t lo = s.lo, hi = s.hi;
  transpose_if(lo, hi, sel0, sel1, m_t);
  lo = reverse_if(lo, sel_r, m_r);
  hi = reverse_if(hi, sel_r, m_r);
  const uint32_t c0 = lo & 0xFFFFu, c1 = lo >> 16, c2 = hi & 0xFFFFu, c3 = hi >> 16;
  // A row's merge score / 4, a uint16 at a byte offset the row's entry gives.
  const auto quarter = [&](uint32_t c) {
    return static_cast<int>(*reinterpret_cast<const uint16_t*>(quarter_scores + offsets[c]));
  };
  const int merge_score = (quarter(c0) + quarter(c1) + quarter(c2) + quarter(c3)) << 2;
  lo = reverse_if(__byte_perm(codes[c0], codes[c1], 0x5410), sel_r, m_r);
  hi = reverse_if(__byte_perm(codes[c2], codes[c3], 0x5410), sel_r, m_r);
  transpose_if(lo, hi, sel0, sel1, m_t);

  const bool changed = (lo != s.lo) | (hi != s.hi);
  const uint32_t z_lo = zero_nibbles(lo, 0x88888888u), z_hi = zero_nibbles(hi, 0x88888888u);
  const int n_lo = __popc(z_lo);
  const int n_blanks = n_lo + __popc(z_hi);
  const int rank = static_cast<int>(((w[1] >> 8) * static_cast<uint32_t>(n_blanks)) >> 24);
  const bool enabled = changed & (n_blanks > 0);
  // The spawn goes to the blank whose running count of blanks (cells
  // 0..i, one nibble per cell, at most 8 per word) is rank + 1; a
  // disabled spawn targets 0, which no blank's count is.
  const int rank1 = enabled ? rank + 1 : 0;
  const uint32_t t_lo = rank1 <= n_lo ? rank1 : 0u;
  const uint32_t t_hi = rank1 > n_lo ? rank1 - n_lo : 0u;
  const uint32_t hit_lo = zero_nibbles(((z_lo >> 3) * 0x11111111u) ^ (t_lo * 0x11111111u), z_lo);
  const uint32_t hit_hi = zero_nibbles(((z_hi >> 3) * 0x11111111u) ^ (t_hi * 0x11111111u), z_hi);
  // hit holds bit 4i+3 of the spawn cell: (hit * value << 29) >> 32 is value << 4i.
  const uint32_t value29 = w[2] < kSpawn4Threshold ? 2u << 29 : 1u << 29;
  lo += __umulhi(hit_lo, value29);
  hi += __umulhi(hit_hi, value29);

  // Post-spawn blanks == n_blanks - enabled. Equal neighbours: a zero
  // nibble of b ^ (b >> 4) at columns 0-2, or of b ^ (b >> 16) at rows 0-2.
  const bool full = n_blanks == static_cast<int>(enabled);
  const uint32_t neigh = zero_nibbles(lo ^ (lo >> 4), 0x08880888u) | zero_nibbles(hi ^ (hi >> 4), 0x08880888u) |
                         zero_nibbles(lo ^ __funnelshift_r(lo, hi, 16), 0x88888888u) |
                         zero_nibbles(hi ^ (hi >> 16), 0x00008888u);
  const bool done = full & (neigh == 0u);

  const int episode_score = s.score + merge_score;
  const int episode_length = s.steps + 1;
  if (done) {
    // The board's largest exponent only grows within an episode, so the
    // episode's last board holds the max over all of its boards.
    s.max_exp = max(s.max_exp, board_max(lo, hi));
    s.episodes += 1;
    s.length_sum += episode_length;
    s.score_sum += episode_score;
    const uint32_t r_rank = w[3] >> 28;  // spawn_rank(w[3], 16)
    const uint32_t r_val = w[4] < kSpawn4Threshold ? 2u : 1u;
    const uint32_t tile = r_val << (4 * (r_rank & 7u));
    s.lo = r_rank < 8u ? tile : 0u;
    s.hi = r_rank < 8u ? 0u : tile;
    s.score = 0;
    s.steps = 0;
  } else {
    s.lo = lo;
    s.hi = hi;
    s.score = episode_score;
    s.steps = episode_length;
  }
}

template <bool kInjected>
__global__ void __launch_bounds__(kMaxThreads, 1)
    rollout_kernel(const uint8_t* __restrict__ boards_in, const int32_t* __restrict__ score_in,
                   const int32_t* __restrict__ steps_in, const uint32_t* __restrict__ bits,
                   const uint4* __restrict__ table, uint8_t* __restrict__ boards_out,
                   int32_t* __restrict__ score_out, int32_t* __restrict__ steps_out,
                   int32_t* __restrict__ stats, int64_t n, int num_steps, uint32_t key0, uint32_t key1,
                   int64_t env_base) {
  extern __shared__ uint4 rollout_smem[];
  for (int i = threadIdx.x; i < kTableBytes / 16; i += blockDim.x) rollout_smem[i] = table[i];
  __syncthreads();
  const auto* smem = reinterpret_cast<const uint8_t*>(rollout_smem);
  const auto* codes = reinterpret_cast<const uint16_t*>(smem);
  const uint8_t* offsets = smem + kIndexOffset;
  const uint8_t* quarter_scores = smem + kScoreOffset;

  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  // The env's stream: its index in the whole batch, of which this launch
  // may hold a slice from env_base on (one rank's share).
  const uint64_t env = static_cast<uint64_t>(env_base + e);
  uint32_t rk0[kPhiloxRounds], rk1[kPhiloxRounds];
#pragma unroll
  for (int r = 0; r < kPhiloxRounds; ++r) {
    rk0[r] = key0 + static_cast<uint32_t>(r) * kPhiloxW0;
    rk1[r] = key1 + static_cast<uint32_t>(r) * kPhiloxW1;
  }

  Env s;
  const uint4 raw = reinterpret_cast<const uint4*>(boards_in)[e];
  s.lo = pack_row(raw.x) | (pack_row(raw.y) << 16);
  s.hi = pack_row(raw.z) | (pack_row(raw.w) << 16);
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
        philox4x32_10(c, rk0, rk1);
#pragma unroll
        for (int k = 0; k < 4; ++k) w[4 * b + k] = c[k];
      }
    }
#pragma unroll
    for (int j = 0; j < kStepsPerGroup; ++j) {
      if (t0 + j < num_steps) env_step(s, w + kWords * j, codes, offsets, quarter_scores);
    }
  }
  // The last board of the run's unfinished episode (after a game over on
  // the last step, the reset board, which holds no more than the finished
  // one did).
  if (num_steps > 0) s.max_exp = max(s.max_exp, board_max(s.lo, s.hi));

  reinterpret_cast<uint4*>(boards_out)[e] =
      make_uint4(unpack_row(s.lo, 0), unpack_row(s.lo, 1), unpack_row(s.hi, 0), unpack_row(s.hi, 1));
  score_out[e] = s.score;
  steps_out[e] = s.steps;
  stats[e] = s.episodes;
  stats[n + e] = s.length_sum;
  stats[2 * n + e] = s.score_sum;
  stats[3 * n + e] = s.max_exp;
}

}  // namespace

// Launches the rollout on `stream` and returns a cudaError_t as an int.
// boards: uint8[n, 16] exponents (each at most 15); score, steps: int32[n];
// bits: uint32[T, 5, n] or null for Philox mode, where env i draws from
// stream (seed, env_base + i); table: the row table, 197,632 bytes in the
// layout above (engine/fused.py::row_table_bytes); stats: int32[4, n]
// (episodes, length sum, score sum, max exponent).
extern "C" int rein48_rollout(const void* boards_in, const void* score_in, const void* steps_in,
                              const void* bits, const void* table, void* boards_out, void* score_out,
                              void* steps_out, void* stats, long long n, int num_steps,
                              unsigned long long seed, long long env_base, void* stream) {
  if (n <= 0) return 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // One block per SM (the table fills most of its shared memory): spread
  // the batch over every SM, 64 to 512 threads a block.
  long long per_sm = (n + sms - 1) / sms;
  per_sm = (per_sm + 31) / 32 * 32;
  const int threads = static_cast<int>(per_sm < kMinThreads ? kMinThreads : per_sm > kMaxThreads ? kMaxThreads : per_sm);
  const unsigned int blocks = static_cast<unsigned int>((n + threads - 1) / threads);
  const auto s = static_cast<cudaStream_t>(stream);
  const uint32_t key0 = static_cast<uint32_t>(seed);
  const uint32_t key1 = static_cast<uint32_t>(seed >> 32);
  const auto* b_in = static_cast<const uint8_t*>(boards_in);
  const auto* sc_in = static_cast<const int32_t*>(score_in);
  const auto* st_in = static_cast<const int32_t*>(steps_in);
  const auto* tab = static_cast<const uint4*>(table);
  auto* b_out = static_cast<uint8_t*>(boards_out);
  auto* sc_out = static_cast<int32_t*>(score_out);
  auto* st_out = static_cast<int32_t*>(steps_out);
  auto* st = static_cast<int32_t*>(stats);
  if (bits != nullptr) {
    err = cudaFuncSetAttribute(rollout_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, kTableBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    rollout_kernel<true><<<blocks, threads, kTableBytes, s>>>(b_in, sc_in, st_in, static_cast<const uint32_t*>(bits),
                                                             tab, b_out, sc_out, st_out, st, n, num_steps, key0,
                                                             key1, env_base);
  } else {
    err = cudaFuncSetAttribute(rollout_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, kTableBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    rollout_kernel<false><<<blocks, threads, kTableBytes, s>>>(b_in, sc_in, st_in, nullptr, tab, b_out, sc_out,
                                                              st_out, st, n, num_steps, key0, key1, env_base);
  }
  return static_cast<int>(cudaGetLastError());
}

// Copyright 2026 The rein48-tpu Authors.
// SPDX-License-Identifier: Apache-2.0
//
// Fused random-policy 2048 rollout for NVIDIA Hopper (sm_90a), and a
// one-step kernel for given actions (the step kernel, below the rollout).
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

// ---------------------------------------------------------------------------
// The step kernel: one autoreset step per env for given actions, behind
// engine/vector.py's step_autoreset (Philox words) and
// step_autoreset_from_bits (injected words). It replaces no Pallas kernel:
// XLA fuses the JAX package's engine/vector.py step. The plain step,
// _step_from_bits, launches ~464 kernels on the card for what this does in
// one; the two agree bit for bit (float fields by the same float32 adds and
// exact integer conversions).
//
// What bounds it: latency. A step moves 111 bytes a board (the state and
// action in, the new state and the step's record out), 0.27 us at 8,192
// boards, under the card's launch floor; the rest is one chain of dependent
// integer work per thread. So the design keeps everything in registers and
// reads device memory once:
// - One thread an env, 128 a block, any batch. The board stays a row of
//   four byte cells a 32-bit word, as it lies in memory, so cells keep their
//   full byte (exponents above 15 step as the plain version steps them).
//   The rollout's nibble helpers (pack_row, zero_nibbles, transpose_if)
//   would pack a cell into 4 bits: the step would then have to refuse
//   exponents above 15 as fused._check_legal does, by reading the boards on
//   the host, a wait for the device on every step, or differ from the plain
//   step on such boards. Each byte helper below is the nibble one's twin.
// - Orientation by byte permutes (a transpose is eight, a row reversal one);
//   rows merged by core.merge_cells_left's compare-exchange network. The
//   rollout's row table read through L2 was slower at 256 and 8,192 boards,
//   the main path's batches (PERF.md), and slower still once evicted.
// - The two Philox blocks that hold the step's words, in registers; the
//   injected mode reads four words at the caller's strides instead.
// - Blanks, the spawn's running count and the neighbour test on zero bytes
//   of the rows, as the rollout does on zero nibbles.

constexpr int kStepThreads = 128;
constexpr uint32_t kMaxExponent = 15;  // lut.MAX_EXPONENT: merges saturate there

struct StepArgs {
  const uint4* boards_in;  // uint8[n, 16]
  const float* score_in;
  const int32_t* steps_in;
  const int64_t* actions;
  const int64_t* seed;
  const int64_t* env_id;
  const int64_t* counter;
  const int64_t* bits;  // [n, 4] words at (bits_row, bits_col) element strides, or null
  int64_t bits_row, bits_col;
  uint4* boards_out;
  float* score_out;
  int32_t* steps_out;
  uint8_t* state_done_out;
  int64_t* counter_out;
  float* reward;
  uint8_t* done;
  uint8_t* changed;
  float* episode_score;
  float* episode_tile_sum;
  int32_t* episode_length;
  float* max_tile;
  int64_t n;
  int parity_zero;
};

// Bit 8j+7 is set where byte j of x is 0 (no carry leaves a byte).
__device__ __forceinline__ uint32_t zero_bytes(uint32_t x) {
  return ~(((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
}

// The transpose of four rows of four byte cells (row r, byte c = cell (r, c)).
__device__ __forceinline__ void transpose_rows(uint32_t r[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140u), t1 = __byte_perm(r[0], r[1], 0x7362u);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140u), t3 = __byte_perm(r[2], r[3], 0x7362u);
  r[0] = __byte_perm(t0, t2, 0x5410u);
  r[1] = __byte_perm(t0, t2, 0x7632u);
  r[2] = __byte_perm(t1, t3, 0x5410u);
  r[3] = __byte_perm(t1, t3, 0x7632u);
}

// core._orient and _unorient on byte rows: the move becomes a merge toward
// byte 0 (vertical: transpose; mirrored: reverse each row), and back.
__device__ __forceinline__ void orient(uint32_t r[4], bool vertical, uint32_t mirror_sel) {
  uint32_t t[4] = {r[0], r[1], r[2], r[3]};
  transpose_rows(t);
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = __byte_perm(vertical ? t[i] : r[i], 0, mirror_sel);
}

__device__ __forceinline__ void unorient(uint32_t r[4], bool vertical, uint32_t mirror_sel) {
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = __byte_perm(r[i], 0, mirror_sel);
  uint32_t t[4] = {r[0], r[1], r[2], r[3]};
  transpose_rows(t);
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = vertical ? t[i] : r[i];
}

// core.merge_cells_left on a row of four byte cells, toward byte 0: the
// compare-exchange compaction, then the left-priority pair merges, which
// saturate at kMaxExponent and pay 2^(e+1). Returns the row's score.
__device__ __forceinline__ int merge_row(uint32_t& row) {
  uint32_t c[4] = {row & 0xFFu, (row >> 8) & 0xFFu, (row >> 16) & 0xFFu, row >> 24};
#pragma unroll
  for (int npairs = 3; npairs >= 1; --npairs) {
#pragma unroll
    for (int i = 0; i < npairs; ++i) {
      const bool sw = c[i] == 0u && c[i + 1] != 0u;
      c[i] = sw ? c[i + 1] : c[i];
      c[i + 1] = sw ? 0u : c[i + 1];
    }
  }
  const bool m01 = c[0] != 0u && c[0] == c[1];
  const bool m12 = c[1] != 0u && c[1] == c[2] && !m01;
  const bool m23 = c[2] != 0u && c[2] == c[3] && !m12;
  const uint32_t b0 = min(c[0] + 1u, kMaxExponent), b1 = min(c[1] + 1u, kMaxExponent);
  const uint32_t b2 = min(c[2] + 1u, kMaxExponent);
  const uint32_t o0 = m01 ? b0 : c[0];
  const uint32_t o1 = m01 ? (m23 ? b2 : c[2]) : (m12 ? b1 : c[1]);
  const uint32_t o2 = m01 ? (m23 ? 0u : c[3]) : (m12 ? c[3] : (m23 ? b2 : c[2]));
  const uint32_t o3 = (m01 || m12 || m23) ? 0u : c[3];
  row = o0 | (o1 << 8) | (o2 << 16) | (o3 << 24);
  return (m01 ? 2 << c[0] : 0) + (m12 ? 2 << c[1] : 0) + (m23 ? 2 << c[2] : 0);
}

// Env e's step. The plain version's order: move, spawn where the move
// changed the board, game over, episode statistics, reset of a finished
// board from the RESET_* words.
template <bool kInjected>
__device__ __forceinline__ void step_env(const StepArgs& a, int64_t e) {
  const uint4 raw = a.boards_in[e];
  const uint32_t before[4] = {raw.x, raw.y, raw.z, raw.w};
  const int64_t action = a.actions[e];
  const bool vertical = action == 0 || action == 1;  // UP, DOWN
  const bool mirrored = action == 1 || action == 3;  // DOWN, RIGHT
  const uint32_t mirror_sel = mirrored ? 0x0123u : 0x3210u;

  uint32_t r[4] = {before[0], before[1], before[2], before[3]};
  orient(r, vertical, mirror_sel);
  long long merge_score = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) merge_score += merge_row(r[i]);
  unorient(r, vertical, mirror_sel);
  const bool changed = (r[0] != before[0]) | (r[1] != before[1]) | (r[2] != before[2]) | (r[3] != before[3]);

  // The step's words after ACTION: spawn rank, spawn value, reset rank,
  // reset value.
  uint32_t w[4];
  if constexpr (kInjected) {
    const int64_t* b = a.bits + e * a.bits_row;
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = static_cast<uint32_t>(b[k * a.bits_col]);
  } else {
    // Words 5n .. 5n+4 of stream (seed, env), n = counter: lanes
    // 5n & 3 .. of blocks 5n >> 2 and the next (philox.step_words).
    const uint64_t seed = static_cast<uint64_t>(a.seed[e]), env = static_cast<uint64_t>(a.env_id[e]);
    const uint64_t first = static_cast<uint64_t>(a.counter[e]) * kWords;
    uint32_t rk0[kPhiloxRounds], rk1[kPhiloxRounds];
#pragma unroll
    for (int i = 0; i < kPhiloxRounds; ++i) {
      rk0[i] = static_cast<uint32_t>(seed) + static_cast<uint32_t>(i) * kPhiloxW0;
      rk1[i] = static_cast<uint32_t>(seed >> 32) + static_cast<uint32_t>(i) * kPhiloxW1;
    }
    uint32_t v[2][4];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const uint64_t block = (first >> 2) + k;
      uint32_t c[4] = {static_cast<uint32_t>(block), static_cast<uint32_t>(block >> 32), static_cast<uint32_t>(env),
                       static_cast<uint32_t>(env >> 32)};
      philox4x32_10(c, rk0, rk1);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[k][j] = c[j];
    }
    switch (static_cast<int>(first & 3u)) {
      case 0: w[0] = v[0][1]; w[1] = v[0][2]; w[2] = v[0][3]; w[3] = v[1][0]; break;
      case 1: w[0] = v[0][2]; w[1] = v[0][3]; w[2] = v[1][0]; w[3] = v[1][1]; break;
      case 2: w[0] = v[0][3]; w[1] = v[1][0]; w[2] = v[1][1]; w[3] = v[1][2]; break;
      default: w[0] = v[1][0]; w[1] = v[1][1]; w[2] = v[1][2]; w[3] = v[1][3]; break;
    }
  }

  // Spawn on the rank-th blank in cell order: the running count of blanks
  // (a byte a cell, counts of at most 4 a row plus the rows before) equals
  // rank + 1 at that blank; a disabled spawn targets 0, which no blank's
  // count is.
  uint32_t z[4];
  int n_blanks = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    z[i] = zero_bytes(r[i]);
    n_blanks += __popc(z[i]);
  }
  const int rank = static_cast<int>(((w[0] >> 8) * static_cast<uint32_t>(n_blanks)) >> 24);
  const bool enabled = changed && n_blanks > 0;
  const uint32_t value = w[1] < kSpawn4Threshold ? 2u : 1u;
  int target = enabled ? rank + 1 : 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t running = (z[i] >> 7) * 0x01010101u;
    const bool here = target >= 1 && target <= 4;
    const uint32_t hit = here ? zero_bytes(running ^ (static_cast<uint32_t>(target) * 0x01010101u)) & z[i] : 0u;
    r[i] += (hit >> 7) * value;
    target -= __popc(z[i]);
  }

  // Game over: full after the spawn, and no equal neighbours in a row
  // (bytes 0-2 against 1-3) or a column (row i against i + 1).
  const bool full = n_blanks == static_cast<int>(enabled);
  uint32_t neigh = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) neigh |= zero_bytes(r[i] ^ (r[i] >> 8)) & 0x00808080u;
#pragma unroll
  for (int i = 0; i < 3; ++i) neigh |= zero_bytes(r[i] ^ r[i + 1]);
  const bool done = full && neigh == 0u;

  long long tile_sum = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t x = (r[i] >> (8 * j)) & 0xFFu;
      tile_sum += x ? 1ll << x : 0ll;
    }
  }
  const uint32_t top4 = __vmaxu4(__vmaxu4(r[0], r[1]), __vmaxu4(r[2], r[3]));
  const uint32_t top = max(max(top4 & 0xFFu, (top4 >> 8) & 0xFFu), max((top4 >> 16) & 0xFFu, top4 >> 24));

  const float merge = static_cast<float>(merge_score);
  const float episode_score = __fadd_rn(a.score_in[e], merge);
  const int32_t episode_length = a.steps_in[e] + 1;
  uint4 out = make_uint4(r[0], r[1], r[2], r[3]);
  if (done) {
    // place_tile on an empty board: rank (w >> 8) * 16 >> 24 = w >> 28.
    const uint32_t cell = w[2] >> 28;
    const uint32_t tile = (w[3] < kSpawn4Threshold ? 2u : 1u) << (8 * (cell & 3u));
    out = make_uint4(cell >> 2 == 0 ? tile : 0u, cell >> 2 == 1 ? tile : 0u, cell >> 2 == 2 ? tile : 0u,
                     cell >> 2 == 3 ? tile : 0u);
  }
  a.boards_out[e] = out;
  a.score_out[e] = done ? 0.0f : episode_score;
  a.steps_out[e] = done ? 0 : episode_length;
  a.state_done_out[e] = 0;
  if constexpr (!kInjected) a.counter_out[e] = a.counter[e] + 1;
  a.reward[e] = a.parity_zero ? 0.0f : merge;
  a.done[e] = done;
  a.changed[e] = changed;
  a.episode_score[e] = done ? episode_score : 0.0f;
  a.episode_tile_sum[e] = done ? static_cast<float>(tile_sum) : 0.0f;
  a.episode_length[e] = done ? episode_length : 0;
  a.max_tile[e] = done ? static_cast<float>(1 << top) : 0.0f;
}

template <bool kInjected>
__global__ void __launch_bounds__(kStepThreads) step_kernel(const StepArgs a) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e < a.n) step_env<kInjected>(a, e);
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

// Launches one autoreset step of n envs on `stream` (one thread an env) and
// returns a cudaError_t as an int. boards: uint8[n, 16] at a 16-byte
// boundary; score float32[n]; steps int32[n]; actions, seed, env_id,
// counter int64[n]; bits: int64 words [n, 4] at element strides (bits_row,
// bits_col), or null to draw step `counter` of stream (seed, env_id) and
// write counter + 1 to counter_out. Outputs as engine/vector.StepOutput and
// the new EnvState's boards, score, steps and done (bool as uint8).
extern "C" int rein48_step(const void* boards_in, const void* score_in, const void* steps_in, const void* actions,
                           const void* seed, const void* env_id, const void* counter, const void* bits,
                           long long bits_row, long long bits_col, void* boards_out,
                           void* score_out, void* steps_out, void* state_done_out, void* counter_out, void* reward,
                           void* done, void* changed, void* episode_score, void* episode_tile_sum,
                           void* episode_length, void* max_tile, long long n, int parity_zero, void* stream) {
  if (n <= 0) return 0;
  StepArgs a;
  a.boards_in = static_cast<const uint4*>(boards_in);
  a.score_in = static_cast<const float*>(score_in);
  a.steps_in = static_cast<const int32_t*>(steps_in);
  a.actions = static_cast<const int64_t*>(actions);
  a.seed = static_cast<const int64_t*>(seed);
  a.env_id = static_cast<const int64_t*>(env_id);
  a.counter = static_cast<const int64_t*>(counter);
  a.bits = static_cast<const int64_t*>(bits);
  a.bits_row = bits_row;
  a.bits_col = bits_col;
  a.boards_out = static_cast<uint4*>(boards_out);
  a.score_out = static_cast<float*>(score_out);
  a.steps_out = static_cast<int32_t*>(steps_out);
  a.state_done_out = static_cast<uint8_t*>(state_done_out);
  a.counter_out = static_cast<int64_t*>(counter_out);
  a.reward = static_cast<float*>(reward);
  a.done = static_cast<uint8_t*>(done);
  a.changed = static_cast<uint8_t*>(changed);
  a.episode_score = static_cast<float*>(episode_score);
  a.episode_tile_sum = static_cast<float*>(episode_tile_sum);
  a.episode_length = static_cast<int32_t*>(episode_length);
  a.max_tile = static_cast<float*>(max_tile);
  a.n = n;
  a.parity_zero = parity_zero;
  const auto blocks = static_cast<unsigned int>((n + kStepThreads - 1) / kStepThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  if (bits != nullptr) {
    step_kernel<true><<<blocks, kStepThreads, 0, s>>>(a);
  } else {
    step_kernel<false><<<blocks, kStepThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Copyright 2026 The rein48-tpu Authors.
// SPDX-License-Identifier: Apache-2.0
//
// The n-tuple network's value, board -> summed lookups, in one kernel for
// NVIDIA Hopper (sm_90a).
//
// Replaces, on the value path of the "mxu" and "cached" backends:
// rein48_tpu/ops/tables.py::_gather_kernel (behind mxu_gather) and
// rein48_tpu/ops/hbm_tables.py::_gather_kernel (behind cached_gather), with
// the XLA program around them in rein48_tpu/agents/ntuple.py::value (the
// base-16 indices of every lookup, the sum over each table's lookups, the
// sum over the tables). The plain PyTorch version is
// rein48_tpu_torch/ops/ntuple_value.py::ntuple_value_reference.
//
//   out[b] = fold_i( fold_l table_i[phys_i(idx_il(b))] )
//   idx_il(b) = sum_k board_b[cells_i[l, k]] * 16**k
//   phys_i(j) = j (no row map) or rowmap_i[j >> 7] * 128 + (j & 127)
//
// Both folds run left to right: over the lookups l of a table, then over
// the tables i; a group that continues an earlier group's sum starts from
// init[b]. These are the adds of the composed path (table[idx].sum(-1) per
// table, then total + v), so on the CPU the plain version is bit-equal to
// it, and the kernel is bit-equal to the plain version: the gathers are
// exact and the adds are the same float32 adds in the same order.
//
// What bounds it on this card: not its bytes. At the trainer's 4,096
// boards it moves 16 B of board and 4 B of value per board, and 4 B per
// touched table entry (and row-map entry), some 0.1 us at 3.35 TB/s. The
// standalone gathers it replaces took 1.2-1.4 us each, near the 0.87 us
// launch floor, and the eager value call around them took about 12 launches
// at SJ_2X4 (2 tables) and 24 at YEH_4X6 (4 tables): the board cast, per
// table the cell gather, the weights, the index sum, the gather and the
// lookup sum, and an add per table. So the design is one launch per value
// call for all tables, and a short chain of dependent loads inside it:
//
// * Everything is passed by value. The packed layout (per lane of a board:
//   its table, its cells as byte offsets into the 16-byte board, its
//   tuple length; per table: its first lane) and the table and row-map
//   pointers travel in the kernel's parameter struct, so a call copies
//   nothing to the device first. A group holds at most kMaxTables tables and
//   kMaxLanes lookups; the wrapper runs a larger network as several groups,
//   each starting from the previous group's output.
// * One lane per (board, lookup). A board's lookups are consecutive lanes of
//   one warp, so a warp holds 32 / lanes boards (2 at SJ_2X4, 1 at
//   YEH_4X6). Each lane reads its board (one 16-byte load where the
//   address allows it, else byte loads: a chunk of a board array may start
//   anywhere), forms its index in registers, and issues its gather (after
//   its row-map load for "cached"). No add waits on another lane's load
//   before every load of the warp is in flight.
// * The folds are warp shuffles in a fixed order: the first lane of each
//   table adds lookups 1..L-1 in order, then the board's first lane adds the
//   tables in order. No atomics, so the result is the same on every run.
// * The tables stay in the 50 MB L2: SJ_2X4's two 256 KiB tables, and
//   YEH_4X6's hot prefixes (1 MiB a table at K = 2,048 rows) and row maps
//   (512 KiB each). A block's 227 KB of shared memory could not hold one
//   256 KiB table, so nothing is staged there.
//
// Boards are uint8 exponents; a board's 16 cells lie in 16 consecutive
// bytes, row-major or transposed (the engine's afterstates are stored
// transposed), which the packed byte offsets absorb. Out-of-range indices
// cannot come from valid boards; the kernel does not check them.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTables = 8;
constexpr int kMaxLanes = 32;
constexpr int kMaxCells = 8;
constexpr int kRow = 128;
constexpr unsigned kAll = 0xffffffffu;

// The packed layout of one group of tables, as the wrapper writes it
// (int32 words; see ops/ntuple_value.py::pack_group).
struct Layout {
  int32_t num_tables;
  int32_t lanes;                        // lookups per board, at most kMaxLanes
  int32_t max_lookups;                  // the largest L of the group's tables
  int32_t table_first[kMaxTables + 1];  // first lane of each table; [num_tables] = lanes
  uint32_t lane_bytes[kMaxLanes];       // nibble k: byte offset of the cell of digit k
  uint32_t lane_meta[kMaxLanes];        // bits 0-3 K, 4-7 table, 8-15 L, bit 16 first lane of its table
};
static_assert(sizeof(Layout) == 4 * (3 + kMaxTables + 1 + 2 * kMaxLanes), "Layout is the wrapper's words");

struct Params {
  Layout layout;
  const float* table[kMaxTables];
  const int32_t* rowmap[kMaxTables];  // null: identity
  const uint8_t* boards;
  const float* init;  // null: the group starts the sum
  float* out;
  long long n;
  int boards_per_warp;
};

// The 16 bytes of a board as four little-endian words.
__device__ __forceinline__ void load_board(const uint8_t* __restrict__ at, bool aligned, uint32_t w[4]) {
  if (aligned) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(at));
    w[0] = q.x;
    w[1] = q.y;
    w[2] = q.z;
    w[3] = q.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = static_cast<uint32_t>(__ldg(at + 4 * i)) | (static_cast<uint32_t>(__ldg(at + 4 * i + 1)) << 8) |
           (static_cast<uint32_t>(__ldg(at + 4 * i + 2)) << 16) | (static_cast<uint32_t>(__ldg(at + 4 * i + 3)) << 24);
  }
}

// sum_k byte[offset_k] * 16**k for k < K, in int32 (the products wrap as
// the plain version's int32 products would; valid boards never reach it).
__device__ __forceinline__ int32_t lookup_index(const uint32_t w[4], uint32_t bytes, int k_cells) {
  uint32_t idx = 0;
#pragma unroll
  for (int k = 0; k < kMaxCells; ++k) {
    if (k < k_cells) {
      const uint32_t at = (bytes >> (4 * k)) & 15u;
      const uint32_t lo = (at & 8u) ? w[2] : w[0];
      const uint32_t hi = (at & 8u) ? w[3] : w[1];
      idx += (__byte_perm(lo, hi, at & 7u) & 0xffu) << (4 * k);
    }
  }
  return static_cast<int32_t>(idx);
}

__global__ void __launch_bounds__(kThreads) ntuple_value_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long first_board = warp * p.boards_per_warp;
  if (first_board >= p.n) return;  // the whole warp: every lane of a live warp reaches the shuffles
  const int lanes = p.layout.lanes;
  const int slot = lane / lanes;  // board within the warp
  const int li = lane - slot * lanes;  // lookup within the board
  const long long b = first_board + slot;
  const bool live = slot < p.boards_per_warp && b < p.n;

  float v = 0.0f;
  uint32_t meta = 0;
  if (live) {
    meta = p.layout.lane_meta[li];
    uint32_t w[4];
    const uint8_t* at = p.boards + 16 * b;
    load_board(at, (reinterpret_cast<uintptr_t>(p.boards) & 15u) == 0, w);
    int32_t j = lookup_index(w, p.layout.lane_bytes[li], static_cast<int>(meta & 15u));
    const int t = static_cast<int>((meta >> 4) & 15u);
    const int32_t* rm = p.rowmap[t];
    if (rm != nullptr) j = __ldg(rm + (j >> 7)) * kRow + (j & (kRow - 1));
    v = __ldg(p.table[t] + j);
  }

  // Each table's first lane adds its lookups 1..L-1 in order.
  const int L = static_cast<int>((meta >> 8) & 0xffu);
  const bool table_lead = (meta >> 16) & 1u;
  float s = v;
  for (int d = 1; d < p.layout.max_lookups; ++d) {
    const float x = __shfl_down_sync(kAll, v, d);
    if (table_lead && d < L) s += x;
  }
  // The board's first lane adds the tables in order, after init.
  float total = s;
  if (p.init != nullptr && live && li == 0) total = p.init[b] + s;
  for (int t = 1; t < p.layout.num_tables; ++t) {
    const float x = __shfl_sync(kAll, s, slot * lanes + p.layout.table_first[t]);
    total += x;
  }
  if (live && li == 0) p.out[b] = total;
}

}  // namespace

// out[b] for the n boards at `boards` (16 bytes each) over one group of
// tables: `layout` points to the group's packed words on the host, `tables`
// and `rowmaps` to its num_tables device pointers on the host (rowmaps may
// be null: no row maps), `init` to the previous group's output or null.
// Returns the CUDA error of the launch, or cudaErrorInvalidValue for a
// layout the parameter struct cannot hold.
extern "C" int rein48_ntuple_value(const void* boards, long long n, const void* layout, const void* const* tables,
                                   const void* const* rowmaps, const void* init, void* out, void* stream) {
  Params p;
  std::memcpy(&p.layout, layout, sizeof(Layout));
  const int nt = p.layout.num_tables, lanes = p.layout.lanes;
  if (nt < 1 || nt > kMaxTables || lanes < 1 || lanes > kMaxLanes || p.layout.max_lookups < 1 ||
      p.layout.max_lookups > lanes || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int t = 0; t < kMaxTables; ++t) {
    p.table[t] = t < nt ? static_cast<const float*>(tables[t]) : nullptr;
    p.rowmap[t] = t < nt && rowmaps != nullptr ? static_cast<const int32_t*>(rowmaps[t]) : nullptr;
  }
  p.boards = static_cast<const uint8_t*>(boards);
  p.init = static_cast<const float*>(init);
  p.out = static_cast<float*>(out);
  p.n = n;
  p.boards_per_warp = kMaxLanes / lanes;
  const long long warps = (n + p.boards_per_warp - 1) / p.boards_per_warp;
  const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ntuple_value_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

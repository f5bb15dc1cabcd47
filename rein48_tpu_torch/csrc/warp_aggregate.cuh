// Copyright 2026 The rein48-tpu Authors.
// SPDX-License-Identifier: Apache-2.0
//
// Warp-aggregated scatter-add for NVIDIA Hopper (sm_90a), shared by the
// table scatter (tables.cu) and the hot-prefix scatter (hbm_tables.cu).
//
// Early-game boards send many lookups to the same few entries (the
// all-empty tuple is index 0), and same-address atomics serialise. Before
// the atomics, the lanes of a warp that add to the same entry are grouped
// with __match_any_sync and their values summed with shuffles, so that each
// entry takes one add per warp and not one per lane.

#pragma once

#include <cuda_runtime.h>

namespace rein48 {

// The sums of one group of lanes that share a key.
struct GroupSums {
  bool leader;  // the group's lowest lane, which adds for all of it; false for key < 0
  float sum;    // of v over the group (valid in the leader)
  float abs_sum;  // of |v| over the group (valid in the leader, with kAbs)
  int count;    // lanes in the group
};

// Groups the warp's lanes by key and sums v (and, with kAbs, |v|) over
// each group whose key is >= 0; a lane with key < 0 belongs to no group
// that adds. Every lane of the warp must call this at the same time: the
// vote and the shuffles name all 32 lanes.
//
// The group's sum is a tree: in round r every lane still live adds the
// value of the next live lane of its group above it, and then the lanes at
// odd positions among the live ones drop out, so a group of g lanes takes
// ceil(log2 g) rounds. The float sums are reassociated against a
// sequential scatter-add; the count is exact.
template <bool kAbs>
__device__ __forceinline__ GroupSums warp_group_sums(int key, float v) {
  constexpr unsigned kAll = 0xffffffffu;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned below = (1u << lane) - 1u;
  const unsigned group = __match_any_sync(kAll, key);
  // The live lanes of the group above this one (none for a lane that adds nothing).
  unsigned above = key < 0 ? 0u : group & ~below & ~(1u << lane);
  unsigned pos = __popc(group & below);  // this lane's position among the group's live lanes
  float s = v;
  float a = fabsf(v);
  while (__any_sync(kAll, above != 0u)) {
    const int next = __ffs(above) - 1;  // -1: nothing left above
    const float ts = __shfl_sync(kAll, s, next & 31);
    const float ta = kAbs ? __shfl_sync(kAll, a, next & 31) : 0.0f;
    if (next >= 0) {
      s += ts;
      a += ta;
    }
    above &= ~__ballot_sync(kAll, pos & 1u);
    pos >>= 1;
  }
  return {key >= 0 && (group & below) == 0u, s, a, __popc(group)};
}

}  // namespace rein48

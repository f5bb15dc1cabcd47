# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Precomputed row-merge lookup table for the 2048 move kernel.

The reference implements the slide/merge as four hand-unrolled two-pointer
passes over Python lists (``reference/game/GameClient.py:130-254``).
On TPU we want the whole move to be a handful of vector ops, so we encode a
board row as four 4-bit tile *exponents* packed into a 16-bit integer
(nibble ``k`` represents the tile ``2**k``; ``0`` is an empty cell) and
precompute, for each of the 65536 possible rows, the result of merging that
row toward index 0 ("left").

The merge semantics exactly match the reference two-pointer routine
(``GameClient.py:140-180`` for UP, mirrored for the other directions):

* tiles compress toward the move direction,
* equal adjacent tiles (after compression) merge once, with priority given
  to the pair nearest the move direction (``[8,8,8,0] -> [16,8,0,0]``,
  ``[2,2,2,2] -> [4,4,0,0]``),
* a merged tile cannot merge again in the same move.

Each table entry packs, into one ``uint32``:

* bits  0..15 — the merged row code (same nibble encoding), and
* bits 16..31 — the merge score divided by 4 (every merge pays ``2**(k+1)``
  with ``k >= 1``, so scores are always multiples of 4; the row-max of
  131072 therefore fits in 16 bits).

``changed`` needs no bit: it is exactly ``new_code != code``, which matches
the reference's deepcopy-compare (``GameClient.py:137,180``).

Note the reference hard-codes ``reward = 0`` and never pays out merge score
(``GameClient.py:138``); the vector engine exposes both the true merge score
(from this table) and a reference-parity zero-reward mode.
"""

from __future__ import annotations

import functools

import numpy as np

BOARD_SIZE = 4
NUM_ROW_CODES = 1 << (4 * BOARD_SIZE)  # 65536
MAX_EXPONENT = 15  # nibble ceiling: 2**15 == 32768 tiles saturate on merge

# Powers used to pack a row of 4 exponents into one 16-bit code
# (row code = e0 + 16*e1 + 256*e2 + 4096*e3).
ROW_PACK_WEIGHTS = np.array([1, 16, 256, 4096], dtype=np.int32)
ROW_UNPACK_SHIFTS = np.array([0, 4, 8, 12], dtype=np.int32)


def merge_row_left(row):
    """Merge one row of tile exponents toward index 0.

    Pure-Python specification of the move kernel; equivalent to the
    reference's two-pointer pass (``GameClient.py:140-180``) restated as
    compress-then-pair-left. Used to build the LUT and as a readable oracle
    in tests.

    Args:
        row: sequence of 4 ints in ``[0, 15]`` (0 = empty, k = tile 2**k).

    Returns:
        ``(new_row, score)`` where ``new_row`` is a list of 4 exponents and
        ``score`` is the sum of the values of tiles created by merges
        (standard 2048 scoring; the reference itself always reports 0).
    """
    compressed = [x for x in row if x != 0]
    out = []
    score = 0
    i = 0
    while i < len(compressed):
        if i + 1 < len(compressed) and compressed[i] == compressed[i + 1]:
            merged = min(compressed[i] + 1, MAX_EXPONENT)
            out.append(merged)
            score += 2 ** (compressed[i] + 1)
            i += 2
        else:
            out.append(compressed[i])
            i += 1
    out.extend([0] * (BOARD_SIZE - len(out)))
    return out, score


def pack_row(row) -> int:
    """Pack 4 exponents into a 16-bit row code."""
    return int(row[0]) | (int(row[1]) << 4) | (int(row[2]) << 8) | (int(row[3]) << 12)


def unpack_row(code: int):
    """Unpack a 16-bit row code into 4 exponents."""
    return [(code >> s) & 0xF for s in (0, 4, 8, 12)]


@functools.lru_cache(maxsize=1)
def build_row_lut() -> np.ndarray:
    """Build the packed 65536-entry merge-left table (see module docstring)."""
    codes = np.arange(NUM_ROW_CODES, dtype=np.uint32)
    # Decode all rows at once: [65536, 4] exponents.
    exps = (codes[:, None] >> ROW_UNPACK_SHIFTS[None, :]) & 0xF

    new_exps = np.zeros_like(exps)
    scores = np.zeros(NUM_ROW_CODES, dtype=np.uint32)

    # Vectorized compress-then-merge over all 65536 rows. Stage 1: stable
    # compaction of nonzeros to the left via argsort on the "is zero" flag.
    order = np.argsort(exps == 0, axis=1, kind="stable")
    comp = np.take_along_axis(exps, order, axis=1)

    # Stage 2: pair-merge left-to-right. With only 4 cells the merge pattern
    # is decided by three adjacent-equality flags with left priority:
    #   m01 — cells 0,1 merge; m12 — cells 1,2 merge (only if not m01);
    #   m23 — cells 2,3 merge (only if not m12).
    c0, c1, c2, c3 = comp[:, 0], comp[:, 1], comp[:, 2], comp[:, 3]
    nz = comp != 0
    m01 = nz[:, 0] & (c0 == c1)
    m12 = nz[:, 1] & (c1 == c2) & ~m01
    m23 = nz[:, 2] & (c2 == c3) & ~m12

    def bump(e):
        return np.minimum(e + 1, MAX_EXPONENT)

    # Build the output sequentially in "slot" space: each input cell either
    # starts a merged tile, is absorbed into the previous one, or passes
    # through. Enumerate the 8 (m01, m12, m23) combinations:
    out = np.zeros_like(comp)
    # Slot 0
    out[:, 0] = np.where(m01, bump(c0), c0)
    # Slot 1: if m01, next distinct tile is c2 (merged with c3 if m23);
    # else it's c1 (merged with c2 if m12).
    out[:, 1] = np.where(
        m01,
        np.where(m23, bump(c2), c2),
        np.where(m12, bump(c1), c1),
    )
    # Slot 2: cases —
    #   m01 & m23   -> exhausted (0)
    #   m01 & ~m23  -> c3
    #   ~m01 & m12  -> c3
    #   ~m01 & ~m12 -> c2 (merged with c3 if m23)
    out[:, 2] = np.where(
        m01,
        np.where(m23, 0, c3),
        np.where(m12, c3, np.where(m23, bump(c2), c2)),
    )
    # Slot 3: only survives when no merge happened at all.
    out[:, 3] = np.where(m01 | m12 | m23, 0, c3)

    new_exps = out
    scores = (
        np.where(m01, 2 ** (c0.astype(np.uint32) + 1), 0)
        + np.where(m12, 2 ** (c1.astype(np.uint32) + 1), 0)
        + np.where(m23, 2 ** (c2.astype(np.uint32) + 1), 0)
    ).astype(np.uint32)

    new_codes = (new_exps.astype(np.uint32) * ROW_PACK_WEIGHTS[None, :].astype(np.uint32)).sum(
        axis=1, dtype=np.uint32
    )
    packed = new_codes | ((scores >> 2) << 16)
    return packed.astype(np.uint32)


def lut_new_code(packed: np.ndarray) -> np.ndarray:
    """Extract the merged row code from packed LUT entries."""
    return packed & 0xFFFF


def lut_score(packed: np.ndarray) -> np.ndarray:
    """Extract the merge score from packed LUT entries."""
    return (packed >> 16) << 2

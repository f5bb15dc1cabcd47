# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Reference-semantics Python oracle for fixed-seed parity testing (a copy of
``rein48_tpu/engine/oracle.py``, which the port does not import).

A clean-room re-statement of the reference game logic
(the reference's ``game/GameClient.py``) with two properties the reference
lacks:

1. **Explicit RNG** — all randomness flows through a caller-supplied
   ``random.Random`` instance instead of the global ``random`` module, and
   the oracle makes *exactly the same RNG calls in the same order* as the
   reference (``random.randint(0, n_blanks-1)`` then
   ``random.uniform(0, 1)`` per spawn, ``GameClient.py:121,125``; the random
   policy's ``random.randint(0, 3)``, ``control/rand.py:10``). Seeding one
   ``Random`` with the seed used to seed the reference's global module
   reproduces reference trajectories bit-for-bit.
2. **Decision capture** — every spawn decision is recorded as a
   ``(blank_rank, value_exponent)`` pair so the tensor engine can be driven
   with the identical choices (see ``core.place_tile``) and compared
   state-for-state.

This module is test/parity infrastructure only; the hot path is the LUT
engine in ``core.py``/``vector.py``.
"""

from __future__ import annotations

import dataclasses
import random
from typing import List, Optional, Sequence, Tuple

Board = List[List[int]]  # raw tile values, like the reference

_SIZE = 4


@dataclasses.dataclass
class SpawnDecision:
    """One spawn event, in engine-consumable form.

    ``rank`` is the chosen index into the board's blank cells in row-major
    order — exactly how the reference picks (it enumerates blanks row-major,
    ``GameClient.py:109-114``, then indexes with ``randint``).
    ``value_exp`` is 1 for a 2-tile, 2 for a 4-tile.
    """

    rank: int
    value_exp: int


def new_board() -> Board:
    """Zero 4x4 board (``GameClient.py:56-63``)."""
    return [[0] * _SIZE for _ in range(_SIZE)]


def merge_line(line: Sequence[int]) -> List[int]:
    """Merge a 4-cell line toward index 0, reference semantics.

    Restates the two-pointer pass (``GameClient.py:140-180``) as
    compress-then-pair-left, which the reference's own golden tests prove
    equivalent (``game/GameClientTest.py:49-331``). Value-agnostic, like the
    reference (its tests use 1s).
    """
    xs = [x for x in line if x != 0]
    out: List[int] = []
    i = 0
    while i < len(xs):
        if i + 1 < len(xs) and xs[i] == xs[i + 1]:
            out.append(xs[i] * 2)
            i += 2
        else:
            out.append(xs[i])
            i += 1
    out.extend([0] * (len(line) - len(out)))
    return out


def update_matrix(matrix: Board, action) -> Tuple[Board, int, bool]:
    """Slide/merge in ``action`` direction.

    Matches ``Game.update_matrix`` (``GameClient.py:130-254``) including its
    hard-coded ``reward = 0`` (``:138``) and accepted action aliases.
    """
    from rein48_tpu_torch.engine.core import ACTION_ALIASES, DOWN, LEFT, RIGHT, UP

    try:
        act = ACTION_ALIASES[action]
    except (KeyError, TypeError):
        try:
            act = ACTION_ALIASES[int(action)]
        except (KeyError, TypeError, ValueError):
            raise ValueError(
                "Input action signal is wrong: must be one of U/D/L/R aliases"
            ) from None

    n = len(matrix)
    out = [row[:] for row in matrix]
    if act == LEFT:
        out = [merge_line(row) for row in out]
    elif act == RIGHT:
        out = [merge_line(row[::-1])[::-1] for row in out]
    elif act == UP:
        cols = [merge_line([out[r][c] for r in range(n)]) for c in range(len(out[0]))]
        out = [[cols[c][r] for c in range(len(cols))] for r in range(n)]
    elif act == DOWN:
        cols = [
            merge_line([out[r][c] for r in range(n)][::-1])[::-1]
            for c in range(len(out[0]))
        ]
        out = [[cols[c][r] for c in range(len(cols))] for r in range(n)]
    changed = out != matrix
    return out, 0, changed


def random_fill_grid(
    matrix: Board,
    rng: random.Random,
    capture: Optional[List[SpawnDecision]] = None,
) -> Board:
    """Spawn one tile with the reference's exact RNG call order.

    ``GameClient.py:103-127``: enumerate blanks row-major, ``randint(0, n-1)``
    picks the cell, ``uniform(0, 1) > 0.1`` picks 2 else 4. No-op when full.
    """
    blanks = [
        (i, j)
        for i in range(len(matrix))
        for j in range(len(matrix[0]))
        if matrix[i][j] == 0
    ]
    if not blanks:
        return matrix
    rank = rng.randint(0, len(blanks) - 1)
    i, j = blanks[rank]
    value = 2 if rng.uniform(0, 1) > 0.1 else 4
    out = [row[:] for row in matrix]
    out[i][j] = value
    if capture is not None:
        capture.append(SpawnDecision(rank=rank, value_exp=1 if value == 2 else 2))
    return out


def has_table_filled(matrix: Board) -> bool:
    """``GameClient.py:97-100``."""
    return all(x != 0 for row in matrix for x in row)


def has_game_over(matrix: Board) -> bool:
    """``GameClient.py:66-94``: full and no equal 4-neighbour pair."""
    if not has_table_filled(matrix):
        return False
    n = len(matrix)
    for i in range(n):
        for j in range(n):
            if i + 1 < n and matrix[i][j] == matrix[i + 1][j]:
                return False
            if j + 1 < n and matrix[i][j] == matrix[i][j + 1]:
                return False
    return True


class OracleGame:
    """Stateful oracle with the reference's ``Game`` API and RNG behaviour.

    ``reset`` spawns one tile (``GameClient.py:33-38``); ``step`` moves,
    spawns iff changed, returns ``(state, reward=0, done)``
    (``GameClient.py:40-51``). All randomness comes from ``self.rng``; every
    spawn is appended to ``self.spawn_log`` for engine-side replay.
    """

    def __init__(self, seed: Optional[int] = None, rng: Optional[random.Random] = None):
        self.rng = rng if rng is not None else random.Random(seed)
        self.spawn_log: List[SpawnDecision] = []
        self.reward_space_size = 1
        self.action_space_size = 4
        self.state_space_size = _SIZE
        self.state_matrix: Board = new_board()
        self.reset()

    def reset(self) -> Board:
        self.state_matrix = new_board()
        self.state_matrix = random_fill_grid(
            self.state_matrix, self.rng, self.spawn_log
        )
        return self.state_matrix

    def step(self, action) -> Tuple[Board, int, bool]:
        self.state_matrix, reward, changed = update_matrix(self.state_matrix, action)
        if changed:
            self.state_matrix = random_fill_grid(
                self.state_matrix, self.rng, self.spawn_log
            )
        return self.state_matrix, reward, has_game_over(self.state_matrix)


def random_action(rng: random.Random) -> str:
    """The reference random policy (``control/rand.py:9-11``): one
    ``randint(0, 3)`` on the same RNG stream, returned as a direction name."""
    return ("UP", "DOWN", "LEFT", "RIGHT")[rng.randint(0, 3)]

# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""2048 environment core on tensors (port of ``rein48_tpu/engine/core.py``).

Same board encoding and semantics as the JAX core: ``uint8[..., 4, 4]``
tile exponents (0 = empty, ``k`` = tile ``2**k``), one spawned tile on
reset, spawn only when the move changed the board, tiles 2 w.p. 0.9 and 4
w.p. 0.1 on a uniform blank cell, game over when the board is full and no
4-neighbours are equal. Every function is shape-polymorphic in the
leading batch dimensions.

Differences from the JAX core, all inside the same semantics:

* random words are int64 tensors holding 32-bit values (CPU torch has no
  ``>>`` on ``uint32``), drawn from per-env Philox streams
  (``engine/philox.py``) instead of threefry keys; the single-env
  :func:`reset` and :func:`step` take their spawn uniforms from those words
  (``philox.uniform_from_words``) and spawn by JAX's float32 formula;
* tile values come from integer shifts, not float ``exp2`` (exact on any
  device; the JAX core's ``exp2`` is exact on the CPU only).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from rein48_tpu_torch.engine import lut, philox

UP, DOWN, LEFT, RIGHT = 0, 1, 2, 3
NUM_ACTIONS = 4
BOARD_SIZE = lut.BOARD_SIZE
NUM_CELLS = BOARD_SIZE * BOARD_SIZE
MAX_EXPONENT = lut.MAX_EXPONENT

ACTION_NAMES = ("UP", "DOWN", "LEFT", "RIGHT")

ACTION_ALIASES = {
    **{a: UP for a in ("UP", "Up", "U", "up", "u", 0)},
    **{a: DOWN for a in ("DOWN", "Down", "D", "down", "d", 1)},
    **{a: LEFT for a in ("LEFT", "Left", "L", "left", "l", 2)},
    **{a: RIGHT for a in ("RIGHT", "Right", "R", "right", "r", 3)},
}


class RewardMode(enum.Enum):
    """Reward channel: the reference's always-zero reward, or merge score."""

    PARITY_ZERO = "parity_zero"
    MERGE_SCORE = "merge_score"


@dataclasses.dataclass
class EnvState:
    """Batched environment state; all fields share the leading batch dims.

    Attributes:
        boards: ``uint8[..., 4, 4]`` tile exponents.
        score: ``float32[...]`` cumulative merge score this episode.
        steps: ``int32[...]`` steps taken this episode.
        done: ``bool[...]`` game-over flags.
        seed: ``int64[...]`` key of each env's Philox stream.
        env_id: ``int64[...]`` env index, the stream's second key word.
        counter: ``int64[...]`` next step of each env's stream.

    ``(seed, env_id, counter)`` replaces the JAX state's per-env threefry
    key: an env's trajectory depends only on them and its actions.
    """

    boards: torch.Tensor
    score: torch.Tensor
    steps: torch.Tensor
    done: torch.Tensor
    seed: torch.Tensor
    env_id: torch.Tensor
    counter: torch.Tensor

    def map(self, fn) -> "EnvState":
        """Apply ``fn`` to every field (slicing, moving to a device)."""
        return EnvState(**{f.name: fn(getattr(self, f.name)) for f in dataclasses.fields(self)})


_ROW_LUT = lut.build_row_lut()
_PACK_WEIGHTS = lut.ROW_PACK_WEIGHTS


def merge_cells_left(c0, c1, c2, c3):
    """Merge one line of 4 cell tensors toward index 0.

    Port of ``core.merge_cells_left``: the 6 compare-exchange stable
    compaction, then three left-priority pair-merge flags. Elementwise
    on any shape and integer dtype; the CUDA rollout kernel runs the same
    network on registers.

    Returns:
        ``((o0, o1, o2, o3), score)``: merged cells (input dtype) and the
        int32 merge score of the line.
    """
    for npairs in (3, 2, 1):
        cells = [c0, c1, c2, c3]
        for i in range(npairs):
            a, b = cells[i], cells[i + 1]
            sw = (a == 0) & (b != 0)
            cells[i] = torch.where(sw, b, a)
            cells[i + 1] = torch.where(sw, 0, b)
        c0, c1, c2, c3 = cells

    m01 = (c0 != 0) & (c0 == c1)
    m12 = (c1 != 0) & (c1 == c2) & ~m01
    m23 = (c2 != 0) & (c2 == c3) & ~m12

    def bump(e):
        return torch.clamp(e + 1, max=MAX_EXPONENT).to(c0.dtype)

    zero = torch.zeros_like(c0)
    o0 = torch.where(m01, bump(c0), c0)
    o1 = torch.where(m01, torch.where(m23, bump(c2), c2), torch.where(m12, bump(c1), c1))
    o2 = torch.where(
        m01,
        torch.where(m23, zero, c3),
        torch.where(m12, c3, torch.where(m23, bump(c2), c2)),
    )
    o3 = torch.where(m01 | m12 | m23, zero, c3)

    def pay(m, e):
        return torch.where(m, 1 << (e.to(torch.int32) + 1), 0)

    score = pay(m01, c0) + pay(m12, c1) + pay(m23, c2)
    return (o0, o1, o2, o3), score.to(torch.int32)


def merge_rows_left(rows: torch.Tensor):
    """Merge rows ``[..., 4]`` toward index 0.

    Returns ``(new_rows, row_score int32, row_changed bool)``.
    """
    (o0, o1, o2, o3), score = merge_cells_left(*rows.unbind(-1))
    new_rows = torch.stack([o0, o1, o2, o3], dim=-1)
    changed = torch.any(new_rows != rows, dim=-1)
    return new_rows, score, changed


def _orient(boards: torch.Tensor, actions: torch.Tensor):
    """Turn each board so that its move becomes a merge toward column 0."""
    actions = actions.to(torch.int64)
    vertical = ((actions == UP) | (actions == DOWN))[..., None, None]
    mirrored = ((actions == RIGHT) | (actions == DOWN))[..., None, None]
    b = torch.where(vertical, boards.transpose(-1, -2), boards)
    b = torch.where(mirrored, b.flip(-1), b)
    return b, vertical, mirrored


def _unorient(b: torch.Tensor, vertical, mirrored):
    b = torch.where(mirrored, b.flip(-1), b)
    return torch.where(vertical, b.transpose(-1, -2), b)


def move_boards(boards: torch.Tensor, actions: torch.Tensor):
    """Slide and merge ``boards`` in the per-board direction ``actions``.

    Returns ``(new_boards, merge_score float32, changed bool)``.
    """
    b, vertical, mirrored = _orient(boards, actions)
    nb, row_scores, row_changed = merge_rows_left(b)
    merge_score = row_scores.sum(-1).to(torch.float32)
    changed = row_changed.any(-1)
    return _unorient(nb, vertical, mirrored), merge_score, changed


def move_boards_lut(boards: torch.Tensor, actions: torch.Tensor):
    """Table-lookup variant of :func:`move_boards` (the exhaustive oracle)."""
    b, vertical, mirrored = _orient(boards, actions)
    weights = torch.as_tensor(_PACK_WEIGHTS.astype(np.int64), device=boards.device)
    codes = (b.to(torch.int64) * weights).sum(-1)  # [..., 4]
    table = torch.as_tensor(_ROW_LUT.astype(np.int64), device=boards.device)
    packed = table[codes]
    new_codes = packed & 0xFFFF
    merge_score = (((packed >> 16) << 2).sum(-1)).to(torch.float32)
    changed = (new_codes != codes).any(-1)
    shifts = torch.as_tensor(lut.ROW_UNPACK_SHIFTS.astype(np.int64), device=boards.device)
    nb = ((new_codes[..., None] >> shifts) & 0xF).to(boards.dtype)
    return _unorient(nb, vertical, mirrored), merge_score, changed


def place_tile(
    boards: torch.Tensor, rank: torch.Tensor, value_exp: torch.Tensor, enabled: torch.Tensor
) -> torch.Tensor:
    """Place a tile of exponent ``value_exp`` on the ``rank``-th blank cell.

    Blank cells are counted in row-major order; a disabled call or a full
    board leaves the board as it is.
    """
    flat = boards.reshape(boards.shape[:-2] + (NUM_CELLS,))
    blanks = flat == 0
    csum = torch.cumsum(blanks.to(torch.int32), dim=-1)
    target = blanks & (csum == (rank[..., None] + 1))
    do = (enabled & blanks.any(-1))[..., None]
    value = value_exp[..., None].to(boards.dtype)
    return torch.where(target & do, value, flat).reshape(boards.shape)


# New tiles are 4 w.p. 0.1, else 2: a 24-bit uniform against round(0.1 * 2**24).
SPAWN4_THRESHOLD_24 = 1677722


def spawn_rank_from_bits(bits: torch.Tensor, n_blanks) -> torch.Tensor:
    """Uniform rank in ``[0, n_blanks)`` from 32-bit words (24-bit fixed point)."""
    return ((bits >> 8) * n_blanks) >> 24


def spawn_exp_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Tile exponent (1 -> 2, 2 -> 4 w.p. 0.1) from 32-bit words."""
    return torch.where((bits >> 8) < SPAWN4_THRESHOLD_24, 2, 1)


def random_spawn(boards: torch.Tensor, u_idx: torch.Tensor, u_val: torch.Tensor, enabled: torch.Tensor) -> torch.Tensor:
    """Spawn a tile on a uniform blank cell from two float32 uniforms.

    The JAX single-env spawn's float arithmetic: the rank is
    ``min(floor(u_idx * n_blanks), max(n_blanks - 1, 0))``, the float32
    product of the same uniforms giving the same rank on any device, and
    the tile a 2 where ``u_val > 0.1``, else a 4. Shape-polymorphic in the
    leading dims; ``u_idx``, ``u_val`` and ``enabled`` are ``[...]``.
    """
    n_blanks = (boards == 0).flatten(-2).sum(-1)
    rank = torch.minimum((u_idx * n_blanks.to(torch.float32)).to(torch.int64), (n_blanks - 1).clamp(min=0))
    value_exp = torch.where(u_val > 0.1, 1, 2)
    return place_tile(boards, rank, value_exp, enabled)


def spawn_uniforms(words: torch.Tensor, first: int = philox.SPAWN_RANK):
    """The two spawn uniforms ``(u_idx, u_val)`` from a step's five stream
    words ``[..., 5]``: the ``SPAWN_*`` pair, or the ``RESET_*`` pair with
    ``first=philox.RESET_RANK``."""
    u = philox.uniform_from_words(words[..., first : first + 2])
    return u[..., 0], u[..., 1]


def is_game_over(boards: torch.Tensor) -> torch.Tensor:
    """Board full and no equal 4-neighbour pair."""
    full = (boards != 0).flatten(-2).all(-1)
    h_merge = (boards[..., :, :-1] == boards[..., :, 1:]).flatten(-2).any(-1)
    v_merge = (boards[..., :-1, :] == boards[..., 1:, :]).flatten(-2).any(-1)
    return full & ~h_merge & ~v_merge


def legal_action_mask(boards: torch.Tensor) -> torch.Tensor:
    """``bool[..., 4]`` (UP, DOWN, LEFT, RIGHT): does the move change the board."""

    def movable(prev, nxt):
        return ((nxt != 0) & ((prev == 0) | (prev == nxt))).flatten(-2).any(-1)

    left = movable(boards[..., :, :-1], boards[..., :, 1:])
    right = movable(boards[..., :, 1:], boards[..., :, :-1])
    up = movable(boards[..., :-1, :], boards[..., 1:, :])
    down = movable(boards[..., 1:, :], boards[..., :-1, :])
    return torch.stack([up, down, left, right], dim=-1)


def boards_to_values(boards: torch.Tensor) -> torch.Tensor:
    """Exponent boards -> raw tile values (int32), by integer shifts."""
    b = boards.to(torch.int32)
    return torch.where(b > 0, 1 << b, 0)


def board_tile_sum(boards: torch.Tensor) -> torch.Tensor:
    """Sum of raw tile values (the reference's "score"), float32.

    The integer sum is at most ``16 * 2**15`` and so exact in float32.
    """
    return boards_to_values(boards).sum((-1, -2)).to(torch.float32)


def max_tile(boards: torch.Tensor) -> torch.Tensor:
    """Largest tile value per board, float32 (``2**0`` for an empty board,
    as the JAX engine's ``exp2(max)``)."""
    e = boards.flatten(-2).amax(-1).to(torch.int32)
    return (1 << e).to(torch.float32)


def values_to_boards(values: np.ndarray) -> np.ndarray:
    """Raw tile values -> exponent boards (host-side helper)."""
    values = np.asarray(values)
    out = np.zeros_like(values, dtype=np.uint8)
    nz = values > 0
    out[nz] = np.round(np.log2(values[nz])).astype(np.uint8)
    return out


def reset(seed, env_id=0, *, uniforms=None, device=None) -> EnvState:
    """Fresh state: a zero board and ONE tile, as the reference resets.

    The counterpart of ``core.reset(key)``: the tile comes from the
    ``RESET_*`` words of step 0 of the stream ``(seed, env_id)`` through
    :func:`random_spawn`, or from ``uniforms`` ``(u_idx, u_val)`` when given.
    ``env_id`` is an int or an int64 tensor (a batch of ``[...]`` states);
    stepping starts at counter 1.
    """
    env_id = torch.as_tensor(env_id, dtype=torch.int64, device=device)
    seed = torch.full_like(env_id, seed) if not torch.is_tensor(seed) else seed.to(env_id.device)
    if uniforms is None:
        uniforms = spawn_uniforms(philox.step_words(seed, env_id, torch.zeros_like(env_id)), philox.RESET_RANK)
    boards = torch.zeros(env_id.shape + (BOARD_SIZE, BOARD_SIZE), dtype=torch.uint8, device=env_id.device)
    boards = random_spawn(boards, *uniforms, torch.ones_like(env_id, dtype=torch.bool))
    return EnvState(
        boards=boards,
        score=torch.zeros(env_id.shape, dtype=torch.float32, device=env_id.device),
        steps=torch.zeros(env_id.shape, dtype=torch.int32, device=env_id.device),
        done=torch.zeros(env_id.shape, dtype=torch.bool, device=env_id.device),
        seed=seed,
        env_id=env_id,
        counter=torch.ones_like(env_id),
    )


def step(state: EnvState, action, reward_mode: RewardMode = RewardMode.MERGE_SCORE, *, uniforms=None):
    """One transition with no auto-reset, in JAX's order: move, spawn where
    the move changed the board, game-over, then the reward by mode.

    The spawn's uniforms are the ``SPAWN_*`` words of the stream at
    ``state.counter`` (then counted), or ``uniforms`` ``(u_idx, u_val)``.
    Shape-polymorphic, so it also steps a batch (``vector.step_batch``).

    Returns ``(new_state, reward float32, done bool)``.
    """
    action = torch.as_tensor(action, device=state.boards.device)
    if uniforms is None:
        uniforms = spawn_uniforms(philox.step_words(state.seed, state.env_id, state.counter))
    new_board, merge_score, changed = move_boards(state.boards, action)
    new_board = random_spawn(new_board, *uniforms, changed)
    done = is_game_over(new_board)
    reward = torch.zeros_like(merge_score) if reward_mode == RewardMode.PARITY_ZERO else merge_score
    new_state = dataclasses.replace(
        state, boards=new_board, done=done, score=state.score + merge_score, steps=state.steps + 1, counter=state.counter + 1
    )
    return new_state, reward, done

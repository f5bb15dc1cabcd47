# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Lockstep batched 2048 engine with auto-reset (port of ``engine/vector.py``).

Boards that finish an episode are reset in place (zero board plus one
random tile), so a batch keeps stepping forever. Every env draws its
random words from its own Philox stream (``engine/philox.py``), keyed by
``(seed, env_id)`` and counted by ``counter``, so env ``i`` steps
identically whatever the batch size. Each step consumes one five-word
group of the stream; a policy-driven step ignores the ``ACTION`` word.
"""

from __future__ import annotations

import dataclasses

import torch

from rein48_tpu_torch.device import resolve_device
from rein48_tpu_torch.engine import core, philox
from rein48_tpu_torch.engine.core import EnvState, RewardMode


@dataclasses.dataclass
class StepOutput:
    """Per-step transition record emitted by :func:`step_autoreset`.

    Attributes:
        reward: ``float32[B]`` reward paid this step (mode-dependent).
        done: ``bool[B]`` episode ended this step (the returned state has
            already been reset there).
        changed: ``bool[B]`` the move changed the board.
        episode_score: ``float32[B]`` merge score of the ended episode.
        episode_tile_sum: ``float32[B]`` tile sum of the ended episode.
        episode_length: ``int32[B]`` length of the ended episode.
        max_tile: ``float32[B]`` largest tile of the ended episode.

    The episode fields are 0 where ``done`` is False.
    """

    reward: torch.Tensor
    done: torch.Tensor
    changed: torch.Tensor
    episode_score: torch.Tensor
    episode_tile_sum: torch.Tensor
    episode_length: torch.Tensor
    max_tile: torch.Tensor


def reset_batch(seed: int, batch_size: int, device=None) -> EnvState:
    """Fresh batch of ``batch_size`` boards with one tile each.

    The opening tile uses the ``RESET_*`` words of step 0 of each env's
    stream; stepping starts at counter 1.
    """
    device = resolve_device(device)
    env_id = torch.arange(batch_size, dtype=torch.int64, device=device)
    seeds = torch.full_like(env_id, seed)
    words = philox.step_words(seeds, env_id, torch.zeros_like(env_id))
    boards = torch.zeros((batch_size, core.BOARD_SIZE, core.BOARD_SIZE), dtype=torch.uint8, device=device)
    boards = core.place_tile(
        boards,
        core.spawn_rank_from_bits(words[:, philox.RESET_RANK], core.NUM_CELLS),
        core.spawn_exp_from_bits(words[:, philox.RESET_VALUE]),
        torch.ones(batch_size, dtype=torch.bool, device=device),
    )
    return EnvState(
        boards=boards,
        score=torch.zeros(batch_size, dtype=torch.float32, device=device),
        steps=torch.zeros(batch_size, dtype=torch.int32, device=device),
        done=torch.zeros(batch_size, dtype=torch.bool, device=device),
        seed=seeds,
        env_id=env_id,
        counter=torch.ones_like(env_id),
    )


def step_autoreset_from_bits(
    state: EnvState,
    actions: torch.Tensor,
    bits: torch.Tensor,
    reward_mode: RewardMode = RewardMode.MERGE_SCORE,
):
    """Autoreset step with randomness supplied as 4 words per env.

    The counterpart of ``vector._step_autoreset_from_bits`` batched:
    ``bits`` is int64 ``[B, 4]`` (spawn rank, spawn value, reset rank,
    reset value), ``actions`` is ``[B]``. The stream counter is left as it
    is; :func:`step_autoreset` advances it.
    """
    moved, merge_score, changed = core.move_boards(state.boards, actions)
    n_blanks = (moved == 0).flatten(-2).sum(-1)
    moved = core.place_tile(
        moved,
        core.spawn_rank_from_bits(bits[:, 0], n_blanks),
        core.spawn_exp_from_bits(bits[:, 1]),
        changed,
    )
    done = core.is_game_over(moved)

    episode_score = state.score + merge_score
    episode_tile_sum = core.board_tile_sum(moved)
    episode_length = state.steps + 1
    max_tile = core.max_tile(moved)

    fresh = core.place_tile(
        torch.zeros_like(moved),
        core.spawn_rank_from_bits(bits[:, 2], core.NUM_CELLS),
        core.spawn_exp_from_bits(bits[:, 3]),
        done,
    )
    board = torch.where(done[:, None, None], fresh, moved)

    new_state = dataclasses.replace(
        state,
        boards=board,
        done=torch.zeros_like(done),
        score=torch.where(done, 0.0, episode_score),
        steps=torch.where(done, 0, episode_length).to(torch.int32),
    )
    reward = merge_score
    if reward_mode == RewardMode.PARITY_ZERO:
        reward = torch.zeros_like(merge_score)
    out = StepOutput(
        reward=reward,
        done=done,
        changed=changed,
        episode_score=torch.where(done, episode_score, 0.0),
        episode_tile_sum=torch.where(done, episode_tile_sum, 0.0),
        episode_length=torch.where(done, episode_length, 0).to(torch.int32),
        max_tile=torch.where(done, max_tile, 0.0),
    )
    return new_state, out


def _advance(state: EnvState, actions, words, reward_mode):
    """Step with this step's stream words (int64 ``[B, 5]``), count it."""
    new_state, out = step_autoreset_from_bits(
        state, actions, words[:, philox.SPAWN_RANK :], reward_mode
    )
    new_state.counter = state.counter + 1
    return new_state, out


def step_autoreset(
    state: EnvState,
    actions: torch.Tensor,
    reward_mode: RewardMode = RewardMode.MERGE_SCORE,
):
    """Step every board with ``actions``; reset finished boards in place.

    Returns ``(new_state, StepOutput)``.
    """
    words = philox.step_words(state.seed, state.env_id, state.counter)
    return _advance(state, actions, words, reward_mode)


def step_batch(
    state: EnvState,
    actions: torch.Tensor,
    reward_mode: RewardMode = RewardMode.MERGE_SCORE,
    *,
    uniforms=None,
):
    """Batched plain step, no auto-reset: ``core.step`` over ``[B]`` states.

    Each env spawns from its own stream's uniforms, or from ``uniforms``
    ``(u_idx, u_val)``, float32 ``[B]`` each. Returns ``(new_state, reward,
    done)``.
    """
    return core.step(state, actions, reward_mode, uniforms=uniforms)


def rollout_random(
    state: EnvState,
    num_steps: int,
    reward_mode: RewardMode = RewardMode.MERGE_SCORE,
):
    """``num_steps`` of uniform-random actions (``ACTION`` word ``& 3``).

    Returns ``(final_state, outputs)`` with the :class:`StepOutput` fields
    stacked along a leading time axis ``[T, B]``.
    """
    outs = []
    for _ in range(num_steps):
        words = philox.step_words(state.seed, state.env_id, state.counter)
        state, out = _advance(state, words[:, philox.ACTION] & 3, words, reward_mode)
        outs.append(out)
    return state, stack_outputs(outs)


def stack_outputs(outs) -> StepOutput:
    """Stack per-step :class:`StepOutput` records along a leading time axis."""
    return StepOutput(
        **{f.name: torch.stack([getattr(o, f.name) for o in outs]) for f in dataclasses.fields(StepOutput)}
    )

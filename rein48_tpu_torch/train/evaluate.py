# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Batched policy evaluation (port of ``train/evaluate.py``).

N envs play in lockstep and the episode statistics come back as a dict of
floats. Two protocols, as in the JAX package: ``window`` aggregates the
episodes that complete within ``num_steps``; ``first`` scores exactly one
(first) episode per env, crediting envs still inside it with their live
board (a lower bound; ``unfinished`` counts them).

The torch modules carry their weights, so the JAX functions' ``params``
argument has no counterpart here. Tile metrics use integer shifts. Every
function runs on ``cuda`` unless ``device="cpu"`` is passed, and nothing
in the step loop waits for the device except ``on_chunk``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from rein48_tpu_torch.agents import a3c as a3c_agent
from rein48_tpu_torch.control import search
from rein48_tpu_torch.device import resolve_device
from rein48_tpu_torch.engine import core, philox, vector
from rein48_tpu_torch.train import common

_TILE_TIERS = (512, 1024, 2048, 4096, 8192, 16384)


def _episode_stats(outs: vector.StepOutput) -> Dict[str, torch.Tensor]:
    """Aggregate a ``StepOutput[T, B]`` trace into completed-episode stats."""
    dones = outs.done.to(torch.float32)
    n_eps = dones.sum()
    safe = torch.clamp(n_eps, min=1.0)
    max_tile = outs.max_tile
    stats = {
        "episodes": n_eps,
        "avg_tile_sum": outs.episode_tile_sum.sum() / safe,
        "avg_length": outs.episode_length.to(torch.float32).sum() / safe,
        "avg_score": outs.episode_score.sum() / safe,
        "best_tile": max_tile.max(),
    }
    for tier in _TILE_TIERS:
        stats[f"frac_{tier}"] = (dones * (max_tile >= tier)).sum() / safe
    return stats


def _to_floats(stats: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v) for k, v in stats.items()}


def greedy_policy(model, obs_encoding: str = "onehot"):
    """Greedy legal-masked policy of a ``(logits, value)`` module."""

    def policy_fn(boards: torch.Tensor) -> torch.Tensor:
        out = model(common.encode_obs(boards, obs_encoding))
        logits = out[0] if isinstance(out, tuple) else out
        return a3c_agent.masked_logits(logits, core.legal_action_mask(boards)).argmax(-1)

    return policy_fn


@torch.inference_mode()
def evaluate_policy(
    model: Any,
    *,
    obs_encoding: str = "onehot",
    num_envs: int = 512,
    num_steps: int = 4096,
    seed: int = 0,
    greedy: bool = True,
    protocol: str = "window",
    device=None,
) -> Dict[str, float]:
    """Play ``num_envs`` games of ``model``'s policy for ``num_steps`` steps.

    Greedy is argmax over legal actions; otherwise actions are sampled
    from the masked softmax by Gumbel-max over the Philox stream ``(seed,
    step)`` (``engine/philox.learner_gumbel``), the same on every device.
    """
    device = resolve_device(device)
    state = vector.reset_batch(seed, num_envs, device)
    if protocol == "first":
        if not greedy:
            raise ValueError("protocol='first' supports greedy eval only")
        _, stats = _first_episode_rollout(state, policy_fn=greedy_policy(model, obs_encoding), num_steps=num_steps)
        return _to_floats(stats)

    outs = []
    for step in range(num_steps):
        out = model(common.encode_obs(state.boards, obs_encoding))
        logits = out[0] if isinstance(out, tuple) else out
        masked = a3c_agent.masked_logits(logits, core.legal_action_mask(state.boards))
        if greedy:
            actions = masked.argmax(-1)
        else:
            actions = a3c_agent.sample_actions(philox.learner_gumbel(seed, step, masked.shape, device=device), masked)
        state, o = vector.step_autoreset(state, actions)
        outs.append(o)
    return _to_floats(_episode_stats(vector.stack_outputs(outs)))


def _build_search_policy(depth, model, obs_encoding, gamma, reward_transform, chance_chunk=None):
    """``policy_fn(boards) -> actions`` for :func:`evaluate_search`.

    With ``model`` the leaves are its value head, and on the card repeated
    calls replay a CUDA graph of the move (``control/search.Replayed``,
    keyed on the module's parameters and buffers); ``policy_fn.eager`` is
    the move launched op by op. The snake heuristic (no ``model``) runs op
    by op: it copies its weights to the card on every call.
    """
    if model is None:
        return search.make_expectimax_policy(depth, chance_chunk=chance_chunk)
    policy = search.make_expectimax_policy(
        depth,
        leaf_value=search.make_value_leaf(model, obs_encoding),
        reward_fn=lambda r: common.transform_reward(r, reward_transform),
        gamma=gamma,
        # Trainers bootstrap V=0 at done, so a dead node is worth 0.
        death_value=0.0,
        chance_chunk=chance_chunk,
    )
    return search.Replayed(policy, (model,))


def _search_rollout(start_state, *, policy_fn, num_steps):
    state, outs = start_state, []
    for _ in range(num_steps):
        state, out = vector.step_autoreset(state, policy_fn(state.boards))
        outs.append(out)
    return state, _episode_stats(vector.stack_outputs(outs))


def _first_episode_init(batch: int, device) -> Dict[str, torch.Tensor]:
    return {
        "finished": torch.zeros(batch, dtype=torch.bool, device=device),
        "score": torch.zeros(batch, dtype=torch.float32, device=device),
        "tile_sum": torch.zeros(batch, dtype=torch.float32, device=device),
        "length": torch.zeros(batch, dtype=torch.int32, device=device),
        "max_tile": torch.zeros(batch, dtype=torch.float32, device=device),
    }


def _first_episode_segment(carry, *, policy_fn, num_steps):
    """``num_steps`` steps of the first-episode sweep."""
    st, acc = carry
    for _ in range(num_steps):
        actions = policy_fn(st.boards)
        st, out = vector.step_autoreset(st, actions)
        first = out.done & ~acc["finished"]
        acc = {
            "finished": acc["finished"] | out.done,
            "score": torch.where(first, out.episode_score, acc["score"]),
            "tile_sum": torch.where(first, out.episode_tile_sum, acc["tile_sum"]),
            "length": torch.where(first, out.episode_length, acc["length"]),
            "max_tile": torch.where(first, out.max_tile, acc["max_tile"]),
        }
    return st, acc


def _first_episode_stats(final: core.EnvState, acc) -> Dict[str, torch.Tensor]:
    """First-episode stats from a sweep carry; live episodes count as they stand."""
    fin = acc["finished"]
    score = torch.where(fin, acc["score"], final.score)
    tile_sum = torch.where(fin, acc["tile_sum"], core.board_tile_sum(final.boards))
    length = torch.where(fin, acc["length"], final.steps)
    max_tile = torch.where(fin, acc["max_tile"], core.max_tile(final.boards))
    stats = {
        "episodes": torch.tensor(float(fin.shape[0])),
        "unfinished": (~fin).sum().to(torch.float32),
        "avg_score": score.mean(),
        "avg_tile_sum": tile_sum.mean(),
        "avg_length": length.to(torch.float32).mean(),
        "best_tile": max_tile.max(),
    }
    for tier in _TILE_TIERS:
        stats[f"frac_{tier}"] = (max_tile >= tier).to(torch.float32).mean()
    return stats


def _first_episode_rollout(start_state, *, policy_fn, num_steps, launch_chunk=None, on_chunk=None):
    """First-episode sweep: exactly B episodes, no completion-length bias.

    ``launch_chunk`` splits the sweep into segments of that many steps.
    ``on_chunk(steps_done, stats)`` is called after every whole segment
    with the lower-bound stats so far (floats), and a truthy return stops
    the sweep; as in the JAX package it is not called after the final
    remainder segment.
    """
    carry = (start_state, _first_episode_init(start_state.score.shape[0], start_state.score.device))
    if launch_chunk is None or launch_chunk >= num_steps:
        carry = _first_episode_segment(carry, policy_fn=policy_fn, num_steps=num_steps)
    else:
        whole, rem = divmod(num_steps, launch_chunk)
        done, stopped = 0, False
        for _ in range(whole):
            carry = _first_episode_segment(carry, policy_fn=policy_fn, num_steps=launch_chunk)
            done += launch_chunk
            if on_chunk is not None and on_chunk(done, _to_floats(_first_episode_stats(*carry))):
                stopped = True
                break
        if rem and not stopped:
            carry = _first_episode_segment(carry, policy_fn=policy_fn, num_steps=rem)
    final, acc = carry
    return final, _first_episode_stats(final, acc)


@torch.inference_mode()
def evaluate_search(
    *,
    depth: int = 1,
    num_envs: int = 256,
    num_steps: int = 4096,
    seed: int = 0,
    model: Any = None,
    obs_encoding: str = "onehot",
    gamma: float = 0.99,
    reward_transform: str = "log2",
    chance_chunk: int | None = None,
    protocol: str = "window",
    launch_chunk: int | None = None,
    on_chunk: Any = None,
    device=None,
) -> Dict[str, float]:
    """Play the expectimax planner (``control/search.py``) in lockstep.

    With ``model`` (a module already on ``device``) the leaves are its
    value head and ``gamma``/``reward_transform`` must match its training;
    without, the snake heuristic. ``chance_chunk`` bounds the leaf batch;
    ``protocol`` is ``window`` or ``first``; ``launch_chunk`` and
    ``on_chunk`` apply to ``first`` (see :func:`_first_episode_rollout`).
    """
    device = resolve_device(device)
    policy_fn = _build_search_policy(depth, model, obs_encoding, gamma, reward_transform, chance_chunk)
    state = vector.reset_batch(seed, num_envs, device)
    if protocol == "first":
        _, stats = _first_episode_rollout(
            state, policy_fn=policy_fn, num_steps=num_steps, launch_chunk=launch_chunk, on_chunk=on_chunk
        )
    else:
        _, stats = _search_rollout(state, policy_fn=policy_fn, num_steps=num_steps)
    return _to_floats(stats)

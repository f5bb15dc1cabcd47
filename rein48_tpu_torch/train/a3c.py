# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Synchronous batched A3C (A2C) trainer (port of ``train/a3c.py``).

B lockstep games unroll T steps under the sampled policy, n-step targets
are built backward from the bootstrap value, and one forward and backward
pass over all ``T * B`` boards gives one optimizer step per update.

An update is two phases, :meth:`A3CStep.rollout` and :meth:`A3CStep.learn`,
which tests and ``chip_smoke.py`` can drive apart; :func:`rollout_policy` is
the acting loop that the PPO trainer shares. Randomness: the env's spawns
come from its Philox streams (``engine/vector.py``); the action-sampling
noise and the working-dropout masks of the MLP from the learner's streams
of the same seed, named by the update step (``engine/philox.py``), one draw
per phase. Each phase takes the same draws injected instead. Nothing in an
update reads a value back to the host.

On a mesh (``parallel/``) each dp rank steps its slice of the global batch
(env ids ``lo..hi``), takes the rows ``lo..hi`` of the learner's draws,
normalizes the advantages over the global batch, and all-reduces the
gradient before the clip; its metrics are combined over the ranks, so
every rank reports the global batch's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from rein48_tpu_torch.agents import a3c as a3c_agent
from rein48_tpu_torch.device import resolve_device
from rein48_tpu_torch.engine import core, philox, vector
from rein48_tpu_torch.engine.core import RewardMode
from rein48_tpu_torch.models import nets
from rein48_tpu_torch.parallel import mesh as mesh_lib
from rein48_tpu_torch.parallel import spmd
from rein48_tpu_torch.train import common
from rein48_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class A3CConfig:
    """Hyperparameters, with the JAX package's fields and defaults.

    The defaults are the flagship's choices; :meth:`reference_parity` is the
    reference's regime (its reward is identically zero).
    """

    batch_size: int = 4096
    unroll_len: int = 32
    model: str = "resnet"
    model_kwargs: Tuple[Tuple[str, Any], ...] = ()
    obs_encoding: str = "onehot"
    reward_mode: RewardMode = RewardMode.MERGE_SCORE
    reward_transform: str = "log2"
    use_legal_mask: bool = True
    gamma: float = 0.99
    entropy_beta: float = 0.01
    value_coef: float = 0.5
    normalize_advantage: bool = True
    optimizer: str = "adam"
    learning_rate: float = 3e-4
    max_grad_norm: float = 1.0
    parity_drop_last_reward: bool = False
    # Cosine lr decay over this many updates (0 = constant) and a linear
    # entropy anneal over entropy_decay_updates (None = constant).
    lr_decay_updates: int = 0
    lr_final_frac: float = 0.1
    entropy_beta_final: Optional[float] = None
    entropy_decay_updates: int = 0

    def make_model(self, generator: torch.Generator | None = None) -> nn.Module:
        return nets.make_model(
            self.model, generator=generator, in_channels=common.obs_channels(self.obs_encoding), **dict(self.model_kwargs)
        )

    def make_learning_rate(self):
        """The learning rate, or a cosine schedule over the updates (one
        optimizer step per update)."""
        if self.lr_decay_updates > 0:
            return common.cosine_decay_schedule(self.learning_rate, self.lr_decay_updates, alpha=self.lr_final_frac)
        return self.learning_rate

    @classmethod
    def reference_parity(cls, **overrides) -> "A3CConfig":
        """The reference's exact training regime (quirks and all)."""
        base = dict(
            batch_size=64,
            unroll_len=100,
            model="mlp",
            obs_encoding="raw",
            reward_mode=RewardMode.PARITY_ZERO,
            reward_transform="identity",
            use_legal_mask=False,
            gamma=0.9,
            entropy_beta=0.001,
            value_coef=1.0,
            optimizer="rmsprop",
            learning_rate=1e-3,
            normalize_advantage=False,
            parity_drop_last_reward=True,
        )
        base.update(overrides)
        return cls(**base)


@dataclasses.dataclass
class A3CTrainState:
    """Trainer state.

    Attributes:
        model: the policy+value net (its parameters, updated in place).
        optimizer: the optimizer over ``model``'s parameters, with its moments.
        env: the ``[B]`` lockstep games.
        seed: the key of the learner's streams (sampling noise, dropout).
        update_step: updates taken (a host int).
    """

    model: nn.Module
    optimizer: common.Optimizer
    env: core.EnvState
    seed: int
    update_step: int


def init_a3c(config: A3CConfig, seed: int, device=None) -> Tuple[A3CTrainState, nn.Module, common.Optimizer]:
    """Fresh parameters (drawn on the CPU, so equal on every device) and
    ``batch_size`` games from ``seed``, which also keys the learner's draws."""
    device = resolve_device(device)
    model = config.make_model(torch.Generator().manual_seed(seed)).to(device)
    optimizer = common.make_optimizer(
        config.optimizer, config.make_learning_rate(), list(model.parameters()), max_grad_norm=config.max_grad_norm
    )
    state = A3CTrainState(
        model=model, optimizer=optimizer, env=vector.reset_batch(seed, config.batch_size, device), seed=seed, update_step=0
    )
    return state, model, optimizer


def entropy_beta_at(config, update_step: int) -> float:
    """The entropy weight of update ``update_step``: linear from
    ``entropy_beta`` to ``entropy_beta_final`` over ``entropy_decay_updates``,
    in float32 as the JAX trainers compute it."""
    if config.entropy_beta_final is None or config.entropy_decay_updates <= 0:
        return config.entropy_beta
    f32 = torch.float32
    frac = torch.clamp(torch.tensor(update_step, dtype=f32) / torch.tensor(config.entropy_decay_updates, dtype=f32), 0.0, 1.0)
    delta = torch.tensor(config.entropy_beta_final - config.entropy_beta, dtype=f32)
    return float(torch.tensor(config.entropy_beta, dtype=f32) + frac * delta)


def policy_fn(model: nn.Module, obs_encoding: str):
    """``policy(boards[..., 4, 4], dropout=None) -> (logits[..., 4], value[...])``."""

    def policy(boards: torch.Tensor, dropout: torch.Tensor | None = None):
        obs = common.encode_obs(boards.reshape((-1,) + boards.shape[-2:]), obs_encoding)
        logits, value = model(obs) if dropout is None else model(obs, dropout)
        return logits.reshape(boards.shape[:-2] + (nets.NUM_ACTIONS,)), value.reshape(boards.shape[:-2])

    return policy


def rollout_policy(config, policy, env: core.EnvState, noise: torch.Tensor, *, bits=None, after_boards: bool = False):
    """``unroll_len`` steps of ``policy``'s sampled actions (the acting path
    of the A3C and PPO trainers).

    Each step masks the logits to the legal moves (``use_legal_mask``) and
    takes ``argmax(masked + noise[t])``; ``noise`` is float ``[T, B, 4]``
    Gumbel noise and ``bits`` (int64 ``[T, B, 4]``) replaces the env's
    Philox words (``vector.step_autoreset_from_bits``). Returns ``(env,
    traj, bootstrap, metrics)``: ``traj`` stacks ``[T, B, ...]`` tensors of
    ``boards`` (s_t), ``actions``, ``rewards`` (transformed), ``dones``,
    ``legal_mask``, ``behavior_logp`` (log pi(a_t | s_t) of the masked
    policy), ``behavior_value`` and, with ``after_boards``, the pre-spawn
    afterstates ``after_boards``; ``bootstrap`` is V(s_T); ``metrics`` the
    episode sums (device scalars). Each step's forward, mask and sampling,
    and the bootstrap forward, are an ``a3c.act`` span each.
    """
    traj = {k: [] for k in ("boards", "actions", "rewards", "dones", "legal_mask", "behavior_logp", "behavior_value")}
    if after_boards:
        traj["after_boards"] = []
    episodes, tile_sum, length, best = [], [], [], []
    for t in range(config.unroll_len):
        with profiling.span("a3c.act"):
            logits, value = policy(env.boards)
            if config.use_legal_mask:
                mask = core.legal_action_mask(env.boards)
            else:
                mask = torch.ones(logits.shape, dtype=torch.bool, device=logits.device)
            masked = a3c_agent.masked_logits(logits, mask)
            actions = (masked + noise[t]).argmax(-1)
            traj["behavior_logp"].append(torch.log_softmax(masked, -1).gather(-1, actions[:, None])[:, 0])
            if after_boards:
                traj["after_boards"].append(core.move_boards(env.boards, actions)[0])
        traj["boards"].append(env.boards)
        if bits is None:
            env, out = vector.step_autoreset(env, actions, config.reward_mode)
        else:
            counter = env.counter
            env, out = vector.step_autoreset_from_bits(env, actions, bits[t], config.reward_mode)
            env.counter = counter + 1
        traj["actions"].append(actions)
        traj["rewards"].append(common.transform_reward(out.reward, config.reward_transform))
        traj["dones"].append(out.done)
        traj["legal_mask"].append(mask)
        traj["behavior_value"].append(value)
        episodes.append(out.done.sum())
        tile_sum.append(out.episode_tile_sum.sum())
        length.append(out.episode_length.sum())
        best.append(out.max_tile.max())
    with profiling.span("a3c.act"):
        _, bootstrap = policy(env.boards)
    metrics = {
        "episodes": torch.stack(episodes).sum().to(torch.float32),
        "episode_tile_sum_sum": torch.stack(tile_sum).sum(),
        "episode_length_sum": torch.stack(length).sum().to(torch.float32),
        "best_tile": torch.stack(best).max(),
    }
    return env, {k: torch.stack(v) for k, v in traj.items()}, bootstrap, metrics


class A3CStep:
    """One update, ``(state) -> (state, metrics)``, and its two phases.

    With a ``mesh`` the state holds this rank's slice of the games, and
    injected draws are the rank's rows.
    """

    def __init__(self, config: A3CConfig, model: nn.Module, optimizer: common.Optimizer, mesh=None):
        self.config, self.model, self.optimizer, self.mesh = config, model, optimizer, mesh
        self.rows, self.batch, self.group = mesh_lib.data_shard(mesh, config.batch_size)
        self.policy = policy_fn(model, config.obs_encoding)
        self.loss_cfg = a3c_agent.A3CLossConfig(
            gamma=config.gamma,
            entropy_beta=config.entropy_beta,
            value_coef=config.value_coef,
            normalize_advantage=config.normalize_advantage,
            parity_drop_last_reward=config.parity_drop_last_reward,
        )

    @torch.no_grad()
    def rollout(self, state: A3CTrainState, *, bits=None, noise=None):
        """Act for ``unroll_len`` steps and build the n-step targets.

        ``noise`` (float ``[T, B, 4]``) replaces the learner stream's Gumbel
        noise, ``bits`` the env's words (:func:`rollout_policy`). Returns
        ``(env, batch, metrics)``: ``batch`` holds ``boards``, ``actions``,
        ``legal_mask``, ``rewards``, ``dones`` and ``targets`` of ``[T, B]``.
        """
        cfg = self.config
        shape = (cfg.unroll_len, cfg.batch_size, nets.NUM_ACTIONS)
        if noise is None:
            noise = philox.learner_gumbel(state.seed, state.update_step, shape, device=state.env.boards.device)[:, self.rows]
        env, traj, bootstrap, metrics = rollout_policy(cfg, self.policy, state.env, noise, bits=bits)
        targets = a3c_agent.n_step_returns(
            traj["rewards"], bootstrap, cfg.gamma, dones=traj["dones"], parity_drop_last_reward=cfg.parity_drop_last_reward
        )
        batch = {k: traj[k] for k in ("boards", "actions", "legal_mask", "rewards", "dones")}
        batch["targets"] = targets
        return env, batch, metrics

    def dropout_draws(self, state: A3CTrainState, n: int, device) -> torch.Tensor | None:
        """The MLP's working-dropout uniforms for ``n`` boards (None when
        the net draws none): float ``[2, n, hidden]`` of the ``DROPOUT`` stream.
        On a mesh ``n`` is the rank's ``T * B / dp`` boards, the rank's rows
        of the global ``[2, T, B, hidden]`` draw."""
        if not getattr(self.model, "dropout_active", False):
            return None
        T, H = self.config.unroll_len, self.model.hidden
        u = philox.learner_uniform(
            state.seed, state.update_step, philox.DROPOUT, (2, T, self.config.batch_size, H), device=device
        )
        return u[:, :, self.rows].reshape(2, n, H)

    def loss_and_grads(self, state: A3CTrainState, batch: Dict[str, torch.Tensor], *, dropout=None):
        """One forward and backward pass over all ``T * B`` boards: the
        loss's diagnostics and the gradient of the global batch (reduced
        over the ranks on a mesh). ``dropout`` replaces :meth:`dropout_draws`."""
        T, B = self.config.unroll_len, self.batch
        boards = batch["boards"].reshape(T * B, 4, 4)
        if dropout is None:
            dropout = self.dropout_draws(state, T * B, boards.device)
        logits, values = self.policy(boards, dropout)
        logits = a3c_agent.masked_logits(logits.reshape(T, B, nets.NUM_ACTIONS), batch["legal_mask"])
        loss_cfg = self.loss_cfg._replace(entropy_beta=entropy_beta_at(self.config, state.update_step))
        loss, aux = a3c_agent.a3c_loss(
            logits, values.reshape(T, B), batch["actions"], batch["targets"], loss_cfg, group=self.group
        )
        grads = self.optimizer.reduce(torch.autograd.grad(loss, self.optimizer.params, allow_unused=True))
        return aux, grads

    def learn(self, state: A3CTrainState, batch: Dict[str, torch.Tensor], *, dropout=None) -> Dict[str, torch.Tensor]:
        """:meth:`loss_and_grads` and one optimizer step. Returns ``loss``,
        ``actor_loss``, ``critic_loss``, ``entropy``, ``td_abs`` and
        ``grad_norm`` (before clipping), as device scalars."""
        aux, grads = self.loss_and_grads(state, batch, dropout=dropout)
        self.optimizer.step(grads)
        metrics = {k: v.detach() for k, v in aux.items()}
        metrics["grad_norm"] = self.optimizer.global_norm(grads)
        return metrics

    def __call__(self, state: A3CTrainState, *, bits=None, noise=None, dropout=None):
        env, batch, rollout_metrics = self.rollout(state, bits=bits, noise=noise)
        metrics = self.learn(state, batch, dropout=dropout)
        metrics.update(rollout_metrics)
        metrics = spmd.reduce_metrics(metrics, self.group, sums=common.EPISODE_SUMS, maxes=("best_tile",))
        metrics["env_steps"] = float(self.config.unroll_len * self.config.batch_size)
        return dataclasses.replace(state, env=env, update_step=state.update_step + 1), metrics


def make_a3c_step(config: A3CConfig, model: nn.Module, optimizer: common.Optimizer, mesh=None) -> A3CStep:
    """Build the update: rollout -> n-step targets -> one optimizer step."""
    return A3CStep(config, model, optimizer, mesh)


def train_a3c(
    config: A3CConfig,
    num_updates: int,
    seed: int = 0,
    mesh=None,
    log_every: int = 10,
    logger=None,
    checkpointer=None,
    device=None,
) -> Tuple[A3CTrainState, list]:
    """Training loop: ``num_updates`` updates, a record every ``log_every``.

    Records hold the JAX package's keys; ``steps_per_sec`` counts from the
    first update. With a ``checkpointer`` the config is saved, the latest
    checkpoint resumed, and the state saved at the logging points that
    ``save_every`` divides.

    ``mesh`` (``parallel.mesh.make_mesh``, over the process group of which
    this process is a rank): the env batch shards over "dp" and the
    parameters and moments follow ``parallel.mesh.shard_params``; every rank
    returns the same records, and only rank 0 logs and saves.
    """
    device = resolve_device(device)
    state, model, optimizer = init_a3c(config, seed, device)
    if checkpointer is not None:
        checkpointer.save_config(config)
    if checkpointer is not None and checkpointer.latest_step() is not None:
        state = checkpointer.restore(state)
        print(f"resumed from checkpoint step {state.update_step}", flush=True)
    state = common.place_on_mesh(mesh, state, optimizer, model)
    step = make_a3c_step(config, model, optimizer, mesh)

    history = []
    base = state.update_step
    t0 = time.perf_counter()
    for i in range(num_updates):
        state, metrics = step(state)
        if (i + 1) % log_every == 0 or i + 1 == num_updates:
            m = {k: float(v) for k, v in metrics.items()}
            eps = max(m["episodes"], 1.0)
            record = {
                "update": base + i + 1,
                "loss": m["loss"],
                "actor_loss": m["actor_loss"],
                "critic_loss": m["critic_loss"],
                "entropy": m["entropy"],
                "grad_norm": m["grad_norm"],
                "episodes": m["episodes"],
                "avg_episode_tile_sum": m["episode_tile_sum_sum"] / eps,
                "avg_episode_length": m["episode_length_sum"] / eps,
                "best_tile": m["best_tile"],
                "steps_per_sec": (i + 1) * config.batch_size * config.unroll_len / (time.perf_counter() - t0),
            }
            common.log_and_save(record, logger, checkpointer, base + i + 1, state, mesh)
            history.append(record)
    return state, history

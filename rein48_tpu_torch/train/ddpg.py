# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""DDPG-style actor-critic with target networks and replay (port of
``train/ddpg.py``).

The discrete-action realization of the reference's DDPG skeleton: a
softmax actor (:class:`nets.CNNPolicy`) and an all-actions critic
(non-dueling :class:`nets.QNetwork`), each with a real target copy kept by
Polyak averaging with the reference's keep fraction 0.9. An update acts
one step, sampled from the masked softmax by Gumbel-max over the learner's
``SAMPLE`` noise, adds the transitions, samples a batch (``REPLAY``), and
computes both losses with the networks from before the update:

* critic: ``mean((r + gamma (1 - done) E_{a~pi_target}[Q_target(s', a)] -
  Q(s, a))**2)``;
* actor: ``-E_s[sum_a pi(a|s) Q(s, a)]`` under the critic from BEFORE its
  step, so both gradients are taken before either optimizer steps.

Below ``min_replay_before_learn`` transitions the gradients are zeroed but
both optimizers still step (unlike DQN, which skips its whole transaction):
Adam's count advances from the first update while the parameters stay.
``train_ddpg`` saves checkpoints and never restores one, as in JAX.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Dict, Tuple

import torch
from torch import nn

from rein48_tpu_torch.agents import a3c as a3c_agent
from rein48_tpu_torch.agents import dqn as dqn_agent
from rein48_tpu_torch.agents import replay as replay_lib
from rein48_tpu_torch.device import resolve_device
from rein48_tpu_torch.engine import core, philox, vector
from rein48_tpu_torch.engine.core import RewardMode
from rein48_tpu_torch.models import nets
from rein48_tpu_torch.train import common
from rein48_tpu_torch.train.dqn import episode_info, transition_example, transitions


@dataclasses.dataclass(frozen=True)
class DDPGConfig:
    """Hyperparameters, with the JAX package's fields and defaults."""

    num_envs: int = 2048
    obs_encoding: str = "onehot"
    reward_mode: RewardMode = RewardMode.MERGE_SCORE
    reward_transform: str = "log2"
    use_legal_mask: bool = True
    replay_capacity: int = 1 << 19
    learn_batch_size: int = 4096
    gamma: float = 0.99  # ddpg.py:9
    tau: float = 0.9  # keep fraction, agent.py:9
    optimizer: str = "adam"  # critic.py:34
    learning_rate: float = 3e-4
    max_grad_norm: float = 1.0
    min_replay_before_learn: int = 20_000

    def make_actor(self, generator: torch.Generator | None = None) -> nn.Module:
        return nets.CNNPolicy(generator=generator, in_channels=common.obs_channels(self.obs_encoding))

    def make_critic(self, generator: torch.Generator | None = None) -> nn.Module:
        return nets.QNetwork(dueling=False, generator=generator, in_channels=common.obs_channels(self.obs_encoding))


@dataclasses.dataclass
class DDPGTrainState:
    """Trainer state: the two nets and their targets (modules), one optimizer
    each, the ``[num_envs]`` games, the buffer, the learner's seed and the
    updates taken (a host int)."""

    actor: nn.Module
    critic: nn.Module
    target_actor: nn.Module
    target_critic: nn.Module
    actor_opt: common.Optimizer
    critic_opt: common.Optimizer
    env: core.EnvState
    replay: replay_lib.ReplayState
    seed: int
    update_step: int


def init_ddpg(config: DDPGConfig, seed: int, device=None) -> Tuple[DDPGTrainState, nn.Module, nn.Module]:
    """Fresh nets (drawn on the CPU from ``seed``, the actor first), their
    target copies, an empty buffer and ``num_envs`` games from ``seed``."""
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(seed)
    actor = config.make_actor(generator).to(device)
    critic = config.make_critic(generator).to(device)

    def opt(module):
        return common.make_optimizer(
            config.optimizer, config.learning_rate, list(module.parameters()), max_grad_norm=config.max_grad_norm
        )

    state = DDPGTrainState(
        actor=actor,
        critic=critic,
        target_actor=copy.deepcopy(actor).requires_grad_(False),
        target_critic=copy.deepcopy(critic).requires_grad_(False),
        actor_opt=opt(actor),
        critic_opt=opt(critic),
        env=vector.reset_batch(seed, config.num_envs, device),
        replay=replay_lib.replay_init(transition_example(device), config.replay_capacity),
        seed=seed,
        update_step=0,
    )
    return state, actor, critic


class DDPGStep:
    """One update, ``(state) -> (state, metrics)``, and its two phases."""

    def __init__(self, config: DDPGConfig, state: DDPGTrainState):
        self.config = config
        self.actor, self.critic = state.actor, state.critic
        self.target_actor, self.target_critic = state.target_actor, state.target_critic
        self.actor_opt, self.critic_opt = state.actor_opt, state.critic_opt

    def _logits(self, actor: nn.Module, boards: torch.Tensor) -> torch.Tensor:
        return actor(common.encode_obs(boards, self.config.obs_encoding))[0]

    def _q(self, critic: nn.Module, boards: torch.Tensor) -> torch.Tensor:
        return critic(common.encode_obs(boards, self.config.obs_encoding))

    @torch.no_grad()
    def act(self, state: DDPGTrainState, *, noise=None):
        """One step of actions sampled from the actor's masked softmax
        (illegal logits at -1e9) by Gumbel-max over ``noise`` (the learner's
        ``SAMPLE`` noise ``[B, 4]`` by default); its transitions are added
        to the buffer. Returns ``(env, replay, info)``."""
        cfg = self.config
        env = state.env
        logits = self._logits(self.actor, env.boards)
        mask = core.legal_action_mask(env.boards) if cfg.use_legal_mask else None
        if noise is None:
            noise = philox.learner_gumbel(state.seed, state.update_step, tuple(logits.shape), device=logits.device)
        actions = a3c_agent.sample_actions(noise, logits, mask)
        env2, out = vector.step_autoreset(env, actions, cfg.reward_mode)
        replay = replay_lib.replay_add(state.replay, transitions(env, actions, env2, out, cfg.reward_transform))
        return env2, replay, episode_info(out)

    def sample_indices(self, state: DDPGTrainState, replay: replay_lib.ReplayState) -> torch.Tensor:
        device = next(iter(replay.data.values())).device
        return replay_lib.sample_indices(state.seed, state.update_step, self.config.learn_batch_size, max(replay.size, 1), device)

    def learn(self, state: DDPGTrainState, replay: replay_lib.ReplayState, *, indices=None) -> Dict[str, torch.Tensor]:
        """Both gradients from the pre-update nets, zeroed while the buffer
        is cold, then both optimizer steps and the Polyak moves of both
        targets. ``indices`` replaces the ``REPLAY`` draw. Returns device
        scalars ``critic_loss``, ``actor_loss`` and ``td_abs``."""
        cfg = self.config
        if indices is None:
            indices = self.sample_indices(state, replay)
        sample = replay_lib.replay_sample(replay, indices)
        with torch.no_grad():
            next_probs = torch.softmax(self._logits(self.target_actor, sample["next_board"]), -1)
            target_v = torch.sum(next_probs * self._q(self.target_critic, sample["next_board"]), -1)
            td_target = sample["reward"] + cfg.gamma * (1.0 - sample["done"].to(torch.float32)) * target_v

        q = self._q(self.critic, sample["board"])
        q_a = q.gather(-1, sample["action"][..., None].long())[..., 0]
        td = td_target - q_a
        critic_loss = torch.mean(torch.square(td))
        critic_grads = torch.autograd.grad(critic_loss, self.critic_opt.params, allow_unused=True)

        # The critic's values before its step: no optimizer has stepped yet.
        probs = torch.softmax(self._logits(self.actor, sample["board"]), -1)
        actor_loss = -torch.mean(torch.sum(probs * q.detach(), -1))
        actor_grads = torch.autograd.grad(actor_loss, self.actor_opt.params, allow_unused=True)

        if replay.size < min(cfg.min_replay_before_learn, cfg.replay_capacity):
            critic_grads, actor_grads = [None] * len(critic_grads), [None] * len(actor_grads)
        self.critic_opt.step(critic_grads)
        self.actor_opt.step(actor_grads)
        dqn_agent.polyak_update(self.target_actor.parameters(), self.actor.parameters(), cfg.tau)
        dqn_agent.polyak_update(self.target_critic.parameters(), self.critic.parameters(), cfg.tau)
        return {"critic_loss": critic_loss.detach(), "actor_loss": actor_loss.detach(), "td_abs": td.detach().abs().mean()}

    def __call__(self, state: DDPGTrainState, *, noise=None, indices=None):
        env, replay, info = self.act(state, noise=noise)
        metrics = self.learn(state, replay, indices=indices)
        metrics.update(info, replay_size=float(replay.size))
        return dataclasses.replace(state, env=env, replay=replay, update_step=state.update_step + 1), metrics


def make_ddpg_step(config: DDPGConfig, state: DDPGTrainState) -> DDPGStep:
    """Build the update over ``state``'s nets and optimizers."""
    return DDPGStep(config, state)


def train_ddpg(
    config: DDPGConfig,
    num_updates: int,
    seed: int = 0,
    log_every: int = 10,
    logger=None,
    checkpointer=None,
    device=None,
) -> Tuple[DDPGTrainState, list]:
    """Training loop: ``num_updates`` updates, a record every ``log_every``
    with the JAX package's keys. With a ``checkpointer`` the state is saved
    at the logging points that ``save_every`` divides; as in JAX, nothing
    is resumed and no config is saved."""
    device = resolve_device(device)
    state, _, _ = init_ddpg(config, seed, device)
    step = make_ddpg_step(config, state)

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
                "critic_loss": m["critic_loss"],
                "actor_loss": m["actor_loss"],
                "td_abs": m["td_abs"],
                "replay_size": m["replay_size"],
                "episodes": m["episodes"],
                "avg_episode_tile_sum": m["episode_tile_sum_sum"] / eps,
                "best_tile": m["best_tile"],
                "steps_per_sec": (i + 1) * config.num_envs / (time.perf_counter() - t0),
            }
            history.append(record)
            if logger is not None:
                logger.write(record)
            if checkpointer is not None:
                checkpointer.maybe_save(base + i + 1, state)
    return state, history

# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""PPO trainer: multi-epoch clipped surrogate on the A3C acting path (port
of ``train/ppo.py``).

An update samples ``unroll_len`` steps of B lockstep games with the A3C
trainer's acting loop (``train/a3c.rollout_policy``), computes GAE over the
trajectory, then takes ``num_epochs`` x ``num_minibatches`` optimizer steps
of the clipped-surrogate loss on fresh shuffles. With ``afterstate_critic``
a second net regresses ``afterstate_targets`` on the rollout's pre-spawn
afterstates under the same optimizer and the same global-norm clip.

An update is two phases, :meth:`PPOStep.rollout` and :meth:`PPOStep.learn`,
which tests and ``chip_smoke.py`` can drive apart. Randomness: the env's
spawns come from its Philox streams; the sampling noise and the shuffles
from the learner's streams of the same seed, named by the update step
(``engine/philox.py``), one draw per phase. Each phase takes the same draws
injected instead. Nothing in an update reads a value back to the host.

On a mesh (``parallel/``) each dp rank steps its slice of the global batch
and takes the rows ``lo..hi`` of the learner's draws. The shuffles must be
``shard_friendly_perm`` (each minibatch holds a time window of every env, so
every rank holds its share of it); the advantages are normalized over the
global minibatch, the gradient is all-reduced before the clip, and the
metrics are combined over the ranks.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from rein48_tpu_torch.agents import a3c as a3c_agent
from rein48_tpu_torch.agents import ppo as ppo_agent
from rein48_tpu_torch.device import resolve_device
from rein48_tpu_torch.engine import core, philox, vector
from rein48_tpu_torch.engine.core import RewardMode
from rein48_tpu_torch.models import nets
from rein48_tpu_torch.parallel import mesh as mesh_lib
from rein48_tpu_torch.parallel import spmd
from rein48_tpu_torch.train import a3c, common


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Hyperparameters, with the JAX package's fields and defaults."""

    batch_size: int = 4096
    unroll_len: int = 32
    model: str = "resnet"
    model_kwargs: Tuple[Tuple[str, Any], ...] = ()
    obs_encoding: str = "onehot"
    reward_mode: RewardMode = RewardMode.MERGE_SCORE
    reward_transform: str = "log2"
    use_legal_mask: bool = True
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    num_epochs: int = 4
    num_minibatches: int = 4
    entropy_beta: float = 0.01
    value_coef: float = 0.5
    # The value clip's ABSOLUTE radius (value_clip_eps), not clip_eps.
    clip_value: bool = False
    value_clip_eps: float = 10.0
    normalize_advantage: bool = True  # per minibatch
    optimizer: str = "adam"
    learning_rate: float = 3e-4
    # Cosine lr decay over this many UPDATES (0 = constant), scaled by the
    # num_epochs * num_minibatches optimizer steps of an update.
    lr_decay_updates: int = 0
    lr_final_frac: float = 0.1
    # Linear entropy anneal over entropy_decay_updates (None = constant).
    entropy_beta_final: Optional[float] = None
    entropy_decay_updates: int = 0
    max_grad_norm: float = 0.5
    # True: each epoch permutes the time axis within each env.
    shard_friendly_perm: bool = True
    # A second value net V_after co-trained on the rollout's afterstates.
    afterstate_critic: bool = False
    after_model: str = "resnet"
    after_model_kwargs: Tuple[Tuple[str, Any], ...] = ()
    after_coef: float = 0.5

    def make_model(self, generator: torch.Generator | None = None) -> nn.Module:
        return nets.make_model(
            self.model, generator=generator, in_channels=common.obs_channels(self.obs_encoding), **dict(self.model_kwargs)
        )

    def make_after_model(self, generator: torch.Generator | None = None) -> nn.Module:
        return nets.make_model(
            self.after_model, generator=generator, in_channels=common.obs_channels(self.obs_encoding),
            **dict(self.after_model_kwargs),
        )

    def make_learning_rate(self):
        """The learning rate, or a cosine schedule over the optimizer's steps."""
        if self.lr_decay_updates > 0:
            steps = self.lr_decay_updates * self.num_epochs * self.num_minibatches
            return common.cosine_decay_schedule(self.learning_rate, steps, alpha=self.lr_final_frac)
        return self.learning_rate


@dataclasses.dataclass
class PPOTrainState:
    """Trainer state.

    Attributes:
        model: the policy+value net (its parameters, updated in place).
        after_model: the afterstate critic, or None without ``afterstate_critic``.
        optimizer: one optimizer over both nets' parameters, with its moments.
        env: the ``[B]`` lockstep games.
        seed: the key of the learner's streams (sampling noise, shuffles).
        update_step: updates taken (a host int).
    """

    model: nn.Module
    after_model: Optional[nn.Module]
    optimizer: common.Optimizer
    env: core.EnvState
    seed: int
    update_step: int


def init_ppo(config: PPOConfig, seed: int, device=None) -> Tuple[PPOTrainState, nn.Module, common.Optimizer]:
    """Fresh parameters (drawn on the CPU, so equal on every device) and
    ``batch_size`` games from ``seed``, which also keys the learner's draws."""
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(seed)
    model = config.make_model(generator).to(device)
    after = config.make_after_model(generator).to(device) if config.afterstate_critic else None
    params = list(model.parameters()) + (list(after.parameters()) if after is not None else [])
    optimizer = common.make_optimizer(config.optimizer, config.make_learning_rate(), params, max_grad_norm=config.max_grad_norm)
    state = PPOTrainState(
        model=model,
        after_model=after,
        optimizer=optimizer,
        env=vector.reset_batch(seed, config.batch_size, device),
        seed=seed,
        update_step=0,
    )
    return state, model, optimizer


class PPOStep:
    """One update, ``(state) -> (state, metrics)``, and its two phases.

    Raises JAX's ``ValueError`` when ``num_minibatches`` does not divide
    ``unroll_len * batch_size``, or ``unroll_len`` under ``shard_friendly_perm``.
    With a ``mesh`` the state holds this rank's slice of the games, and
    injected draws are the rank's rows.
    """

    def __init__(
        self,
        config: PPOConfig,
        model: nn.Module,
        optimizer: common.Optimizer,
        after_model: nn.Module | None = None,
        mesh=None,
    ):
        T, B, M = config.unroll_len, config.batch_size, config.num_minibatches
        if (T * B) % M:
            raise ValueError(f"unroll_len*batch_size={T * B} not divisible by {M}")
        if config.shard_friendly_perm and T % M:
            raise ValueError(f"shard_friendly_perm needs unroll_len={T} divisible by num_minibatches={M}")
        if config.afterstate_critic != (after_model is not None):
            raise ValueError("afterstate_critic needs after_model, and only then")
        if mesh is not None and mesh.dp > 1 and not config.shard_friendly_perm:
            raise ValueError("a mesh needs shard_friendly_perm: a permutation of all samples would move them between ranks")
        self.config, self.model, self.optimizer, self.after_model = config, model, optimizer, after_model
        self.rows, self.batch, self.group = mesh_lib.data_shard(mesh, B)
        self.policy = a3c.policy_fn(model, config.obs_encoding)
        self.after_value = None if after_model is None else a3c.policy_fn(after_model, config.obs_encoding)
        self.loss_cfg = ppo_agent.PPOLossConfig(
            clip_eps=config.clip_eps,
            entropy_beta=config.entropy_beta,
            value_coef=config.value_coef,
            clip_value=config.clip_value,
            value_clip_eps=config.value_clip_eps,
        )

    @torch.no_grad()
    def rollout(self, state: PPOTrainState, *, bits=None, noise=None):
        """Act for ``unroll_len`` steps and build GAE advantages and returns.

        ``noise`` (float ``[T, B, 4]``) replaces the learner stream's Gumbel
        noise, ``bits`` the env's words (``a3c.rollout_policy``). Returns
        ``(env, batch, metrics)``: ``batch`` holds ``[T, B, ...]`` tensors
        ``boards``, ``actions``, ``legal_mask``, ``behavior_logp``,
        ``behavior_value``, ``advantages``, ``returns`` and, with the
        afterstate critic, ``after_boards`` and ``after_targets``.
        """
        cfg = self.config
        shape = (cfg.unroll_len, cfg.batch_size, nets.NUM_ACTIONS)
        if noise is None:
            noise = philox.learner_gumbel(state.seed, state.update_step, shape, device=state.env.boards.device)[:, self.rows]
        critic = cfg.afterstate_critic
        env, traj, bootstrap, metrics = a3c.rollout_policy(cfg, self.policy, state.env, noise, bits=bits, after_boards=critic)
        advantages, returns = ppo_agent.gae(
            traj["rewards"], traj["behavior_value"], bootstrap, cfg.gamma, cfg.gae_lambda, dones=traj["dones"]
        )
        keys = ["boards", "actions", "legal_mask", "behavior_logp", "behavior_value"] + (["after_boards"] if critic else [])
        batch = {k: traj[k] for k in keys}
        batch.update(advantages=advantages, returns=returns)
        if critic:
            batch["after_targets"] = ppo_agent.afterstate_targets(returns, bootstrap, traj["dones"])
        return env, batch, metrics

    def permutations(self, state: PPOTrainState, device) -> torch.Tensor:
        """The update's shuffles, one per epoch (``common.shuffles``); on a
        mesh the rank's envs of them."""
        cfg = self.config
        perms = common.shuffles(
            state.seed, state.update_step, cfg.num_epochs, cfg.unroll_len, cfg.batch_size, cfg.shard_friendly_perm, device
        )
        return perms[..., self.rows]

    def minibatches(self, batch: Dict[str, torch.Tensor], perm: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Each ``[T, B, ...]`` entry shuffled by ``perm`` and cut into
        ``[M, T * B / M, ...]``: under ``shard_friendly_perm`` minibatch ``m``
        holds time slots ``m*T/M .. (m+1)*T/M`` of every env."""
        T, B, M = self.config.unroll_len, self.batch, self.config.num_minibatches
        out = {}
        for k, x in batch.items():
            if self.config.shard_friendly_perm:
                x = torch.take_along_dim(x, perm.reshape((T, B) + (1,) * (x.ndim - 2)), dim=0)
            else:
                x = x.reshape((T * B,) + x.shape[2:])[perm]
            out[k] = x.reshape((M, -1) + x.shape[(2 if self.config.shard_friendly_perm else 1):])
        return out

    def minibatch_loss(self, mb: Dict[str, torch.Tensor], loss_cfg: ppo_agent.PPOLossConfig):
        """The loss of one minibatch and its diagnostics (device scalars)."""
        logits, values = self.policy(mb["boards"])
        logits = a3c_agent.masked_logits(logits, mb["legal_mask"])
        adv = mb["advantages"]
        if self.config.normalize_advantage:
            adv = a3c_agent.normalize(adv, self.group)
        loss, aux = ppo_agent.ppo_loss(
            logits, values, mb["actions"], mb["behavior_logp"], mb["behavior_value"], adv, mb["returns"], loss_cfg
        )
        if self.after_value is not None:
            v_after = self.after_value(mb["after_boards"])[1]
            after_loss = torch.mean(torch.square(v_after - mb["after_targets"].detach()))
            loss = loss + self.config.after_coef * after_loss
            aux.update(after_loss=after_loss, loss=loss)
        return loss, aux

    def learn(self, state: PPOTrainState, batch: Dict[str, torch.Tensor], *, perms=None) -> Dict[str, torch.Tensor]:
        """``num_epochs`` x ``num_minibatches`` optimizer steps.

        ``perms`` (``num_epochs`` shuffles as :meth:`permutations` makes
        them) replaces the learner stream's. Returns the last epoch's means
        of the loss's diagnostics and ``grad_norm`` (before clipping), and
        ``approx_kl_last``, the last minibatch's ``approx_kl``, as device
        scalars.
        """
        loss_cfg = self.loss_cfg._replace(entropy_beta=a3c.entropy_beta_at(self.config, state.update_step))
        if perms is None:
            perms = self.permutations(state, batch["returns"].device)
        params = self.optimizer.params
        for perm in perms:
            mbs = self.minibatches(batch, perm)
            aux = []
            for m in range(self.config.num_minibatches):
                loss, a = self.minibatch_loss({k: v[m] for k, v in mbs.items()}, loss_cfg)
                grads = self.optimizer.reduce(torch.autograd.grad(loss, params, allow_unused=True))
                a = {k: v.detach() for k, v in a.items()}
                a["grad_norm"] = self.optimizer.global_norm(grads)
                self.optimizer.step(grads)
                aux.append(a)
        metrics = {k: torch.stack([a[k] for a in aux]).mean() for k in aux[0]}
        metrics["approx_kl_last"] = aux[-1]["approx_kl"]
        return metrics

    def __call__(self, state: PPOTrainState, *, bits=None, noise=None, perms=None):
        env, batch, rollout_metrics = self.rollout(state, bits=bits, noise=noise)
        metrics = self.learn(state, batch, perms=perms)
        metrics.update(rollout_metrics)
        metrics = spmd.reduce_metrics(metrics, self.group, sums=common.EPISODE_SUMS, maxes=("best_tile",))
        metrics["env_steps"] = float(self.config.unroll_len * self.config.batch_size)
        return dataclasses.replace(state, env=env, update_step=state.update_step + 1), metrics


def make_ppo_step(
    config: PPOConfig, model: nn.Module, optimizer: common.Optimizer, after_model: nn.Module | None = None, mesh=None
) -> PPOStep:
    """Build the update: rollout -> GAE -> epochs x minibatches."""
    return PPOStep(config, model, optimizer, after_model, mesh)


def train_ppo(
    config: PPOConfig,
    num_updates: int,
    seed: int = 0,
    mesh=None,
    log_every: int = 10,
    logger=None,
    checkpointer=None,
    warm_start_policy=None,
    device=None,
) -> Tuple[PPOTrainState, list]:
    """Training loop: ``num_updates`` updates, a record every ``log_every``.

    Records hold the JAX package's keys (``after_loss`` with the critic);
    ``steps_per_sec`` counts from the first update. With a ``checkpointer``
    the config is saved, the latest checkpoint resumed, and the state saved
    at the logging points that ``save_every`` divides.
    ``warm_start_policy`` (a ``state_dict`` of the policy net) seeds the
    policy when nothing is resumed; the afterstate critic starts fresh.

    ``mesh``: as in ``train_a3c``; both nets are placed on it.
    """
    device = resolve_device(device)
    state, model, optimizer = init_ppo(config, seed, device)
    if checkpointer is not None:
        checkpointer.save_config(config)
    if checkpointer is not None and checkpointer.latest_step() is not None:
        state = checkpointer.restore(state)
        print(f"resumed from checkpoint step {state.update_step}", flush=True)
    elif warm_start_policy is not None:
        model.load_state_dict(warm_start_policy)
        print("warm-started policy params", flush=True)
    learners = (model,) if state.after_model is None else (model, state.after_model)
    state = common.place_on_mesh(mesh, state, optimizer, *learners)
    step = make_ppo_step(config, model, optimizer, state.after_model, mesh)

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
                "approx_kl": m["approx_kl_last"],
                "clip_frac": m["clip_frac"],
                **({"after_loss": m["after_loss"]} if "after_loss" in m else {}),
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

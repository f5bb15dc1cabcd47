# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Deep afterstate-TD trainer, the n-tuple recipe on a dense net (port of
``train/afterstate.py``).

Acting is the depth-0 planner: each board's four afterstates go through
the value net in one batch and the greedy action maximises
``q(a) = r(a) + gamma * V(after(s, a))``. The rollout's state values give
TD(lambda) returns (``agents/ppo.py`` ``gae``), shifted onto the
afterstates (``afterstate_targets``); then ``num_epochs`` x
``num_minibatches`` steps of MSE regress ``V`` toward them.

An update is two phases, :meth:`AfterstateTDStep.rollout` and
:meth:`AfterstateTDStep.learn`, which tests and ``chip_smoke.py`` can drive
apart. The JAX ``lax.scan`` loops are Python loops; the model's parameters
and the optimizer's moments are updated in place. Acting runs under
``torch.no_grad`` (tensors made under ``inference_mode`` could not enter the
learn phase's autograd graph). Randomness: the env's spawns come from its
Philox streams (``engine/vector.py``); the shuffles and the epsilon draws
from the learner's streams of the same seed, named by the update step
(``engine/philox.py``), one draw per phase. Each phase takes the same
draws injected instead. Nothing in an update reads a value back to the
host.

On a mesh (``parallel/``) each dp rank steps its slice of the global batch,
takes the rows ``lo..hi`` of the learner's draws and, with
``shard_friendly_perm``, regresses its envs' share of every minibatch; the
gradient is all-reduced before the clip and the metrics are combined over
the ranks.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Tuple

import torch
from torch import nn

from rein48_tpu_torch.agents import ppo as ppo_agent
from rein48_tpu_torch.control import search
from rein48_tpu_torch.device import resolve_device
from rein48_tpu_torch.engine import core, philox, vector
from rein48_tpu_torch.engine.core import RewardMode
from rein48_tpu_torch.models import nets
from rein48_tpu_torch.parallel import mesh as mesh_lib
from rein48_tpu_torch.parallel import spmd
from rein48_tpu_torch.train import common

@dataclasses.dataclass(frozen=True)
class AfterstateTDConfig:
    """Hyperparameters, with the JAX package's fields and defaults.

    ``model_kwargs`` holds the model's keyword arguments as pairs, e.g.
    ``(("channels", 8), ("num_blocks", 1), ("dtype", torch.float32))``.
    """

    batch_size: int = 8192
    unroll_len: int = 32
    model: str = "resnet"
    model_kwargs: Tuple[Tuple[str, Any], ...] = ()
    obs_encoding: str = "onehot"
    reward_mode: RewardMode = RewardMode.MERGE_SCORE
    reward_transform: str = "log2"
    gamma: float = 0.997
    # TD(lambda) mixing: 0 = one-step TD (the n-tuple regime), 1 = Monte Carlo.
    td_lambda: float = 0.7
    epsilon: float = 0.0
    num_epochs: int = 2
    num_minibatches: int = 4
    optimizer: str = "adam"
    learning_rate: float = 1e-4
    lr_decay_updates: int = 0
    lr_final_frac: float = 0.1
    max_grad_norm: float = 0.5
    # True: each epoch permutes the time axis within each env.
    shard_friendly_perm: bool = True

    def make_model(self, generator: torch.Generator | None = None) -> nn.Module:
        return nets.make_model(
            self.model, generator=generator, in_channels=common.obs_channels(self.obs_encoding), **dict(self.model_kwargs)
        )

    def make_learning_rate(self):
        """The learning rate, or a cosine schedule over the optimizer's steps."""
        if self.lr_decay_updates > 0:
            steps = self.lr_decay_updates * self.num_epochs * self.num_minibatches
            return common.cosine_decay_schedule(self.learning_rate, steps, alpha=self.lr_final_frac)
        return self.learning_rate


@dataclasses.dataclass
class AfterstateTDState:
    """Trainer state.

    Attributes:
        model: the value net (its parameters, updated in place).
        optimizer: the optimizer over ``model``'s parameters, with its moments.
        env: the ``[B]`` lockstep games (Philox ``seed``/``env_id``/``counter``).
        seed: the key of the learner's streams (shuffles, epsilon draws).
        update_step: updates taken (a host int).
    """

    model: nn.Module
    optimizer: common.Optimizer
    env: core.EnvState
    seed: int
    update_step: int


def init_afterstate_td(
    config: AfterstateTDConfig, seed: int, device=None
) -> Tuple[AfterstateTDState, nn.Module, common.Optimizer]:
    """Fresh parameters (drawn on the CPU, so equal on every device) and
    ``batch_size`` games from ``seed``, which also keys the learner's draws."""
    device = resolve_device(device)
    model = config.make_model(torch.Generator().manual_seed(seed)).to(device)
    optimizer = common.make_optimizer(
        config.optimizer, config.make_learning_rate(), list(model.parameters()), max_grad_norm=config.max_grad_norm
    )
    state = AfterstateTDState(
        model=model,
        optimizer=optimizer,
        env=vector.reset_batch(seed, config.batch_size, device),
        seed=seed,
        update_step=0,
    )
    return state, model, optimizer


def make_value_fn(config: AfterstateTDConfig, model: nn.Module):
    """``V_after(boards[..., 4, 4]) -> float32[...]`` through the value head."""

    def value(boards: torch.Tensor) -> torch.Tensor:
        out = model(common.encode_obs(boards.reshape((-1,) + boards.shape[-2:]), config.obs_encoding))
        v = out[1] if isinstance(out, tuple) else out
        return v.reshape(boards.shape[:-2])

    return value


def make_act_values(config: AfterstateTDConfig, model: nn.Module):
    """``q(a) = r(a) + gamma * V(after(s, a))`` over all 4 actions.

    Returns ``act_values(boards[B, 4, 4]) -> (q[B, 4], after[B, 4, 4, 4],
    reward_tr[B, 4], legal[B, 4])``. The greedy argmax over the legal
    entries of ``q`` is the depth-0 planner of ``control/search.py`` with
    this value as its leaf.
    """
    value = make_value_fn(config, model)

    def act_values(boards: torch.Tensor):
        after, reward, legal = search._afterstates(boards)
        r_tr = common.transform_reward(reward.to(torch.float32), config.reward_transform)
        return r_tr + config.gamma * value(after), after, r_tr, legal

    return act_values


def _legal_pick(allowed: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The ``floor(u * n)``-th of the ``n`` allowed actions per row: a
    uniform legal action from a uniform draw ``u`` in [0, 1)."""
    n = allowed.sum(-1)
    k = torch.minimum((u * n).floor().to(n.dtype), n - 1)
    return (allowed.cumsum(-1) <= k[:, None]).sum(-1)


class AfterstateTDStep:
    """One update, ``(state) -> (state, metrics)``, and its two phases.

    Raises JAX's ``ValueError`` when ``shard_friendly_perm`` is on and
    ``num_minibatches`` does not divide ``unroll_len``. With a ``mesh`` the
    state holds this rank's slice of the games, and injected draws are the
    rank's rows.
    """

    def __init__(self, config: AfterstateTDConfig, model: nn.Module, optimizer: common.Optimizer, mesh=None):
        T, M = config.unroll_len, config.num_minibatches
        if config.shard_friendly_perm and T % M:
            raise ValueError(f"shard_friendly_perm needs unroll_len={T} divisible by num_minibatches={M}")
        if (T * config.batch_size) % M:
            raise ValueError(f"num_minibatches={M} must divide unroll_len x batch_size={T * config.batch_size}")
        if mesh is not None and mesh.dp > 1 and not config.shard_friendly_perm:
            raise ValueError("a mesh needs shard_friendly_perm: a permutation of all samples would move them between ranks")
        self.config, self.model, self.optimizer = config, model, optimizer
        self.rows, self.batch, self.group = mesh_lib.data_shard(mesh, config.batch_size)
        self.value = make_value_fn(config, model)
        self.act_values = make_act_values(config, model)

    @torch.no_grad()
    def rollout(self, state: AfterstateTDState, *, bits=None, draws=None):
        """Act greedily for ``unroll_len`` steps and build the targets.

        ``bits`` (int64 ``[T, B, 4]``) replaces the env's Philox words (see
        ``vector.step_autoreset_from_bits``); ``draws`` (float ``[T, 2, B]``
        in [0, 1)) replaces the epsilon draws: explore where ``draws[t, 0] <
        epsilon``, taking the ``floor(draws[t, 1] * n)``-th of the ``n``
        legal actions. Returns ``(env, batch, metrics)``: the games after
        the rollout, ``{"after_boards": uint8[T, B, 4, 4], "targets":
        float32[T, B]}``, and the rollout's episode sums (device scalars).
        """
        cfg = self.config
        T, B = cfg.unroll_len, self.batch
        env = state.env
        rows = torch.arange(B, device=env.boards.device)
        if cfg.epsilon > 0.0 and draws is None:
            shape = (T, 2, cfg.batch_size)
            draws = philox.learner_uniform(state.seed, state.update_step, philox.EPSILON, shape, device=rows.device)
            draws = draws[..., self.rows]
        after_boards, rewards, dones, values = [], [], [], []
        episodes, tile_sum, length, best = [], [], [], []
        for t in range(T):
            q, after, r_tr, legal = self.act_values(env.boards)
            all_illegal = ~legal.any(-1, keepdim=True)
            masked = torch.where(all_illegal, 0.0, torch.where(legal, q, -torch.inf))
            actions = masked.argmax(-1)
            if cfg.epsilon > 0.0:
                u = draws[t]
                explore = u[0] < cfg.epsilon
                actions = torch.where(explore, _legal_pick(legal | all_illegal, u[1]), actions)
            after_boards.append(after[rows, actions])
            rewards.append(r_tr[rows, actions])
            # U_t = q(chosen): the state value of s_t under the greedy policy.
            values.append(q[rows, actions])
            if bits is None:
                env, out = vector.step_autoreset(env, actions, cfg.reward_mode)
            else:
                counter = env.counter
                env, out = vector.step_autoreset_from_bits(env, actions, bits[t], cfg.reward_mode)
                env.counter = counter + 1
            dones.append(out.done)
            episodes.append(out.done.sum())
            tile_sum.append(out.episode_tile_sum.sum())
            length.append(out.episode_length.sum())
            best.append(out.max_tile.max())

        # Bootstrap: the state value of s_T under the same greedy policy.
        q_T, _, _, legal_T = self.act_values(env.boards)
        dead_T = ~legal_T.any(-1)
        u_T = torch.where(dead_T, 0.0, torch.where(legal_T, q_T, -torch.inf).amax(-1))
        dones = torch.stack(dones)
        _, returns = ppo_agent.gae(
            torch.stack(rewards), torch.stack(values), u_T, cfg.gamma, cfg.td_lambda, dones=dones
        )
        batch = {
            "after_boards": torch.stack(after_boards),
            "targets": ppo_agent.afterstate_targets(returns, u_T, dones),
        }
        metrics = {
            "episodes": torch.stack(episodes).sum().to(torch.float32),
            "episode_tile_sum_sum": torch.stack(tile_sum).sum(),
            "episode_length_sum": torch.stack(length).sum().to(torch.float32),
            "best_tile": torch.stack(best).max(),
        }
        return env, batch, metrics

    def permutations(self, state: AfterstateTDState, device) -> torch.Tensor:
        """The update's shuffles, one per epoch: ``[T, B]`` time indices per
        env (on a mesh, the rank's envs) or, without ``shard_friendly_perm``,
        one permutation of all ``T * B`` samples (``common.shuffles``)."""
        cfg = self.config
        perms = common.shuffles(
            state.seed, state.update_step, cfg.num_epochs, cfg.unroll_len, cfg.batch_size, cfg.shard_friendly_perm, device
        )
        return perms[..., self.rows]

    def minibatches(self, batch: Dict[str, torch.Tensor], perm: torch.Tensor):
        """``(boards[M, N, 4, 4], targets[M, N])`` of one epoch's shuffle."""
        M = self.config.num_minibatches
        boards, targets = batch["after_boards"], batch["targets"]
        if self.config.shard_friendly_perm:
            boards = torch.take_along_dim(boards, perm[:, :, None, None], dim=0)
            targets = torch.take_along_dim(targets, perm, dim=0)
        else:
            boards = boards.reshape((-1,) + boards.shape[2:])[perm]
            targets = targets.reshape(-1)[perm]
        return boards.reshape((M, -1) + boards.shape[-2:]), targets.reshape(M, -1)

    def learn(self, state: AfterstateTDState, batch: Dict[str, torch.Tensor], *, perms=None) -> Dict[str, torch.Tensor]:
        """``num_epochs`` x ``num_minibatches`` optimizer steps of MSE.

        ``perms`` (``num_epochs`` shuffles as :meth:`permutations` makes
        them) replaces the learner stream's. Returns the last epoch's means of
        ``loss``, ``v_mean``, ``target_mean`` and ``grad_norm`` (the norm
        before clipping), as device scalars.
        """
        params = self.optimizer.params
        if perms is None:
            perms = self.permutations(state, batch["targets"].device)
        for perm in perms:
            aux = []
            for boards, targets in zip(*self.minibatches(batch, perm)):
                v = self.value(boards)
                loss = torch.mean(torch.square(v - targets))
                grads = self.optimizer.reduce(torch.autograd.grad(loss, params, allow_unused=True))
                aux.append((loss.detach(), v.detach().mean(), targets.mean(), self.optimizer.global_norm(grads)))
                self.optimizer.step(grads)
        return {k: torch.stack(col).mean() for k, col in zip(("loss", "v_mean", "target_mean", "grad_norm"), zip(*aux))}

    def __call__(self, state: AfterstateTDState, *, bits=None, draws=None, perms=None):
        env, batch, rollout_metrics = self.rollout(state, bits=bits, draws=draws)
        metrics = self.learn(state, batch, perms=perms)
        metrics.update(rollout_metrics)
        metrics = spmd.reduce_metrics(metrics, self.group, sums=common.EPISODE_SUMS, maxes=("best_tile",))
        metrics["env_steps"] = float(self.config.unroll_len * self.config.batch_size)
        return dataclasses.replace(state, env=env, update_step=state.update_step + 1), metrics


def make_afterstate_td_step(
    config: AfterstateTDConfig, model: nn.Module, optimizer: common.Optimizer, mesh=None
) -> AfterstateTDStep:
    """Build the update: greedy-TD rollout -> targets -> SGD epochs."""
    return AfterstateTDStep(config, model, optimizer, mesh)


def train_afterstate_td(
    config: AfterstateTDConfig,
    num_updates: int,
    seed: int = 0,
    mesh=None,
    log_every: int = 10,
    logger=None,
    checkpointer=None,
    warm_start_params=None,
    device=None,
) -> Tuple[AfterstateTDState, list]:
    """Training loop: ``num_updates`` updates, a record every ``log_every``.

    Records hold the JAX package's keys; ``steps_per_sec`` counts from the
    first update. With a ``checkpointer`` the config is saved, the latest
    checkpoint resumed, and the state saved at the logging points that
    ``save_every`` divides. ``warm_start_params`` (a ``state_dict`` of the
    model) seeds the value net when nothing is resumed.

    ``mesh``: as in ``train_a3c``.
    """
    device = resolve_device(device)
    state, model, optimizer = init_afterstate_td(config, seed, device)
    if checkpointer is not None:
        checkpointer.save_config(config)
    if checkpointer is not None and checkpointer.latest_step() is not None:
        state = checkpointer.restore(state)
        print(f"resumed from checkpoint step {state.update_step}", flush=True)
    elif warm_start_params is not None:
        model.load_state_dict(warm_start_params)
        print("warm-started afterstate value params", flush=True)
    state = common.place_on_mesh(mesh, state, optimizer, model, checkpointer=checkpointer)
    step = make_afterstate_td_step(config, model, optimizer, mesh)

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
                "v_mean": m["v_mean"],
                "target_mean": m["target_mean"],
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

# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""DQN with a replay buffer on the device (port of ``train/dqn.py``).

An update acts ``acting_steps_per_update`` epsilon-greedy steps of the
lockstep games with the parameters from before the update, writes each
step's transitions into the circular buffer, samples a learn batch (1-step,
or ``n_step`` chains of the buffer's strided layout), takes one optimizer
step of the Huber TD loss against the target net, and moves the target:
Polyak with ``tau`` (the keep fraction) every update, or a hard copy of the
new parameters every ``target_sync_period`` updates.

As in JAX, the gate ``size >= min(min_replay_before_learn, capacity)``
covers the whole optimizer transaction: before it opens neither the
parameters nor Adam's moments or count move, while the loss and the
gradient norm are still computed and reported. The buffer's size is a host
int, so the gate reads nothing back from the device.

An update is two phases, :meth:`DQNStep.act` and :meth:`DQNStep.learn`.
Randomness: the env's spawns from its Philox streams; the explore
uniforms, the random actions' draws and the sample's indices from the
learner's ``EPSILON``, ``SAMPLE`` and ``REPLAY`` streams of the same seed,
named by the update step (``engine/philox.py``), one draw each per update.
Each phase also takes those draws injected.

On a mesh (``parallel/``) the buffer keeps the global layout without moving
rows: a step's ``N = num_envs`` transitions land at slots ``cursor ..
cursor + N``, so with ``capacity % N == 0`` slot ``s`` always holds env ``s %
N``, and a dp rank stores the slots of its own envs, ``capacity / dp`` rows,
in a ring of its own (its cursor and size are the global ones over ``dp``).
Every rank draws the same global sample indices, computes the loss terms of
the samples it holds (an n-step chain stays on one env, so on one rank), and
divides their sums by the global batch size; the all-reduced sum of those
gradients is the global mean's.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from rein48_tpu_torch.agents import dqn as dqn_agent
from rein48_tpu_torch.agents import replay as replay_lib
from rein48_tpu_torch.device import resolve_device
from rein48_tpu_torch.engine import core, philox, vector
from rein48_tpu_torch.engine.core import RewardMode
from rein48_tpu_torch.models import nets
from rein48_tpu_torch.parallel import mesh as mesh_lib
from rein48_tpu_torch.parallel import spmd
from rein48_tpu_torch.train import common


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    """Hyperparameters, with the JAX package's fields and defaults."""

    num_envs: int = 4096
    model: str = "resnet"
    model_kwargs: Tuple[Tuple[str, Any], ...] = ()
    obs_encoding: str = "onehot"
    reward_mode: RewardMode = RewardMode.MERGE_SCORE
    reward_transform: str = "log2"
    use_legal_mask: bool = True
    replay_capacity: int = 1 << 20
    learn_batch_size: int = 8192
    acting_steps_per_update: int = 1
    gamma: float = 0.99
    double_dqn: bool = True
    huber_delta: float = 1.0
    # n-step TD targets from the buffer's strided layout; 1 is classic DQN.
    n_step: int = 1
    optimizer: str = "adam"
    learning_rate: float = 3e-4
    max_grad_norm: float = 1.0
    # Polyak every update (tau the KEEP fraction); target_sync_period > 1
    # makes it a hard copy every that many updates instead.
    tau: float = 0.995
    target_sync_period: int = 1
    # Linear epsilon anneal, in environment steps.
    epsilon_start: float = 1.0
    epsilon_end: float = 0.05
    epsilon_decay_steps: int = 2_000_000
    min_replay_before_learn: int = 50_000

    def make_model(self, generator: torch.Generator | None = None) -> nn.Module:
        """``qnet`` is :class:`nets.QNetwork`; any other name comes from the
        registry (a policy net's logits then serve as Q)."""
        kwargs = dict(self.model_kwargs, generator=generator, in_channels=common.obs_channels(self.obs_encoding))
        if self.model == "qnet":
            return nets.QNetwork(**kwargs)
        return nets.make_model(self.model, **kwargs)


@dataclasses.dataclass
class DQNTrainState:
    """Trainer state.

    Attributes:
        model: the online net (its parameters, updated in place).
        target_model: the target net, a copy of ``model`` at init.
        optimizer: the optimizer over ``model``'s parameters, with its moments.
        env: the ``[num_envs]`` lockstep games.
        replay: the buffer (data on the device; cursor and size host ints).
        seed: the key of the learner's streams.
        update_step: updates taken (a host int).
        env_steps: environment steps taken (a host int).
    """

    model: nn.Module
    target_model: nn.Module
    optimizer: common.Optimizer
    env: core.EnvState
    replay: replay_lib.ReplayState
    seed: int
    update_step: int
    env_steps: int


def transition_example(device) -> Dict[str, torch.Tensor]:
    """One unbatched transition of the replay learners: 41 bytes a slot."""
    board = torch.zeros((core.BOARD_SIZE, core.BOARD_SIZE), dtype=torch.uint8, device=device)
    return {
        "board": board,
        "action": torch.zeros((), dtype=torch.int32, device=device),
        "reward": torch.zeros((), dtype=torch.float32, device=device),
        "next_board": board.clone(),
        "done": torch.zeros((), dtype=torch.bool, device=device),
    }


def init_dqn(config: DQNConfig, seed: int, device=None) -> Tuple[DQNTrainState, nn.Module, common.Optimizer]:
    """Fresh parameters (drawn on the CPU, so equal on every device), their
    copy as the target, an empty buffer and ``num_envs`` games from
    ``seed``, which also keys the learner's draws."""
    device = resolve_device(device)
    model = config.make_model(torch.Generator().manual_seed(seed)).to(device)
    target = copy.deepcopy(model).requires_grad_(False)
    optimizer = common.make_optimizer(
        config.optimizer, config.learning_rate, list(model.parameters()), max_grad_norm=config.max_grad_norm
    )
    state = DQNTrainState(
        model=model,
        target_model=target,
        optimizer=optimizer,
        env=vector.reset_batch(seed, config.num_envs, device),
        replay=replay_lib.replay_init(transition_example(device), config.replay_capacity),
        seed=seed,
        update_step=0,
        env_steps=0,
    )
    return state, model, optimizer


def q_values(model: nn.Module, boards: torch.Tensor, encoding: str) -> torch.Tensor:
    """Q(s, .) of a :class:`nets.QNetwork`, or a policy net's logits."""
    out = model(common.encode_obs(boards, encoding))
    return out[0] if isinstance(out, tuple) else out


def epsilon_at(config, env_steps: int) -> float:
    """The linear anneal at ``env_steps``, in float32 as JAX computes it."""
    f32 = np.float32
    frac = np.clip(f32(env_steps) / f32(config.epsilon_decay_steps), f32(0.0), f32(1.0))
    return float(f32(config.epsilon_start) + frac * f32(config.epsilon_end - config.epsilon_start))


def sync_target(config, target: nn.Module, model: nn.Module, update_step: int) -> None:
    """The target after update ``update_step``: a hard copy of the new
    parameters when ``target_sync_period > 1`` divides the step, else
    Polyak with ``tau`` (with ``target_sync_period`` 1)."""
    if config.target_sync_period > 1:
        if update_step % config.target_sync_period == 0:
            with torch.no_grad():
                torch._foreach_copy_(list(target.parameters()), list(model.parameters()))
    else:
        dqn_agent.polyak_update(target.parameters(), model.parameters(), config.tau)


def episode_info(out: vector.StepOutput) -> Dict[str, torch.Tensor]:
    """One step's episode sums, as the JAX replay trainers collect them."""
    return {
        "episodes": out.done.to(torch.float32).sum(),
        "episode_tile_sum_sum": out.episode_tile_sum.sum(),
        "episode_length_sum": out.episode_length.to(torch.float32).sum(),
        "best_tile": out.max_tile.max(),
    }


def merge_infos(infos) -> Dict[str, torch.Tensor]:
    """Sums over steps, and the best tile's max."""
    return {k: (torch.stack([i[k] for i in infos]).amax() if k == "best_tile" else sum(i[k] for i in infos)) for k in infos[0]}


def transitions(env: core.EnvState, actions, env2: core.EnvState, out: vector.StepOutput, reward_transform: str):
    """A step's transitions as the buffer stores them. The next board is the
    post-step board: at an episode end the slot was reset, but ``done`` cuts
    the TD recursion there."""
    return {
        "board": env.boards,
        "action": actions.to(torch.int32),
        "reward": common.transform_reward(out.reward, reward_transform),
        "next_board": env2.boards,
        "done": out.done,
    }


def check_mesh_layout(config: DQNConfig, mesh) -> None:
    """The sharded buffer's rule: ``replay_capacity % num_envs == 0`` and
    ``num_envs % dp == 0``, so that every slot's env, and its rank, is fixed."""
    if config.replay_capacity % config.num_envs or config.num_envs % mesh.dp:
        raise ValueError(
            f"a mesh needs replay_capacity % num_envs == 0 and num_envs % dp == 0, got replay_capacity="
            f"{config.replay_capacity}, num_envs={config.num_envs}, dp={mesh.dp}"
        )


def shard_replay(replay: replay_lib.ReplayState, num_envs: int, mesh) -> replay_lib.ReplayState:
    """This rank's ring of a global buffer: the slots of its envs, in order."""
    rows = mesh_lib.batch_slice(mesh, num_envs)
    data = {k: v.reshape((-1, num_envs) + v.shape[1:])[:, rows].flatten(0, 1).clone() for k, v in replay.data.items()}
    return replay_lib.ReplayState(data=data, cursor=replay.cursor // mesh.dp, size=replay.size // mesh.dp)


def gather_replay(replay: replay_lib.ReplayState, num_envs: int, mesh) -> replay_lib.ReplayState:
    """The global buffer from every rank's ring, in the global slot order."""
    n = num_envs // mesh.dp

    def whole(v):
        parts = spmd.all_gather(v.reshape((-1, n) + v.shape[1:]), mesh.dp_group)  # [dp, rows, n, ...]
        return parts.transpose(0, 1).flatten(0, 2)

    data = {k: whole(v) for k, v in replay.data.items()}
    return replay_lib.ReplayState(data=data, cursor=replay.cursor * mesh.dp, size=replay.size * mesh.dp)


class DQNStep:
    """One update, ``(state) -> (state, metrics)``, and its two phases.

    With a ``mesh`` the state holds this rank's games and ring of the buffer
    (:func:`shard_replay`); injected acting draws are the rank's rows, and
    sample indices are global.
    """

    def __init__(
        self, config: DQNConfig, model: nn.Module, target_model: nn.Module, optimizer: common.Optimizer, mesh=None
    ):
        if mesh is not None:
            check_mesh_layout(config, mesh)
        self.config, self.model, self.target_model, self.optimizer, self.mesh = config, model, target_model, optimizer, mesh
        self.rows, self.envs, self.group = mesh_lib.data_shard(mesh, config.num_envs)
        # The buffer's cursor and size are the global ones over dp.
        self.dp = 1 if mesh is None else mesh.dp
        # With n-step targets the bootstrap discount is gamma**n_step.
        self.loss_cfg = dqn_agent.DQNLossConfig(
            gamma=config.gamma**config.n_step, double_dqn=config.double_dqn, huber_delta=config.huber_delta
        )

    def acting_draws(self, state: DQNTrainState, device):
        """The update's explore uniforms ``[A, B]`` (``EPSILON``) and random
        actions' draws (``SAMPLE``: Gumbel noise ``[A, B, 4]`` with the legal
        mask, words ``[A, B]`` without)."""
        cfg = self.config
        shape = (cfg.acting_steps_per_update, cfg.num_envs)
        explore_u = philox.learner_uniform(state.seed, state.update_step, philox.EPSILON, shape, device=device)
        if cfg.use_legal_mask:
            random_draw = philox.learner_gumbel(state.seed, state.update_step, shape + (4,), device=device)
        else:
            random_draw = philox.learner_words(state.seed, state.update_step, philox.SAMPLE, shape, device=device)
        return explore_u[:, self.rows], random_draw[:, self.rows]

    @torch.no_grad()
    def act(self, state: DQNTrainState, *, explore_u=None, random_draw=None):
        """``acting_steps_per_update`` epsilon-greedy steps with the current
        parameters, each step's transitions added to the buffer. Epsilon is
        taken before each step's ``env_steps`` grows.

        Returns ``(env, replay, env_steps, info)``, ``info`` the episode sums.
        """
        cfg = self.config
        env, replay, env_steps = state.env, state.replay, state.env_steps
        if explore_u is None:
            explore_u, random_draw = self.acting_draws(state, env.boards.device)
        infos = []
        for k in range(cfg.acting_steps_per_update):
            q = q_values(self.model, env.boards, cfg.obs_encoding)
            mask = core.legal_action_mask(env.boards) if cfg.use_legal_mask else None
            actions = dqn_agent.epsilon_greedy(q, epsilon_at(cfg, env_steps), mask, explore_u[k], random_draw[k])
            env2, out = vector.step_autoreset(env, actions, cfg.reward_mode)
            replay = replay_lib.replay_add(replay, transitions(env, actions, env2, out, cfg.reward_transform))
            infos.append(episode_info(out))
            env, env_steps = env2, env_steps + cfg.num_envs
        return env, replay, env_steps, merge_infos(infos)

    def sample_indices(self, state: DQNTrainState, replay: replay_lib.ReplayState) -> torch.Tensor:
        """The learn batch's draw: slots in ``[0, max(size, 1))``, or with
        ``n_step > 1`` chain starts (age indices) in the valid window, of the
        global buffer."""
        cfg = self.config
        size = replay.size * self.dp
        if cfg.n_step > 1:
            n = max(size - (cfg.n_step - 1) * cfg.num_envs, 1)
        else:
            n = max(size, 1)
        device = next(iter(replay.data.values())).device
        return replay_lib.sample_indices(state.seed, state.update_step, cfg.learn_batch_size, n, device)

    def sample(self, replay: replay_lib.ReplayState, indices: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The learn batch at ``indices``: 1-step transitions, or ``n_step``
        chains reduced to 1-step form. On a mesh, the samples this rank holds."""
        cfg = self.config
        if self.mesh is None:
            if cfg.n_step > 1:
                return replay_lib.replay_sample_nstep(replay, indices, n_step=cfg.n_step, stride=cfg.num_envs, gamma=cfg.gamma)
            return replay_lib.replay_sample(replay, indices)
        N, dp = cfg.num_envs, self.dp
        if cfg.n_step > 1:
            if cfg.n_step * N > replay.capacity * dp:
                raise ValueError(f"n_step*stride={cfg.n_step * N} exceeds capacity {replay.capacity * dp}")
            slots = replay_lib.nstep_slots(replay.cursor * dp, replay.size * dp, replay.capacity * dp, indices, cfg.n_step, N)
        else:
            slots = indices[:, None]
        env = slots[:, 0] % N
        mine = torch.nonzero((env >= self.rows.start) & (env < self.rows.stop))[:, 0]
        # Global slot k * N + e is local slot k * envs + (e - lo).
        local = (slots[mine] // N) * self.envs + slots[mine] % N - self.rows.start
        if cfg.n_step > 1:
            return replay_lib.nstep_from_slots(replay.data, local, cfg.gamma)
        return replay_lib.replay_sample(replay, local[:, 0])

    def loss(self, batch: Dict[str, torch.Tensor]):
        """The TD loss of a learn batch and its diagnostics: ``Q_online(s)``
        with a gradient, ``Q_online(s')`` and ``Q_target(s')`` without. On a
        mesh of dp > 1, the rank's sums over the global batch size."""
        cfg = self.config
        q_online = q_values(self.model, batch["board"], cfg.obs_encoding)
        with torch.no_grad():
            q_online_next = q_values(self.model, batch["next_board"], cfg.obs_encoding)
            q_target_next = q_values(self.target_model, batch["next_board"], cfg.obs_encoding)
        return dqn_agent.dqn_loss(
            q_online, q_online_next, q_target_next, batch["action"], batch["reward"], batch["done"], self.loss_cfg,
            count=None if self.dp == 1 else cfg.learn_batch_size,
        )

    def learn(self, state: DQNTrainState, replay: replay_lib.ReplayState, *, indices=None) -> Dict[str, torch.Tensor]:
        """One gated optimizer step on a sampled batch, then the target sync
        for update ``state.update_step + 1``. ``indices`` replaces the
        ``REPLAY`` stream's draw. Returns the loss's diagnostics and
        ``grad_norm`` (of the raw gradients), device scalars."""
        cfg = self.config
        if indices is None:
            indices = self.sample_indices(state, replay)
        loss, aux = self.loss(self.sample(replay, indices))
        grads = self.optimizer.reduce(torch.autograd.grad(loss, self.optimizer.params, allow_unused=True), average=False)
        metrics = {k: v.detach() for k, v in aux.items()}
        metrics["grad_norm"] = self.optimizer.global_norm(grads)
        if replay.size * self.dp >= min(cfg.min_replay_before_learn, cfg.replay_capacity):
            self.optimizer.step(grads)
        sync_target(cfg, self.target_model, self.model, state.update_step + 1)
        return metrics

    def __call__(self, state: DQNTrainState, *, explore_u=None, random_draw=None, indices=None):
        env, replay, env_steps, info = self.act(state, explore_u=explore_u, random_draw=random_draw)
        metrics = self.learn(state, replay, indices=indices)
        metrics.update(info)
        if self.mesh is not None:
            # The loss terms are the rank's shares of the global means: they add up.
            sums = common.EPISODE_SUMS + ("loss", "td_abs", "q_mean", "target_mean")
            metrics = spmd.reduce_metrics(metrics, self.group, sums=sums, maxes=("best_tile",))
        metrics.update(
            epsilon=epsilon_at(self.config, env_steps), replay_size=float(replay.size * self.dp), env_steps=float(env_steps)
        )
        new_state = dataclasses.replace(state, env=env, replay=replay, update_step=state.update_step + 1, env_steps=env_steps)
        return new_state, metrics


def make_dqn_step(
    config: DQNConfig, model: nn.Module, target_model: nn.Module, optimizer: common.Optimizer, mesh=None
) -> DQNStep:
    """Build the update: act -> store -> sample -> learn -> sync."""
    return DQNStep(config, model, target_model, optimizer, mesh)


def train_dqn(
    config: DQNConfig,
    num_updates: int,
    seed: int = 0,
    mesh=None,
    log_every: int = 10,
    logger=None,
    checkpointer=None,
    device=None,
) -> Tuple[DQNTrainState, list]:
    """Training loop: ``num_updates`` updates, a record every ``log_every``.

    Records hold the JAX package's keys; ``steps_per_sec`` is, as in JAX,
    the state's total env steps (a resumed run's included) over the seconds
    since this call's first update. With a ``checkpointer`` the config is
    saved, the latest checkpoint resumed (the buffer with it), and the
    state saved at the logging points that ``save_every`` divides.

    ``mesh``: as in ``train_a3c``, with the buffer sharded by env
    (:class:`DQNStep`); a checkpoint holds the global buffer. Raises
    ``ValueError`` unless ``replay_capacity % num_envs == 0`` and ``num_envs
    % dp == 0``.
    """
    if mesh is not None:
        check_mesh_layout(config, mesh)
    device = resolve_device(device)
    state, model, optimizer = init_dqn(config, seed, device)
    if checkpointer is not None:
        checkpointer.save_config(config)
    if checkpointer is not None and checkpointer.latest_step() is not None:
        state = checkpointer.restore(state)
        print(f"resumed from checkpoint step {state.update_step}", flush=True)
    gather = None
    if mesh is not None:
        state = dataclasses.replace(state, replay=shard_replay(state.replay, config.num_envs, mesh))
        mesh_lib.shard_params(state.target_model, mesh)

        def gather(s):
            env, replay = mesh_lib.gather_batch(s.env, mesh), gather_replay(s.replay, config.num_envs, mesh)
            return dataclasses.replace(s, env=env, replay=replay)

    state = common.place_on_mesh(mesh, state, optimizer, model, checkpointer=checkpointer)
    step = make_dqn_step(config, model, state.target_model, optimizer, mesh)

    history = []
    base = state.update_step
    t0 = time.perf_counter()
    for i in range(num_updates):
        state, metrics = step(state)
        if (i + 1) % log_every == 0 or i + 1 == num_updates:
            m = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            eps = max(m["episodes"], 1.0)
            record = {
                "update": base + i + 1,
                "loss": m["loss"],
                "td_abs": m["td_abs"],
                "q_mean": m["q_mean"],
                "epsilon": m["epsilon"],
                "replay_size": m["replay_size"],
                "episodes": m["episodes"],
                "avg_episode_tile_sum": m["episode_tile_sum_sum"] / eps,
                "avg_episode_length": m["episode_length_sum"] / eps,
                "best_tile": m["best_tile"],
                "steps_per_sec": m["env_steps"] / dt,
            }
            common.log_and_save(record, logger, checkpointer, base + i + 1, state, mesh, gather=gather)
            history.append(record)
    return state, history

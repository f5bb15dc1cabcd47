# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Afterstate TD(0) learning for n-tuple networks (port of ``train/ntuple.py``).

B games run in lockstep. Each step acts greedily on
``Q(s, a) = r(a) + V(afterstate(s, a))`` and backs up the previous
afterstate toward ``r + V(afterstate')`` (Szubert & Jaskowski, CIG 2014);
a board that the spawn killed backs its last afterstate up toward 0. No
optimizer and no gradients: learning is a scatter-add into the tables.

The JAX ``lax.scan`` over the steps of an update is a Python loop here,
and the tables are updated in place. Acting draws its spawns from the
engine's Philox streams (``engine/vector.py``). On a card the ``"mxu"``
backend runs the table kernels of ``ops/tables.py`` and the ``"cached"``
backend those of ``ops/hbm_tables.py``; every backend's values take the
fused value kernel of ``ops/ntuple_value.py``.

On a mesh (``parallel/``) each dp rank steps its slice of the global batch
and acts on its own boards, and the tables stay replicated. Before each
window's update every rank gathers every rank's backups, in the global
batch's order, and applies the whole window with its backend (its scatter
kernel on the card), as one process would; then the entries the window
touched take rank 0's values on every rank. A backup is 20 bytes and a
touched entry 4 bytes per array, where the dense statistics of a table
are 12 bytes per entry of the table.

Why not sum each rank's dense statistics instead, as XLA sums the
per-device scatters in JAX: a reassociated sum moves a table entry by an
ulp, and the values of mirror-image afterstates tie to the ulp, so greedy
decisions then part from the one-process run's within an update. Why the
touched entries: the kernels add with atomics in an order that changes
from run to run (as ``index_add_`` does on the card), so replicas that
each applied the window would drift apart; every other entry moves by an
exact 0 on every rank.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, Tuple

import torch

from rein48_tpu_torch.agents import ntuple as ntuple_lib
from rein48_tpu_torch.control import search
from rein48_tpu_torch.device import resolve_device
from rein48_tpu_torch.engine import core, vector
from rein48_tpu_torch.ops import tables as table_ops
from rein48_tpu_torch.parallel import spmd
from rein48_tpu_torch.train import common, evaluate
from rein48_tpu_torch.utils import profiling

# The trainer's fields that hold the env batch (sharded over "dp" on a mesh).
BATCHED = ("env", "prev_after", "prev_valid")


@dataclasses.dataclass(frozen=True)
class NTupleTrainConfig:
    """Trainer hyperparameters, with the JAX package's defaults.

    ``alpha`` is the total learning rate per TD backup, split over the
    network's lookups. With ``update_mode="delayed"`` the per-window step
    saturates at ``alpha * beta = 1``, so ``alpha > 1`` needs ``tc=True``.
    ``table_backend`` is ``"auto"``, ``"torch"``, ``"mxu"`` or ``"cached"``;
    ``"auto"`` takes ``"mxu"`` when every table qualifies and the device is
    CUDA, else ``"torch"``, and never ``"cached"``, as in JAX.
    ``cache_prefix_rows`` (hot-prefix rows per table) and
    ``cache_refresh_every`` (updates between refreshes of the permutation)
    belong to ``"cached"``. See the JAX class for the measurements behind
    each default.
    """

    batch_size: int = 1024
    steps_per_update: int = 64
    tuples: Tuple[Tuple[int, ...], ...] = ntuple_lib.YEH_4X6
    symmetric: bool = True
    alpha: float = 1.0
    optimistic_init: float = 0.0
    collision: str = "mean"
    tc: bool = True
    update_mode: str = "step"
    delay_window: int | None = 4
    table_backend: str = "auto"
    cache_prefix_rows: int = 2048
    cache_refresh_every: int = 50

    def network_config(self, device=None) -> ntuple_lib.NTupleConfig:
        """The network's config, ``"auto"`` resolved for ``device``."""
        backend = self.table_backend
        if backend == "auto":
            small = all(table_ops.supports_mxu(ntuple_lib.BASE ** len(t)) for t in self.tuples)
            backend = "mxu" if small and resolve_device(device).type == "cuda" else "torch"
        return ntuple_lib.NTupleConfig(
            tuples=tuple(tuple(int(c) for c in t) for t in self.tuples),
            symmetric=self.symmetric,
            optimistic_init=self.optimistic_init,
            backend=backend,
            prefix_rows=self.cache_prefix_rows,
        )


@functools.lru_cache(maxsize=8)
def get_network(config: ntuple_lib.NTupleConfig) -> ntuple_lib.NTupleNetwork:
    """One network instance per config (its lookup constants are cached)."""
    return ntuple_lib.NTupleNetwork(config)


@dataclasses.dataclass
class NTupleTrainState:
    """Trainer state.

    Attributes:
        params: the tables (and TC accumulators), updated in place.
        env: the ``[B]`` lockstep games.
        prev_after: ``uint8[B, 4, 4]`` afterstate awaiting its backup.
        prev_valid: ``float32[B]``, 0 right after an episode start.
        update_step: updates taken (a host int).
    """

    params: Dict[str, torch.Tensor]
    env: core.EnvState
    prev_after: torch.Tensor
    prev_valid: torch.Tensor
    update_step: int


# Afterstates, rewards and legal masks of all 4 actions: [B, 4, ...].
_all_afterstates = search._afterstates


def init_ntuple(
    config: NTupleTrainConfig, seed: int, device=None
) -> Tuple[NTupleTrainState, ntuple_lib.NTupleNetwork]:
    """Fresh tables and ``batch_size`` games from ``seed``."""
    device = resolve_device(device)
    net = get_network(config.network_config(device))
    B = config.batch_size
    state = NTupleTrainState(
        params=net.init_tc(device) if config.tc else net.init(device),
        env=vector.reset_batch(seed, B, device),
        prev_after=torch.zeros((B, core.BOARD_SIZE, core.BOARD_SIZE), dtype=torch.uint8, device=device),
        prev_valid=torch.zeros(B, dtype=torch.float32, device=device),
        update_step=0,
    )
    return state, net


def _policy_and_backups(net, params, env, prev_after, prev_valid):
    """Greedy afterstate step and the step's two TD backups.

    ``params`` is the table the policy acts with (updated every step in
    "step" mode, frozen for a window in "delayed" mode). Returns
    ``(env2, chosen_after, done, upd_boards, upd_errs, metrics)``.
    """
    after, reward, legal = _all_afterstates(env.boards)
    v_after = net.value(params, after)  # [B, 4]
    q = torch.where(legal, reward + v_after, -torch.inf)
    # Autoreset keeps every board alive, so some action is legal; argmax
    # takes the first of equal maxima, as jnp.argmax does.
    action = q.argmax(-1)
    r_chosen = reward.gather(1, action[:, None])[:, 0]
    v_chosen = v_after.gather(1, action[:, None])[:, 0]
    chosen_after = after[torch.arange(after.shape[0], device=after.device), action]

    # Backup 1: V(prev_after) <- r_t + V(after_t), with values read before
    # this step's writes.
    err_prev = (r_chosen + v_chosen - net.value(params, prev_after)) * prev_valid

    env2, out = vector.step_autoreset(env, action)

    # Backup 2: the spawn killed the board, so V(after_t) <- 0 now.
    done = out.done.to(torch.float32)
    err_term = (0.0 - v_chosen) * done

    metrics = {
        "episodes": done.sum(),
        "episode_score_sum": out.episode_score.sum(),
        "episode_tile_sum_sum": out.episode_tile_sum.sum(),
        "episode_length_sum": out.episode_length.to(torch.float32).sum(),
        "best_tile": out.max_tile.max(),
        "td_abs_err": err_prev.abs().sum(),
        "td_updates": prev_valid.sum(),
    }
    upd_boards = torch.cat([prev_after, chosen_after])
    upd_errs = torch.cat([err_prev, err_term])
    return env2, chosen_after, done, upd_boards, upd_errs, metrics


def gather_backups(boards: list, errs: list, group) -> Tuple[torch.Tensor, torch.Tensor]:
    """A window's backups of every rank, in the global batch's order.

    ``boards`` and ``errs`` hold one ``[2 * b, ...]`` entry per step (the
    rank's ``b`` previous afterstates, then its ``b`` chosen ones); the
    result is what one process would have concatenated: per step the
    previous afterstates of all ranks, then the chosen ones. One gather of
    20 bytes per backup, exact.
    """
    S, n = len(boards), boards[0].shape[0] // 2
    packed = torch.cat(
        [torch.stack(boards).reshape(S, 2, n, 16), torch.stack(errs).reshape(S, 2, n, 1).view(torch.uint8)], dim=-1
    )
    full = spmd.all_gather(packed, group).permute(1, 2, 0, 3, 4).reshape(-1, 20)
    return full[:, :16].reshape(-1, 4, 4), full[:, 16:].contiguous().view(torch.float32).reshape(-1)


def share_touched(net: ntuple_lib.NTupleNetwork, params: Dict[str, torch.Tensor], boards: torch.Tensor, group) -> None:
    """Give every rank rank 0's values of the table entries (and their TC
    accumulators) that a window of ``boards`` touched: one broadcast."""
    touched, keys = [], []
    for i, idx in enumerate(net.indices(boards)):
        ids = torch.unique(net.physical_ids(params, i, idx.reshape(-1)))
        for key in (f"t{i}", f"t{i}_E", f"t{i}_A"):
            if key in params:
                touched.append(ids)
                keys.append(key)
    values = torch.cat([params[k][ids] for k, ids in zip(keys, touched)])
    spmd.broadcast_from_first(values, group)
    for k, ids, v in zip(keys, touched, values.split([t.numel() for t in touched])):
        params[k][ids] = v


def make_ntuple_step(config: NTupleTrainConfig, device=None, mesh=None):
    """Build one update: ``steps_per_update`` TD steps.

    Returns ``step_fn(state) -> (state, metrics)``; ``state`` must live on
    ``device`` (resolved as :func:`init_ntuple` resolves it), and its
    tables are updated in place. With a ``mesh`` the state holds this
    rank's slice of the games, each window's backups are gathered before
    the tables move (:func:`gather_backups`, :func:`share_touched`), and the
    metrics are combined over the ranks. Each acting step is an
    ``ntuple.act`` span, each window's table update an ``ntuple.apply`` span.
    """
    device = resolve_device(device)
    net = get_network(config.network_config(device))
    alpha = config.alpha
    if config.update_mode not in ("step", "delayed"):
        raise ValueError(f"unknown update_mode '{config.update_mode}'")
    if config.update_mode == "delayed" and not config.tc and config.alpha > 1.0:
        raise ValueError(
            f"alpha={config.alpha} > 1 with update_mode='delayed', tc=False: "
            "the windowed update saturates at alpha=1; use alpha <= 1 "
            "(or tc=True, where large alpha is modulated per-entry)."
        )
    window = config.delay_window or config.steps_per_update
    if config.update_mode == "delayed" and config.steps_per_update % window:
        raise ValueError(f"delay_window {window} must divide steps_per_update {config.steps_per_update}")
    # "step" mode is a window of one step whose backups land at once.
    if config.update_mode == "step":
        window = 1
    group = None if mesh is None else mesh.dp_group

    def apply(params, boards, errs):
        if config.update_mode == "delayed":
            return net.td_apply_delayed(params, boards, errs, alpha, tc=config.tc)
        if config.tc:
            return net.td_apply_tc(params, boards, errs, alpha)
        return net.td_apply(params, boards, errs, alpha, collision=config.collision)

    @torch.no_grad()
    def step_fn(state: NTupleTrainState):
        if state.prev_after.device.type != device.type:
            raise ValueError(f"state is on {state.prev_after.device}, the step was built for {device}")
        params, env = state.params, state.env
        prev_after, prev_valid = state.prev_after, state.prev_valid
        ms = []
        for _ in range(config.steps_per_update // window):
            boards, errs = [], []
            for _ in range(window):
                with profiling.span("ntuple.act"):
                    env, prev_after, done, upd_boards, upd_errs, m = _policy_and_backups(
                        net, params, env, prev_after, prev_valid
                    )
                prev_valid = 1.0 - done
                boards.append(upd_boards)
                errs.append(upd_errs)
                ms.append(m)
            with profiling.span("ntuple.apply"):
                if mesh is None:
                    params = apply(params, torch.cat(boards), torch.cat(errs))
                else:
                    all_boards, all_errs = gather_backups(boards, errs, group)
                    params = apply(params, all_boards, all_errs)
                    share_touched(net, params, all_boards, group)
        stacked = {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
        sums = ("episodes", "episode_score_sum", "episode_tile_sum_sum", "episode_length_sum", "td_abs_err", "td_updates")
        metrics = {k: stacked[k].sum() for k in sums}
        metrics["best_tile"] = stacked["best_tile"].max()
        metrics = spmd.reduce_metrics(metrics, group, sums=sums, maxes=("best_tile",))
        metrics["td_abs_err"] = metrics["td_abs_err"] / torch.clamp(metrics.pop("td_updates"), min=1.0)
        metrics["env_steps"] = float(config.steps_per_update * config.batch_size)
        new_state = NTupleTrainState(
            params=params, env=env, prev_after=prev_after, prev_valid=prev_valid, update_step=state.update_step + 1
        )
        return new_state, metrics

    return step_fn


def train_ntuple(
    config: NTupleTrainConfig,
    num_updates: int,
    seed: int = 0,
    mesh=None,
    log_every: int = 10,
    logger=None,
    checkpointer=None,
    device=None,
) -> Tuple[NTupleTrainState, list]:
    """Training loop: ``num_updates`` updates, a record every ``log_every``.

    ``logger`` is anything with ``.write(record)``. Records hold the same
    keys as the JAX package's; ``steps_per_sec`` counts from the first
    update, whose time includes building the kernels. With ``"cached"``
    the permutation is derived before the first update and after every
    ``cache_refresh_every``-th, as in JAX; the state then holds the new
    tables. With a ``checkpointer`` the config is saved, the latest
    checkpoint resumed, and the state saved at the logging points that
    ``save_every`` divides, as in JAX.

    ``mesh`` (``parallel.mesh.make_mesh``): the env batch shards over "dp"
    and the tables stay replicated (:func:`make_ntuple_step`); every rank
    returns the same records, and only rank 0 logs and saves.
    """
    device = resolve_device(device)
    state, net = init_ntuple(config, seed, device)
    if checkpointer is not None:
        checkpointer.save_config(config)
    if checkpointer is not None and checkpointer.latest_step() is not None:
        state = checkpointer.restore(state)
        print(f"resumed from checkpoint step {state.update_step}", flush=True)
    if mesh is not None:
        # The tables are built or restored alike on every rank; compare their sums.
        spmd.assert_replicated([t.sum(dtype=torch.float64) for t in state.params.values()], mesh.group, "tables")
    state = common.place_on_mesh(mesh, state, None, batched=BATCHED)
    step = make_ntuple_step(config, device, mesh)
    cached = net.config.backend == "cached"
    if cached:
        # After a resume the heat is real; on a fresh init every row's heat
        # is 0, so this fronts the lowest rows, and the dense fallback of an
        # overflowing window stays exact until the next refresh.
        state = dataclasses.replace(state, params=net.refresh_cache(state.params))
    history = []
    base = state.update_step
    t0 = time.perf_counter()
    for i in range(num_updates):
        state, metrics = step(state)
        if cached and (i + 1) % config.cache_refresh_every == 0:
            state = dataclasses.replace(state, params=net.refresh_cache(state.params))
        if (i + 1) % log_every == 0 or i + 1 == num_updates:
            m = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            eps = max(m["episodes"], 1.0)
            record = {
                "update": state.update_step,
                "episodes": m["episodes"],
                "avg_episode_score": m["episode_score_sum"] / eps,
                "avg_episode_tile_sum": m["episode_tile_sum_sum"] / eps,
                "avg_episode_length": m["episode_length_sum"] / eps,
                "best_tile": m["best_tile"],
                "td_abs_err": m["td_abs_err"],
                "steps_per_sec": (i + 1) * config.batch_size * config.steps_per_update / dt,
            }
            common.log_and_save(record, logger, checkpointer, base + i + 1, state, mesh, batched=BATCHED)
            history.append(record)
    return state, history


@functools.lru_cache(maxsize=16)
def _get_ntuple_policy(net_config: ntuple_lib.NTupleConfig, depth: int, chance_chunk: int | None = None):
    """``policy_fn(params, boards) -> actions`` for the evaluation sweep.

    depth=0 is the training policy (greedy ``r + V(afterstate)``); depth>=1
    wraps the same value in the expectimax tree of ``control/search.py``,
    where n-tuple values are exact afterstate leaves. ``chance_chunk``
    bounds the leaf batch (the same sum). On the card repeated calls replay
    a CUDA graph of the call (``control/search.Replayed``, keyed on the
    tables' addresses); ``policy_fn.eager`` is the call launched op by op.
    A graph does not see code patched in after its capture:
    ``_get_ntuple_policy.cache_clear()`` drops the cached players.
    """
    net = get_network(net_config)

    def policy_fn(params, boards):
        return search.make_expectimax_policy(
            depth,
            leaf_value=net.make_leaf(params),
            reward_fn=lambda r: r,
            gamma=1.0,
            death_value=0.0,
            chance_chunk=chance_chunk,
        )(boards)

    return search.Replayed(policy_fn)


@torch.no_grad()
def evaluate_ntuple(
    params: Dict[str, torch.Tensor],
    config: NTupleTrainConfig | ntuple_lib.NTupleConfig,
    *,
    depth: int = 0,
    num_envs: int = 512,
    num_steps: int | None = None,
    seed: int = 0,
    protocol: str = "window",
    chance_chunk: int | None = None,
    launch_chunk: int | None = None,
    device=None,
) -> Dict[str, float]:
    """Greedy (or expectimax-boosted) evaluation sweep on ``device``.

    ``protocol="window"`` reports the episodes completed within the sweep;
    ``"first"`` scores exactly ``num_envs`` first episodes. ``num_steps``
    defaults to 16384 for ``"first"`` and 4096 for ``"window"``.
    """
    device = resolve_device(device)
    if num_steps is None:
        num_steps = 16384 if protocol == "first" else 4096
    if isinstance(config, NTupleTrainConfig):
        config = config.network_config(device)
    for k, t in params.items():
        if t.device.type != device.type:
            raise ValueError(f"params[{k!r}] is on {t.device}, the evaluation runs on {device}")
    policy = _get_ntuple_policy(config, depth, chance_chunk)

    def policy_fn(boards):
        return policy(params, boards)

    state = vector.reset_batch(seed, num_envs, device)
    if protocol == "first":
        _, stats = evaluate._first_episode_rollout(
            state, policy_fn=policy_fn, num_steps=num_steps, launch_chunk=launch_chunk
        )
    else:
        _, stats = evaluate._search_rollout(state, policy_fn=policy_fn, num_steps=num_steps)
    return {k: float(v) for k, v in stats.items()}

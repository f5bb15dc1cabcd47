# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Inputs for checking the port's kernels against their plain versions, and
the recipes' learning against the JAX runs' recorded curves.

Nothing on a main path reads this module; the tests and ``chip_smoke.py``
do. It loads without a card and without JAX, and imports the port only
inside the functions that run it.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import importlib
import itertools
import json
import os
import tempfile
import time
from pathlib import Path

import numpy as np

# Positions random play rarely reaches (tile exponents): merges at and
# into the exponent cap, dead boards, a single legal direction, one blank
# left, rows of equal tiles, and the empty and one-tile boards.
EDGE_BASES = (
    ((15, 15, 0, 0), (14, 14, 0, 0), (15, 15, 15, 15), (14, 14, 15, 15)),  # 15+15 -> 15, 14+14 -> 15
    ((15, 14, 14, 15), (15, 0, 15, 0), (14, 0, 14, 15), (13, 13, 14, 14)),
    ((1, 2, 1, 2), (2, 1, 2, 1), (1, 2, 1, 2), (2, 1, 2, 1)),  # dead: resets on the next step
    ((15, 14, 15, 14), (14, 15, 14, 15), (15, 14, 15, 14), (14, 15, 14, 15)),
    ((1, 2, 3, 4), (2, 3, 4, 1), (3, 4, 1, 2), (4, 1, 2, 3)),
    ((3, 5, 7, 9), (11, 13, 15, 1), (2, 4, 6, 8), (10, 12, 14, 3)),
    ((1, 2, 3, 3), (2, 3, 4, 1), (3, 4, 1, 2), (4, 1, 2, 3)),  # full, one equal pair: one axis
    ((1, 2, 3, 0), (2, 3, 1, 0), (3, 1, 2, 0), (1, 2, 3, 0)),  # exactly one legal direction
    ((15, 14, 13, 0), (14, 13, 15, 0), (13, 15, 14, 0), (15, 14, 13, 0)),
    ((1, 2, 1, 2), (2, 0, 2, 1), (1, 2, 1, 2), (2, 1, 2, 1)),  # one blank left
    ((1, 2, 3, 4), (2, 3, 4, 1), (3, 4, 0, 2), (4, 1, 2, 3)),
    ((15, 14, 15, 14), (14, 15, 14, 15), (15, 14, 15, 14), (14, 15, 14, 0)),
    ((2, 2, 2, 2), (8, 8, 8, 0), (0, 8, 8, 8), (2, 0, 2, 2)),  # rows of equal tiles
    ((1, 1, 1, 1), (1, 1, 1, 1), (1, 1, 1, 1), (1, 1, 1, 1)),
    ((0, 0, 0, 0), (0, 0, 0, 0), (0, 0, 0, 0), (0, 0, 0, 0)),  # empty: never moves, never spawns
    ((0, 0, 0, 0), (0, 0, 0, 0), (0, 0, 0, 0), (0, 0, 0, 15)),
)


def edge_boards(n: int, seed: int = 0) -> np.ndarray:
    """``uint8[n, 4, 4]`` boards drawn (from ``seed``) from ``EDGE_BASES``
    in all eight orientations, so that every crafted row is also a column
    and each move meets it from every side."""
    bases = np.asarray(EDGE_BASES, np.uint8)
    turns = [np.rot90(bases, k, axes=(1, 2)) for k in range(4)]
    variants = np.concatenate(turns + [t.transpose(0, 2, 1) for t in turns])
    pick = np.random.default_rng(seed).integers(0, len(variants), n)
    return np.ascontiguousarray(variants[pick])


def capped_evaluations(evaluations, **caps):
    """A recipe's ``evaluations`` (``rein48_tpu_torch.examples``) with each
    call's keywords capped, e.g. ``num_steps=32``: the same calls, each
    keyword at most its cap (a ``None`` stays ``None``)."""

    def capped(*args, **kwargs):
        return [
            (tag, {k: min(v, caps[k]) if k in caps and v is not None else v for k, v in kw.items()})
            for tag, kw in evaluations(*args, **kwargs)
        ]

    return capped


@dataclasses.dataclass(frozen=True)
class LearningCheck:
    """A recipe's learning held to the JAX run's recorded curve.

    ``recipe`` (a module of ``rein48_tpu_torch.examples``) runs
    ``main(argv)``; its ``runs/<tag>/metrics.csv`` (``tag`` the module's
    ``TAG`` unless named) is read in ``column`` and the ``also`` columns at
    the ``checks`` updates, beside ``runs/<jax_run>/metrics.csv``, and each
    of those columns is held to the JAX run's. ``above_random``: ``column``
    (a tile sum) must also beat uniform-random play's. ``same_start``: the
    record's ``config.warm_start`` must be the JAX run's (its
    ``eval.json``'s).
    """

    recipe: str
    argv: tuple
    jax_run: str
    checks: tuple
    column: str = "avg_episode_tile_sum"
    also: tuple = ()
    above_random: bool = False
    tag: str | None = None
    same_start: bool = False


# At each recipe's full width and its JAX run's logging cadence. A record
# holds the metrics of the update it was logged at, in JAX as here: the
# episode columns are means over the episodes that update's acting ended, and
# DQN's ``q_mean`` and ``td_abs`` means over its learn batch (8,192 samples).
LEARNING_CHECKS = {
    # examples/train_ntuple_tpu.py 4000 1024 delayed (BASELINE.md:97-99).
    "ntuple": LearningCheck("train_ntuple", ("40", "1024", "delayed"), "ntuple_tpu", (20, 40), column="avg_episode_score"),
    "ppo": LearningCheck("train_ppo", ("40", "4096"), "ppo_tpu", (20, 40), above_random=True),
    # The fresh-init run, not the recipe's warm-started twin.
    "afterstate": LearningCheck(
        "train_afterstate_td", ("50", "8192", "afterstate_td_fresh_cuda"), "afterstate_td_fresh_tpu", (25, 50),
        above_random=True, tag="afterstate_td_fresh_cuda", same_start=True,
    ),
    "a3c": LearningCheck("train_a3c_flagship", ("50", "8192"), "a3c_flagship_tpu", (50,), above_random=True),
    # After the first wrap of the 2**20-slot buffer (update 128 at 4,096 envs
    # x 2 acting steps). Epsilon is still 0.76 at update 300, so the scores
    # are near random play's; the Q columns tell the targets apart.
    "dqn": LearningCheck("train_dqn", ("300", "4096"), "dqn_tpu", (240, 260, 280, 300), column="q_mean", also=("td_abs",)),
    "dqn_nstep": LearningCheck(
        "train_dqn_nstep", ("300", "4096", "5", "0.997", "1.0"), "dqn_r5_tpu", (240, 260, 280, 300), column="q_mean",
        also=("td_abs",),
    ),
    # Longer runs, made once each on the card, not by chip_smoke.py.
    "dqn_long": LearningCheck("train_dqn", ("1000", "4096"), "dqn_tpu", tuple(range(900, 1001, 20)), above_random=True),
    "dqn_nstep_long": LearningCheck(
        "train_dqn_nstep", ("1600", "4096", "5", "0.997", "1.0"), "dqn_r5_tpu", tuple(range(1500, 1601, 20)),
        above_random=True,
    ),
    "ppo_flagship": LearningCheck("train_ppo_flagship", ("50", "8192"), "ppo_flagship_tpu", (25, 50), above_random=True),
}


def read_curve(path: str | Path) -> dict:
    """The last run of a ``metrics.csv``, as ``{update: {column: float}}``.

    A file may hold several runs one after another. Where ``update`` falls
    to the file's first update or below it, a run started again from
    nothing: only the rows from the last such start are read. A fall to a
    later update is a run resumed from a checkpoint: the rows before it
    stay, and its rows replace those of the updates it repeats.
    """
    with open(path) as f:
        rows = [{k: float(v) for k, v in r.items()} for r in csv.DictReader(f)]
    curve: dict = {}
    for row in rows:
        update = int(row["update"])
        if update <= rows[0]["update"]:
            curve = {}
        curve[update] = row
    return curve


def compare_curves(ours: dict, theirs: dict, column: str, checks, also=()) -> dict:
    """``column`` of two curves (:func:`read_curve`) at the ``checks``
    updates: each side's values and mean, the episodes behind ours, and the
    ratio of the means (ours over theirs); with ``also``, each of those
    columns' values, means and ratio under ``"also"``. Raises if a curve has
    no record at a check update."""
    for name, curve in (("the port's", ours), ("the JAX run's", theirs)):
        missing = [u for u in checks if u not in curve]
        if missing:
            raise KeyError(f"{name} curve has no record at updates {missing} (it has {sorted(curve)})")

    def held(col):
        values, jax_values = [ours[u][col] for u in checks], [theirs[u][col] for u in checks]
        mean, jax_mean = float(np.mean(values)), float(np.mean(jax_values))
        return {"values": values, "mean": mean, "jax_values": jax_values, "jax_mean": jax_mean, "ratio": mean / jax_mean}

    first = held(column)
    out = {
        "values": first["values"], "episodes": [ours[u]["episodes"] for u in checks], "mean": first["mean"],
        "jax_values": first["jax_values"], "jax_mean": first["jax_mean"], "ratio": first["ratio"],
    }
    if also:
        out["also"] = {col: held(col) for col in also}
    return out


def replay_cursor(config, updates: int) -> int:
    """Where ``updates`` DQN updates from an empty buffer leave its cursor,
    in slots: each acting step adds ``num_envs`` transitions at the cursor
    and moves it on modulo the capacity (JAX's ``replay_add``)."""
    return updates * config.acting_steps_per_update * config.num_envs % config.replay_capacity


def saved_replay(config, directory: str | Path, device) -> dict:
    """The last checkpoint in ``directory`` of a DQN run with ``config``,
    restored into a fresh trainer state: its ``update_step``,
    ``env_steps`` and the buffer's ``cursor``, ``size`` and ``capacity``."""
    from rein48_tpu_torch.train.dqn import init_dqn
    from rein48_tpu_torch.utils.checkpoint import Checkpointer

    state, _, _ = init_dqn(config, 0, device)
    state = Checkpointer(str(directory)).restore(state)
    replay = state.replay
    return dict(update_step=state.update_step, env_steps=state.env_steps, cursor=replay.cursor, size=replay.size,
                capacity=replay.capacity)


def jax_record(check: LearningCheck, root: str | Path) -> dict:
    """The JAX run's ``eval.json``."""
    with open(Path(root) / "runs" / check.jax_run / "eval.json") as f:
        return json.load(f)


def learning_curve(check: LearningCheck, root: str | Path, device, *, configure=None, workdir=None, **caps) -> dict:
    """Run ``check``'s recipe for its updates and compare its curve with the
    JAX run's (:func:`compare_curves`).

    The recipe's ``make_config`` is replaced for the run: the config is built
    at the JAX run's horizon (its ``eval.json``'s ``updates``, where it says),
    so that a schedule decays as it did there although only ``argv``'s
    updates are trained, then passed through ``configure`` (e.g. another
    table backend). Its evaluations are capped by ``caps``
    (:func:`capped_evaluations`). It runs in ``workdir``, a fresh temporary
    directory by default, so that no checkpoint is resumed and no donor
    warm-starts it. Also returns ``config`` (as built, before ``configure``),
    ``horizon``, ``record`` (what ``main`` returned), both curves (``curve``,
    ``jax_curve``), ``wall_s`` (``main``, to a fence on a card) and
    ``train_s`` (the logger's clock at the last check update: init and
    warm-up included). A DQN recipe's run also returns ``replay``, the
    checkpoint it saved at its end as :func:`saved_replay` restores it,
    with ``expected_cursor`` (:func:`replay_cursor`)."""
    import torch

    from rein48_tpu_torch.train.dqn import DQNConfig

    recipe = importlib.import_module(f"rein48_tpu_torch.examples.{check.recipe}")
    reference = jax_record(check, root)
    horizon = reference.get("updates")
    make_config, evaluations = recipe.make_config, recipe.evaluations
    built, configured = [], []

    def pinned(num_updates, *args):
        config = make_config(num_updates if horizon is None else horizon, *args)
        built.append(config)
        configured.append(config if configure is None else configure(config))
        return configured[-1]

    recipe.make_config = pinned
    recipe.evaluations = capped_evaluations(evaluations, **caps)
    device = torch.device(device)
    try:
        with contextlib.ExitStack() as stack:
            work = workdir or stack.enter_context(tempfile.TemporaryDirectory())
            stack.enter_context(contextlib.chdir(work))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            record = recipe.main(list(check.argv), device=device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
            ours = read_curve(os.path.join("runs", check.tag or recipe.TAG, "metrics.csv"))
            extra = {}
            if isinstance(configured[0], DQNConfig):
                ckpt = os.path.join("ckpt", getattr(recipe, "CKPT", check.tag or recipe.TAG))
                updates = int(check.argv[0])
                extra["replay"] = dict(saved_replay(configured[0], ckpt, device),
                                       expected_cursor=replay_cursor(configured[0], updates))
    finally:
        recipe.make_config, recipe.evaluations = make_config, evaluations
    if check.same_start:
        start, jax_start = record["config"]["warm_start"], reference["config"]["warm_start"]
        if start != jax_start:
            raise AssertionError(f"{check.recipe} started from {start!r}, the JAX run from {jax_start!r}")
    theirs = read_curve(Path(root) / "runs" / check.jax_run / "metrics.csv")
    return dict(
        compare_curves(ours, theirs, check.column, check.checks, check.also), config=built[0], horizon=horizon,
        record=record, curve=ours, jax_curve=theirs, wall_s=wall, train_s=ours[max(check.checks)]["wall_time"], **extra,
    )


def random_play(device, num_envs: int = 8192, seed: int = 0, max_steps: int = 4096) -> dict:
    """First-episode stats (``evaluate_search``'s) of uniform-random play over
    the legal moves (``control.random_legal_policy``) on the port's plain
    engine: ``num_envs`` episodes, each played to its end."""
    import torch

    from rein48_tpu_torch.control import random_legal_policy
    from rein48_tpu_torch.engine import vector
    from rein48_tpu_torch.train import evaluate

    steps = itertools.count()

    def policy(boards):
        return random_legal_policy(seed, next(steps), boards)

    with torch.inference_mode():
        _, stats = evaluate._first_episode_rollout(
            vector.reset_batch(seed, num_envs, device), policy_fn=policy, num_steps=max_steps, launch_chunk=64,
            on_chunk=lambda done, so_far: so_far["unfinished"] == 0,
        )
    stats = {k: float(v) for k, v in stats.items()}
    if stats["unfinished"]:
        raise AssertionError(f"random play left {stats['unfinished']:.0f} of {num_envs} episodes unfinished in {max_steps} steps")
    return stats

# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""The learning checks of ``rein48_tpu_torch.testing`` (``learning_curve``,
``compare_curves``, ``random_play``), which ``chip_smoke.py`` runs at full
width on the card.

On the CPU every check runs its recipe's ``main`` tiny (the config shrunk
by ``configure`` after the check has built it): the config is built at the
JAX run's horizon, both curves have a record at every check update, the
ratio is the one the curves give, and the recipe's ``make_config`` is back
afterwards. The ratio is checked on hand-written CSVs; a warm-started
afterstate run is refused.
"""

from __future__ import annotations

import dataclasses
import importlib
from pathlib import Path

import pytest
import torch

from rein48_tpu_torch import testing
from rein48_tpu_torch.train.afterstate import init_afterstate_td
from rein48_tpu_torch.utils.checkpoint import Checkpointer

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SMALL = (("channels", 8), ("num_blocks", 1), ("dtype", torch.float32))
# Tiny widths through the check's configure; the batch and unroll of the
# deep trainers, and the n-tuple trainer's tables.
TINY = {
    "ntuple": dict(tuples=((0, 1, 2, 3), (4, 5, 6, 7)), batch_size=8, steps_per_update=4),
    "ppo": dict(batch_size=8, unroll_len=4, model_kwargs=SMALL),
    "afterstate": dict(batch_size=8, unroll_len=4, model_kwargs=SMALL),
    "a3c": dict(batch_size=8, unroll_len=4, model_kwargs=SMALL),
}
CAPS = dict(num_envs=4, num_steps=8)


def shrink(name):
    return lambda config: dataclasses.replace(config, **TINY[name])


def recipe(name):
    return importlib.import_module(f"rein48_tpu_torch.examples.{testing.LEARNING_CHECKS[name].recipe}")


@pytest.mark.parametrize("name", sorted(testing.LEARNING_CHECKS))
def test_check_updates_are_in_the_jax_curve(name):
    """Each check update is a record of the JAX run's curve, at most the
    updates the check trains, and the JAX run trained at least that many."""
    check = testing.LEARNING_CHECKS[name]
    curve = testing.read_curve(REPO / "runs" / check.jax_run / "metrics.csv")
    assert set(check.checks) <= set(curve) and max(check.checks) <= int(check.argv[0])
    assert all(check.column in curve[u] and curve[u]["episodes"] > 0 for u in check.checks)


@pytest.fixture(scope="module")
def tiny_runs(tmp_path_factory):
    """Every check run tiny on the CPU, each in its own directory."""
    runs = {}
    for name, check in testing.LEARNING_CHECKS.items():
        work = tmp_path_factory.mktemp(name)
        runs[name] = (work, testing.learning_curve(check, REPO, "cpu", configure=shrink(name), workdir=work, **CAPS))
    return runs


@pytest.mark.parametrize("name", sorted(testing.LEARNING_CHECKS))
def test_check_runs_its_recipe(tiny_runs, name):
    """The port's curve has a record at every check update, the result is
    what the two curves give, and the recipe's functions are restored."""
    check = testing.LEARNING_CHECKS[name]
    work, result = tiny_runs[name]
    tag = check.tag or recipe(name).TAG
    ours = testing.read_curve(work / "runs" / tag / "metrics.csv")
    theirs = testing.read_curve(REPO / "runs" / check.jax_run / "metrics.csv")
    assert result["curve"] == ours and result["jax_curve"] == theirs
    assert {k: result[k] for k in ("values", "episodes", "mean", "jax_values", "jax_mean", "ratio")} == testing.compare_curves(
        ours, theirs, check.column, check.checks
    )
    assert result["train_s"] == ours[max(check.checks)]["wall_time"] and result["wall_s"] > 0
    module = recipe(name)
    assert module.make_config.__module__ == module.__name__ and module.evaluations.__module__ == module.__name__


def test_configs_are_built_at_the_jax_horizon(tiny_runs):
    """A3C and the afterstate trainer decay their schedules over the JAX
    run's updates, not over the 50 the check trains; PPO and the n-tuple
    trainer have no horizon in their configs, and the n-tuple record states
    none."""
    a3c, afterstate, ppo, ntuple = (recipe(n) for n in ("a3c", "afterstate", "ppo", "ntuple"))
    assert tiny_runs["a3c"][1]["config"] == a3c.make_config(12000, 8192) != a3c.make_config(50, 8192)
    assert tiny_runs["afterstate"][1]["config"] == afterstate.make_config(4000, 8192) != afterstate.make_config(50, 8192)
    assert tiny_runs["ppo"][1]["config"] == ppo.make_config(1200, 4096) == ppo.make_config(40, 4096)
    assert tiny_runs["ntuple"][1]["config"] == ntuple.make_config(40, 1024, "delayed")
    assert [tiny_runs[n][1]["horizon"] for n in ("a3c", "afterstate", "ppo", "ntuple")] == [12000, 4000, 1200, None]
    for name in ("a3c", "afterstate", "ppo"):
        check = testing.LEARNING_CHECKS[name]
        assert tiny_runs[name][1]["horizon"] == testing.jax_record(check, REPO)["updates"]


def test_afterstate_check_starts_as_the_jax_run(tiny_runs):
    """The JAX run it is held to trained from the fresh init, and so does the check."""
    start = testing.jax_record(testing.LEARNING_CHECKS["afterstate"], REPO)["config"]["warm_start"]
    assert tiny_runs["afterstate"][1]["record"]["config"]["warm_start"] == start == "none (fresh init)"


def test_afterstate_check_refuses_a_warm_start(tmp_path):
    """With the afterstate PPO's checkpoint in its directory the recipe
    warm-starts from its critic, and the check refuses the run: the JAX run
    it is held to trained from the fresh init."""
    config = TINY["afterstate"]
    state, _, _ = init_afterstate_td(dataclasses.replace(recipe("afterstate").make_config(1, 8), **config), 0, "cpu")

    @dataclasses.dataclass
    class Donor:
        after_model: torch.nn.Module

    Checkpointer(str(tmp_path / "ckpt" / recipe("afterstate").DONOR)).save(1, Donor(state.model))
    check = dataclasses.replace(testing.LEARNING_CHECKS["afterstate"], argv=("25", "8", "afterstate_td_fresh_cuda"), checks=(25,))
    with pytest.raises(AssertionError, match="started from 'ckpt/ppo_afterstate_cuda after_model', the JAX run from 'none"):
        testing.learning_curve(check, REPO, "cpu", configure=shrink("afterstate"), workdir=tmp_path, **CAPS)


def _csv(path: Path, rows) -> Path:
    path.write_text("update,episodes,avg_episode_tile_sum,wall_time\n" + "".join(f"{','.join(map(str, r))}\n" for r in rows))
    return path


def test_compare_curves_on_written_csvs(tmp_path):
    ours = testing.read_curve(_csv(tmp_path / "ours.csv", [(20, 10, 300.0, 5.0), (40, 4, 600.0, 9.5), (60, 3, 900.0, 14.0)]))
    theirs = testing.read_curve(_csv(tmp_path / "theirs.csv", [(20, 7, 400.0, 1.0), (40, 5, 800.0, 2.0)]))
    got = testing.compare_curves(ours, theirs, "avg_episode_tile_sum", (20, 40))
    assert got == {
        "values": [300.0, 600.0], "episodes": [10.0, 4.0], "mean": 450.0,
        "jax_values": [400.0, 800.0], "jax_mean": 600.0, "ratio": 0.75,
    }
    assert testing.compare_curves(ours, theirs, "avg_episode_tile_sum", (40,))["ratio"] == 0.75
    with pytest.raises(KeyError, match=r"the JAX run's curve has no record at updates \[60\]"):
        testing.compare_curves(ours, theirs, "avg_episode_tile_sum", (20, 60))
    with pytest.raises(KeyError, match=r"the port's curve has no record at updates \[80\]"):
        testing.compare_curves(ours, theirs, "avg_episode_tile_sum", (80,))


def test_random_play(monkeypatch):
    """Every episode played to its end, every move legal where one is, the
    same stats again from the same seed, and other stats from another."""
    from rein48_tpu_torch import control
    from rein48_tpu_torch.engine import core

    policy, illegal = control.random_legal_policy, []

    def checked(seed, step, boards):
        actions = policy(seed, step, boards)
        legal = core.legal_action_mask(boards)
        illegal.append(int((legal.any(-1) & ~legal.gather(-1, actions[:, None])[:, 0]).sum()))
        return actions

    monkeypatch.setattr(control, "random_legal_policy", checked)
    stats = testing.random_play("cpu", num_envs=64, seed=3)
    assert len(illegal) > 10 and not any(illegal)
    assert stats["episodes"] == 64 and stats["unfinished"] == 0
    assert 16 < stats["avg_tile_sum"] < 1024 and stats["avg_length"] > 10
    assert testing.random_play("cpu", num_envs=64, seed=3) == stats != testing.random_play("cpu", num_envs=64, seed=4)
    with pytest.raises(AssertionError, match="unfinished"):
        testing.random_play("cpu", num_envs=8, seed=3, max_steps=16)

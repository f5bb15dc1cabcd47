# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""The learning checks of ``rein48_tpu_torch.testing`` (``learning_curve``,
``compare_curves``, ``random_play``), which ``chip_smoke.py`` runs at full
width on the card.

On the CPU every check runs its recipe's ``main`` tiny (the config shrunk
by ``configure`` after the check has built it; the long checks also cut
to 60 updates): the config is built at the JAX run's horizon, both curves
have a record at every check update, the ratios are the ones the curves
give, and the recipe's ``make_config`` is back afterwards. The DQN checks
wrap a 28-slot buffer many times over, and the checkpoint their recipe
saves restores with the cursor JAX's ``replay_add`` leaves after as many
adds. The ratios are checked on hand-written CSVs, ``read_curve`` on the
JAX records of two runs and of a resumed run; a warm-started afterstate
run is refused.
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
    "ppo_flagship": dict(batch_size=8, unroll_len=4, model_kwargs=SMALL),
    # 2 x 4 transitions an update into 28 slots: the buffer wraps at update 4
    # and the n-step chains (5 x 4 slots) read across the wrap.
    "dqn": dict(num_envs=4, replay_capacity=28, learn_batch_size=8, min_replay_before_learn=16, model_kwargs=SMALL),
}
TINY.update(dqn_nstep=TINY["dqn"], dqn_long=TINY["dqn"], dqn_nstep_long=TINY["dqn"])
# The long checks cut to 60 updates on the CPU (updates of the JAX curves).
SHORT = {
    "dqn_long": dict(argv=("60", "4096"), checks=(40, 60)),
    "dqn_nstep_long": dict(argv=("60", "4096", "5", "0.997", "1.0"), checks=(40, 60)),
}
CAPS = dict(num_envs=4, num_steps=8)


def shrink(name):
    return lambda config: dataclasses.replace(config, **TINY[name])


def tiny_check(name):
    return dataclasses.replace(testing.LEARNING_CHECKS[name], **SHORT.get(name, {}))


def recipe(name):
    return importlib.import_module(f"rein48_tpu_torch.examples.{testing.LEARNING_CHECKS[name].recipe}")


@pytest.mark.parametrize("name", sorted(testing.LEARNING_CHECKS))
def test_check_updates_are_in_the_jax_curve(name):
    """Each check update is a record of the JAX run's curve, at most the
    updates the check trains, and the JAX run trained at least that many."""
    for check in (testing.LEARNING_CHECKS[name], tiny_check(name)):
        curve = testing.read_curve(REPO / "runs" / check.jax_run / "metrics.csv")
        assert set(check.checks) <= set(curve) and max(check.checks) <= int(check.argv[0])
        assert all(c in curve[u] for c in (check.column, *check.also) for u in check.checks)
        assert all(curve[u]["episodes"] > 0 for u in check.checks)


@pytest.fixture(scope="module")
def tiny_runs(tmp_path_factory):
    """Every check run tiny on the CPU, each in its own directory."""
    runs = {}
    for name in testing.LEARNING_CHECKS:
        work = tmp_path_factory.mktemp(name)
        runs[name] = (work, testing.learning_curve(tiny_check(name), REPO, "cpu", configure=shrink(name), workdir=work, **CAPS))
    return runs


@pytest.mark.parametrize("name", sorted(testing.LEARNING_CHECKS))
def test_check_runs_its_recipe(tiny_runs, name):
    """The port's curve has a record at every check update, the result is
    what the two curves give, and the recipe's functions are restored."""
    check = tiny_check(name)
    work, result = tiny_runs[name]
    tag = check.tag or recipe(name).TAG
    ours = testing.read_curve(work / "runs" / tag / "metrics.csv")
    theirs = testing.read_curve(REPO / "runs" / check.jax_run / "metrics.csv")
    assert result["curve"] == ours and result["jax_curve"] == theirs
    keys = ("values", "episodes", "mean", "jax_values", "jax_mean", "ratio") + (("also",) if check.also else ())
    assert {k: result[k] for k in keys} == testing.compare_curves(ours, theirs, check.column, check.checks, check.also)
    assert ("replay" in result) == name.startswith("dqn")
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


def test_replay_and_flagship_configs_are_built_at_the_jax_horizon(tiny_runs):
    """DQN's schedules run over env steps, so its configs are the recipes'
    at any horizon, and the checks read 12,000 updates from each JAX run's
    record (the n-step check from ``dqn_r5_tpu``'s, not from the records its
    recipe's keys are held to); the PPO flagship decays over 8,000."""
    dqn, nstep, flagship = recipe("dqn"), recipe("dqn_nstep"), recipe("ppo_flagship")
    for name in ("dqn", "dqn_long"):
        assert tiny_runs[name][1]["config"] == dqn.make_config(12000, 4096) == dqn.make_config(300, 4096)
    for name in ("dqn_nstep", "dqn_nstep_long"):
        assert tiny_runs[name][1]["config"] == nstep.make_config(12000, 4096, 5, 0.997, 1.0)
    assert tiny_runs["ppo_flagship"][1]["config"] == flagship.make_config(8000, 8192) != flagship.make_config(50, 8192)
    horizons = {n: tiny_runs[n][1]["horizon"] for n in ("dqn", "dqn_nstep", "dqn_long", "dqn_nstep_long", "ppo_flagship")}
    assert horizons == dict(dqn=12000, dqn_nstep=12000, dqn_long=12000, dqn_nstep_long=12000, ppo_flagship=8000)
    assert testing.LEARNING_CHECKS["dqn_nstep"].jax_run == "dqn_r5_tpu"


@pytest.mark.parametrize("name", ["dqn", "dqn_nstep", "dqn_long", "dqn_nstep_long"])
def test_replay_cursor_after_the_wrap(tiny_runs, name):
    """The checkpoint the recipe saves at its end restores a full buffer
    whose cursor is where JAX's ``replay_add`` leaves it after the same adds
    (two of 4 transitions per update into 28 slots), and where
    ``testing.replay_cursor`` puts it."""
    import jax
    import jax.numpy as jnp

    from rein48_tpu.agents import replay as jax_replay

    updates = int(tiny_check(name).argv[0])
    config = dataclasses.replace(tiny_runs[name][1]["config"], **TINY[name])
    example = {"board": jnp.zeros((4, 4), jnp.uint8), "done": jnp.zeros((), bool)}
    add = jax.jit(jax_replay.replay_add)
    buf, batch = jax_replay.replay_init(example, 28), {"board": jnp.ones((4, 4, 4), jnp.uint8), "done": jnp.ones(4, bool)}
    for _ in range(updates * config.acting_steps_per_update):
        buf = add(buf, batch)
    saved = tiny_runs[name][1]["replay"]
    assert saved == dict(
        update_step=updates, env_steps=updates * 2 * 4, cursor=int(buf.cursor), size=int(buf.size), capacity=28,
        expected_cursor=testing.replay_cursor(config, updates),
    )
    assert saved["cursor"] == saved["expected_cursor"] and saved["size"] == 28


def test_replay_cursor_at_full_width():
    """What ``chip_smoke.py`` expects of the DQN checks' 300 updates at 4,096
    envs x 2 acting steps: the 2**20-slot buffer full from update 128, so
    before the first check at 240, and the cursor at 300 x 8,192 mod 2**20."""
    for name in ("dqn", "dqn_nstep"):
        check = testing.LEARNING_CHECKS[name]
        config = recipe(name).make_config(12000, *recipe(name).parse(check.argv)[1:5])
        assert config.replay_capacity == 2**20 and config.num_envs * config.acting_steps_per_update == 8192
        assert testing.replay_cursor(config, 300) == 360448 and testing.replay_cursor(config, 128) == 0
        assert 240 * 8192 >= 2**20 > 127 * 8192


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


def test_compare_curves_holds_two_columns(tmp_path):
    header = "update,episodes,q_mean,td_abs,wall_time\n"
    ours, theirs = tmp_path / "ours.csv", tmp_path / "theirs.csv"
    ours.write_text(header + "20,3,4.0,1.0,1.0\n40,5,6.0,1.5,2.0\n")
    theirs.write_text(header + "20,4,5.0,2.0,1.0\n40,6,5.0,1.0,2.0\n")
    got = testing.compare_curves(testing.read_curve(ours), testing.read_curve(theirs), "q_mean", (20, 40), also=("td_abs",))
    assert got == {
        "values": [4.0, 6.0], "episodes": [3.0, 5.0], "mean": 5.0, "jax_values": [5.0, 5.0], "jax_mean": 5.0, "ratio": 1.0,
        "also": {"td_abs": {"values": [1.0, 1.5], "mean": 1.25, "jax_values": [2.0, 1.0], "jax_mean": 1.5, "ratio": 1.25 / 1.5}},
    }


def test_read_curve_keeps_the_last_run(tmp_path):
    """Two runs in one file: only the second; a run resumed from a
    checkpoint: the rows before its resume point stay, its own replace the
    ones it repeats."""
    runs = _csv(tmp_path / "runs.csv", [(20, 1, 1.0, 1.0), (40, 1, 2.0, 2.0), (60, 1, 3.0, 3.0), (20, 1, 7.0, 1.0), (40, 1, 8.0, 2.0)])
    assert {u: r["avg_episode_tile_sum"] for u, r in testing.read_curve(runs).items()} == {20: 7.0, 40: 8.0}
    resumed = _csv(tmp_path / "resumed.csv", [(20, 1, 1.0, 1.0), (40, 1, 2.0, 2.0), (60, 1, 3.0, 3.0), (40, 1, 5.0, 1.0), (60, 1, 6.0, 2.0)])
    assert {u: r["avg_episode_tile_sum"] for u, r in testing.read_curve(resumed).items()} == {20: 1.0, 40: 5.0, 60: 6.0}


def test_read_curve_on_the_jax_records():
    """``runs/dqn_tpu/metrics.csv`` holds an earlier run of 16,384
    transitions an update (rows 2-151) before the run its ``eval.json``
    records (4,096 envs x 2): only that one is read. The fresh afterstate
    run was resumed at update 1,000 and keeps its first updates."""
    curve = testing.read_curve(REPO / "runs" / "dqn_tpu" / "metrics.csv")
    assert curve[20]["replay_size"] == 163840 and round(curve[20]["epsilon"], 5) == 0.98411
    assert sorted(curve) == list(range(20, 12001, 20))
    assert all(r["replay_size"] == min(u * 8192, 2**20) for u, r in curve.items())
    afterstate = testing.read_curve(REPO / "runs" / "afterstate_td_fresh_tpu" / "metrics.csv")
    assert sorted(afterstate) == list(range(25, 4001, 25))
    assert round(afterstate[25]["avg_episode_tile_sum"], 4) == 568.4586 and afterstate[1025]["wall_time"] == 260.403


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

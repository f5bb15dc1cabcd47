# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Data- and tensor-parallel training of the port in real process groups.

Ranks are spawned processes joined over gloo on the CPU (``tests/
torch_dist_ranks.py``, which imports no JAX); the cases of a group of
families run in one spawn, and each is held against the same case run in
this process without a mesh, as JAX's sharded updates are held against the
single-device ones (``tests/test_parallel.py``):

* boards, actions (or the chosen afterstates) and the replay buffer bit for
  bit;
* losses and metrics at rtol 1e-5;
* parameters at atol 1e-5, rtol 1e-4 (JAX's own tolerances), or, for Adam,
  within 2 x lr per update per entry where a near-zero gradient's sign can
  round apart (the bound of ``tests/test_torch_afterstate.py``);
* n-tuple tables bit for bit (the plain scatters add in order on the CPU);
* every replicated tensor and metric bit for bit across the ranks.
"""

from __future__ import annotations

import ast
import csv
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from rein48_tpu.agents import a3c as ja3c
from rein48_tpu.engine import core as jcore
from rein48_tpu.train import a3c as ja3c_train
from rein48_tpu.train import common as jcommon
from rein48_tpu_torch.models import convert
from rein48_tpu_torch.utils.checkpoint import Checkpointer

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


def a3c_grad_inputs():
    """JAX's A3C MLP parameters and a fixed batch of T=3 steps of 16 boards."""
    rng = np.random.default_rng(7)
    jcfg = ja3c_train.A3CConfig(batch_size=16, unroll_len=3, model="mlp")
    jmodel = jcfg.make_model()
    jparams = jmodel.init(jax.random.key(5), jnp.zeros((1, 4, 4, 16)))["params"]
    boards = rng.integers(0, 11, size=(3, 16, 4, 4), dtype=np.uint8)
    legal = np.asarray(jcore.legal_action_mask(jnp.asarray(boards)))
    actions = np.argmax(legal * rng.random(legal.shape), -1).astype(np.int64)
    targets = rng.normal(size=(3, 16)).astype(np.float32)
    batch = {"boards": boards, "legal_mask": legal, "actions": actions, "targets": targets}
    return jcfg, jmodel, jparams, batch


def jax_a3c_grads(jcfg, jmodel, jparams, batch):
    """``jax.grad`` of JAX's A3C loss on the whole batch (``train/a3c.py:239-252``)."""
    loss_cfg = ja3c.A3CLossConfig(
        gamma=jcfg.gamma, entropy_beta=jcfg.entropy_beta, value_coef=jcfg.value_coef,
        normalize_advantage=jcfg.normalize_advantage, parity_drop_last_reward=jcfg.parity_drop_last_reward,
    )
    T, B = batch["targets"].shape

    def loss_fn(params):
        flat = jnp.asarray(batch["boards"]).reshape(T * B, 4, 4)
        logits, values = jmodel.apply({"params": params}, jcommon.encode_obs(flat, jcfg.obs_encoding), train=False)
        logits = ja3c.masked_logits(logits.reshape(T, B, 4), jnp.asarray(batch["legal_mask"]))
        return ja3c.a3c_loss(
            logits, values.reshape(T, B), jnp.asarray(batch["actions"], jnp.int32), jnp.asarray(batch["targets"]), loss_cfg
        )

    (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(jparams)
    return float(loss), convert.mlp_params_from_flax(jax.tree.map(np.asarray, grads))


@pytest.fixture(scope="module")
def actor_critic(tmp_path_factory):
    """A3C, its gradient against JAX's, PPO with the critic and the afterstate
    trainer, in one spawn of two ranks."""
    jcfg, jmodel, jparams, batch = a3c_grad_inputs()
    params = {k: v.numpy() for k, v in convert.mlp_params_from_flax(jax.tree.map(np.asarray, jparams)).items()}
    jobs = {
        "a3c_update": ("a3c_update", ranks.A3C_CFG),
        "a3c_grads": ("a3c_grads", (params, batch)),
        "ppo_update": ("ppo_update", ranks.PPO_CFG),
        "afterstate_update": ("afterstate_update", ranks.AFTERSTATE_CFG),
        "replicated": ("replicated", None),
    }
    return ranks.spawn(tmp_path_factory.mktemp("ac"), jobs), (jcfg, jmodel, jparams, batch, params)


class TestActorCritic:
    def test_a3c_update_equals_one_process(self, actor_critic):
        results, _ = actor_critic
        ref = ranks.a3c_update(None)
        ranks.check_family([r["a3c_update"] for r in results], ref, chosen_dim=1)

    def test_a3c_gradient_equals_jax_full_batch(self, actor_critic):
        results, (jcfg, jmodel, jparams, batch, params) = actor_critic
        loss, want = jax_a3c_grads(jcfg, jmodel, jparams, batch)
        got = [r["a3c_grads"] for r in results]
        ranks.assert_replicated(got, "grads")
        for k in want:
            np.testing.assert_allclose(got[0]["grads"][k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-7, err_msg=k)
        # Each rank's loss is the mean over its half: their mean is the batch's.
        np.testing.assert_allclose(np.mean([g["loss"] for g in got]), loss, rtol=1e-5)

    def test_ppo_update_equals_one_process(self, actor_critic):
        results, _ = actor_critic
        ref = ranks.ppo_update(None)
        ranks.check_family([r["ppo_update"] for r in results], ref, chosen_dim=1)

    def test_afterstate_update_equals_one_process(self, actor_critic):
        results, _ = actor_critic
        ref = ranks.afterstate_update(None)
        ranks.check_family([r["afterstate_update"] for r in results], ref, chosen_dim=1)

    def test_replicated_check(self, actor_critic):
        results, _ = actor_critic
        # Rank 0's tensor is the reference: only rank 1's differs.
        assert [r["replicated"]["raised"] for r in results] == [False, True]


@pytest.fixture(scope="module")
def ntuple_runs(tmp_path_factory):
    jobs = {name: ("ntuple_update", name) for name in ranks.NTUPLE_CASES}
    return ranks.spawn(tmp_path_factory.mktemp("nt"), jobs)


@pytest.mark.parametrize("name", list(ranks.NTUPLE_CASES))
def test_ntuple_update_equals_one_process(ntuple_runs, name):
    """Every backend and update mode: the ranks gather each window's backups
    in the global order and apply them as one process does, so on the CPU,
    where the plain scatters add in order, the tables are the same bits
    (tighter than the 1e-6 + 1e-5 x S of reassociated sums)."""
    results = [r[name] for r in ntuple_runs]
    ref = ranks.ntuple_update(None, name)
    ranks.assert_replicated(results, "metrics", "tables")
    assert torch.equal(ranks.global_env(results, "chosen"), ref["chosen"])
    assert torch.equal(ranks.global_env(results), ref["boards"])
    ranks.assert_metrics_close(results[0]["metrics"], ref["metrics"])
    for k, v in ref["tables"].items():
        assert torch.equal(results[0]["tables"][k], v), k


@pytest.fixture(scope="module")
def dqn_runs(tmp_path_factory):
    """1-step and n-step updates, and checkpoints across world sizes: a
    one-process run saved at update 2 resumed by the ranks, and the ranks'
    run saved at update 2 resumed here."""
    tmp = tmp_path_factory.mktemp("dqn")
    one = ranks.dqn_resume(None, str(tmp / "one"))
    jobs = {
        "1-step": ("dqn_update", 1),
        "3-step": ("dqn_update", 3),
        "from-ranks": ("dqn_resume", str(tmp / "ranks")),
        "from-one": ("dqn_resume", str(tmp / "one")),
    }
    return ranks.spawn(tmp, jobs), one, tmp


@pytest.mark.parametrize("n_step", [1, 3])
def test_dqn_update_equals_one_process(dqn_runs, n_step):
    results = [r[f"{n_step}-step"] for r in dqn_runs[0]]
    ref = ranks.dqn_update(None, n_step)
    ranks.assert_replicated(results, "metrics", "params", "replay")
    assert torch.equal(ranks.global_env(results), ref["boards"])
    data, cursor, size = results[0]["replay"]
    want, wcursor, wsize = ref["replay"]
    assert (cursor, size) == (wcursor, wsize) == (64, 64)
    for k in want:
        assert torch.equal(data[k], want[k]), k
    ranks.assert_metrics_close(results[0]["metrics"], ref["metrics"])
    for got, want in zip(results[0]["params"], ref["params"], strict=True):
        ranks.assert_params_close(got, want)


def test_dqn_checkpoints_cross_world_sizes(dqn_runs):
    results, one, tmp = dqn_runs
    assert sorted(os.listdir(tmp / "ranks")) == ["2", "train_config.json"]
    # Two ranks' checkpoint, resumed in one process: the ranks' next update.
    ranks_run = [r["from-ranks"] for r in results]
    ranks.assert_replicated(ranks_run, "history", "params")
    resumed = ranks.dqn_resume(None, str(tmp / "ranks"))
    assert [r["update"] for r in resumed["history"]] == [3]
    ranks.assert_metrics_close(resumed["history"], ranks_run[0]["history"][2:])
    ranks.assert_params_close(resumed["params"], ranks_run[0]["params"])
    assert torch.equal(resumed["boards"], ranks.global_env(ranks_run))
    # One process's checkpoint, resumed by two ranks: the process's next update.
    from_one = [r["from-one"] for r in results]
    assert [r["update"] for r in from_one[0]["history"]] == [3]
    ranks.assert_metrics_close(from_one[0]["history"], one["history"][2:])
    ranks.assert_params_close(from_one[0]["params"], one["params"])
    assert torch.equal(ranks.global_env(from_one), one["boards"])
    # Only rank 0 wrote, and the step holds the global state.
    saved = Checkpointer(str(tmp / "ranks")).restore_field("replay")
    assert saved["data"]["board"].shape[0] == ranks.DQN_CFG.replay_capacity and saved["cursor"] == 32


def test_tensor_parallel_a3c_equals_one_process(tmp_path):
    """dp=2 x tp=2: the MLP's dense weights, and the tiny ResNet's
    convolutions, split over tp, the env batch over dp."""
    jobs = {"a3c": ("a3c_update", ranks.A3C_CFG), "afterstate": ("afterstate_update", ranks.AFTERSTATE_CFG)}
    results = ranks.spawn(tmp_path, jobs, world=4, tp=2)
    for name, case in (("a3c", ranks.a3c_update), ("afterstate", ranks.afterstate_update)):
        # Ranks 0 and 2 hold the two dp halves; each tp pair holds the same.
        ranks.check_family([r[name] for r in results[::2]], case(None), chosen_dim=1)
        ranks.assert_replicated([r[name] for r in results], "metrics", "params")


def test_train_mesh_under_torchrun(tmp_path):
    """``train --mesh`` under two ranks: equal records, and only rank 0 logs
    and checkpoints."""
    argv = ["train", "--algo", "a3c", "--model", "mlp", "--batch-size", "16", "--unroll", "3", "--updates", "2",
            "--log-every", "1", "--mesh", "--device", "cpu", "--checkpoint-dir", str(tmp_path / "ck"),
            "--checkpoint-every", "2", "--log-dir", str(tmp_path / "log")]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2", "-m", "rein48_tpu_torch", *argv],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    finals = [ast.literal_eval(line[len("final: "):]) for line in proc.stderr.splitlines() if line.startswith("final: ")]
    assert len(finals) == 2 and "mesh: Mesh(dp=2, tp=1" in proc.stderr and "backend gloo" in proc.stderr
    for f in finals:
        f.pop("steps_per_sec")
    assert finals[0] == finals[1]
    rows = list(csv.DictReader(open(tmp_path / "log" / "metrics.csv")))
    assert [int(r["update"]) for r in rows] == [1, 2]
    assert sorted(os.listdir(tmp_path / "ck")) == ["2", "train_config.json"]
    ref = ranks.a3c_update(None)["metrics"][1]
    np.testing.assert_allclose(finals[0]["loss"], ref["loss"], rtol=1e-5)

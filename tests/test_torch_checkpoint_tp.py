# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Checkpoints of tensor-parallel training: saved whole, resumed on any mesh.

Every trainer that takes a mesh runs in gloo ranks on the CPU (``tests/
torch_dist_ranks.py``) at dp=1 x tp=2 and at dp=2 x tp=2, checkpointing
every 2 updates, and in this process without a mesh:

* a run saved at update 2 and resumed for 2 more in a fresh group of ranks
  writes the same update-4 checkpoint as the uninterrupted run, bit for bit
  (params, moments, env, replay buffer), with the same records;
* a checkpoint of the ranks restores in one process into the whole params
  and moments the ranks gathered, bit for bit, and the next updates stay
  within the tolerances of ``tests/test_torch_distributed.py`` (atol 1e-5,
  rtol 1e-4 for params and moments, rtol 1e-5 for metrics), boards equal;
* a one-process checkpoint restores in the ranks likewise;
* a checkpoint of the ranks has the keys, shapes and dtypes of one written
  in one process (tp=1) by the same trainer.

Beside them, JAX's own round trip: its A3C trainer at dp=1 x tp=2 saves
through orbax and restores into a one-device state, equal to the global
arrays it saved.
"""

from __future__ import annotations

import concurrent.futures
import shutil

import jax
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from rein48_tpu.parallel import mesh as jmesh
from rein48_tpu.train import a3c as ja3c
from rein48_tpu.utils.checkpoint import Checkpointer as JaxCheckpointer
from rein48_tpu_torch.train import a3c

torch.set_num_threads(1)

NAMES = list(ranks.TRAINERS)
MESHES = {"dp1xtp2": 2, "dp2xtp2": 4}  # name -> world, all at tp=2
# The fields a learner's checkpoint holds its params and moments in.
LEARNER_FIELDS = ("model", "after_model", "target_model", "optimizer", "params")
JOBS = (  # label, directory, updates; in order, since "from-one" reuses one directory
    ("run", "tp", 2),
    ("whole", "tp-whole", 4),
    ("from-one/restored", "one@2", 0),
    ("from-one", "one@2", 2),
)


def copy_step(src, step, dst):
    """A checkpoint directory holding step ``step`` of ``src`` alone, and its config."""
    dst.mkdir(parents=True)
    shutil.copytree(src / str(step), dst / str(step))
    shutil.copy(src / "train_config.json", dst)


def saved(directory, step) -> dict:
    return torch.load(directory / str(step) / "state.pt", weights_only=True)


def flatten(tree, prefix="") -> dict:
    """``{path: leaf}`` of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in flatten(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree) for k, v in flatten(sub, f"{prefix}[{i}]").items()}
    return {prefix: tree}


def learners(state: dict) -> dict:
    return {k: state[k] for k in LEARNER_FIELDS if state.get(k) is not None}


def assert_equal(got: dict, want: dict):
    got, want = flatten(got), flatten(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        if torch.is_tensor(w):
            assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
        else:
            assert got[k] == w, k


def assert_close(got: dict, want: dict):
    """Float tensors at atol 1e-5, rtol 1e-4; everything else equal."""
    got, want = flatten(got), flatten(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        if torch.is_tensor(w) and w.is_floating_point():
            np.testing.assert_allclose(got[k].float().numpy(), w.float().numpy(), rtol=1e-4, atol=1e-5, err_msg=k)
        elif torch.is_tensor(w):
            assert torch.equal(got[k], w), k
        else:
            assert got[k] == w, k


def one_process(name, directory, updates):
    return ranks.train_checkpointed(None, (name, str(directory), updates))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every trainer: four updates in one process; on each mesh, a run saved
    at update 2, an uninterrupted one of 4, and the one-process step-2
    checkpoint resumed (restored alone, then 2 updates); then, in a fresh
    group, the ranks' step-2 checkpoint resumed for 2 updates, and in this
    process restored alone and resumed for 2 updates."""
    tmp = tmp_path_factory.mktemp("ckpt-tp")
    one = {}
    for name in NAMES:
        one[name] = one_process(name, tmp / name / "one", 4)
        for mesh in MESHES:
            copy_step(tmp / name / "one", 2, tmp / mesh / name / "one@2")

    def spawn_all(jobs_of):
        with concurrent.futures.ThreadPoolExecutor(len(MESHES)) as pool:
            futures = {
                mesh: pool.submit(ranks.spawn, (tmp / mesh / "spawns").resolve(), jobs_of(mesh), world=world, tp=2)
                for mesh, world in MESHES.items()
            }
            return {mesh: f.result() for mesh, f in futures.items()}

    for mesh in MESHES:
        (tmp / mesh / "spawns").mkdir()
    first = spawn_all(lambda mesh: {
        f"{name}/{label}": ("train_checkpointed", (name, str(tmp / mesh / name / d), n))
        for name in NAMES for label, d, n in JOBS
    })
    for mesh in MESHES:
        for name in NAMES:
            copy_step(tmp / mesh / name / "tp", 2, tmp / mesh / name / "tp@2")
    resumed = spawn_all(lambda mesh: {
        name: ("train_checkpointed", (name, str(tmp / mesh / name / "tp"), 2)) for name in NAMES
    })
    here = {
        (mesh, name): (one_process(name, tmp / mesh / name / "tp@2", 0), one_process(name, tmp / mesh / name / "tp@2", 2))
        for mesh in MESHES for name in NAMES
    }
    return tmp, one, first, resumed, here


CASES = [pytest.param(mesh, name, id=f"{mesh}-{name}") for mesh in MESHES for name in NAMES]


@pytest.mark.parametrize("mesh,name", CASES)
def test_resume_on_the_same_mesh_is_bit_equal(runs, mesh, name):
    tmp, _, first, resumed, _ = runs
    d = tmp / mesh / name
    ranks.assert_replicated([r[name] for r in resumed[mesh]], "history")
    assert [r["update"] for r in resumed[mesh][0][name]["history"]] == [3, 4]
    assert resumed[mesh][0][name]["history"] == first[mesh][0][f"{name}/whole"]["history"][2:]
    # The whole state: params, moments, env and replay buffer, counters.
    assert_equal(saved(d / "tp", 4), saved(d / "tp-whole", 4))
    assert_equal(saved(d / "tp", 2), saved(d / "tp-whole", 2))


@pytest.mark.parametrize("mesh,name", CASES)
def test_tp_checkpoint_resumes_in_one_process(runs, mesh, name):
    tmp, _, first, _, here = runs
    d = tmp / mesh / name
    restored, continued = here[(mesh, name)]
    gathered = [r[f"{name}/run"]["state"] for r in first[mesh]]
    ranks.assert_replicated(gathered, *learners(gathered[0]))
    assert_equal(learners(restored["state"]), learners(gathered[0]))
    assert_equal(restored["state"], saved(d / "tp", 2))
    # The next updates, in one process, against the ranks' uninterrupted run.
    want = saved(d / "tp-whole", 4)
    got = saved(d / "tp@2", 4)
    assert_close(learners(got), learners(want))
    assert torch.equal(got["env"]["boards"], want["env"]["boards"])
    ranks.assert_metrics_close(continued["history"], first[mesh][0][f"{name}/whole"]["history"][2:])


@pytest.mark.parametrize("mesh,name", CASES)
def test_one_process_checkpoint_resumes_on_the_mesh(runs, mesh, name):
    tmp, one, first, _, _ = runs
    d = tmp / mesh / name
    restored = [r[f"{name}/from-one/restored"]["state"] for r in first[mesh]]
    for r in restored:
        assert_equal(learners(r), learners(saved(tmp / name / "one", 2)))
    got, want = saved(d / "one@2", 4), saved(tmp / name / "one", 4)
    assert_close(learners(got), learners(want))
    assert torch.equal(got["env"]["boards"], want["env"]["boards"])
    ranks.assert_metrics_close(first[mesh][0][f"{name}/from-one"]["history"], one[name]["history"][2:])


@pytest.mark.parametrize("mesh,name", CASES)
def test_tp_checkpoint_has_the_one_process_format(runs, mesh, name):
    tmp = runs[0]
    got, want = flatten(saved(tmp / mesh / name / "tp", 2)), flatten(saved(tmp / name / "one", 2))
    assert got.keys() == want.keys()
    for k, w in want.items():
        if torch.is_tensor(w):
            assert (got[k].shape, got[k].dtype) == (w.shape, w.dtype), k
        else:
            assert type(got[k]) is type(w), k


def test_jax_reference_round_trip(runs, tmp_path):
    """JAX's A3C at dp=1 x tp=2 saves its sharded state through orbax and
    restores into a one-device ``state_like``: the arrays equal the global
    ones it saved. The port's A3C at dp=1 x tp=2 meets the same invariant."""
    cfg = ja3c.A3CConfig(batch_size=16, unroll_len=3, model="mlp")
    mesh = jmesh.make_mesh(jmesh.MeshConfig(dp=1, tp=2), devices=jax.devices()[:2])
    ckpt = JaxCheckpointer(str(tmp_path / "jax"), save_every=2)
    state, _ = ja3c.train_a3c(cfg, 2, mesh=mesh, log_every=1, checkpointer=ckpt)
    assert any(len(leaf.sharding.device_set) == 2 and not leaf.sharding.is_fully_replicated
               for leaf in jax.tree.leaves(state.params))
    like, _, _ = ja3c.init_a3c(cfg, jax.random.key(1))
    restored = ckpt.restore(like)
    ckpt.close()

    def host(tree):
        return [np.asarray(jax.random.key_data(x) if jax.dtypes.issubdtype(x.dtype, jax.dtypes.prng_key) else x)
                for x in jax.tree.leaves(tree)]

    assert all(len(leaf.sharding.device_set) == 1 for leaf in jax.tree.leaves(restored.params))
    for a, b in zip(host(restored), host(state), strict=True):
        np.testing.assert_array_equal(a, b)
    # The port: the dp=1 x tp=2 checkpoint restored in one process equals
    # the whole state the ranks gathered.
    _, _, first, _, here = runs
    restored_port = here[("dp1xtp2", "a3c")][0]["state"]
    assert_equal(restored_port, first["dp1xtp2"][0]["a3c/run"]["state"])
    assert restored_port["model"].keys() == a3c.init_a3c(ranks.A3C_CFG, 0, device="cpu")[1].state_dict().keys()

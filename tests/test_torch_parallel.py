# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's ``parallel/`` against the JAX package's, in one process.

Meshes as layouts (no process group) and over a one-rank gloo group; JAX
runs on the conftest's 8 CPU devices. The multi-process updates are in
``tests/test_torch_distributed.py``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from rein48_tpu.parallel import mesh as jmesh
from rein48_tpu.parallel import multihost as jmultihost
from rein48_tpu.parallel import spmd as jspmd
from rein48_tpu.train import a3c as ja3c
from rein48_tpu.train import afterstate as jafter
from rein48_tpu_torch.engine import fused, vector
from rein48_tpu_torch.models import convert, nets
from rein48_tpu_torch.parallel import mesh as mesh_lib
from rein48_tpu_torch.parallel import multihost, spmd
from rein48_tpu_torch.train import a3c, afterstate, common, dqn, ppo

from torch_dist_ranks import layout, one_rank

torch.set_num_threads(1)


class TestMeshLayout:
    @pytest.mark.parametrize("dp,tp", [(8, 1), (2, 4), (None, 2), (1, 8)])
    def test_shapes_and_rank_layout_match_jax(self, dp, tp):
        jm = jmesh.make_mesh(jmesh.MeshConfig(dp=dp, tp=tp))
        m = mesh_lib.make_mesh(mesh_lib.MeshConfig(dp=dp, tp=tp), world=8)
        assert m.shape == dict(jm.shape)
        # tp innermost: the port's rank layout is JAX's device-id layout.
        np.testing.assert_array_equal(m.ranks, np.vectorize(lambda d: d.id)(jm.devices))

    def test_bad_shape_raises_jax_text(self):
        with pytest.raises(ValueError) as want:
            jmesh.make_mesh(jmesh.MeshConfig(dp=3, tp=2))
        with pytest.raises(ValueError) as got:
            mesh_lib.make_mesh(mesh_lib.MeshConfig(dp=3, tp=2), world=8)
        assert str(got.value) == str(want.value)

    def test_host_local_batch_matches_jax(self, monkeypatch):
        assert multihost.host_local_batch(8192) == jmultihost.host_local_batch(8192)
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        monkeypatch.setattr(multihost.dist, "is_initialized", lambda: True)
        monkeypatch.setattr(multihost.dist, "get_world_size", lambda group=None: 2)
        assert multihost.host_local_batch(8192) == jmultihost.host_local_batch(8192) == 4096
        with pytest.raises(ValueError) as want:
            jmultihost.host_local_batch(7)
        with pytest.raises(ValueError) as got:
            multihost.host_local_batch(7)
        assert str(got.value) == str(want.value)

    def test_batch_slices_tile_the_batch(self):
        rows = [mesh_lib.batch_slice(layout(4, r), 64) for r in range(4)]
        assert [(s.start, s.stop) for s in rows] == [(0, 16), (16, 32), (32, 48), (48, 64)]
        with pytest.raises(ValueError, match="global batch 10 % 4 hosts != 0"):
            mesh_lib.batch_slice(layout(4), 10)


class TestShardEnvState:
    def test_stepping_a_slice_is_the_slice_of_stepping_the_whole(self):
        whole = vector.reset_batch(3, 64, "cpu")
        final, out = vector.rollout_random(whole, 20)
        for r in range(4):
            shard = mesh_lib.shard_env_state(whole, layout(4, r))
            assert shard.boards.shape == (16, 4, 4)
            torch.testing.assert_close(shard.env_id, torch.arange(16 * r, 16 * (r + 1)), rtol=0, atol=0)
            got, got_out = vector.rollout_random(shard, 20)
            rows = slice(16 * r, 16 * (r + 1))
            for f in dataclasses.fields(final):
                assert torch.equal(getattr(got, f.name), getattr(final, f.name)[rows]), f.name
            assert torch.equal(got_out.reward, out.reward[:, rows])
            assert torch.equal(got_out.done, out.done[:, rows])

    def test_fused_rollout_of_a_slice_keys_its_global_envs(self):
        whole = vector.reset_batch(5, 64, "cpu")
        want_state, want_stats = fused.rollout_random_fused(whole, 3, 9)
        shard = mesh_lib.shard_env_state(whole, layout(4, 2))
        got_state, got_stats = fused.rollout_random_fused(shard, 3, 9, env_base=32)
        assert torch.equal(got_state.boards, want_state.boards[32:48])
        for f in dataclasses.fields(want_stats):
            assert torch.equal(getattr(got_stats, f.name), getattr(want_stats, f.name)[32:48]), f.name


def flax_to_port_names(flax_params, to_state_dict):
    """``{flax leaf path: port parameter name}`` through ``models/convert.py``:
    each leaf filled with its index, converted, and found by its value."""
    paths, leaves = zip(*jax.tree_util.tree_flatten_with_path(flax_params)[0])
    tree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(flax_params), [np.full(np.shape(x), i, np.float32) for i, x in enumerate(leaves)]
    )
    names = {int(v.reshape(-1)[0]): k for k, v in to_state_dict(tree).items()}
    return {jax.tree_util.keystr(p): names[i] for i, p in enumerate(paths)}


SPEC_NETS = {
    "a3c-mlp": (ja3c.A3CConfig(model="mlp"), convert.mlp_params_from_flax, lambda: nets.A3CMLP()),
    "resnet": (jafter.AfterstateTDConfig(), convert.params_from_flax, lambda: nets.ResNetPolicy()),
}


@pytest.mark.parametrize("net", list(SPEC_NETS))
@pytest.mark.parametrize("tp", [1, 4])
def test_param_specs_match_jax_leaf_for_leaf(net, tp):
    jcfg, to_state_dict, make = SPEC_NETS[net]
    jmodel = jcfg.make_model()
    jparams = jmodel.init(jax.random.key(0), jnp.zeros((1, 4, 4, 16)))["params"]
    jspecs = jmesh.param_specs(jparams, jmesh.make_mesh(jmesh.MeshConfig(dp=8 // tp, tp=tp)))
    specs = mesh_lib.param_specs(make(), mesh_lib.make_mesh(mesh_lib.MeshConfig(tp=tp), world=8))
    names = flax_to_port_names(jparams, to_state_dict)
    assert sorted(names.values()) == sorted(specs)
    sharded = 0
    for path, spec in jax.tree_util.tree_flatten_with_path(jspecs, is_leaf=lambda x: isinstance(x, P))[0]:
        port = specs[names[jax.tree_util.keystr(path)]]
        # JAX shards a kernel's last (output) axis, the port a weight's first.
        assert (len(spec) > 0 and spec[-1] == "tp") == bool(port), path
        assert port in ((), ("tp",) + (None,) * (len(spec) - 1)), path
        sharded += bool(port)
    assert (sharded > 0) == (tp > 1)


def test_psum_mean_grads_equals_jax_shard_map():
    """One rank's mean gradient, reduced over a one-rank group, against JAX's
    shard_map + psum over 8 devices on the same inputs."""
    mesh = jmesh.make_mesh(jmesh.MeshConfig(dp=8, tp=1))
    x = np.asarray(jax.random.normal(jax.random.key(0), (32, 4)))
    w = np.ones((4, 2), np.float32)

    def loss(w, x):
        return jnp.mean((x @ w) ** 2)

    def local_step(w, x_local):
        return jspmd.psum_mean_grads(jax.grad(loss)(w, x_local))

    want = jax.jit(
        jax.shard_map(local_step, mesh=mesh, in_specs=(P(), P("dp")), out_specs=P(), check_vma=False)
    )(jnp.asarray(w), jax.device_put(jnp.asarray(x), jmesh.batch_sharding(mesh)))
    tw = torch.tensor(w, requires_grad=True)
    (g,) = torch.autograd.grad(torch.mean((torch.tensor(x) @ tw) ** 2), tw)
    with one_rank() as m:
        (got,) = spmd.psum_mean_grads([g], m.dp_group)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_psum_grads_keep_each_gradient_layout():
    """A channels-last gradient comes back channels last, so the global norm
    over the reduced list adds in the order it adds without a group: on one
    rank the same bits (the one-rank NCCL update of chip_smoke.py is held
    bit for bit to the update without a mesh)."""
    g = torch.Generator().manual_seed(0)
    grads = [torch.randn(64, 16, 3, 3, generator=g).to(memory_format=torch.channels_last),
             torch.randn(64, generator=g), None, torch.randn(8, 64, 3, 3, generator=g).to(memory_format=torch.channels_last)]
    params = [torch.zeros(64, 16, 3, 3), torch.zeros(64), torch.zeros(5), torch.zeros(8, 64, 3, 3)]
    with one_rank() as m:
        got = spmd.psum_grads(grads, params, m.dp_group)
    for a, b, p in zip(got, grads, params):
        want = torch.zeros_like(p) if b is None else b
        assert torch.equal(a, want) and a.stride() == want.stride()
    assert torch.equal(common.tree_norm(got), common.tree_norm([torch.zeros(5) if t is None else t for t in grads]))


class TestInitialize:
    def test_idempotent_and_refuses_another_join(self):
        topo = multihost.initialize()
        assert (topo.process_index, topo.process_count, topo.is_primary) == (0, 1, True)
        with one_rank():
            again = multihost.initialize(num_processes=1, process_id=0, device="cpu")
            assert (again.process_index, again.process_count, again.global_device_count) == (0, 1, 1)
            with pytest.raises(RuntimeError, match="already joined"):
                multihost.initialize(num_processes=1, process_id=0, backend="nccl")
        assert not multihost.dist.is_initialized()

    def test_helpers_on_a_one_rank_group(self):
        with one_rank() as m:
            assert (m.dp, m.tp, m.rank, m.is_primary) == (1, 1, 0, True)
            x = torch.arange(6, dtype=torch.float32).reshape(3, 2)
            assert torch.equal(spmd.all_gather(x, m.dp_group), x[None])
            mean, std = spmd.global_mean_std(x, m.dp_group)
            assert torch.equal(mean, x.mean()) and torch.equal(std, x.std(correction=0))
            spmd.assert_replicated([x], m.group)
            env = vector.reset_batch(0, 8, "cpu")
            assert torch.equal(mesh_lib.gather_batch(mesh_lib.shard_env_state(env, m), m).boards, env.boards)


class TestTrainersOnAMesh:
    def test_a_mesh_without_its_process_group_is_refused(self):
        cfg = a3c.A3CConfig(batch_size=8, unroll_len=2, model="mlp")
        with pytest.raises(ValueError, match="needs their process group"):
            a3c.train_a3c(cfg, 1, mesh=layout(2), device="cpu")

    def test_dqn_buffer_rule(self):
        cfg = dqn.DQNConfig(num_envs=16, model="qnet", replay_capacity=250)
        with pytest.raises(ValueError, match="replay_capacity % num_envs == 0 and num_envs % dp == 0"):
            dqn.train_dqn(cfg, 1, mesh=layout(2), device="cpu")
        with pytest.raises(ValueError, match="num_envs % dp == 0"):
            dqn.check_mesh_layout(dataclasses.replace(cfg, replay_capacity=256), layout(3))
        dqn.check_mesh_layout(dataclasses.replace(cfg, replay_capacity=256), layout(2))

    def test_shuffles_must_stay_on_the_rank(self):
        cfg = ppo.PPOConfig(batch_size=8, unroll_len=4, num_minibatches=2, model="mlp", shard_friendly_perm=False)
        state, model, opt = ppo.init_ppo(cfg, 0, device="cpu")
        with pytest.raises(ValueError, match="needs shard_friendly_perm"):
            ppo.make_ppo_step(cfg, model, opt, mesh=layout(2))
        acfg = afterstate.AfterstateTDConfig(batch_size=8, unroll_len=4, num_minibatches=2, model="mlp", shard_friendly_perm=False)
        state, model, opt = afterstate.init_afterstate_td(acfg, 0, device="cpu")
        with pytest.raises(ValueError, match="needs shard_friendly_perm"):
            afterstate.make_afterstate_td_step(acfg, model, opt, mesh=layout(2))

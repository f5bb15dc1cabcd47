# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's DDPG trainer against the JAX package.

Small float32 nets (``CNNPolicy(channels=(4, 8))`` and a plain
``QNetwork(channels=(4, 8), hidden=16)``) start from one Flax init carried
across by ``models/convert.py``. Whole updates run JAX's own
``make_ddpg_step`` on the port's draws (``test_torch_dqn.jit_with_draws``:
the actions' Gumbel noise, the sample's indices and the env's words).
Tolerances as in ``test_torch_dqn``: boards, actions and the buffer exact,
metrics rtol 1e-4, parameters rtol 1e-5 with SGD and the moment-sign bound
with Adam; targets likewise.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rein48_tpu.models import nets as jnets
from rein48_tpu.train import ddpg as jddpg_train
from rein48_tpu_torch import cli
from rein48_tpu_torch.agents import replay
from rein48_tpu_torch.engine import philox
from rein48_tpu_torch.models import convert, nets
from rein48_tpu_torch.train import common
from rein48_tpu_torch.train import ddpg as ddpg_train
from rein48_tpu_torch.utils.checkpoint import Checkpointer

from test_torch_a3c import assert_params_match, to_numpy
from test_torch_dqn import _check_buffers, env_words, jax_env_fields, jit_with_draws

torch.set_num_threads(1)


@dataclasses.dataclass(frozen=True)
class SmallDDPG(ddpg_train.DDPGConfig):
    def make_actor(self, generator=None):
        return nets.CNNPolicy(channels=(4, 8), dtype=torch.float32, generator=generator,
                              in_channels=common.obs_channels(self.obs_encoding))

    def make_critic(self, generator=None):
        return nets.QNetwork(channels=(4, 8), hidden=16, dueling=False, dtype=torch.float32, generator=generator,
                             in_channels=common.obs_channels(self.obs_encoding))


@dataclasses.dataclass(frozen=True)
class JSmallDDPG(jddpg_train.DDPGConfig):
    def make_actor(self):
        return jnets.CNNPolicy(channels=(4, 8), dtype=jnp.float32)

    def make_critic(self):
        return jnets.QNetwork(channels=(4, 8), hidden=16, dueling=False, dtype=jnp.float32)


def ddpg_configs(**kw):
    base = {"num_envs": 8, "replay_capacity": 64, "learn_batch_size": 16, "min_replay_before_learn": 24, **kw}
    return SmallDDPG(**base), JSmallDDPG(**base)


def init_pair(cfg, jcfg, seed=4):
    jstate, actor, critic, tx = jddpg_train.init_ddpg(jcfg, jax.random.key(seed))
    jstep = jit_with_draws(jddpg_train.make_ddpg_step(jcfg, actor, critic, tx))
    state, _, _ = ddpg_train.init_ddpg(cfg, 5, device="cpu")
    convert.ddpg_state_from_jax(state, actor=to_numpy(jstate.actor_params), critic=to_numpy(jstate.critic_params),
                                env=jax_env_fields(jstate.env))
    return state, ddpg_train.make_ddpg_step(cfg, state), jstate, jstep


def jax_update(cfg, step, jstep, state, jstate):
    """One port update, and JAX's own update on the port's draws."""
    words = torch.stack(env_words(state.env, 1))
    noise = philox.learner_gumbel(state.seed, state.update_step, (cfg.num_envs, 4))
    new_state, metrics = step(state)
    idx = step.sample_indices(state, new_state.replay)
    jstate, jm = jstep(jstate, words.numpy().astype(np.uint32), np.zeros((0,), np.float32), noise.numpy()[None], [idx.numpy()])
    return new_state, metrics, jstate, jm


def check_nets(state, jstate, cfg, counts):
    pairs = ((state.actor, jstate.actor_params, counts[0]), (state.critic, jstate.critic_params, counts[1]),
             (state.target_actor, jstate.target_actor_params, counts[0]), (state.target_critic, jstate.target_critic_params, counts[1]))
    for module, jp, count in pairs:
        assert_params_match([module], [jp], cfg.optimizer, cfg.learning_rate, max(count, 1))


DDPG_CASES = {
    # Cold for two updates (8, 16 < 24), learning at the third.
    "adam-cold-then-learn": dict(learning_rate=3e-3),
    "sgd-nomask-tau": dict(optimizer="sgd", learning_rate=0.05, use_legal_mask=False, tau=0.5, gamma=0.9,
                           min_replay_before_learn=8),
}


@pytest.mark.parametrize("case", list(DDPG_CASES))
def test_ddpg_updates_match_jax_step(case):
    cfg, jcfg = ddpg_configs(**DDPG_CASES[case])
    state, step, jstate, jstep = init_pair(cfg, jcfg)
    for u in range(3):
        before = [p.clone() for p in list(state.actor.parameters()) + list(state.critic.parameters())]
        nets_before = {name: {k: v.clone() for k, v in getattr(state, name).state_dict().items()} for name in ("actor", "critic")}
        state_before = state
        state, metrics, jstate, jm = jax_update(cfg, step, jstep, state, jstate)
        np.testing.assert_array_equal(state.env.boards.numpy(), np.asarray(jstate.env.boards))
        _check_buffers(state.replay, jstate.replay)
        assert set(metrics) == set(jm)
        for k, v in jm.items():
            np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4, atol=1e-6, err_msg=f"{k} update {u}")
        # Both optimizers step every update, cold or not: Adam's count advances.
        assert state.actor_opt.count == state.critic_opt.count == u + 1
        if cfg.optimizer == "adam":
            assert int(jstate.actor_opt[1][0].count) == int(jstate.critic_opt[1][0].count) == u + 1
        cold = state.replay.size < cfg.min_replay_before_learn
        after = list(state.actor.parameters()) + list(state.critic.parameters())
        assert all(torch.equal(a, b) for a, b in zip(before, after)) == cold
        check_nets(state, jstate, cfg, (state.actor_opt.count, state.critic_opt.count))
        if not cold:
            # The actor's loss is -E[sum pi Q] under the critic from BEFORE its step.
            actor, critic = cfg.make_actor(), cfg.make_critic()
            actor.load_state_dict(nets_before["actor"])
            critic.load_state_dict(nets_before["critic"])
            boards = state.replay.data["board"][step.sample_indices(state_before, state.replay)]
            with torch.no_grad():
                probs = torch.softmax(step._logits(actor, boards), -1)
                want = -torch.mean(torch.sum(probs * step._q(critic, boards), -1))
                stepped = -torch.mean(torch.sum(probs * step._q(state.critic, boards), -1))
            np.testing.assert_allclose(float(metrics["actor_loss"]), float(want), rtol=1e-6)
            assert abs(float(stepped) - float(want)) > 1e-4 * abs(float(want))


def test_ddpg_state_from_jax_mid_training():
    cfg, jcfg = ddpg_configs(learning_rate=3e-3, min_replay_before_learn=8)
    jstate, actor, critic, tx = jddpg_train.init_ddpg(jcfg, jax.random.key(8))
    step_fn = jddpg_train.make_ddpg_step(jcfg, actor, critic, tx)
    jit_step = jax.jit(step_fn)
    for _ in range(2):
        jstate, _ = jit_step(jstate)
    state, _, _ = ddpg_train.init_ddpg(cfg, 0, device="cpu")
    rep = jstate.replay

    def adam(opt_state):
        a = opt_state[1][0]
        return {"mu": to_numpy(a.mu), "nu": to_numpy(a.nu), "count": np.asarray(a.count)}

    convert.ddpg_state_from_jax(
        state, actor=to_numpy(jstate.actor_params), critic=to_numpy(jstate.critic_params),
        target_actor=to_numpy(jstate.target_actor_params), target_critic=to_numpy(jstate.target_critic_params),
        actor_opt=adam(jstate.actor_opt), critic_opt=adam(jstate.critic_opt), env=jax_env_fields(jstate.env),
        replay={"data": to_numpy(rep.data), "cursor": np.asarray(rep.cursor), "size": np.asarray(rep.size)},
    )
    state = dataclasses.replace(state, update_step=2)
    assert state.actor_opt.count == state.critic_opt.count == 2
    _check_buffers(state.replay, rep)
    step = ddpg_train.make_ddpg_step(cfg, state)
    state, metrics, jstate, jm = jax_update(cfg, step, jit_with_draws(step_fn), state, jstate)
    for k, v in jm.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4, atol=1e-6, err_msg=k)
    check_nets(state, jstate, cfg, (3, 3))


def test_ddpg_phases_take_the_streams_draws():
    cfg, _ = ddpg_configs(optimizer="sgd", learning_rate=0.05, min_replay_before_learn=8)
    runs = []
    for inject in (False, True):
        state, _, _ = ddpg_train.init_ddpg(cfg, 6, device="cpu")
        step = ddpg_train.make_ddpg_step(cfg, state)
        for u in range(2):
            kw = {}
            if inject:
                kw["noise"] = philox.learner_gumbel(6, u, (cfg.num_envs, 4))
                size = min(state.replay.size + cfg.num_envs, cfg.replay_capacity)
                kw["indices"] = replay.sample_indices(6, u, cfg.learn_batch_size, size)
            state, m = step(state, **kw)
        runs.append((state, m))
    (a, ma), (b, mb) = runs
    assert all(float(ma[k]) == float(mb[k]) for k in ma)
    assert all(torch.equal(x, y) for x, y in zip(a.actor.parameters(), b.actor.parameters()))


def test_train_ddpg_saves_but_never_resumes(tmp_path):
    cfg, _ = ddpg_configs(min_replay_before_learn=8)
    ckpt = Checkpointer(str(tmp_path), save_every=2)
    first, h1 = ddpg_train.train_ddpg(cfg, 2, seed=1, log_every=1, checkpointer=ckpt, device="cpu")
    second, h2 = ddpg_train.train_ddpg(cfg, 2, seed=1, log_every=1, checkpointer=ckpt, device="cpu")
    # The second run starts afresh, as JAX's train_ddpg does (train/ddpg.py:233-271).
    assert [r["update"] for r in h2] == [1, 2] and ckpt.all_steps() == [2]
    assert all(torch.equal(x, y) for x, y in zip(first.actor.parameters(), second.actor.parameters()))
    assert not (tmp_path / "train_config.json").exists()
    saved = ckpt.restore_field("actor")
    assert all(torch.equal(saved[k], v) for k, v in second.actor.state_dict().items())
    assert set(h1[0]) == {"update", "critic_loss", "actor_loss", "td_abs", "replay_size", "episodes",
                          "avg_episode_tile_sum", "best_tile", "steps_per_sec"}


def test_ddpg_config_json_and_defaults_equal_jax():
    def dump(cfg):
        return json.dumps(dataclasses.asdict(cfg), sort_keys=True, default=lambda v: v.name)

    assert dump(ddpg_train.DDPGConfig()) == dump(jddpg_train.DDPGConfig())
    cfg = ddpg_train.DDPGConfig()
    actor, critic = cfg.make_actor(), cfg.make_critic()
    assert isinstance(actor, nets.CNNPolicy) and isinstance(critic, nets.QNetwork) and not critic.dueling
    assert actor.dtype == critic.dtype == torch.bfloat16


def test_cli_train_ddpg():
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["train", "--algo", "ddpg", "--batch-size", "16", "--updates", "2", "--log-every", "1", "--device", "cpu"])
    assert rc == 0 and "final: {'update': 2" in err.getvalue()

# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's DQN family against the JAX package: ``QNetwork``, the loss,
exploration and target sync, the replay buffer, the trainer, its
checkpoints, the presets and the CLI.

Inputs are made with numpy from fixed seeds; nets start from one Flax init
carried across by ``models/convert.py``.

Tolerances. ``QNetwork``, ``huber``, ``dqn_loss`` and its gradients and
``polyak_update`` run the same float32 operations: rtol 1e-5. The replay
buffer and its samples are exact: JAX's own indices (``jax.random.randint``
of its key) index the port's buffer. Whole updates: :func:`jit_with_draws` runs
JAX's own ``make_dqn_step`` with the port's draws fed to it in place of
its threefry draws (explore uniforms, Gumbel noise for
``jax.random.categorical``, ``jax.random.randint``'s indices, and the
env's Philox words for ``vector.step_autoreset``), its ``lax.scan``
unrolled so that each acting step takes its own draws. Boards,
actions and the buffer are exact; epsilon within one float32 ulp (the
compiled step contracts its multiply-add); metrics rtol 1e-4; parameters
after 3 updates rtol 1e-5 with SGD, and with Adam the moment-sign bound of
``test_torch_a3c`` (2 lr per step per entry, rtol 1e-4 over the set).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rein48_tpu import cli as jcli
from rein48_tpu import configs as jconfigs
from rein48_tpu.agents import dqn as jdqn
from rein48_tpu.agents import replay as jreplay
from rein48_tpu.engine import vector as jvector
from rein48_tpu.models import nets as jnets
from rein48_tpu.train import common as jcommon
from rein48_tpu.train import dqn as jdqn_train
from rein48_tpu_torch import cli, configs
from rein48_tpu_torch.agents import dqn, replay
from rein48_tpu_torch.engine import philox
from rein48_tpu_torch.models import convert, nets
from rein48_tpu_torch.train import common
from rein48_tpu_torch.train import dqn as dqn_train
from rein48_tpu_torch.utils import flops
from rein48_tpu_torch.utils.checkpoint import Checkpointer

from test_torch_a3c import assert_params_match, t, to_numpy
from test_torch_engine import random_boards

torch.set_num_threads(1)

QSMALL = (("channels", (4, 8)), ("hidden", 16))


# --- QNetwork -----------------------------------------------------------------------------


@pytest.mark.parametrize("dueling", [True, False])
@pytest.mark.parametrize("encoding", ["onehot", "log2"])
def test_qnetwork_matches_flax(dueling, encoding):
    jm = jnets.QNetwork(channels=(4, 8), hidden=16, dueling=dueling, dtype=jnp.float32)
    boards = random_boards(np.random.default_rng(1), 64)
    jobs = jcommon.encode_obs(jnp.asarray(boards), encoding)
    params = jax.jit(jm.init)(jax.random.key(3), jobs[:1])["params"]
    tm = nets.QNetwork(channels=(4, 8), hidden=16, dueling=dueling, dtype=torch.float32, in_channels=common.obs_channels(encoding))
    tm.load_state_dict(convert.qnet_params_from_flax(to_numpy(params)))
    obs = common.encode_obs(t(boards), encoding)
    got = tm(obs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jm.apply({"params": params}, jobs)), rtol=1e-5, atol=1e-6)
    # The gradient of a scalar of Q, through both libraries.
    w = np.random.default_rng(2).normal(size=(64, 4)).astype(np.float32)
    jg = jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, jobs) * w))(params)
    grads = torch.autograd.grad((got * t(w)).sum(), list(tm.parameters()))
    want = convert.qnet_params_from_flax(to_numpy(jg))
    for (name, _), g in zip(tm.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-5, atol=1e-6, err_msg=name)
    assert got.shape == (64, 4) and tm(obs[None, :3]).shape == (1, 3, 4)
    assert set(tm.state_dict()) == set(want)


def test_qnetwork_defaults_and_bf16():
    m = nets.QNetwork(generator=torch.Generator().manual_seed(0))
    assert m.dtype == torch.bfloat16 and all(p.dtype == torch.float32 for p in m.parameters())
    q = m(common.encode_obs(torch.zeros((2, 4, 4), dtype=torch.uint8), "onehot"))
    assert q.dtype == torch.float32 and q.shape == (2, 4)
    jm = jnets.QNetwork()
    jp = jm.init(jax.random.key(0), jnp.zeros((1, 4, 4, 16)))["params"]
    assert jax.tree_util.tree_reduce(lambda a, x: a + x.size, jp, 0) == nets.count_params(m)
    with pytest.raises(ValueError, match="unknown model"):
        nets.make_model("qnet")


# --- loss, exploration, target sync ---------------------------------------------------------


def test_huber_matches_jax():
    x = np.linspace(-3, 3, 61).astype(np.float32)
    for delta in (0.5, 1.0, 2.0):
        np.testing.assert_allclose(dqn.huber(t(x), delta).numpy(), np.asarray(jdqn.huber(jnp.asarray(x), delta)), rtol=1e-6)


@pytest.mark.parametrize("double", [True, False])
def test_dqn_loss_and_grads_match_jax(double):
    rng = np.random.default_rng(int(double))
    n = 64
    q, qn, qt = (rng.normal(size=(n, 4)).astype(np.float32) * 2 for _ in range(3))
    actions = rng.integers(0, 4, n).astype(np.int32)
    rewards = rng.normal(size=n).astype(np.float32)
    dones = rng.uniform(size=n) < 0.2
    cfg = dict(gamma=0.9, double_dqn=double, huber_delta=1.0)

    def jloss(q_):
        return jdqn.dqn_loss(q_, jnp.asarray(qn), jnp.asarray(qt), jnp.asarray(actions), jnp.asarray(rewards),
                             jnp.asarray(dones), jdqn.DQNLossConfig(**cfg))

    (_, jaux), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(q))
    tq = t(q).requires_grad_()
    loss, aux = dqn.dqn_loss(tq, t(qn), t(qt), t(actions), t(rewards), t(dones), dqn.DQNLossConfig(**cfg))
    (g,) = torch.autograd.grad(loss, tq)
    assert set(aux) == set(jaux)
    for k in aux:
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-8)
    assert 0.1 < float(aux["td_abs"].detach()) and bool((torch.abs(t(rewards)) > 1).any())  # both Huber branches in play


@pytest.mark.parametrize("masked", [True, False])
def test_epsilon_greedy_with_the_same_draws(masked):
    """The port given JAX's explore uniforms and Gumbel noise picks JAX's
    actions; without a mask the random action is the port's words formula."""
    rng = np.random.default_rng(5)
    n = 512
    q = rng.normal(size=(n, 4)).astype(np.float32)
    mask = rng.uniform(size=(n, 4)) < 0.6
    mask[:8] = False
    key = jax.random.key(11)
    for eps in (0.0, 0.3, 1.0):
        want = jdqn.epsilon_greedy(key, jnp.asarray(q), jnp.asarray(eps, jnp.float32), jnp.asarray(mask) if masked else None)
        k_explore, k_rand = jax.random.split(key)
        u = jax.random.uniform(k_explore, (n,))
        if masked:
            got = dqn.epsilon_greedy(t(q), eps, t(mask), t(u), t(jax.random.gumbel(k_rand, (n, 4))))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            legal = mask.any(-1)
            assert mask[legal, got.numpy()[legal]].all()
        else:
            words = philox.learner_words(0, 0, philox.SAMPLE, (n,))
            got = dqn.epsilon_greedy(t(q), eps, None, t(u), words)
            explore = np.asarray(u) < np.float32(eps)
            np.testing.assert_array_equal(got.numpy()[~explore], np.asarray(want)[~explore])
            np.testing.assert_array_equal(got.numpy()[explore], ((words.numpy() * 4) >> 32)[explore])
        assert got.dtype == torch.int64


def test_polyak_matches_jax():
    rng = np.random.default_rng(7)
    tgt = {"a": rng.normal(size=(3, 5)).astype(np.float32), "b": rng.normal(size=7).astype(np.float32)}
    onl = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in tgt.items()}
    for tau in (0.9, 0.995, 0.5):
        want = jdqn.polyak_update(jax.tree.map(jnp.asarray, tgt), jax.tree.map(jnp.asarray, onl), tau)
        got = [t(tgt[k]) for k in ("a", "b")]
        dqn.polyak_update(got, [t(onl[k]) for k in ("a", "b")], tau)
        for g, k in zip(got, ("a", "b")):
            np.testing.assert_allclose(g.numpy(), np.asarray(want[k]), rtol=1e-5)


# --- the replay buffer ------------------------------------------------------------------------


def _transitions(rng, n):
    return {
        "board": rng.integers(0, 12, (n, 4, 4)).astype(np.uint8),
        "action": rng.integers(0, 4, n).astype(np.int32),
        "reward": rng.normal(size=n).astype(np.float32),
        "next_board": rng.integers(0, 12, (n, 4, 4)).astype(np.uint8),
        "done": rng.uniform(size=n) < 0.3,
    }


def _example_pair():
    jex = {"board": jnp.zeros((4, 4), jnp.uint8), "action": jnp.asarray(0, jnp.int32), "reward": jnp.asarray(0.0, jnp.float32),
           "next_board": jnp.zeros((4, 4), jnp.uint8), "done": jnp.asarray(False)}
    return jex, dqn_train.transition_example("cpu")


def _check_buffers(state, jstate):
    assert (state.cursor, state.size) == (int(jstate.cursor), int(jstate.size))
    for k, buf in state.data.items():
        np.testing.assert_array_equal(buf.numpy(), np.asarray(jstate.data[k]), err_msg=k)


def test_replay_add_wraps_and_samples_with_jax_indices():
    rng = np.random.default_rng(0)
    jex, ex = _example_pair()
    jstate, state = jreplay.replay_init(jex, 24), replay.replay_init(ex, 24)
    assert state.capacity == 24 and not replay.replay_filled(state)
    for i, n in enumerate((8, 8, 5, 8, 8, 24)):
        batch = _transitions(rng, n)
        jstate = jreplay.replay_add(jstate, jax.tree.map(jnp.asarray, batch))
        state = replay.replay_add(state, {k: t(v) for k, v in batch.items()})
        _check_buffers(state, jstate)
        key = jax.random.key(i)
        want = jreplay.replay_sample(jstate, key, 16)
        idx = jax.random.randint(key, (16,), 0, jnp.maximum(jstate.size, 1))
        got = replay.replay_sample(state, t(idx))
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert replay.replay_filled(state) and bool(jreplay.replay_filled(jstate))
    with pytest.raises(ValueError, match="does not fit"):
        replay.replay_add(state, {k: t(v) for k, v in _transitions(rng, 25).items()})


@pytest.mark.parametrize("adds", [3, 7])
def test_replay_sample_nstep_with_jax_indices(adds):
    """Before and after the buffer wraps (capacity 40, stride 8)."""
    rng = np.random.default_rng(adds)
    jex, ex = _example_pair()
    jstate, state = jreplay.replay_init(jex, 40), replay.replay_init(ex, 40)
    for _ in range(adds):
        batch = _transitions(rng, 8)
        jstate = jreplay.replay_add(jstate, jax.tree.map(jnp.asarray, batch))
        state = replay.replay_add(state, {k: t(v) for k, v in batch.items()})
    key = jax.random.key(adds)
    want = jreplay.replay_sample_nstep(jstate, key, 32, n_step=3, stride=8, gamma=0.9)
    n_valid = replay.nstep_valid(state, 3, 8)
    assert n_valid == max(state.size - 16, 1)
    j = jax.random.randint(key, (32,), 0, n_valid)
    got = replay.replay_sample_nstep(state, t(j), n_step=3, stride=8, gamma=0.9)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert got["done"].any() and not got["done"].all()
    with pytest.raises(ValueError, match="n_step must be >= 1"):
        replay.replay_sample_nstep(state, t(j), n_step=0, stride=8, gamma=0.9)
    with pytest.raises(ValueError, match="exceeds capacity"):
        replay.replay_sample_nstep(state, t(j), n_step=6, stride=8, gamma=0.9)


def test_sample_indices_are_uniform_below_n():
    idx = replay.sample_indices(3, 1, 65536, 10)
    assert idx.dtype == torch.int64 and int(idx.min()) == 0 and int(idx.max()) == 9
    assert torch.equal(idx, philox.below_from_words(philox.learner_words(3, 1, philox.REPLAY, (65536,)), 10))
    freq = torch.bincount(idx, minlength=10).double() / 65536
    assert ((freq - 0.1).abs() < 0.01).all()
    big = replay.sample_indices(3, 1, 4096, 1 << 31)
    assert int(big.max()) < 1 << 31 and int(big.max()) > 1 << 30


# --- whole updates: JAX's own step with the port's draws ----------------------------------------------


def _py_scan(f, init, xs=None, length=None):
    carry, ys = init, []
    for _ in range(length):
        carry, y = f(carry, None)
        ys.append(y)
    return carry, jax.tree.map(lambda *a: jnp.stack(a), *ys)


@contextlib.contextmanager
def port_draws(words, uniforms=(), noise=(), randints=()):
    """Within the block, JAX's step functions draw the port's values, in call
    order: ``words`` (``[B, 4]`` per env step) for ``vector.step_autoreset``,
    ``uniforms`` for ``jax.random.uniform``, ``noise`` (Gumbel) for
    ``jax.random.categorical`` (its argmax identity) and ``randints`` for
    ``jax.random.randint``. Works eagerly and under tracing."""
    queues = {k: list(v) for k, v in dict(words=words, uniforms=uniforms, noise=noise, randints=randints).items()}

    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        u = jnp.asarray(queues["uniforms"].pop(0))
        assert u.shape == tuple(shape)
        return u

    def categorical(key, logits, axis=-1, shape=None):
        return jnp.argmax(logits + jnp.asarray(queues["noise"].pop(0)), axis=axis)

    def randint(key, shape, minval, maxval, dtype=jnp.int32):
        values = jnp.asarray(queues["randints"].pop(0)).astype(jnp.int32)
        assert values.shape == tuple(shape)
        return values

    def step_autoreset(state, actions, reward_mode=jvector.RewardMode.MERGE_SCORE):
        w = jnp.asarray(queues["words"].pop(0)).astype(jnp.uint32)
        return jax.vmap(lambda s, a, b: jvector._step_autoreset_from_bits(s, s.key, a, b, reward_mode))(state, actions, w)

    with mock.patch.object(jax.random, "uniform", uniform), mock.patch.object(jax.random, "categorical", categorical), \
            mock.patch.object(jax.random, "randint", randint), mock.patch.object(jvector, "step_autoreset", step_autoreset), \
            mock.patch.object(jax.lax, "scan", _py_scan):
        yield
    assert not any(queues.values()), {k: len(v) for k, v in queues.items()}


def jit_with_draws(step_fn):
    """JAX's ``step_fn(state)`` as ``f(state, words, uniforms, noise,
    randints)``, jitted: the draws are arguments, fed in call order by
    :func:`port_draws` while it traces, so a case compiles once."""

    def run(state, words, uniforms, noise, randints):
        with port_draws(words, uniforms, noise, randints):
            return step_fn(state)

    return jax.jit(run)


def env_words(env, steps):
    """The Philox words ``vector.step_autoreset`` consumes over ``steps`` steps."""
    return [philox.step_words(env.seed, env.env_id, env.counter + k)[:, philox.SPAWN_RANK :] for k in range(steps)]


def jax_env_fields(jenv):
    return {k: np.asarray(getattr(jenv, k)) for k in ("boards", "score", "steps", "done")}


def dqn_configs(model="qnet", model_kwargs=QSMALL, **kw):
    """The port's and JAX's configs of one small float32 trainer."""
    base = {"num_envs": 8, "replay_capacity": 64, "learn_batch_size": 16, "min_replay_before_learn": 16,
            "epsilon_start": 0.5, "epsilon_end": 0.1, "epsilon_decay_steps": 40, "model": model, **kw}
    return (dqn_train.DQNConfig(model_kwargs=model_kwargs + (("dtype", torch.float32),), **base),
            jdqn_train.DQNConfig(model_kwargs=model_kwargs + (("dtype", jnp.float32),), **base))


def check_update(state, jstate, metrics, jm):
    """Env, buffer, counters and metrics of one update against JAX's."""
    np.testing.assert_array_equal(state.env.boards.numpy(), np.asarray(jstate.env.boards))
    np.testing.assert_array_equal(state.env.score.numpy(), np.asarray(jstate.env.score))
    _check_buffers(state.replay, jstate.replay)
    assert state.env_steps == int(jstate.env_steps) and state.update_step == int(jstate.update_step)
    assert set(metrics) == set(jm)
    for k, v in jm.items():
        if k == "epsilon":
            # One float32 ulp: compiled, XLA contracts the anneal's multiply-add.
            np.testing.assert_allclose(float(metrics[k]), float(v), rtol=2**-23)
        else:
            np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4, atol=1e-6, err_msg=k)


def jax_update(cfg, step, jstep, state, jstate):
    """One port update, and JAX's own update (``jstep``, made by
    :func:`jit_with_draws`) on the port's draws."""
    explore_u, draw = step.acting_draws(state, "cpu")
    words = torch.stack(env_words(state.env, cfg.acting_steps_per_update))
    new_state, metrics = step(state)
    idx = step.sample_indices(state, new_state.replay)
    randints = [idx.numpy()]
    noise = draw.numpy()
    if not cfg.use_legal_mask:
        # JAX draws the random action with randint(0, 4): the port's words formula in its place.
        randints = [w.numpy() for w in philox.below_from_words(draw, 4)] + randints
        noise = noise[:0]
    jstate, jm = jstep(jstate, words.numpy().astype(np.uint32), explore_u.numpy(), noise, randints)
    return new_state, metrics, jstate, jm


DQN_CASES = {
    # The learn gate opens at update 2 (8 then 16 transitions): Adam's count is frozen through update 1.
    "adam-gate": dict(learning_rate=3e-3),
    # Two acting steps a update, a policy net's logits as Q, hard sync every 2 updates.
    "sgd-resnet-hardsync": dict(model="resnet", model_kwargs=(("channels", 8), ("num_blocks", 1)), optimizer="sgd",
                                learning_rate=0.05, acting_steps_per_update=2, target_sync_period=2,
                                min_replay_before_learn=24),
    # n-step chains, no legal mask, plain (not double) DQN.
    "sgd-nstep3-nomask": dict(n_step=3, gamma=0.9, replay_capacity=128, acting_steps_per_update=2, optimizer="sgd",
                              learning_rate=0.05, use_legal_mask=False, double_dqn=False, min_replay_before_learn=32),
}


@pytest.mark.parametrize("case", list(DQN_CASES))
def test_dqn_updates_match_jax_step(case):
    cfg, jcfg = dqn_configs(**DQN_CASES[case])
    jstate, jmodel, jopt = jdqn_train.init_dqn(jcfg, jax.random.key(4))
    jstep = jit_with_draws(jdqn_train.make_dqn_step(jcfg, jmodel, jopt))
    state, model, opt = dqn_train.init_dqn(cfg, 5, device="cpu")
    convert.dqn_state_from_jax(state, to_numpy(jstate.params), env=jax_env_fields(jstate.env))
    step = dqn_train.make_dqn_step(cfg, model, state.target_model, opt)
    for u in range(3):
        params_before = [p.clone() for p in model.parameters()]
        state, metrics, jstate, jm = jax_update(cfg, step, jstep, state, jstate)
        check_update(state, jstate, metrics, jm)
        adam_count = int(jstate.opt_state[1][0].count) if cfg.optimizer == "adam" else None
        learned = state.replay.size >= cfg.min_replay_before_learn
        if not learned:
            # The whole optimizer transaction is gated: parameters, moments and count.
            assert all(torch.equal(a, b) for a, b in zip(params_before, model.parameters()))
            assert opt.count == 0 and all(float(m.abs().max()) == 0 for ms in opt.moments.values() for m in ms)
            assert adam_count in (None, 0)
        assert adam_count in (None, opt.count)
        assert_params_match([model], [jstate.params], cfg.optimizer, cfg.learning_rate, max(opt.count, 1))
        assert_params_match([state.target_model], [jstate.target_params], cfg.optimizer, cfg.learning_rate, max(opt.count, 1))
    assert opt.count == {"adam-gate": 2, "sgd-resnet-hardsync": 2, "sgd-nstep3-nomask": 2}[case]
    if case == "sgd-resnet-hardsync":
        # Update 2 hard-copied the new parameters; update 3 left the target there.
        assert not all(torch.equal(a, b) for a, b in zip(model.parameters(), state.target_model.parameters()))


def test_dqn_phases_take_the_streams_draws():
    """An update equals its phases with the learner's draws injected: the
    EPSILON uniforms, the SAMPLE noise and the REPLAY indices of the update."""
    cfg, _ = dqn_configs(acting_steps_per_update=2, optimizer="sgd", learning_rate=0.05)
    runs = []
    for inject in (False, True):
        state, model, opt = dqn_train.init_dqn(cfg, 6, device="cpu")
        step = dqn_train.make_dqn_step(cfg, model, state.target_model, opt)
        for _ in range(3):
            kw = {}
            if inject:
                shape = (cfg.acting_steps_per_update, cfg.num_envs)
                kw["explore_u"] = philox.learner_uniform(6, state.update_step, philox.EPSILON, shape)
                kw["random_draw"] = philox.learner_gumbel(6, state.update_step, shape + (4,))
                size = min(state.replay.size + shape[0] * shape[1], cfg.replay_capacity)
                kw["indices"] = replay.sample_indices(6, state.update_step, cfg.learn_batch_size, size)
            state, m = step(state, **kw)
        runs.append((state, m, model))
    (a, ma, pa), (b, mb, pb) = runs
    assert all(float(ma[k]) == float(mb[k]) for k in ma)
    assert all(torch.equal(x, y) for x, y in zip(pa.parameters(), pb.parameters()))
    assert torch.equal(a.replay.data["board"], b.replay.data["board"]) and a.env_steps == b.env_steps == 48


def test_dqn_state_from_jax_mid_training():
    """A JAX state two jitted updates in (its own draws), carried across
    whole, takes the next update as JAX's own step does."""
    cfg, jcfg = dqn_configs(learning_rate=3e-3, min_replay_before_learn=8)
    jstate, jmodel, jopt = jdqn_train.init_dqn(jcfg, jax.random.key(8))
    step_fn = jdqn_train.make_dqn_step(jcfg, jmodel, jopt)
    jit_step = jax.jit(step_fn)
    for _ in range(2):
        jstate, _ = jit_step(jstate)
    adam = jstate.opt_state[1][0]
    state, model, opt = dqn_train.init_dqn(cfg, 0, device="cpu")
    jrep = jstate.replay
    convert.dqn_state_from_jax(
        state, to_numpy(jstate.params), target_params=to_numpy(jstate.target_params), mu=to_numpy(adam.mu),
        nu=to_numpy(adam.nu), count=np.asarray(adam.count), env=jax_env_fields(jstate.env),
        replay={"data": to_numpy(jrep.data), "cursor": np.asarray(jrep.cursor), "size": np.asarray(jrep.size)},
        env_steps=np.asarray(jstate.env_steps),
    )
    state = dataclasses.replace(state, update_step=2)
    assert opt.count == 2 and state.env_steps == 16
    _check_buffers(state.replay, jrep)
    step = dqn_train.make_dqn_step(cfg, model, state.target_model, opt)
    state, metrics, jstate, jm = jax_update(cfg, step, jit_with_draws(step_fn), state, jstate)
    check_update(state, jstate, metrics, jm)
    assert_params_match([model], [jstate.params], "adam", cfg.learning_rate, 3)
    assert opt.count == 3 == int(jstate.opt_state[1][0].count)


# --- the training loop, checkpoints, configs, presets, the CLI -----------------------------------------


def _same_state(a, b):
    for x, y in zip(list(a.model.parameters()) + list(a.target_model.parameters()),
                    list(b.model.parameters()) + list(b.target_model.parameters())):
        assert torch.equal(x, y)
    for k in a.replay.data:
        assert torch.equal(a.replay.data[k], b.replay.data[k]), k
    for name in ("boards", "score", "steps", "counter"):
        assert torch.equal(getattr(a.env, name), getattr(b.env, name)), name
    assert (a.replay.cursor, a.replay.size, a.update_step, a.env_steps) == (b.replay.cursor, b.replay.size, b.update_step, b.env_steps)
    assert a.optimizer.count == b.optimizer.count
    for m in a.optimizer.moments:
        assert all(torch.equal(x, y) for x, y in zip(a.optimizer.moments[m], b.optimizer.moments[m]))


def test_dqn_checkpoint_resumes_bit_for_bit(tmp_path, capsys):
    cfg, _ = dqn_configs(acting_steps_per_update=2, n_step=2, replay_capacity=48)
    straight, history = dqn_train.train_dqn(cfg, 4, seed=3, log_every=1, device="cpu")
    ckpt = Checkpointer(str(tmp_path), save_every=2)
    dqn_train.train_dqn(cfg, 2, seed=3, log_every=1, checkpointer=ckpt, device="cpu")
    resumed, rest = dqn_train.train_dqn(cfg, 2, seed=3, log_every=1, checkpointer=Checkpointer(str(tmp_path), save_every=2),
                                        device="cpu")
    assert "resumed from checkpoint step 2" in capsys.readouterr().out
    _same_state(straight, resumed)
    strip = [{k: v for k, v in r.items() if k != "steps_per_sec"} for r in history[2:] + rest]
    assert strip[:2] == strip[2:] and [r["update"] for r in rest] == [3, 4]
    assert set(history[0]) == {"update", "loss", "td_abs", "q_mean", "epsilon", "replay_size", "episodes",
                               "avg_episode_tile_sum", "avg_episode_length", "best_tile", "steps_per_sec"}
    assert json.load(open(tmp_path / "train_config.json"))["model"] == "qnet"
    assert ckpt.all_steps() == [2, 4]


def test_dqn_config_json_and_presets_equal_jax():
    def dump(cfg):
        return json.dumps(dataclasses.asdict(cfg), sort_keys=True, default=lambda v: v.name)

    assert dump(dqn_train.DQNConfig()) == dump(jdqn_train.DQNConfig())
    assert set(configs.PRESETS) == set(jconfigs.PRESETS)
    for name, fn in configs.PRESETS.items():
        got, want = fn(), jconfigs.PRESETS[name]()
        if isinstance(want, dict):
            assert got == want, name
        else:
            assert dump(got) == dump(want), name
    assert isinstance(configs.dqn_4k().make_model(), nets.QNetwork)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        dqn_train.train_dqn(dqn_configs()[0], 1, mesh=object(), device="cpu")


def test_dqn_flops_per_frame_follows_the_mfu_report():
    fwd = flops.model_forward_flops(nets.QNetwork())
    assert flops.dqn_flops_per_frame(fwd, 8192, 8192) == 6 * fwd
    assert flops.dqn_flops_per_frame(fwd, 8192, 4096) == 11 * fwd


def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_cli_train_and_eval_dqn(tmp_path):
    ckpt = str(tmp_path / "dqn")
    rc, _, err = _cli(cli.main, ["train", "--algo", "dqn", "--model", "mlp", "--batch-size", "16", "--updates", "2",
                                 "--log-every", "1", "--checkpoint-dir", ckpt, "--checkpoint-every", "2", "--device", "cpu"])
    assert rc == 0 and "final: {'update': 2" in err
    saved = json.load(open(f"{ckpt}/train_config.json"))
    assert saved["model"] == "qnet" and saved["num_envs"] == 16
    for extra in ([], ["--sample"]):
        rc, out, err = _cli(cli.main, ["eval", "--algo", "dqn", "--checkpoint-dir", ckpt, "--num-envs", "8", "--max-steps",
                                       "40", "--device", "cpu"] + extra)
        stats = json.loads(out.strip().splitlines()[-1])
        assert rc == 0 and "restored step 2" in err and stats["episodes"] >= 0
    # Without a checkpoint: a fresh init of the named net, as in JAX.
    rc, out, _ = _cli(cli.main, ["eval", "--algo", "dqn", "--model", "qnet", "--num-envs", "4", "--max-steps", "5",
                                 "--device", "cpu"])
    assert rc == 0 and set(json.loads(out)) >= {"episodes"}
    args, jargs = cli.build_parser().parse_args(["train"]), jcli.build_parser().parse_args(["train"])
    assert (args.algo, args.model, args.batch_size, args.lr) == (jargs.algo, jargs.model, jargs.batch_size, jargs.lr)
    with pytest.raises(SystemExit, match="--mesh is not yet ported"):
        cli.main(["train", "--algo", "dqn", "--mesh", "--device", "cpu"])


def test_plot_renders_a_png(tmp_path):
    pytest.importorskip("matplotlib")
    from rein48_tpu_torch.utils import plot
    from rein48_tpu_torch.utils.metrics import MetricLogger

    cfg, _ = dqn_configs()
    logger = MetricLogger(log_dir=str(tmp_path))
    dqn_train.train_dqn(cfg, 3, seed=0, log_every=1, logger=logger, device="cpu")
    logger.close()
    out = plot.plot_metrics(str(tmp_path / "metrics.csv"))
    assert out.endswith("curves.png") and (tmp_path / "curves.png").stat().st_size > 1000
    assert plot.main([]) == 2

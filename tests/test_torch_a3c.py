# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's A3C agent and trainer against the JAX package, and the
learner's counter-based draws.

Inputs are made with numpy from fixed seeds; nets start from one Flax init
carried across by ``models/convert.py``.

Tolerances. Returns, losses and their gradients run the same float32
operations: rtol 1e-5. Sampled actions are exact: ``jax.random.categorical``
is ``argmax(logits + gumbel)`` (asserted here against JAX itself), so the
port's sampler given JAX's noise gives JAX's actions. In whole updates the
port's Philox words, Gumbel noise and actions drive a reference composed
from the JAX package's pieces (:class:`JaxActing`): boards, dones and the
step's integer outputs are exact, and the port's action equals JAX's argmax
wherever the top two noisy logits are further apart than ``GAP_TOL``.
Values go through two libraries' convolutions: logits and values at rtol
1e-5, targets and metrics at rtol 1e-4 (sums over the unroll). Parameters
after 3 updates: SGD at rtol 1e-5, atol 1e-6; Adam and RMSprop divide by
the root of a moment, so a near-zero gradient that the libraries round to
opposite signs moves a weight by up to ``2 * lr`` (Adam) or ``2 * lr /
sqrt(1 - decay)`` (RMSprop) per step: each entry is held to that, and the
parameters as a whole to rtol 1e-4 (the bound of ``test_torch_afterstate``).
"""

from __future__ import annotations

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rein48_tpu.agents import a3c as ja3c
from rein48_tpu.engine import core as jcore
from rein48_tpu.engine import vector as jvector
from rein48_tpu.train import a3c as ja3c_train
from rein48_tpu.train import common as jcommon
from rein48_tpu_torch.agents import a3c
from rein48_tpu_torch.engine import philox
from rein48_tpu_torch.models import convert
from rein48_tpu_torch.train import a3c as a3c_train
from rein48_tpu_torch.train import common

from test_torch_engine import jax_state

torch.set_num_threads(1)

GAP_TOL = 1e-4
SMALL = (("channels", 8), ("num_blocks", 1))


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def t(x):
    return torch.from_numpy(np.asarray(x).copy())


# --- returns and losses --------------------------------------------------------


@pytest.mark.parametrize("parity", [False, True])
@pytest.mark.parametrize("with_dones", [False, True])
def test_n_step_returns_match_jax(parity, with_dones):
    rng = np.random.default_rng(10 * parity + with_dones)
    rewards = rng.normal(size=(9, 6)).astype(np.float32)
    bootstrap = rng.normal(size=(6,)).astype(np.float32)
    dones = rng.uniform(size=(9, 6)) < 0.25
    kw = dict(dones=dones) if with_dones else {}
    want = ja3c.n_step_returns(jnp.asarray(rewards), jnp.asarray(bootstrap), 0.93, parity_drop_last_reward=parity,
                               **{k: jnp.asarray(v) for k, v in kw.items()})
    got = a3c.n_step_returns(t(rewards), t(bootstrap), 0.93, parity_drop_last_reward=parity, **{k: t(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    if parity:
        assert torch.equal(got[-1], t(bootstrap))


@pytest.mark.parametrize("normalize", [False, True])
def test_a3c_loss_and_grads_match_jax(normalize):
    rng = np.random.default_rng(3 + normalize)
    logits = rng.normal(size=(5, 7, 4)).astype(np.float32)
    values = rng.normal(size=(5, 7)).astype(np.float32)
    targets = rng.normal(size=(5, 7)).astype(np.float32)
    actions = rng.integers(0, 4, size=(5, 7)).astype(np.int32)
    cfg = dict(gamma=0.9, entropy_beta=0.02, value_coef=0.5, normalize_advantage=normalize)

    def jloss(lg, v):
        return ja3c.a3c_loss(lg, v, jnp.asarray(actions), jnp.asarray(targets), ja3c.A3CLossConfig(**cfg))

    (jl, jaux), (jgl, jgv) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(logits), jnp.asarray(values))
    tl, tv = t(logits).requires_grad_(), t(values).requires_grad_()
    loss, aux = a3c.a3c_loss(tl, tv, t(actions), t(targets), a3c.A3CLossConfig(**cfg))
    gl, gv = torch.autograd.grad(loss, (tl, tv))
    assert set(aux) == set(jaux)
    for k in aux:
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(gl.numpy(), np.asarray(jgl), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(gv.numpy(), np.asarray(jgv), rtol=1e-5, atol=1e-8)


def test_normalize_uses_the_population_std():
    adv = torch.tensor([1.0, 2.0, 4.0, 7.0])
    want = (adv - adv.mean()) / (torch.tensor(np.std(adv.numpy())) + 1e-6)
    torch.testing.assert_close(a3c.normalize(adv), want)


# --- sampling -----------------------------------------------------------------------


def noisy_inputs(seed, n=256):
    """Logits, legal masks with all-illegal rows, and a JAX key."""
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(n, 4)) * 2).astype(np.float32)
    mask = rng.uniform(size=(n, 4)) < 0.6
    mask[:4] = False  # all illegal: the unmasked logits decide
    return logits, mask, jax.random.key(seed)


@pytest.mark.parametrize("seed", [0, 1])
def test_categorical_is_gumbel_argmax(seed):
    """The identity the port's sampler rests on, held against JAX itself."""
    logits, mask, key = noisy_inputs(seed)
    masked = ja3c.masked_logits(jnp.asarray(logits), jnp.asarray(mask))
    want = jax.random.categorical(key, masked)
    noise = jax.random.gumbel(key, masked.shape)
    np.testing.assert_array_equal(np.asarray(want), np.asarray(jnp.argmax(masked + noise, -1)))
    # The port given JAX's noise samples JAX's actions.
    got = a3c.sample_actions(t(noise), t(logits), t(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ja3c.sample_actions(key, jnp.asarray(logits), jnp.asarray(mask))))
    legal_rows = mask.any(-1)
    assert mask[legal_rows, got.numpy()[legal_rows]].all()


def test_learner_gumbel_samples_the_softmax():
    logits = torch.tensor([[2.0, 0.0, -1.0, 0.5]]).expand(65536, 4)
    noise = philox.learner_gumbel(7, 3, (65536, 4))
    assert torch.isfinite(noise).all()
    freq = torch.bincount(a3c.sample_actions(noise, logits), minlength=4).double() / 65536
    np.testing.assert_allclose(freq.numpy(), torch.softmax(logits[0].double(), -1).numpy(), atol=0.01)
    assert abs(float(noise.double().mean()) - 0.5772156649) < 0.02  # Euler-Mascheroni


def test_learner_draws_are_named_by_seed_step_and_purpose():
    words = philox.learner_words(5, 9, philox.SHUFFLE, (3, 5), index=2)
    assert torch.equal(words, philox.learner_words(5, 9, philox.SHUFFLE, (3, 5), index=2))
    # The layout: block b is Philox of (b, update_step, purpose << 16 | index, LEARNER_TAG) under the seed.
    c = [torch.tensor(v) for v in (9, (philox.SHUFFLE << 16) | 2, philox.LEARNER_TAG, 5, 0)]
    want = torch.stack(torch.broadcast_tensors(*philox.philox4x32(torch.arange(4), *c)), -1).flatten()[:15]
    assert torch.equal(words.flatten(), want)
    others = [
        philox.learner_words(6, 9, philox.SHUFFLE, (3, 5), index=2),
        philox.learner_words(5, 10, philox.SHUFFLE, (3, 5), index=2),
        philox.learner_words(5, 9, philox.EPSILON, (3, 5), index=2),
        philox.learner_words(5, 9, philox.SHUFFLE, (3, 5), index=3),
    ]
    assert not any(torch.equal(words, o) for o in others)
    # No env stream reaches a learner block: an env counter's last word is env >> 32 = 0.
    assert philox.LEARNER_TAG != 0
    u = philox.learner_uniform(5, 9, philox.EPSILON, (4096,))
    g = philox.open_uniform_from_words(philox.learner_words(5, 9, philox.SAMPLE, (4096,)))
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0 and 0.0 < float(g.min()) and float(g.max()) < 1.0
    edges = torch.tensor([0, 0xFF, 0xFFFFFFFF])
    assert philox.uniform_from_words(edges).tolist() == [0.0, 0.0, 1 - 2**-24]
    assert philox.open_uniform_from_words(edges).tolist() == [2**-24, 2**-24, 1 - 2**-24]
    with pytest.raises(ValueError, match="out of range"):
        philox.learner_words(-1, 0, philox.SHUFFLE, (4,))


# --- whole updates -------------------------------------------------------------------


def jax_beta(jcfg, update_step):
    """The JAX trainers' entropy anneal (``train/a3c.py:186-198``)."""
    if jcfg.entropy_beta_final is None or jcfg.entropy_decay_updates <= 0:
        return jcfg.entropy_beta
    frac = jnp.clip(jnp.asarray(update_step, jnp.int32).astype(jnp.float32) / jcfg.entropy_decay_updates, 0.0, 1.0)
    return jcfg.entropy_beta + frac * (jcfg.entropy_beta_final - jcfg.entropy_beta)


class JaxActing:
    """The JAX trainers' acting loop (``train/a3c.py:200-225``,
    ``train/ppo.py:239-279``), composed from the JAX package's pieces.

    It acts on the port's recorded trajectory: the policy's masked logits
    plus the port's Gumbel noise give JAX's action, checked against the
    port's where the top two are clear; the boards step with the port's
    actions and Philox words through ``vector._step_autoreset_from_bits``.
    """

    def __init__(self, jcfg, jmodel):
        self.cfg = jcfg

        def act(p, boards, noise, actions):
            logits, value = jmodel.apply({"params": p}, jcommon.encode_obs(boards, jcfg.obs_encoding), train=False)
            mask = jcore.legal_action_mask(boards) if jcfg.use_legal_mask else jnp.ones(logits.shape, bool)
            masked = ja3c.masked_logits(logits, mask)
            logp = jnp.take_along_axis(jax.nn.log_softmax(masked), actions[:, None], -1)[:, 0]
            return masked + noise, mask, value, logp, jcore.move_boards(boards, actions)[0]

        def step(s, a, w):
            s, out = jax.vmap(lambda s, a, w: jvector._step_autoreset_from_bits(s, s.key, a, w, jcfg.reward_mode))(s, a, w)
            return s, jcommon.transform_reward(out.reward, jcfg.reward_transform), out.done

        self.act, self.step = jax.jit(act), jax.jit(step)
        self.value = jax.jit(lambda p, b: jmodel.apply({"params": p}, jcommon.encode_obs(b, jcfg.obs_encoding), train=False)[1])

    def rollout(self, params, jenv, env0, traj, noise):
        """Returns ``(jenv, ref)``: ``ref`` stacks JAX's ``rewards``,
        ``dones``, ``legal_mask``, ``behavior_logp``, ``behavior_value``,
        ``after_boards`` and holds ``bootstrap`` and the clear ``gaps``."""
        names = ("legal_mask", "behavior_value", "behavior_logp", "after_boards", "rewards", "dones")
        ref = {k: [] for k in names}
        gaps = []
        for step in range(self.cfg.unroll_len):
            np.testing.assert_array_equal(traj["boards"][step].numpy(), np.asarray(jenv.boards), err_msg=f"step {step}")
            actions = traj["actions"][step].numpy()
            a = jnp.asarray(actions.astype(np.int32))
            noisy, *acted = self.act(params, jenv.boards, jnp.asarray(noise[step].numpy()), a)
            noisy = np.asarray(noisy)
            top2 = np.sort(noisy, -1)[:, -2:]
            gap = top2[:, 1] - top2[:, 0]
            clear = gap > GAP_TOL
            np.testing.assert_array_equal(actions[clear], np.argmax(noisy, -1)[clear], err_msg=f"step {step}")
            gaps.append(gap)
            words = philox.step_words(env0.seed, env0.env_id, env0.counter + step)[:, philox.SPAWN_RANK :]
            jenv, *stepped = self.step(jenv, a, jnp.asarray(words.numpy().astype(np.uint32)))
            for k, v in zip(names, acted + stepped):
                ref[k].append(v)
        ref = {k: jnp.stack(v) for k, v in ref.items()}
        ref["bootstrap"] = self.value(params, jenv.boards)
        ref["gaps"] = np.concatenate(gaps)
        return jenv, ref


def check_rollout(env, batch, jenv, ref, keys):
    """The port's rollout against the reference: integer fields exact, floats
    at rtol 1e-5."""
    for name in ("boards", "score", "steps"):
        np.testing.assert_array_equal(getattr(env, name).numpy(), np.asarray(getattr(jenv, name)), err_msg=name)
    for k in keys:
        got, want = batch[k].numpy(), np.asarray(ref[k])
        if got.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=k)


def assert_params_match(modules, jparams_list, optimizer, lr, steps):
    """SGD: rtol 1e-5; Adam / RMSprop: the moment-sign bound per entry and
    rtol 1e-4 over the whole set (module note)."""
    got, want = [], []
    for module, jp in zip(modules, jparams_list):
        ref = convert.state_dict_from_flax(module, to_numpy(jp))
        for name, value in module.state_dict().items():
            if optimizer == "sgd":
                np.testing.assert_allclose(value.numpy(), ref[name].numpy(), rtol=1e-5, atol=1e-6, err_msg=name)
            else:
                per_step = 2 * lr / (math.sqrt(1 - common.RMSPROP_DECAY) if optimizer == "rmsprop" else 1.0)
                assert float((value - ref[name]).abs().max()) <= per_step * steps, name
            got.append(value.flatten())
            want.append(ref[name].flatten())
    got, want = torch.cat(got), torch.cat(want)
    assert float((got - want).norm() / want.norm()) < 1e-4


class A3CReference:
    """The JAX A3C update (``train/a3c.py:183-278``), from its pieces."""

    def __init__(self, jcfg, jmodel, params):
        self.cfg, self.params = jcfg, params
        self.acting = JaxActing(jcfg, jmodel)
        self.opt = jcommon.make_optimizer(jcfg.optimizer, jcfg.make_learning_rate(), max_grad_norm=jcfg.max_grad_norm)
        self.opt_state = self.opt.init(params)
        T, B = jcfg.unroll_len, jcfg.batch_size

        def loss_fn(p, boards, mask, actions, targets, beta):
            logits, values = jmodel.apply(
                {"params": p}, jcommon.encode_obs(boards.reshape(-1, 4, 4), jcfg.obs_encoding), train=True,
                rngs={"dropout": jax.random.key(0)},
            )
            logits = ja3c.masked_logits(logits.reshape(T, B, 4), mask)
            cfg = ja3c.A3CLossConfig(jcfg.gamma, beta, jcfg.value_coef, jcfg.normalize_advantage, jcfg.parity_drop_last_reward)
            return ja3c.a3c_loss(logits, values.reshape(T, B), actions, targets, cfg)

        def learn(p, opt_state, boards, mask, actions, targets, beta):
            (_, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(p, boards, mask, actions, targets, beta)
            updates, opt_state = self.opt.update(grads, opt_state, p)
            aux["grad_norm"] = jcommon.tree_norm(grads)
            return optax.apply_updates(p, updates), opt_state, aux

        self.learn_fn = jax.jit(learn)

    def update(self, jenv, env0, traj, noise, update_step):
        jenv, ref = self.acting.rollout(self.params, jenv, env0, traj, noise)
        ref["targets"] = ja3c.n_step_returns(
            ref["rewards"], ref["bootstrap"], self.cfg.gamma, dones=ref["dones"],
            parity_drop_last_reward=self.cfg.parity_drop_last_reward,
        )
        self.params, self.opt_state, aux = self.learn_fn(
            self.params, self.opt_state, jnp.asarray(traj["boards"].numpy()), ref["legal_mask"],
            jnp.asarray(traj["actions"].numpy().astype(np.int32)), ref["targets"], jax_beta(self.cfg, update_step),
        )
        return jenv, ref, {k: float(v) for k, v in aux.items()}


def a3c_configs(parity=False, model_kwargs=SMALL, **kw):
    """The port's and JAX's configs of one small float32 trainer."""
    base = {"batch_size": 16, "unroll_len": 6, **kw}

    def make(cls, dtype):
        return (cls.reference_parity if parity else cls)(model_kwargs=model_kwargs + (("dtype", dtype),), **base)

    return make(a3c_train.A3CConfig, torch.float32), make(ja3c_train.A3CConfig, jnp.float32)


def jax_init(jcfg, seed=4):
    jmodel = jcfg.make_model()
    obs = jcommon.encode_obs(jnp.zeros((1, 4, 4), jnp.uint8), jcfg.obs_encoding)
    return jmodel, jax.jit(jmodel.init)(jax.random.key(seed), obs)["params"]


A3C_CASES = {
    # The flagship's defaults on a small float32 ResNet, with the entropy anneal and the cosine lr.
    "resnet-adam": dict(gamma=0.95, learning_rate=1e-3, lr_decay_updates=4, entropy_beta_final=0.002, entropy_decay_updates=2),
    # The reference regime: the MLP on raw tiles, RMSprop, no mask, zero reward.
    "parity": dict(parity=True, model_kwargs=(), unroll_len=8),
    "cnn-sgd": dict(gamma=0.95, model="cnn", model_kwargs=(), optimizer="sgd", learning_rate=0.05),
}


@pytest.mark.parametrize("case", list(A3C_CASES))
def test_a3c_updates_match_reference(case):
    cfg, jcfg = a3c_configs(**A3C_CASES[case])
    jmodel, params = jax_init(jcfg)
    state, model, opt = a3c_train.init_a3c(cfg, 5, device="cpu")
    convert.a3c_state_from_jax(state, to_numpy(params))
    step = a3c_train.make_a3c_step(cfg, model, opt)
    ref = A3CReference(jcfg, jmodel, params)
    env = state.env
    jenv = jax_state(env.boards.numpy().copy(), env.score.numpy().copy(), env.steps.numpy().copy())
    T, B = cfg.unroll_len, cfg.batch_size
    gaps = []
    for u in range(3):
        noise = philox.learner_gumbel(state.seed, state.update_step, (T, B, 4))
        env0 = state.env
        env, batch, rollout_metrics = step.rollout(state)
        jenv, jref, jaux = ref.update(jenv, env0, batch, noise, state.update_step)
        gaps.append(jref["gaps"])
        check_rollout(env, batch, jenv, jref, ("legal_mask",))
        np.testing.assert_allclose(batch["targets"].numpy(), np.asarray(jref["targets"]), rtol=1e-4, atol=1e-5)
        assert float(rollout_metrics["episodes"]) == float(jnp.sum(jref["dones"]))
        metrics = step.learn(state, batch)
        assert set(metrics) == set(jaux)
        for k, v in jaux.items():
            np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-4, atol=1e-6, err_msg=f"{k} update {u}")
        state = dataclasses.replace(state, env=env, update_step=state.update_step + 1)
        assert_params_match([model], [ref.params], cfg.optimizer, cfg.learning_rate, opt.count)
        if case == "parity":
            # Zero reward: the targets are the bootstrap's discounts alone
            # (tests/test_train.py:56-63), not zero.
            assert bool(jnp.all(jref["rewards"] == 0))
            bootstrap = batch["targets"][-1]
            want = a3c.n_step_returns(torch.zeros((T, B)), bootstrap, cfg.gamma, dones=t(jref["dones"]),
                                      parity_drop_last_reward=True)
            assert torch.equal(batch["targets"], want)
    assert opt.count == 3
    assert np.mean(np.concatenate(gaps) > GAP_TOL) > 0.5


def test_a3c_phases_take_the_streams_draws():
    """An update equals its phases driven with the learner's noise and the
    env's words injected; the state names the next draws."""
    cfg, _ = a3c_configs(gamma=0.95, optimizer="sgd", learning_rate=0.02)
    runs = []
    for inject in (False, True):
        state, model, opt = a3c_train.init_a3c(cfg, 6, device="cpu")
        step = a3c_train.make_a3c_step(cfg, model, opt)
        kw = {}
        if inject:
            env, T = state.env, cfg.unroll_len
            steps = torch.arange(T)[:, None]
            kw["bits"] = philox.step_words(env.seed[None], env.env_id[None], env.counter[None] + steps)[..., philox.SPAWN_RANK :]
            kw["noise"] = philox.learner_gumbel(6, 0, (T, cfg.batch_size, 4))
        runs.append(step(state, **kw) + (model,))
    (a, ma, pa), (b, mb, pb) = runs
    assert a.update_step == b.update_step == 1 and a.seed == b.seed == 6
    for name in ("boards", "score", "steps", "counter"):
        assert torch.equal(getattr(a.env, name), getattr(b.env, name))
    assert all(float(ma[k]) == float(mb[k]) for k in ma)
    assert all(torch.equal(x, y) for x, y in zip(pa.parameters(), pb.parameters()))


def test_working_dropout_draws_from_the_learner_stream():
    cfg, _ = a3c_configs(model="mlp", model_kwargs=(("parity_noop_dropout", False),), optimizer="sgd", learning_rate=0.02)
    state, model, opt = a3c_train.init_a3c(cfg, 3, device="cpu")
    step = a3c_train.make_a3c_step(cfg, model, opt)
    n = cfg.unroll_len * cfg.batch_size
    u = step.dropout_draws(state, n, "cpu")
    assert u.shape == (2, n, 64)
    assert torch.equal(u, philox.learner_uniform(3, 0, philox.DROPOUT, (2, n, 64)))
    assert not torch.equal(u, step.dropout_draws(dataclasses.replace(state, update_step=1), n, "cpu"))
    obs = common.encode_obs(state.env.boards.repeat(cfg.unroll_len, 1, 1), cfg.obs_encoding)
    with torch.no_grad():
        hidden = torch.nn.functional.relu6(model.critic_fc(obs.reshape(n, -1)))
        kept = torch.where(u[1] < 0.6, hidden / 0.6, 0.0)
        assert torch.allclose(model(obs, u)[1], model.critic_out(kept)[:, 0])
        assert torch.equal(model(obs)[1], model.critic_out(hidden)[:, 0])  # eval: no dropout
    # The parity default draws nothing.
    parity, _ = a3c_configs(parity=True, model_kwargs=())
    pstate, pmodel, popt = a3c_train.init_a3c(parity, 3, device="cpu")
    assert a3c_train.make_a3c_step(parity, pmodel, popt).dropout_draws(pstate, n, "cpu") is None


def test_a3c_state_from_jax_mid_training():
    """A JAX parity state two RMSprop steps in takes the next step as optax does."""
    cfg, jcfg = a3c_configs(parity=True, model_kwargs=())
    jmodel, params = jax_init(jcfg)
    opt = jcommon.make_optimizer("rmsprop", 1e-3, max_grad_norm=jcfg.max_grad_norm)
    opt_state, rng = opt.init(params), np.random.default_rng(8)

    def grads_like(tree):
        return jax.tree.map(lambda x: jnp.asarray((rng.normal(size=x.shape) * 0.1).astype(np.float32)), tree)

    for _ in range(2):
        updates, opt_state = opt.update(grads_like(params), opt_state, params)
        params = optax.apply_updates(params, updates)
    rms = opt_state[1][0]
    state, model, topt = a3c_train.init_a3c(cfg, 0, device="cpu")
    boards = np.random.default_rng(2).integers(0, 6, (cfg.batch_size, 4, 4)).astype(np.uint8)
    env = {"boards": boards, "score": np.full(cfg.batch_size, 7.0, np.float32), "steps": np.arange(cfg.batch_size),
           "done": np.zeros(cfg.batch_size, bool)}
    convert.a3c_state_from_jax(state, to_numpy(params), nu=to_numpy(rms.nu), env=env)
    assert torch.equal(state.env.boards, t(boards)) and state.env.steps.dtype == torch.int32
    grads = grads_like(params)
    updates, opt_state = opt.update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)
    tgrads = convert.state_dict_from_flax(model, to_numpy(grads))
    topt.step([tgrads[n] for n, _ in model.named_parameters()])
    for name, value in model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), convert.mlp_params_from_flax(to_numpy(params))[name].numpy(),
                                   rtol=1e-6, atol=1e-8, err_msg=name)


# --- the training loop ------------------------------------------------------------------


class TestA3CLoop:
    def test_deterministic_with_jax_record_keys(self):
        cfg, _ = a3c_configs(gamma=0.95)
        runs = [a3c_train.train_a3c(cfg, 2, seed=7, log_every=1, device="cpu") for _ in range(2)]
        (sa, ha), (sb, hb) = runs
        strip = [{k: v for k, v in r.items() if k != "steps_per_sec"} for r in ha + hb]
        assert strip[:2] == strip[2:]
        assert all(torch.equal(x, y) for x, y in zip(sa.model.parameters(), sb.model.parameters()))
        assert set(ha[0]) == {
            "update", "loss", "actor_loss", "critic_loss", "entropy", "grad_norm", "episodes", "avg_episode_tile_sum",
            "avg_episode_length", "best_tile", "steps_per_sec",
        }

    def test_config_json_equals_jax(self):
        def dump(cfg):
            return json.dumps(dataclasses.asdict(cfg), sort_keys=True, default=lambda v: v.name)

        assert dump(a3c_train.A3CConfig()) == dump(ja3c_train.A3CConfig())
        assert dump(a3c_train.A3CConfig.reference_parity(batch_size=32)) == dump(ja3c_train.A3CConfig.reference_parity(batch_size=32))
        port, jx = a3c_train.A3CConfig(lr_decay_updates=10), ja3c_train.A3CConfig(lr_decay_updates=10)
        for count in (0, 1, 5, 10, 30):
            np.testing.assert_allclose(port.make_learning_rate()(count), float(jx.make_learning_rate()(count)), rtol=1e-6)
        anneal = dict(entropy_beta=0.01, entropy_beta_final=0.002, entropy_decay_updates=7)
        for step in (0, 1, 3, 7, 9):
            want = np.float32(jax_beta(ja3c_train.A3CConfig(**anneal), step))
            assert np.float32(a3c_train.entropy_beta_at(a3c_train.A3CConfig(**anneal), step)) == want

    def test_mesh_is_not_yet_ported(self):
        cfg, _ = a3c_configs()
        with pytest.raises(NotImplementedError, match="not yet ported"):
            a3c_train.train_a3c(cfg, 1, mesh=object(), device="cpu")

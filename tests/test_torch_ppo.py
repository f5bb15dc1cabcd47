# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's PPO loss and trainer against the JAX package.

Inputs are made with numpy from fixed seeds; the nets (small float32
ResNets) start from one Flax init carried across by ``models/convert.py``.

Tolerances, as in ``test_torch_a3c``: the loss and its gradients rtol 1e-5;
in whole updates the port's Philox words, Gumbel noise, actions and
shuffles drive a reference composed from the JAX package's pieces
(:class:`PPOReference`): boards, dones and masks exact, behavior log-probs
and values rtol 1e-5, advantages, returns, afterstate targets and the
update's metrics rtol 1e-4 (``approx_kl`` and ``clip_frac`` also atol 1e-6:
the first is a difference of nearly equal terms), parameters after 3
updates rtol 1e-5 with SGD, and the moment-sign bound with Adam.
"""

from __future__ import annotations

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rein48_tpu.agents import a3c as ja3c
from rein48_tpu.agents import ppo as jppo
from rein48_tpu.train import common as jcommon
from rein48_tpu.train import ppo as jppo_train
from rein48_tpu_torch.agents import ppo
from rein48_tpu_torch.engine import philox
from rein48_tpu_torch.models import convert
from rein48_tpu_torch.train import ppo as ppo_train

from torch_dist_ranks import layout

from test_torch_a3c import GAP_TOL, JaxActing, assert_params_match, check_rollout, jax_beta, t, to_numpy
from test_torch_engine import jax_state

torch.set_num_threads(1)

SMALL = (("channels", 8), ("num_blocks", 1))


# --- the loss -------------------------------------------------------------------------


@pytest.mark.parametrize("clip_value", [False, True])
@pytest.mark.parametrize("far", [False, True])
def test_ppo_loss_and_grads_match_jax(clip_value, far):
    """Both value-clip modes; ``far`` puts most ratios outside 1 +- eps,
    where the clipped branch cuts the actor gradient."""
    rng = np.random.default_rng(2 * clip_value + far)
    n = 64
    logits = rng.normal(size=(n, 4)).astype(np.float32)
    values = (rng.normal(size=n) * 4).astype(np.float32)
    actions = rng.integers(0, 4, n).astype(np.int32)
    behavior_logp = (np.log(np.full(n, 0.25)) + rng.normal(size=n) * (1.0 if far else 0.05)).astype(np.float32)
    behavior_values = (values + rng.normal(size=n) * 3).astype(np.float32)
    adv = rng.normal(size=n).astype(np.float32)
    ret = (rng.normal(size=n) * 5).astype(np.float32)
    cfg = dict(clip_eps=0.2, entropy_beta=0.01, value_coef=0.5, clip_value=clip_value, value_clip_eps=1.5)
    others = [jnp.asarray(x) for x in (actions, behavior_logp, behavior_values, adv, ret)]

    def jloss(lg, v):
        return jppo.ppo_loss(lg, v, *others, jppo.PPOLossConfig(**cfg))

    (_, jaux), (jgl, jgv) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(logits), jnp.asarray(values))
    tl, tv = t(logits).requires_grad_(), t(values).requires_grad_()
    loss, aux = ppo.ppo_loss(tl, tv, *(t(x) for x in (actions, behavior_logp, behavior_values, adv, ret)), ppo.PPOLossConfig(**cfg))
    gl, gv = torch.autograd.grad(loss, (tl, tv))
    assert set(aux) == set(jaux)
    for k in aux:
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(gl.numpy(), np.asarray(jgl), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(gv.numpy(), np.asarray(jgv), rtol=1e-5, atol=1e-8)
    if far:
        assert float(aux["clip_frac"]) > 0.5


# --- whole updates ------------------------------------------------------------------------


class PPOReference:
    """The JAX PPO update (``train/ppo.py:222-398``), from its pieces, on the
    port's trajectory, noise and shuffles."""

    def __init__(self, jcfg, jmodel, jafter, params):
        self.cfg, self.params = jcfg, params
        critic = jcfg.afterstate_critic
        self.acting = JaxActing(jcfg, jmodel)
        self.opt = jcommon.make_optimizer(jcfg.optimizer, jcfg.make_learning_rate(), max_grad_norm=jcfg.max_grad_norm)
        self.opt_state = self.opt.init(params)

        def apply(model, p, boards):
            return model.apply({"params": p}, jcommon.encode_obs(boards, jcfg.obs_encoding), train=False)

        def minibatch_loss(p, mb, beta):
            logits, values = apply(jmodel, p["policy"] if critic else p, mb["boards"])
            logits = ja3c.masked_logits(logits, mb["legal_mask"])
            adv = mb["advantages"]
            if jcfg.normalize_advantage:
                adv = (adv - jnp.mean(adv)) / (jnp.std(adv) + 1e-6)
            cfg = jppo.PPOLossConfig(jcfg.clip_eps, beta, jcfg.value_coef, jcfg.clip_value, jcfg.value_clip_eps)
            loss, aux = jppo.ppo_loss(
                logits, values, mb["actions"], mb["behavior_logp"], mb["behavior_value"], adv, mb["returns"], cfg
            )
            if critic:
                v_after = apply(jafter, p["after"], mb["after_boards"])[1]
                after_loss = jnp.mean(jnp.square(v_after - jax.lax.stop_gradient(mb["after_targets"])))
                loss = loss + jcfg.after_coef * after_loss
                aux["after_loss"], aux["loss"] = after_loss, loss
            return loss, aux

        def sgd_step(p, opt_state, mb, beta):
            (_, aux), grads = jax.value_and_grad(minibatch_loss, has_aux=True)(p, mb, beta)
            updates, opt_state = self.opt.update(grads, opt_state, p)
            aux["grad_norm"] = jcommon.tree_norm(grads)
            return optax.apply_updates(p, updates), opt_state, aux

        self.sgd_step = jax.jit(sgd_step)

    def update(self, jenv, env0, batch, noise, perms, update_step):
        cfg, (T, B, M) = self.cfg, (self.cfg.unroll_len, self.cfg.batch_size, self.cfg.num_minibatches)
        policy = self.params["policy"] if cfg.afterstate_critic else self.params
        jenv, ref = self.acting.rollout(policy, jenv, env0, batch, noise)
        ref["advantages"], ref["returns"] = jppo.gae(
            ref["rewards"], ref["behavior_value"], ref["bootstrap"], cfg.gamma, cfg.gae_lambda, dones=ref["dones"]
        )
        data = {k: ref[k] for k in ("legal_mask", "behavior_logp", "behavior_value", "advantages", "returns")}
        data["boards"] = jnp.asarray(batch["boards"].numpy())
        data["actions"] = jnp.asarray(batch["actions"].numpy().astype(np.int32))
        if cfg.afterstate_critic:
            ref["after_targets"] = jppo.afterstate_targets(ref["returns"], ref["bootstrap"], ref["dones"])
            data.update(after_boards=ref["after_boards"], after_targets=ref["after_targets"])
        beta = jax_beta(cfg, update_step)
        for perm in jnp.asarray(perms.numpy()):
            if cfg.shard_friendly_perm:
                mbs = {
                    k: jnp.take_along_axis(x, perm.reshape((T, B) + (1,) * (x.ndim - 2)), axis=0).reshape((M, T // M) + x.shape[1:])
                    for k, x in data.items()
                }
            else:
                mbs = {k: x.reshape((T * B,) + x.shape[2:])[perm].reshape((M, T * B // M) + x.shape[2:]) for k, x in data.items()}
            aux = []
            for m in range(M):
                self.params, self.opt_state, a = self.sgd_step(self.params, self.opt_state, {k: v[m] for k, v in mbs.items()}, beta)
                aux.append(a)
        metrics = {k: float(np.mean([float(a[k]) for a in aux])) for k in aux[0]}
        metrics["approx_kl_last"] = float(aux[-1]["approx_kl"])
        return jenv, ref, metrics


def ppo_configs(**kw):
    """The port's and JAX's configs of one small float32 trainer."""
    base = {"batch_size": 8, "unroll_len": 6, "num_epochs": 2, "num_minibatches": 3, "gamma": 0.95, **kw}

    def make(cls, dt):
        f32 = SMALL + (("dtype", dt),)
        return cls(model_kwargs=f32, after_model_kwargs=f32, **base)

    return make(ppo_train.PPOConfig, torch.float32), make(jppo_train.PPOConfig, jnp.float32)


@functools.lru_cache(maxsize=None)
def flax_init(seed):
    """One init of the small float32 Flax ResNet (every case's net)."""
    jmodel = ppo_configs()[1].make_model()
    return jax.jit(jmodel.init)(jax.random.key(seed), jnp.zeros((1, 4, 4, 16), jnp.float32))["params"]


def jax_init(jcfg, seed=4):
    jmodel = jcfg.make_model()
    if not jcfg.afterstate_critic:
        return jmodel, None, flax_init(seed)
    return jmodel, jcfg.make_after_model(), {"policy": flax_init(seed), "after": flax_init(seed + 1)}


ANNEAL = dict(entropy_beta_final=0.002, entropy_decay_updates=2)
PPO_CASES = {
    "sgd-shard-clipvalue-anneal": dict(optimizer="sgd", learning_rate=0.02, clip_value=True, value_clip_eps=0.5, **ANNEAL),
    "sgd-flat-critic": dict(optimizer="sgd", learning_rate=0.02, shard_friendly_perm=False, afterstate_critic=True),
    "adam-critic-anneal": dict(learning_rate=1e-3, lr_decay_updates=4, afterstate_critic=True, **ANNEAL),
}


@pytest.mark.parametrize("case", list(PPO_CASES))
def test_ppo_updates_match_reference(case):
    cfg, jcfg = ppo_configs(**PPO_CASES[case])
    jmodel, jafter, params = jax_init(jcfg)
    state, model, opt = ppo_train.init_ppo(cfg, 5, device="cpu")
    convert.ppo_state_from_jax(state, to_numpy(params))
    step = ppo_train.make_ppo_step(cfg, model, opt, state.after_model)
    ref = PPOReference(jcfg, jmodel, jafter, params)
    env = state.env
    jenv = jax_state(env.boards.numpy().copy(), env.score.numpy().copy(), env.steps.numpy().copy())
    T, B = cfg.unroll_len, cfg.batch_size
    critic = cfg.afterstate_critic
    keys = ("legal_mask", "behavior_logp", "behavior_value", "advantages", "returns") + (("after_boards", "after_targets") if critic else ())
    gaps = []
    for u in range(3):
        noise = philox.learner_gumbel(state.seed, state.update_step, (T, B, 4))
        perms = step.permutations(state, "cpu")
        env0 = state.env
        env, batch, _ = step.rollout(state)
        jenv, jref, want = ref.update(jenv, env0, batch, noise, perms, state.update_step)
        gaps.append(jref["gaps"])
        check_rollout(env, batch, jenv, jref, keys[:3] + (("after_boards",) if critic else ()))
        for k in ("advantages", "returns") + (("after_targets",) if critic else ()):
            np.testing.assert_allclose(batch[k].numpy(), np.asarray(jref[k]), rtol=1e-4, atol=1e-5, err_msg=k)
        metrics = step.learn(state, batch)  # the stream's own shuffles, which the reference was given
        assert set(metrics) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-4, atol=1e-6, err_msg=f"{k} update {u}")
        state = dataclasses.replace(state, env=env, update_step=state.update_step + 1)
        modules = [model, state.after_model] if critic else [model]
        jparams = [ref.params["policy"], ref.params["after"]] if critic else [ref.params]
        assert_params_match(modules, jparams, cfg.optimizer, cfg.learning_rate, opt.count)
    assert opt.count == 3 * cfg.num_epochs * cfg.num_minibatches
    assert np.mean(np.concatenate(gaps) > GAP_TOL) > 0.5


def test_ppo_phases_take_the_streams_draws():
    """An update equals its phases with the learner's noise and shuffles
    and the env's words injected."""
    cfg, _ = ppo_configs(optimizer="sgd", learning_rate=0.02, afterstate_critic=True)
    runs = []
    for inject in (False, True):
        state, model, opt = ppo_train.init_ppo(cfg, 6, device="cpu")
        step = ppo_train.make_ppo_step(cfg, model, opt, state.after_model)
        kw = {}
        if inject:
            env, T = state.env, cfg.unroll_len
            steps = torch.arange(T)[:, None]
            kw["bits"] = philox.step_words(env.seed[None], env.env_id[None], env.counter[None] + steps)[..., philox.SPAWN_RANK :]
            kw["noise"] = philox.learner_gumbel(6, 0, (T, cfg.batch_size, 4))
            kw["perms"] = step.permutations(state, "cpu")
            assert kw["perms"].shape == (cfg.num_epochs, T, cfg.batch_size)
        runs.append(step(state, **kw) + (state.after_model,))
    (a, ma, aa), (b, mb, ab) = runs
    assert a.update_step == b.update_step == 1
    for name in ("boards", "score", "steps", "counter"):
        assert torch.equal(getattr(a.env, name), getattr(b.env, name))
    assert ma.keys() == mb.keys() and all(float(ma[k]) == float(mb[k]) for k in ma)
    assert all(torch.equal(x, y) for x, y in zip(aa.parameters(), ab.parameters()))
    assert "after_loss" in ma and float(ma["env_steps"]) == cfg.unroll_len * cfg.batch_size


def test_ppo_state_from_jax_mid_training():
    """A JAX critic-carrying state three Adam steps in, carried across with
    its env by ``convert``, takes the next step as optax does."""
    cfg, jcfg = ppo_configs(learning_rate=1e-3, afterstate_critic=True)
    _, _, params = jax_init(jcfg)
    opt = jcommon.make_optimizer("adam", 1e-3, max_grad_norm=jcfg.max_grad_norm)
    opt_state, rng = opt.init(params), np.random.default_rng(12)

    def grads_like(tree):
        return jax.tree.map(lambda x: jnp.asarray((rng.normal(size=x.shape) * 0.1).astype(np.float32)), tree)

    update = jax.jit(opt.update)
    for _ in range(3):
        updates, opt_state = update(grads_like(params), opt_state, params)
        params = optax.apply_updates(params, updates)
    adam = opt_state[1][0]
    state, model, topt = ppo_train.init_ppo(cfg, 0, device="cpu")
    jenv = jax_state(np.random.default_rng(3).integers(0, 5, (cfg.batch_size, 4, 4)).astype(np.uint8))
    env = {k: np.asarray(getattr(jenv, k)) for k in ("boards", "score", "steps", "done")}
    convert.ppo_state_from_jax(state, to_numpy(params), mu=to_numpy(adam.mu), nu=to_numpy(adam.nu), count=np.asarray(adam.count), env=env)
    assert topt.count == 3 and torch.equal(state.env.boards, t(env["boards"]))
    grads = grads_like(params)
    updates, opt_state = update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)
    flat = []
    for module, sub in ((model, "policy"), (state.after_model, "after")):
        g = convert.state_dict_from_flax(module, to_numpy(grads[sub]))
        flat += [g[n] for n, _ in module.named_parameters()]
    topt.step(flat)
    for module, sub in ((model, "policy"), (state.after_model, "after")):
        want = convert.params_from_flax(to_numpy(params[sub]))
        for name, value in module.state_dict().items():
            np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=1e-6, atol=1e-8, err_msg=f"{sub} {name}")


# --- the training loop ----------------------------------------------------------------------


class TestPPOLoop:
    def test_deterministic_with_jax_record_keys(self):
        cfg, _ = ppo_configs(afterstate_critic=True)
        runs = [ppo_train.train_ppo(cfg, 2, seed=7, log_every=1, device="cpu") for _ in range(2)]
        (sa, ha), (sb, hb) = runs
        strip = [{k: v for k, v in r.items() if k != "steps_per_sec"} for r in ha + hb]
        assert strip[:2] == strip[2:]
        assert all(torch.equal(x, y) for x, y in zip(sa.after_model.parameters(), sb.after_model.parameters()))
        assert set(ha[0]) == {
            "update", "loss", "actor_loss", "critic_loss", "entropy", "approx_kl", "clip_frac", "after_loss", "grad_norm",
            "episodes", "avg_episode_tile_sum", "avg_episode_length", "best_tile", "steps_per_sec",
        }
        # The first update's ratios start at 1: approx_kl stays small (tests/test_ppo.py:180-189).
        assert abs(ha[0]["approx_kl"]) < 1e-2

    def test_warm_start_policy_at_lr0_leaves_params(self, capsys):
        cfg, _ = ppo_configs(learning_rate=0.0, afterstate_critic=True)
        donor, _, _ = ppo_train.init_ppo(cfg, 9, device="cpu")
        params = {k: v.clone() for k, v in donor.model.state_dict().items()}
        state, history = ppo_train.train_ppo(cfg, 1, seed=0, warm_start_policy=params, device="cpu")
        assert "warm-started policy params" in capsys.readouterr().out and len(history) == 1
        assert all(torch.equal(v, params[k]) for k, v in state.model.state_dict().items())
        fresh = ppo_train.init_ppo(cfg, 0, device="cpu")[0].after_model
        assert all(torch.equal(x, y) for x, y in zip(state.after_model.parameters(), fresh.parameters()))

    def test_config_json_equals_jax(self):
        def dump(cfg):
            return json.dumps(dataclasses.asdict(cfg), sort_keys=True, default=lambda v: v.name)

        assert dump(ppo_train.PPOConfig()) == dump(jppo_train.PPOConfig())
        port, jx = ppo_train.PPOConfig(lr_decay_updates=10), jppo_train.PPOConfig(lr_decay_updates=10)
        for count in (0, 1, 79, 160, 161, 400):
            np.testing.assert_allclose(port.make_learning_rate()(count), float(jx.make_learning_rate()(count)), rtol=1e-6)

    def test_unsupported_inputs_raise(self):
        cfg, jcfg = ppo_configs(unroll_len=4, num_minibatches=3, batch_size=6)
        # mesh= is ported; a mesh of two ranks needs their process group.
        with pytest.raises(ValueError, match="needs their process group"):
            ppo_train.train_ppo(dataclasses.replace(cfg, num_minibatches=2), 1, mesh=layout(2), device="cpu")
        state, model, opt = ppo_train.init_ppo(cfg, 0, device="cpu")
        with pytest.raises(ValueError, match="divisible by num_minibatches"):
            ppo_train.make_ppo_step(cfg, model, opt)
        with pytest.raises(ValueError, match="divisible by num_minibatches"):
            jppo_train.make_ppo_step(jcfg, jcfg.make_model(), None)
        with pytest.raises(ValueError, match="not divisible by 3"):
            ppo_train.make_ppo_step(dataclasses.replace(cfg, batch_size=5), model, opt)


def test_flops_per_frame_are_mfu_reports_formulas():
    """``benchmarks/mfu_report.py`` reckons PPO as 4 epochs of reuse (and as
    many through the afterstate critic) and A3C as one pass."""
    from rein48_tpu.utils import flops as jflops
    from rein48_tpu_torch.utils import flops

    fwd = 9_994_880.0
    assert flops.ppo_flops_per_frame(4, fwd) == jflops.train_flops_per_frame(fwd, reuse_passes=4)
    assert flops.ppo_flops_per_frame(4, fwd, fwd) == jflops.train_flops_per_frame(
        fwd, reuse_passes=4, extra_forward_flops=fwd, extra_reuse_passes=4
    )
    assert flops.a3c_flops_per_frame(fwd) == jflops.train_flops_per_frame(fwd, reuse_passes=1)

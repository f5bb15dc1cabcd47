# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's afterstate-TD trainer and its pieces against the JAX package.

Inputs are made with numpy from fixed seeds; the ResNet (8 channels, 1
block, float32 on both sides) starts from one Flax init carried across by
``models/convert.py``.

Tolerances. Boards, afterstates, legal masks, merge rewards and
``StepOutput`` are exact; ``log2(1 + r)`` rounds in each library's last
bit (2 ulp). The optimizers follow optax's formulas op for op, so after 6
steps the parameters agree to rtol 1e-6, atol 1e-8 and the moments to
rtol 1e-5, atol 1e-9 (the clip's norm sums in another order, and float32
``pow``/``sqrt`` round on either side). ``gae`` and the targets run
the same float32 operations in the same order: rtol 1e-6. Values go
through two convolution libraries: q at rtol 1e-5, targets and the update's
metrics at rtol 1e-4 (sums of q over the unroll). Greedy actions are
compared where the top two legal q-values are further apart than
``GAP_TOL``, and the port's actions drive both packages. Parameters after
3 whole updates: with SGD at rtol 1e-5, atol 1e-6; with Adam see
:meth:`TestUpdates.test_updates_match_reference`.
"""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rein48_tpu.agents import ppo as jppo
from rein48_tpu.engine import core as jcore
from rein48_tpu.engine import vector as jvector
from rein48_tpu.train import afterstate as jafter
from rein48_tpu.train import common as jcommon
from rein48_tpu_torch.agents import ppo
from rein48_tpu_torch.control import search
from rein48_tpu_torch.engine import philox, vector
from rein48_tpu_torch.models import convert
from rein48_tpu_torch.train import afterstate, common

from test_torch_engine import jax_state, random_boards
from test_torch_search_eval import top_two_gap
from torch_dist_ranks import layout

torch.set_num_threads(1)

GAP_TOL = 1e-4
SMALL = (("channels", 8), ("num_blocks", 1))
B, T, M = 16, 8, 2


def configs(**kw):
    """The port's and JAX's configs of one small float32 trainer."""
    base = dict(batch_size=B, unroll_len=T, num_minibatches=M, num_epochs=2, gamma=0.99)
    base.update(kw)
    return (
        afterstate.AfterstateTDConfig(model_kwargs=SMALL + (("dtype", torch.float32),), **base),
        jafter.AfterstateTDConfig(model_kwargs=SMALL + (("dtype", jnp.float32),), **base),
    )


@pytest.fixture(scope="module")
def jax_net():
    """The small Flax ResNet and one init of its parameters."""
    model = configs()[1].make_model()
    return model, jax.jit(model.init)(jax.random.key(3), jnp.zeros((1, 4, 4, 16), jnp.float32))["params"]


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def assert_params_close(model, jparams, rtol, atol):
    want = convert.params_from_flax(to_numpy(jparams))
    for name, got in model.state_dict().items():
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), rtol=rtol, atol=atol, err_msg=name)


# --- optimizers -------------------------------------------------------------

OPT_CASES = [(n, c, s) for n in common.OPTIMIZERS for c in (None, 0.5) for s in ("constant", "cosine")]


@pytest.mark.parametrize("name, clip, schedule", OPT_CASES)
def test_optimizer_matches_optax(name, clip, schedule):
    rng = np.random.default_rng(len(name) * 10 + (clip is None) * 2 + (schedule == "cosine"))
    shapes = {"a": (3, 4), "b": (5,), "unused": (2, 2)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    lr = 0.05
    jlr = optax.cosine_decay_schedule(lr, 4, alpha=0.1) if schedule == "cosine" else lr
    tlr = common.cosine_decay_schedule(lr, 4, alpha=0.1) if schedule == "cosine" else lr
    jopt = jcommon.make_optimizer(name, jlr, max_grad_norm=clip)
    jstate, jp = jopt.init(params), {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    topt = common.make_optimizer(name, tlr, list(tp.values()), max_grad_norm=clip)
    jupdate = jax.jit(jopt.update)
    for step in range(6):
        # Gradients below and above the clip norm; "unused" gets none (zero).
        scale = 0.01 if step % 2 else 3.0
        grads = {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in shapes.items()}
        grads["unused"] = np.zeros(shapes["unused"], np.float32)
        updates, jstate = jupdate({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        topt.step([None if k == "unused" else torch.from_numpy(grads[k]) for k in tp])
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-8, err_msg=f"{k} step {step}")
    inner = (jstate[1] if clip is not None else jstate)[0]
    for moment in topt.moments:
        for i, k in enumerate(tp):
            np.testing.assert_allclose(
                topt.moments[moment][i].numpy(), np.asarray(getattr(inner, moment)[k]), rtol=1e-5, atol=1e-9
            )
    if name in ("adam", "adamw"):
        assert topt.count == int(inner.count) == 6
    state = topt.state_dict()
    again = common.make_optimizer(name, tlr, [torch.zeros_like(t) for t in tp.values()], max_grad_norm=clip)
    again.load_state_dict(state)
    assert again.count == 6 and all(torch.equal(a, b) for m in again.moments for a, b in zip(again.moments[m], topt.moments[m]))


def test_state_from_jax_mid_training(jax_net):
    """A JAX state three Adam steps in, carried across by ``convert``, takes
    the next step as optax does."""
    cfg, jcfg = configs(learning_rate=1e-3)
    _, params = jax_net
    opt = jcommon.make_optimizer("adam", 1e-3, max_grad_norm=jcfg.max_grad_norm)
    opt_state, rng = opt.init(params), np.random.default_rng(12)

    def grads_like(tree):
        return jax.tree.map(lambda x: jnp.asarray((rng.normal(size=x.shape) * 0.1).astype(np.float32)), tree)

    for _ in range(3):
        updates, opt_state = opt.update(grads_like(params), opt_state, params)
        params = optax.apply_updates(params, updates)
    adam = opt_state[1][0]
    state, model, topt = afterstate.init_afterstate_td(cfg, 0, device="cpu")
    convert.afterstate_state_from_jax(
        state, to_numpy(params), mu=to_numpy(adam.mu), nu=to_numpy(adam.nu), count=np.asarray(adam.count)
    )
    assert topt.count == 3
    grads = grads_like(params)
    updates, opt_state = opt.update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)
    tgrads = convert.params_from_flax(to_numpy(grads))
    topt.step([tgrads[n] for n, _ in model.named_parameters()])
    assert_params_close(model, params, rtol=1e-6, atol=1e-8)


def test_optimizer_rejects_unknown_names():
    with pytest.raises(ValueError, match="unknown optimizer"):
        common.make_optimizer("lamb", 1e-3, [torch.zeros(2)])
    opt = common.make_optimizer("adam", 1e-3, [torch.zeros(2)])
    with pytest.raises(ValueError, match="cannot load"):
        opt.load_state_dict(common.make_optimizer("sgd", 1e-3, [torch.zeros(2)]).state_dict())


# --- gae and afterstate targets ---------------------------------------------


@pytest.mark.parametrize("lam", [0.0, 0.7, 1.0])
@pytest.mark.parametrize("with_dones", [False, True])
def test_gae_and_targets_match_jax(lam, with_dones):
    rng = np.random.default_rng(int(lam * 10) + 100 * with_dones)
    rewards = rng.normal(size=(12, 5)).astype(np.float32)
    values = rng.normal(size=(12, 5)).astype(np.float32)
    bootstrap = rng.normal(size=(5,)).astype(np.float32)
    dones = rng.uniform(size=(12, 5)) < 0.2
    kw = dict(dones=dones) if with_dones else {}
    jadv, jret = jppo.gae(jnp.asarray(rewards), jnp.asarray(values), jnp.asarray(bootstrap), 0.97, lam,
                          **{k: jnp.asarray(v) for k, v in kw.items()})
    adv, ret = ppo.gae(torch.from_numpy(rewards), torch.from_numpy(values), torch.from_numpy(bootstrap), 0.97, lam,
                       **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ret.numpy(), np.asarray(jret), rtol=1e-6, atol=1e-6)
    jt = jppo.afterstate_targets(jret, jnp.asarray(bootstrap), jnp.asarray(dones))
    tt = ppo.afterstate_targets(ret, torch.from_numpy(bootstrap), torch.from_numpy(dones))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6, atol=1e-6)


# --- acting ----------------------------------------------------------------


def test_act_values_match_jax(jax_net):
    cfg, jcfg = configs()
    jmodel, params = jax_net
    state, model, _ = afterstate.init_afterstate_td(cfg, 0, device="cpu")
    convert.afterstate_state_from_jax(state, to_numpy(params))
    boards = random_boards(np.random.default_rng(1), 64)
    jq, jafter_b, jr, jlegal = jax.jit(jafter.make_act_values(jcfg, jmodel))(params, jnp.asarray(boards))
    with torch.no_grad():
        q, after_b, r, legal = afterstate.make_act_values(cfg, model)(torch.from_numpy(boards))
    np.testing.assert_array_equal(after_b.numpy(), np.asarray(jafter_b))
    np.testing.assert_array_equal(legal.numpy(), np.asarray(jlegal))
    # The merge rewards are exact; their log2 rounds in each library's last bit.
    tiled = np.repeat(boards[:, None], 4, axis=1)
    _, jmerge, _ = jax.jit(jcore.move_boards)(jnp.asarray(tiled), jnp.broadcast_to(jnp.arange(4), (64, 4)))
    np.testing.assert_array_equal(search._afterstates(torch.from_numpy(boards))[1].numpy(), np.asarray(jmerge))
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=2.4e-7, atol=0)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-5, atol=1e-6)


def test_acting_is_depth0_planner():
    """The trainer's greedy action is the depth-0 planner with the same leaf."""
    cfg, _ = configs()
    state, model, _ = afterstate.init_afterstate_td(cfg, 1, device="cpu")
    boards = torch.from_numpy(random_boards(np.random.default_rng(2), 256))
    with torch.no_grad():
        q, _, _, legal = afterstate.make_act_values(cfg, model)(boards)
        value = afterstate.make_value_fn(cfg, model)
        planner = search.make_expectimax_policy(
            0, leaf_value=value, reward_fn=lambda r: common.transform_reward(r, cfg.reward_transform),
            gamma=cfg.gamma, death_value=0.0,
        )
        assert torch.equal(search._argmax_legal(q, legal), planner(boards))


def test_epsilon_explores_legal_actions(monkeypatch):
    cfg, _ = configs(epsilon=0.5)
    state, model, opt = afterstate.init_afterstate_td(cfg, 4, device="cpu")
    step = afterstate.make_afterstate_td_step(cfg, model, opt)
    draws = torch.from_numpy(np.random.default_rng(5).uniform(size=(T, 2, B)).astype(np.float32))
    seen = []
    real = vector.step_autoreset

    def recording(env, actions, *a):
        legal = search._afterstates(env.boards)[2]
        seen.append((env.boards.clone(), actions.clone(), legal))
        return real(env, actions, *a)

    greedy_q = afterstate.make_act_values(cfg, model)
    monkeypatch.setattr(vector, "step_autoreset", recording)
    step.rollout(state, draws=draws)
    for t, (boards, actions, legal) in enumerate(seen):
        explore = draws[t, 0] < cfg.epsilon
        n = legal.sum(-1)
        k = (draws[t, 1] * n).floor().long()
        picks = torch.stack([torch.nonzero(row)[i, 0] for row, i in zip(legal, k)])
        with torch.no_grad():
            q = greedy_q(boards)[0]
        greedy = search._argmax_legal(q, legal)
        assert torch.equal(actions, torch.where(explore, picks, greedy)), t
        assert explore.any() and (~explore).any()


def test_flop_convention_against_jax():
    """The port counts every tap of the padded 3x3 convolutions; XLA's cost
    analysis counts the taps inside the board and adds elementwise work."""
    from rein48_tpu.models import nets as jnets
    from rein48_tpu.utils import flops as jflops
    from rein48_tpu_torch.models import nets
    from rein48_tpu_torch.utils import flops

    port = flops.model_forward_flops(nets.ResNetPolicy(64, 4))
    jx = jflops.model_forward_flops(jnets.ResNetPolicy(64, 4))
    assert port == 9_994_880 and round(jx) == 7_219_126
    assert port / jx == pytest.approx(1.3845, abs=5e-5)


# --- whole updates ------------------------------------------------------------


class ReferenceUpdate:
    """The JAX trainer's update, composed from the JAX package's public pieces.

    It acts with ``make_act_values``, steps the boards with
    ``vector._step_autoreset_from_bits`` fed the port's Philox words and the
    port's actions, builds targets with ``ppo.gae``/``afterstate_targets``,
    and learns with ``make_value_fn`` and ``common.make_optimizer`` on the
    same shuffles as the port.
    """

    def __init__(self, jcfg, jmodel, params):
        self.cfg, self.params = jcfg, params
        self.opt = jcommon.make_optimizer(jcfg.optimizer, jcfg.make_learning_rate(), max_grad_norm=jcfg.max_grad_norm)
        self.opt_state = self.opt.init(params)
        self.act = jax.jit(jafter.make_act_values(jcfg, jmodel))
        value = jafter.make_value_fn(jcfg, jmodel)

        def loss_fn(p, boards, targ):
            v = value(p, boards)
            return jnp.mean(jnp.square(v - targ)), v

        def sgd_step(p, opt_state, boards, targ):
            (loss, v), grads = jax.value_and_grad(loss_fn, has_aux=True)(p, boards, targ)
            updates, opt_state = self.opt.update(grads, opt_state, p)
            aux = dict(loss=loss, v_mean=jnp.mean(v), target_mean=jnp.mean(targ), grad_norm=jcommon.tree_norm(grads))
            return optax.apply_updates(p, updates), opt_state, aux

        self.sgd_step = jax.jit(sgd_step)
        self.step = jax.jit(
            jax.vmap(lambda s, a, w: jvector._step_autoreset_from_bits(s, s.key, a, w, jcore.RewardMode.MERGE_SCORE))
        )

    def rollout(self, jenv, env0, seen):
        """Steps with the port's actions; returns the env, the batch, the
        greedy actions' top-two gaps and whether they equal the port's."""
        idx = jnp.arange(B)
        after_b, rewards, dones, values, gaps = [], [], [], [], []
        for t, (actions, out) in enumerate(seen):
            q, after, r_tr, legal = self.act(self.params, jenv.boards)
            qn, ln = np.asarray(q), np.asarray(legal)
            greedy = np.argmax(np.where(ln, qn, -np.inf), axis=-1)
            gap = top_two_gap(qn, ln)
            clear = gap > GAP_TOL
            np.testing.assert_array_equal(actions.numpy()[clear], greedy[clear], err_msg=f"step {t}")
            gaps.append(gap)
            a = jnp.asarray(actions.numpy().astype(np.int32))
            after_b.append(after[idx, a])
            rewards.append(r_tr[idx, a])
            values.append(q[idx, a])
            words = philox.step_words(env0.seed, env0.env_id, env0.counter + t)[:, philox.SPAWN_RANK :]
            jenv, jout = self.step(jenv, a, jnp.asarray(words.numpy().astype(np.uint32)))
            for f in dataclasses.fields(vector.StepOutput):
                np.testing.assert_array_equal(getattr(out, f.name).numpy(), np.asarray(getattr(jout, f.name)), err_msg=f.name)
            dones.append(jout.done)
        q_T, _, _, legal_T = self.act(self.params, jenv.boards)
        u_T = jnp.where(~jnp.any(legal_T, -1), 0.0, jnp.max(jnp.where(legal_T, q_T, -jnp.inf), -1))
        dones = jnp.stack(dones)
        _, returns = jppo.gae(jnp.stack(rewards), jnp.stack(values), u_T, self.cfg.gamma, self.cfg.td_lambda, dones=dones)
        return jenv, jnp.stack(after_b), jppo.afterstate_targets(returns, u_T, dones), np.concatenate(gaps)

    def learn(self, boards, targets, perms):
        for perm in perms:
            if self.cfg.shard_friendly_perm:
                sb = jnp.take_along_axis(boards, perm[:, :, None, None], axis=0).reshape((M, -1, 4, 4))
                st = jnp.take_along_axis(targets, perm, axis=0).reshape((M, -1))
            else:
                sb = boards.reshape((-1, 4, 4))[perm].reshape((M, -1, 4, 4))
                st = targets.reshape(-1)[perm].reshape((M, -1))
            aux = []
            for m in range(M):
                self.params, self.opt_state, a = self.sgd_step(self.params, self.opt_state, sb[m], st[m])
                aux.append(a)
        return {k: float(np.mean([float(a[k]) for a in aux])) for k in aux[0]}


class TestUpdates:
    UPDATES = 3

    @pytest.mark.parametrize(
        "optimizer, lr, shard_friendly",
        [("sgd", 0.02, True), ("sgd", 0.02, False), ("adam", 1e-3, True)],
    )
    def test_updates_match_reference(self, optimizer, lr, shard_friendly, monkeypatch, jax_net):
        cfg, jcfg = configs(optimizer=optimizer, learning_rate=lr, shard_friendly_perm=shard_friendly, lr_decay_updates=4)
        jmodel, params = jax_net
        state, model, opt = afterstate.init_afterstate_td(cfg, 5, device="cpu")
        convert.afterstate_state_from_jax(state, to_numpy(params))
        step = afterstate.make_afterstate_td_step(cfg, model, opt)
        ref = ReferenceUpdate(jcfg, jmodel, params)

        seen = []
        real = vector.step_autoreset

        def recording(env, actions, *a):
            env2, out = real(env, actions, *a)
            seen.append((actions.clone(), out))
            return env2, out

        monkeypatch.setattr(vector, "step_autoreset", recording)
        rng = np.random.default_rng(9)
        env = state.env
        jenv = jax_state(env.boards.numpy().copy(), env.score.numpy().copy(), env.steps.numpy().copy())
        gaps = []
        for _ in range(self.UPDATES):
            env0, seen[:] = state.env, []
            env, batch, rollout_metrics = step.rollout(state)
            assert len(seen) == T
            jenv, jboards, jtargets, gap = ref.rollout(jenv, env0, seen)
            gaps.append(gap)
            np.testing.assert_array_equal(batch["after_boards"].numpy(), np.asarray(jboards))
            np.testing.assert_allclose(batch["targets"].numpy(), np.asarray(jtargets), rtol=1e-4, atol=1e-5)
            for name in ("boards", "score", "steps"):
                np.testing.assert_array_equal(getattr(env, name).numpy(), np.asarray(getattr(jenv, name)))

            if shard_friendly:
                perms = np.stack([np.argsort(rng.uniform(size=(T, B)), axis=0) for _ in range(cfg.num_epochs)])
            else:
                perms = np.stack([rng.permutation(T * B) for _ in range(cfg.num_epochs)])
            metrics = step.learn(state, batch, perms=torch.from_numpy(perms))
            want = ref.learn(jboards, jtargets, jnp.asarray(perms))
            for k, v in want.items():
                np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-4, err_msg=k)
            state = dataclasses.replace(state, env=env, update_step=state.update_step + 1)
            if optimizer == "sgd":
                assert_params_close(model, ref.params, rtol=1e-5, atol=1e-6)
            else:
                # Adam divides each moment by the root of its square, so a
                # near-zero gradient entry that the two libraries round to
                # opposite signs moves its weight by +lr in one and -lr in
                # the other: entries may differ by up to 2 * lr per step.
                # Every entry is held to that, and the parameters as a
                # whole to rtol 1e-4.
                want_p = convert.params_from_flax(to_numpy(ref.params))
                steps = opt.count
                for name, got in model.state_dict().items():
                    diff = (got - want_p[name]).abs()
                    assert float(diff.max()) <= 2 * lr * steps, name
                got = torch.cat([p.flatten() for p in model.state_dict().values()])
                want_all = torch.cat([want_p[n].flatten() for n in model.state_dict()])
                assert float((got - want_all).norm() / want_all.norm()) < 1e-4
        assert opt.count == self.UPDATES * cfg.num_epochs * M
        gaps = np.concatenate(gaps)
        assert np.mean(gaps > GAP_TOL) > 0.5

    def test_step_runs_both_phases_and_bits_are_the_streams(self):
        cfg, _ = configs(optimizer="sgd", learning_rate=0.02)
        runs = []
        for inject in (False, True):
            state, model, opt = afterstate.init_afterstate_td(cfg, 6, device="cpu")
            step = afterstate.make_afterstate_td_step(cfg, model, opt)
            env = state.env
            bits = None
            if inject:
                t = torch.arange(T)[:, None]
                bits = philox.step_words(env.seed[None], env.env_id[None], env.counter[None] + t)[..., philox.SPAWN_RANK :]
            state, metrics = step(state, bits=bits)
            runs.append((state, metrics))
        (a, ma), (b, mb) = runs
        assert a.update_step == b.update_step == 1 and torch.equal(a.env.counter, b.env.counter)
        for name in ("boards", "score", "steps"):
            assert torch.equal(getattr(a.env, name), getattr(b.env, name))
        assert ma.keys() == mb.keys() and all(float(ma[k]) == float(mb[k]) for k in ma)
        assert float(ma["env_steps"]) == B * T and all(np.isfinite(float(v)) for v in ma.values())


# --- the training loop -----------------------------------------------------------


class TestTrainingLoop:
    def test_deterministic_given_seed(self):
        cfg, _ = configs()
        runs = [afterstate.train_afterstate_td(cfg, 2, seed=7, log_every=1, device="cpu") for _ in range(2)]
        (sa, ha), (sb, hb) = runs
        strip = [{k: v for k, v in r.items() if k != "steps_per_sec"} for r in ha + hb]
        assert strip[:2] == strip[2:]
        for (k, x), y in zip(sa.model.state_dict().items(), sb.model.state_dict().values()):
            assert torch.equal(x, y), k
        assert set(ha[0]) == {
            "update", "loss", "v_mean", "target_mean", "grad_norm", "episodes", "avg_episode_tile_sum",
            "avg_episode_length", "best_tile", "steps_per_sec",
        }

    def test_warm_start_at_lr0_leaves_params(self, capsys):
        cfg, _ = configs(learning_rate=0.0)
        donor, _, _ = afterstate.init_afterstate_td(cfg, 9, device="cpu")
        params = {k: v.clone() for k, v in donor.model.state_dict().items()}
        state, history = afterstate.train_afterstate_td(cfg, 1, seed=0, warm_start_params=params, device="cpu")
        assert "warm-started" in capsys.readouterr().out and len(history) == 1
        for k, v in state.model.state_dict().items():
            assert torch.equal(v, params[k]), k

    def test_unsupported_inputs_raise(self, jax_net):
        cfg, _ = configs()
        # mesh= is ported; a mesh of two ranks needs their process group.
        with pytest.raises(ValueError, match="needs their process group"):
            afterstate.train_afterstate_td(cfg, 1, mesh=layout(2), device="cpu")
        bad, jbad = configs(unroll_len=6, num_minibatches=4)
        state, model, opt = afterstate.init_afterstate_td(bad, 0, device="cpu")
        with pytest.raises(ValueError, match="divisible by num_minibatches"):
            afterstate.make_afterstate_td_step(bad, model, opt)
        with pytest.raises(ValueError, match="divisible by num_minibatches"):
            jafter.make_afterstate_td_step(jbad, jax_net[0], None)

    def test_config_json_equals_jax(self):
        def dump(cfg):
            return json.dumps(dataclasses.asdict(cfg), sort_keys=True, default=lambda v: v.name)

        assert dump(afterstate.AfterstateTDConfig()) == dump(jafter.AfterstateTDConfig())
        port, jx = configs(lr_decay_updates=10)
        assert set(dataclasses.asdict(port)) == set(dataclasses.asdict(jx))
        lr, jlr = port.make_learning_rate(), jx.make_learning_rate()
        for count in (0, 1, 39, 80, 81, 200):
            np.testing.assert_allclose(lr(count), float(jlr(count)), rtol=1e-6)

# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's n-tuple network and trainer against the JAX package.

Both start from the same tables (``convert.ntuple_params_from_jax``) and
the same boards and errors, made with numpy from fixed seeds. The port's
``"torch"`` backend is held against JAX's ``"xla"``; the port's ``"mxu"``
backend, which on the CPU runs the plain versions of its kernels, against
JAX's ``"mxu"``, whose Pallas kernels run in interpret mode here.

Tolerances. Lookup indices, boards, actions and ``StepOutput`` are
integers or exact and are compared for equality. Values sum the same
float32 lookups in the same order as JAX (lookups, then tables) and are
held at rtol 1e-5. TD updates scatter-add float32 deltas, which JAX's
``"mxu"`` kernels reassociate (``rein48_tpu/ops/tables.py:246-251``);
tables and metrics are held at rtol 1e-5, atol 1e-6, the tolerance of
``tests/test_ntuple.py::TestMXUBackend``. Greedy actions are compared
where the top two legal q-values are further apart than ``GAP_TOL``; the
tests assert that the compared share is large, and where they drive both
packages with one side's actions they say so.
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

from rein48_tpu.agents import ntuple as jntuple
from rein48_tpu.control import search as jsearch
from rein48_tpu.engine import core as jcore
from rein48_tpu.engine import vector as jvector
from rein48_tpu.train import evaluate as jevaluate
from rein48_tpu.train import ntuple as jtrain
from rein48_tpu_torch import cli
from rein48_tpu_torch.agents import ntuple
from rein48_tpu_torch.engine import philox, vector
from rein48_tpu_torch.models import convert
from rein48_tpu_torch.ops import hbm_tables
from rein48_tpu_torch.train import ntuple as train
from rein48_tpu_torch.utils import profiling

from test_torch_engine import jax_state, random_boards
from test_torch_search_eval import top_two_gap
from torch_dist_ranks import one_rank, without_rate

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
GAP_TOL = 1e-4
BACKENDS = [("torch", "xla"), ("mxu", "mxu")]
SHAPES = {"tiny": ntuple.TINY_2X3, "sj": ntuple.SJ_2X4}


def nets(tuples, backend, jbackend, symmetric=True):
    tnet = ntuple.NTupleNetwork(ntuple.NTupleConfig(tuples=tuples, backend=backend, symmetric=symmetric))
    jnet = jntuple.NTupleNetwork(jntuple.NTupleConfig(tuples=tuples, backend=jbackend, symmetric=symmetric))
    return tnet, jnet


def random_tables(jnet, seed: int, tc: bool = False) -> dict:
    """Normal tables (and positive-ish accumulators), numpy, JAX key names."""
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in sorted(jnet.init().items())}
    if tc:
        for k in list(params):
            params[f"{k}_E"] = rng.normal(size=params[k].shape).astype(np.float32)
            params[f"{k}_A"] = np.abs(params[f"{k}_E"]) * rng.uniform(1.0, 3.0, params[k].shape).astype(np.float32)
    return params


def both(params: dict):
    """The same tables for the port (fresh tensors) and for JAX."""
    return convert.ntuple_params_from_jax(params, "cpu"), {k: jnp.asarray(v) for k, v in params.items()}


def assert_tables_close(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL, atol=ATOL, err_msg=k)


def td_inputs(n: int, seed: int):
    rng = np.random.default_rng(seed)
    boards = random_boards(rng, n)
    err = rng.normal(size=n).astype(np.float32)
    err[::5] = 0.0  # masked backups
    err[1::7] = -0.0
    return boards, err


class TestNetwork:
    def test_constants_match_jax(self):
        np.testing.assert_array_equal(ntuple._symmetry_maps(), jntuple._symmetry_maps())
        assert (ntuple.BASE, ntuple.YEH_4X6, ntuple.SJ_2X4, ntuple.TINY_2X3) == (
            jntuple.BASE, jntuple.YEH_4X6, jntuple.SJ_2X4, jntuple.TINY_2X3,
        )
        for name in ("tiny", "sj"):
            tnet, jnet = nets(SHAPES[name], "torch", "xla")
            assert tnet.table_sizes == jnet.table_sizes and tnet.num_lookups == jnet.num_lookups

    @pytest.mark.parametrize("tuples", [ntuple.TINY_2X3, ntuple.SJ_2X4, ntuple.YEH_4X6])
    @pytest.mark.parametrize("symmetric", [True, False])
    def test_indices_equal(self, tuples, symmetric):
        tnet, jnet = nets(tuples, "torch", "xla", symmetric)
        boards = random_boards(np.random.default_rng(0), 96).reshape(8, 3, 4, 4, 4)
        boards[0, 0, 0] = 15  # the largest digit in every cell
        got = tnet.indices(torch.from_numpy(boards))
        want = jnet.indices(jnp.asarray(boards))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    @pytest.mark.parametrize("shape", sorted(SHAPES))
    @pytest.mark.parametrize("backend, jbackend", BACKENDS)
    def test_value_matches(self, shape, backend, jbackend):
        tnet, jnet = nets(SHAPES[shape], backend, jbackend)
        tp, jp = both(random_tables(jnet, 1))
        boards = random_boards(np.random.default_rng(2), 64).reshape(16, 4, 4, 4)
        got = tnet.value(tp, torch.from_numpy(boards))
        want = np.asarray(jnet.value(jp, jnp.asarray(boards)))
        assert got.shape == want.shape == (16, 4)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)

    @pytest.mark.parametrize("shape", sorted(SHAPES))
    @pytest.mark.parametrize("backend, jbackend", BACKENDS)
    @pytest.mark.parametrize("collision", ["mean", "sum"])
    def test_td_apply_matches(self, shape, backend, jbackend, collision):
        tnet, jnet = nets(SHAPES[shape], backend, jbackend)
        tp, jp = both(random_tables(jnet, 3))
        boards, err = td_inputs(48, 4)
        got = tnet.td_apply(tp, torch.from_numpy(boards), torch.from_numpy(err), 0.3, collision=collision)
        want = jnet.td_apply(jp, jnp.asarray(boards), jnp.asarray(err), 0.3, collision=collision)
        assert got is tp  # updated in place
        assert_tables_close(got, want)

    @pytest.mark.parametrize("shape", sorted(SHAPES))
    @pytest.mark.parametrize("backend, jbackend", BACKENDS)
    def test_td_apply_tc_matches_over_three_calls(self, shape, backend, jbackend):
        tnet, jnet = nets(SHAPES[shape], backend, jbackend)
        tp, jp = both({k: np.asarray(v) for k, v in jnet.init_tc().items()})
        boards, err = td_inputs(40, 5)
        for step in range(3):  # the accumulators evolve across calls
            e = err + np.float32(step) * (err != 0)
            tnet.td_apply_tc(tp, torch.from_numpy(boards), torch.from_numpy(e), 0.5)
            jp = jnet.td_apply_tc(jp, jnp.asarray(boards), jnp.asarray(e), 0.5)
            jax.block_until_ready(jp)  # interpret mode under async dispatch can deadlock
        assert_tables_close(tp, jp)
        assert float(tp["t0_A"].max()) > 0

    @pytest.mark.parametrize("shape", sorted(SHAPES))
    @pytest.mark.parametrize("backend, jbackend", BACKENDS)
    @pytest.mark.parametrize("tc", [True, False])
    def test_td_apply_delayed_matches(self, shape, backend, jbackend, tc):
        tnet, jnet = nets(SHAPES[shape], backend, jbackend)
        tp, jp = both(random_tables(jnet, 6, tc=tc))
        boards, err = td_inputs(96, 7)
        boards[48:] = boards[:48]  # entries hit several times in the window
        got = tnet.td_apply_delayed(tp, torch.from_numpy(boards), torch.from_numpy(err), 0.4, tc=tc)
        want = jnet.td_apply_delayed(jp, jnp.asarray(boards), jnp.asarray(err), 0.4, tc=tc)
        assert_tables_close(got, want)

    def test_value_is_symmetry_invariant(self):
        tnet, jnet = nets(ntuple.SJ_2X4, "torch", "xla")
        tp, _ = both(random_tables(jnet, 8))
        boards = torch.from_numpy(random_boards(np.random.default_rng(9), 32))
        v = tnet.value(tp, boards)
        for k in range(4):
            for flip in (False, True):
                b = boards.flip(-1) if flip else boards
                torch.testing.assert_close(tnet.value(tp, torch.rot90(b, k, (-2, -1))), v, rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("backend", ["torch", "mxu"])
    def test_chunked_leaf_equals_unchunked(self, backend):
        tnet, jnet = nets(ntuple.TINY_2X3, backend, "xla")
        tp, _ = both(random_tables(jnet, 10))
        boards = torch.from_numpy(random_boards(np.random.default_rng(11), 300).reshape(3, 25, 4, 4, 4))
        whole = tnet.make_leaf(tp, max_batch=4096)(boards)
        chunked = tnet.make_leaf(tp, max_batch=64)(boards)  # 300 boards: four chunks, the last ragged
        assert whole.shape == (3, 25, 4)
        assert torch.equal(whole, chunked)

    def test_mxu_runs_no_kernel_on_the_cpu(self):
        tnet, jnet = nets(ntuple.TINY_2X3, "mxu", "xla")
        tp, _ = both({k: np.asarray(v) for k, v in jnet.init_tc().items()})
        boards, err = td_inputs(8, 12)
        names = ("tables.table_gather", "tables.table_scatter", "ntuple_value.launches")
        before = [profiling.counters.get(k, 0) for k in names]
        tnet.td_apply_tc(tp, torch.from_numpy(boards), torch.from_numpy(err), 0.5)
        tnet.value(tp, torch.from_numpy(boards))
        assert [profiling.counters.get(k, 0) for k in names] == before

    def test_backends_validated(self):
        with pytest.raises(ValueError, match="mxu"):
            ntuple.NTupleNetwork(ntuple.NTupleConfig(tuples=((0, 1, 2, 3, 4, 5),), backend="mxu"))
        for make in (ntuple.NTupleNetwork, jntuple.NTupleNetwork):  # tables of 4096 entries
            with pytest.raises(ValueError, match="backend='cached' needs table sizes divisible by 16384"):
                make(type(make().config)(tuples=ntuple.TINY_2X3, backend="cached"))
        for prefix_rows, want in ((32, (128, 128)), (300, (256, 256)), (10**6, (512, 512))):
            tnet, jnet = (
                make(type(make().config)(tuples=ntuple.SJ_2X4, backend="cached", prefix_rows=prefix_rows))
                for make in (ntuple.NTupleNetwork, jntuple.NTupleNetwork)
            )
            assert tnet.prefix_rows == jnet.prefix_rows == want
        with pytest.raises(ValueError, match="'torch' is the JAX package's 'xla'"):
            ntuple.NTupleNetwork(ntuple.NTupleConfig(backend="xla"))
        tnet, _ = nets(ntuple.TINY_2X3, "torch", "xla")
        with pytest.raises(ValueError, match="collision"):
            tnet.td_apply(tnet.init("cpu"), torch.zeros((1, 4, 4), dtype=torch.uint8), torch.ones(1), 0.1, "max")

    def test_params_from_jax_checks_shapes(self):
        _, jnet = nets(ntuple.TINY_2X3, "torch", "xla")
        params = {k: np.asarray(v, np.float64) for k, v in jnet.init_tc().items()}
        out = convert.ntuple_params_from_jax(params, "cpu")
        assert sorted(out) == sorted(params) and all(t.dtype == torch.float32 for t in out.values())
        for bad, match in (
            ({**params, "t0": np.zeros(1000, np.float32)}, "16\\*\\*k"),
            ({**params, "t1_E": np.zeros(256, np.float32)}, "its table"),
            ({**params, "t0_rm": np.zeros(32, np.int32)}, "permutation of the 32 rows"),
            ({**params, "t0_rm": np.arange(32, dtype=np.int64)}, "flat int32"),
            ({**params, "t0_rm": np.arange(16, dtype=np.int32)}, "permutation of the 32 rows"),
            ({**params, "t0_rm": np.arange(32, dtype=np.int32), "t0_hot": np.array([0, 0], np.int32)}, "distinct"),
            ({**params, "t0_rm": np.arange(32, dtype=np.int32), "t0_hot": np.array([1, 0], np.int32)}, "rm\\[hot"),
            ({**params, "t0_hot": np.arange(4, dtype=np.int32)}, "rm\\[hot"),  # no row map
            ({**params, "t0_hot": np.arange(33, dtype=np.int32)}, "at most 32 distinct rows"),
            ({**params, "t0_Q": params["t0"]}, "unexpected"),
        ):
            with pytest.raises(ValueError, match=match):
                convert.ntuple_params_from_jax(bad, "cpu")
        # The "cached" backend's row maps come across as int32.
        jnet = jntuple.NTupleNetwork(jntuple.NTupleConfig(tuples=ntuple.SJ_2X4, backend="cached", prefix_rows=128))
        params = {k: np.asarray(v) for k, v in jnet.refresh_cache(jnet.init_tc()).items()}
        out = convert.ntuple_params_from_jax(params, "cpu")
        assert sorted(out) == sorted(params)
        for k, v in params.items():
            assert out[k].dtype == (torch.int32 if k.endswith(("_rm", "_hot")) else torch.float32), k
            np.testing.assert_array_equal(out[k].numpy(), v)


class ReferenceTrainer:
    """The JAX trainer's step, composed from the JAX package's public pieces.

    It acts greedily on ``r + V(afterstate)`` with JAX's ``NTupleNetwork``
    and steps the boards with ``vector._step_autoreset_from_bits`` fed the
    port's Philox words, so that both packages see the same spawns.
    """

    def __init__(self, cfg: jtrain.NTupleTrainConfig):
        self.cfg = cfg
        self.net = jntuple.NTupleNetwork(cfg.network_config())
        self._step = jax.jit(
            jax.vmap(lambda s, a, w: jvector._step_autoreset_from_bits(s, s.key, a, w, jcore.RewardMode.MERGE_SCORE))
        )
        self._q = jax.jit(self._q_values)
        self._value = jax.jit(self.net.value)

    def _q_values(self, params, boards):
        after, reward, legal = jtrain._all_afterstates(boards)
        v_after = self.net.value(params, after)
        return jnp.where(legal, reward + v_after, -jnp.inf), reward, v_after, after, legal

    def policy_step(self, params, env, prev_after, prev_valid, words):
        q, reward, v_after, after, legal = self._q(params, env.boards)
        action = jnp.argmax(q, axis=-1).astype(jnp.int32)
        idx = jnp.arange(q.shape[0])
        r_chosen, v_chosen, chosen_after = reward[idx, action], v_after[idx, action], after[idx, action]
        err_prev = (r_chosen + v_chosen - self._value(params, prev_after)) * prev_valid
        env2, out = self._step(env, action, words)
        done = out.done.astype(jnp.float32)
        err_term = (0.0 - v_chosen) * done
        gap = top_two_gap(np.asarray(q), np.asarray(legal))
        return env2, action, out, chosen_after, done, gap, (
            jnp.concatenate([prev_after, chosen_after]),
            jnp.concatenate([err_prev, err_term]),
            jnp.sum(jnp.abs(err_prev)),
            jnp.sum(prev_valid),
        )

    def apply(self, params, boards, errs):
        cfg = self.cfg
        if cfg.update_mode == "delayed":
            return self.net.td_apply_delayed(params, boards, errs, cfg.alpha, tc=cfg.tc)
        if cfg.tc:
            return self.net.td_apply_tc(params, boards, errs, cfg.alpha)
        return self.net.td_apply(params, boards, errs, cfg.alpha, collision=cfg.collision)


class TestTrainer:
    """The slice as a whole: updates of the port's ``make_ntuple_step``."""

    B, T, UPDATES = 16, 8, 3

    @pytest.mark.parametrize("mode", ["step", "delayed"])
    def test_updates_match_reference(self, mode, monkeypatch):
        kw = dict(batch_size=self.B, steps_per_update=self.T, tuples=ntuple.TINY_2X3, update_mode=mode)
        cfg = train.NTupleTrainConfig(table_backend="torch", **kw)
        ref = ReferenceTrainer(jtrain.NTupleTrainConfig(table_backend="xla", **kw))
        state, _ = train.init_ntuple(cfg, seed=5, device="cpu")
        step = train.make_ntuple_step(cfg, device="cpu")

        # Record the port's actions and StepOutput from inside its update.
        seen = []
        real_step = vector.step_autoreset

        def recording_step(env, actions, *a):
            env2, out = real_step(env, actions, *a)
            seen.append((actions.clone(), out))
            return env2, out

        monkeypatch.setattr(vector, "step_autoreset", recording_step)

        # Copies: jnp.asarray may alias numpy memory, and the port updates its tables in place.
        jparams = {k: jnp.array(v.numpy(), copy=True) for k, v in state.params.items()}
        jenv = jax_state(state.env.boards.numpy().copy(), state.env.score.numpy().copy(), state.env.steps.numpy().copy())
        prev_after, prev_valid = jnp.array(state.prev_after.numpy(), copy=True), jnp.array(state.prev_valid.numpy(), copy=True)
        window = cfg.delay_window if mode == "delayed" else 1
        gaps = []
        for _ in range(self.UPDATES):
            env0, seen[:] = state.env, []
            state, metrics = step(state)
            assert len(seen) == self.T
            sums = dict(episodes=0.0, episode_score_sum=0.0, episode_tile_sum_sum=0.0, episode_length_sum=0.0)
            best, abs_err, updates = 0.0, 0.0, 0.0
            upd = []
            for t in range(self.T):
                counter = env0.counter + t
                words = philox.step_words(env0.seed, env0.env_id, counter)[:, philox.SPAWN_RANK :]
                jenv, jaction, jout, prev_after, done, gap, (ub, ue, ae, nu) = ref.policy_step(
                    jparams, jenv, prev_after, prev_valid, jnp.asarray(words.numpy().astype(np.uint32))
                )
                prev_valid = 1.0 - done
                gaps.append(gap)
                taction, tout = seen[t]
                np.testing.assert_array_equal(taction.numpy(), np.asarray(jaction))
                for f in dataclasses.fields(vector.StepOutput):
                    np.testing.assert_array_equal(
                        getattr(tout, f.name).numpy(), np.asarray(getattr(jout, f.name)), err_msg=f.name
                    )
                sums["episodes"] += float(jnp.sum(done))
                sums["episode_score_sum"] += float(jnp.sum(jout.episode_score))
                sums["episode_tile_sum_sum"] += float(jnp.sum(jout.episode_tile_sum))
                sums["episode_length_sum"] += float(jnp.sum(jout.episode_length))
                best = max(best, float(jnp.max(jout.max_tile)))
                abs_err, updates = abs_err + float(ae), updates + float(nu)
                upd.append((ub, ue))
                if len(upd) == window:
                    jparams = ref.apply(jparams, jnp.concatenate([b for b, _ in upd]), jnp.concatenate([e for _, e in upd]))
                    upd = []
            np.testing.assert_array_equal(state.env.boards.numpy(), np.asarray(jenv.boards))
            np.testing.assert_array_equal(state.env.score.numpy(), np.asarray(jenv.score))
            np.testing.assert_array_equal(state.env.steps.numpy(), np.asarray(jenv.steps))
            np.testing.assert_array_equal(state.prev_after.numpy(), np.asarray(prev_after))
            np.testing.assert_array_equal(state.prev_valid.numpy(), np.asarray(prev_valid))
            assert_tables_close(state.params, jparams)
            for k, v in sums.items():
                np.testing.assert_allclose(float(metrics[k]), v, rtol=RTOL, err_msg=k)
            assert float(metrics["best_tile"]) == best
            np.testing.assert_allclose(float(metrics["td_abs_err"]), abs_err / max(updates, 1.0), rtol=RTOL, atol=ATOL)
            assert float(metrics["env_steps"]) == self.B * self.T
        assert state.update_step == self.UPDATES
        # Actions were compared at every step: exact ties (untouched tables)
        # break to the first index in both, and the values are bit-equal
        # here, so near-ties break alike too. Record how often they occur.
        gaps = np.concatenate(gaps)
        assert np.mean(gaps > GAP_TOL) > 0.3

    def test_delayed_window_of_whole_update(self):
        cfg = train.NTupleTrainConfig(
            batch_size=8, steps_per_update=4, tuples=ntuple.TINY_2X3, update_mode="delayed", delay_window=None,
            table_backend="mxu",
        )
        state, net = train.init_ntuple(cfg, seed=1, device="cpu")
        assert net.config.backend == "mxu"
        state, metrics = train.make_ntuple_step(cfg, device="cpu")(state)
        assert all(np.isfinite(float(v)) for v in metrics.values())
        assert float(state.params["t0_A"].sum()) > 0

    @pytest.mark.parametrize(
        "kw, match",
        [
            (dict(update_mode="delayed", steps_per_update=6, delay_window=4), "must divide"),
            (dict(update_mode="delayed", tc=False, alpha=1.5), "alpha=1.5 > 1"),
            (dict(update_mode="batch"), "unknown update_mode"),
        ],
    )
    def test_step_validation_matches_jax(self, kw, match):
        base = dict(batch_size=4, steps_per_update=8, tuples=ntuple.TINY_2X3)
        with pytest.raises(ValueError, match=match):
            jtrain.make_ntuple_step(jtrain.NTupleTrainConfig(**{**base, **kw}))
        with pytest.raises(ValueError, match=match):
            train.make_ntuple_step(train.NTupleTrainConfig(**{**base, **kw}), device="cpu")

    def test_backend_resolution(self):
        small = train.NTupleTrainConfig(tuples=ntuple.SJ_2X4)
        big = train.NTupleTrainConfig()  # the 4x6 flagship: tables of 16.7M
        assert small.network_config("cuda").backend == "mxu"
        assert small.network_config("cpu").backend == "torch"
        assert big.network_config("cuda").backend == "torch"
        assert jtrain.NTupleTrainConfig(tuples=ntuple.SJ_2X4).network_config().backend == "xla"  # JAX on the CPU
        for make_step in (lambda c: jtrain.make_ntuple_step(jtrain.NTupleTrainConfig(**c)),
                          lambda c: train.make_ntuple_step(train.NTupleTrainConfig(**c), device="cpu")):
            with pytest.raises(ValueError, match="backend='mxu' supports tables <= 65536"):
                make_step(dict(table_backend="mxu"))  # the 4x6 flagship's tables
            with pytest.raises(ValueError, match="backend='cached' needs table sizes divisible by 16384"):
                make_step(dict(tuples=ntuple.TINY_2X3, table_backend="cached"))
        # "auto" never takes "cached"; naming it builds the network in both.
        assert all(big.network_config(d).backend != "cached" for d in ("cpu", "cuda"))
        cached = dict(tuples=ntuple.SJ_2X4, table_backend="cached", cache_prefix_rows=256)
        _, net = train.init_ntuple(train.NTupleTrainConfig(**cached), 0, "cpu")
        jnet = jtrain.get_network(jtrain.NTupleTrainConfig(**cached).network_config())
        assert net.config.backend == jnet.config.backend == "cached"
        assert net.prefix_rows == jnet.prefix_rows == (256, 256)

    def test_trainer_config_defaults_match_jax(self):
        t, j = train.NTupleTrainConfig(), jtrain.NTupleTrainConfig()
        for f in dataclasses.fields(j):
            if f.name != "table_backend":
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.table_backend == j.table_backend == "auto"

    def test_train_loop_records(self):
        records = []

        class Logger:
            def write(self, record):
                records.append(record)

        cfg = train.NTupleTrainConfig(batch_size=8, steps_per_update=4, tuples=ntuple.TINY_2X3)
        state, history = train.train_ntuple(cfg, num_updates=3, log_every=2, logger=Logger(), device="cpu")
        assert [r["update"] for r in history] == [2, 3] and records == history
        assert set(history[0]) == {
            "update", "episodes", "avg_episode_score", "avg_episode_tile_sum", "avg_episode_length",
            "best_tile", "td_abs_err", "steps_per_sec",
        }
        assert state.update_step == 3
        # A one-rank mesh trains bit for bit as no mesh does.
        with one_rank() as mesh:
            got_state, got = train.train_ntuple(cfg, num_updates=3, log_every=2, device="cpu", mesh=mesh)
        assert without_rate(got) == without_rate(history)
        for k, v in state.params.items():
            assert torch.equal(got_state.params[k], v), k


class TestEvaluate:
    """``evaluate_ntuple`` against a lockstep run of the JAX policy.

    The port's policy drives the lockstep run; at every step its actions
    must equal the JAX policy's wherever the top two JAX q-values are
    further apart than ``GAP_TOL`` (and be a best action within it
    elsewhere), and both packages' boards and ``StepOutput`` must be equal.
    Then ``evaluate_ntuple`` itself must report the JAX side's first-episode
    stats exactly.
    """

    B, T = 16, 64

    @pytest.mark.parametrize("depth, chunk", [(0, None), (1, 4)])
    def test_first_episode_stats_match_jax(self, depth, chunk):
        tnet, jnet = nets(ntuple.TINY_2X3, "torch", "xla")
        params = random_tables(jnet, 13)
        tp, jp = both(params)
        jq_fn = jax.jit(lambda b: jsearch._action_values(b, depth, jnet.make_leaf(jp), lambda r: r, 1.0, 0.0, chunk))
        jstep = jax.jit(
            jax.vmap(lambda s, a, w: jvector._step_autoreset_from_bits(s, s.key, a, w, jcore.RewardMode.MERGE_SCORE))
        )
        policy = train._get_ntuple_policy(tnet.config, depth, chunk)

        tstate = vector.reset_batch(17, self.B, device="cpu")
        jstate = jax_state(tstate.boards.numpy())
        acc = {k: jnp.zeros(self.B, dt) for k, dt in (("score", jnp.float32), ("tile_sum", jnp.float32),
                                                       ("length", jnp.int32), ("max_tile", jnp.float32))}
        acc["finished"] = jnp.zeros(self.B, bool)
        compared = []
        for _ in range(self.T):
            jq, jlegal = (np.asarray(x) for x in jq_fn(jstate.boards))
            with torch.no_grad():
                tactions = policy(tp, tstate.boards)
            ta = tactions.numpy()
            clear = top_two_gap(jq, jlegal) > GAP_TOL
            np.testing.assert_array_equal(ta[clear], np.asarray(jsearch._argmax_legal(jq, jlegal))[clear])
            has_legal = jlegal.any(-1)
            best = np.where(jlegal, jq, -np.inf).max(-1)
            assert (jq[has_legal, ta[has_legal]] >= best[has_legal] - GAP_TOL).all()
            compared.append(clear.mean())

            words = philox.step_words(tstate.seed, tstate.env_id, tstate.counter)[:, philox.SPAWN_RANK :]
            tstate, tout = vector.step_autoreset(tstate, tactions)
            jstate, jout = jstep(jstate, jnp.asarray(ta.astype(np.int32)), jnp.asarray(words.numpy().astype(np.uint32)))
            np.testing.assert_array_equal(tstate.boards.numpy(), np.asarray(jstate.boards))
            for f in dataclasses.fields(vector.StepOutput):
                np.testing.assert_array_equal(getattr(tout, f.name).numpy(), np.asarray(getattr(jout, f.name)), err_msg=f.name)
            first = jout.done & ~acc["finished"]
            acc = {
                "finished": acc["finished"] | jout.done,
                "score": jnp.where(first, jout.episode_score, acc["score"]),
                "tile_sum": jnp.where(first, jout.episode_tile_sum, acc["tile_sum"]),
                "length": jnp.where(first, jout.episode_length, acc["length"]),
                "max_tile": jnp.where(first, jout.max_tile, acc["max_tile"]),
            }
        assert np.mean(compared) > 0.8

        stats = train.evaluate_ntuple(
            tp, tnet.config, depth=depth, num_envs=self.B, num_steps=self.T, seed=17, protocol="first",
            chance_chunk=chunk, launch_chunk=24, device="cpu",
        )
        jstats = jevaluate._first_episode_stats(jstate, acc)
        assert set(stats) == set(jstats)
        for k in jstats:
            assert stats[k] == float(jstats[k]), k

    def test_window_protocol_and_device_check(self):
        cfg = train.NTupleTrainConfig(tuples=ntuple.TINY_2X3)
        tnet, _ = nets(ntuple.TINY_2X3, "torch", "xla")
        params = tnet.init("cpu")
        stats = train.evaluate_ntuple(params, cfg, num_envs=8, num_steps=200, device="cpu")
        assert stats["episodes"] > 0 and "frac_2048" in stats
        with pytest.raises(ValueError, match="params\\['t0'\\] is on"):
            train.evaluate_ntuple({"t0": torch.zeros(4096, device="meta")}, cfg, num_envs=2, num_steps=1, device="cpu")


class TestNtupleCli:
    def _run(self, argv):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            assert cli.main(argv) == 0
        return out.getvalue(), err.getvalue()

    def test_train_ntuple_on_cpu_writes_records(self, tmp_path, monkeypatch):
        # The CLI trains the 4x6 flagship (tables of 16.7M); TINY-sized work
        # keeps the test small, as the CLI has no flag for the tuples.
        real = train.NTupleTrainConfig

        def tiny(**kw):
            return real(tuples=ntuple.TINY_2X3, **kw)

        monkeypatch.setattr(train, "NTupleTrainConfig", tiny)
        out, err = self._run([
            "train", "--algo", "ntuple", "--updates", "3", "--batch-size", "8", "--unroll", "4",
            "--update-mode", "delayed", "--delay-window", "2", "--alpha", "0.5", "--table-backend", "torch",
            "--log-dir", str(tmp_path), "--log-every", "1", "--device", "cpu",
        ])
        lines = (tmp_path / "metrics.csv").read_text().splitlines()
        assert lines[0].startswith("update,episodes,") and len(lines) == 4
        assert "update=3" in out and err.startswith("final: {'update': 3")

    def test_unported_train_flags_say_so(self):
        # --mesh is ported: DDPG takes none (as in JAX), and without a card
        # a mesh run needs --device cpu like every entry point; the group it
        # joined is left either way.
        with pytest.raises(SystemExit, match="takes no --mesh"):
            cli.main(["train", "--algo", "ddpg", "--mesh"])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            with contextlib.redirect_stderr(io.StringIO()):
                cli.main(["train", "--algo", "dqn", "--mesh"])
        assert not torch.distributed.is_initialized()
        with pytest.raises(SystemExit, match="needs --checkpoint-dir"):
            cli.main(["eval", "--algo", "ntuple", "--device", "cpu"])
        with pytest.raises(SystemExit):
            with contextlib.redirect_stderr(io.StringIO()):
                cli.main(["train", "--algo", "ntuple", "--table-backend", "xla"])

    def test_train_ntuple_mxu_needs_small_tables(self):
        with pytest.raises(ValueError, match="mxu"):
            cli.main(["train", "--algo", "ntuple", "--table-backend", "mxu", "--device", "cpu", "--updates", "1"])

    def test_json_record_line(self, capsys):
        from rein48_tpu_torch.utils.metrics import MetricLogger

        MetricLogger(stdout=False).write_json({"a": 1.5})
        assert json.loads(capsys.readouterr().out) == {"a": 1.5}

    def test_metric_logger_writes_what_jax_writes(self, tmp_path, capsys):
        from rein48_tpu.utils.metrics import MetricLogger as JaxLogger
        from rein48_tpu_torch.utils.metrics import MetricLogger

        records = [{"update": 1, "loss": 0.25, "wall_time": 1.0}, {"update": 2, "loss": 1e-7, "extra": 3, "wall_time": 2.0}]
        for name, cls in (("jax", JaxLogger), ("torch", MetricLogger)):
            logger = cls(log_dir=str(tmp_path / name))
            for r in records:
                logger.write(r)
            logger.close()
        out = capsys.readouterr().out.splitlines()
        assert out[:2] == out[2:] and "loss=1e-07" in out[1]
        assert (tmp_path / "jax" / "metrics.csv").read_text() == (tmp_path / "torch" / "metrics.csv").read_text()


def cached_nets(cold_capacity_rows: int = 16):
    """SJ_2X4 on ``"cached"`` with 128 prefix rows of 512: part of every table is cold."""
    kw = dict(tuples=ntuple.SJ_2X4, backend="cached", prefix_rows=128, cold_capacity_rows=cold_capacity_rows)
    return ntuple.NTupleNetwork(ntuple.NTupleConfig(**kw)), jntuple.NTupleNetwork(jntuple.NTupleConfig(**kw))


def cached_tables(jnet, seed: int, tc: bool) -> dict:
    """Random tables in a refreshed, non-identity layout, numpy, JAX key names.

    JAX's ``refresh_cache`` makes the layout from the random heat, so both
    packages get the same physical tables, row maps and hot rows.
    """
    rng = np.random.default_rng(seed)
    params = {k: jnp.asarray(v) for k, v in jnet.init().items()}
    for i, n in enumerate(jnet.table_sizes):
        params[f"t{i}"] = jnp.asarray(rng.normal(size=n).astype(np.float32))
        if tc:
            e = rng.normal(size=n).astype(np.float32)
            params[f"t{i}_E"] = jnp.asarray(e)
            params[f"t{i}_A"] = jnp.asarray(np.abs(e) * rng.uniform(1.0, 3.0, n).astype(np.float32))
    params = {k: np.asarray(v) for k, v in jnet.refresh_cache(params).items()}
    assert not np.array_equal(params["t0_rm"], np.arange(params["t0_rm"].size))
    return params


def logical(params: dict, key: str) -> np.ndarray:
    """A physical table (or accumulator) of ``"cached"`` in logical order."""
    table = params[key]
    i = key[1:].split("_")[0]
    n = table.shape[0]
    rm = torch.as_tensor(np.asarray(params[f"t{i}_rm"]))
    return np.asarray(table)[hbm_tables.physical_index(rm, torch.arange(n, dtype=torch.int32)).numpy()]


class TestHotPrefixNetwork:
    """The port's ``"cached"`` network against JAX's ``"cached"``, on tables
    carried across with ``convert`` in a refreshed layout. Values are
    bit-equal; TD updates at ``RTOL, ATOL``."""

    def test_value_bit_equal_to_jax(self):
        tnet, jnet = cached_nets()
        tp, jp = both(cached_tables(jnet, 20, tc=False))
        boards = random_boards(np.random.default_rng(21), 64).reshape(16, 4, 4, 4)
        got = tnet.value(tp, torch.from_numpy(boards))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jnet.value(jp, jnp.asarray(boards))))
        # ...and equal to the plain backend reading the same tables unpermuted.
        plain, _ = nets(ntuple.SJ_2X4, "torch", "xla")
        flat = {f"t{i}": torch.from_numpy(logical(tp, f"t{i}")) for i in range(2)}
        assert torch.equal(plain.value(flat, torch.from_numpy(boards)), got)

    @pytest.mark.parametrize("fn", ["td_apply_tc", "td_apply_mean", "td_apply_sum"])
    def test_step_updates_match_jax(self, fn):
        tnet, jnet = cached_nets()
        tc = fn == "td_apply_tc"
        tp, jp = both(cached_tables(jnet, 22, tc=tc))
        boards, err = td_inputs(48, 23)
        boards[24:] = boards[:24]
        args = (torch.from_numpy(boards), torch.from_numpy(err), 0.5)
        jargs = (jnp.asarray(boards), jnp.asarray(err), 0.5)
        if tc:
            got, want = tnet.td_apply_tc(tp, *args), jnet.td_apply_tc(jp, *jargs)
        else:
            collision = fn.split("_")[-1]
            got, want = tnet.td_apply(tp, *args, collision=collision), jnet.td_apply(jp, *jargs, collision=collision)
        assert got is tp
        assert_tables_close(got, want)

    @pytest.mark.parametrize("tc", [True, False])
    @pytest.mark.parametrize("cold_capacity_rows, branch", [(16, "fast"), (1, "fallback")])
    def test_td_apply_delayed_matches_jax(self, tc, cold_capacity_rows, branch):
        tnet, jnet = cached_nets(cold_capacity_rows)
        tp, jp = both(cached_tables(jnet, 24, tc=tc))
        boards, err = td_inputs(96, 25)
        boards[48:] = boards[:48]  # entries hit several times in the window
        before = profiling.counters.get(f"ntuple.cached_{branch}", 0)
        got = tnet.td_apply_delayed(tp, torch.from_numpy(boards), torch.from_numpy(err), 0.4, tc=tc)
        want = jnet.td_apply_delayed(jp, jnp.asarray(boards), jnp.asarray(err), 0.4, tc=tc)
        # 768 lookups per table, about three quarters cold: 128 slots overflow, 2,048 do not.
        assert profiling.counters[f"ntuple.cached_{branch}"] == before + 2
        assert_tables_close(got, want)

    def test_refresh_cache_keeps_values_and_matches_jax(self):
        tnet, jnet = cached_nets()
        rng = np.random.default_rng(26)
        params = {k: np.asarray(v) for k, v in jnet.init_tc().items()}
        for i in range(2):
            params[f"t{i}"] = rng.normal(size=params[f"t{i}"].size).astype(np.float32)
            # Whole-number heat: row sums are exact in either package's order.
            params[f"t{i}_A"] = rng.integers(0, 1000, params[f"t{i}"].size).astype(np.float32)
        tp, jp = both(params)
        boards = torch.from_numpy(random_boards(np.random.default_rng(27), 64))
        v0 = tnet.value(tp, boards)
        new = tnet.refresh_cache(tp)
        assert new is not tp and new["t0"] is not tp["t0"]
        assert torch.equal(tnet.value(new, boards), v0)
        assert not torch.equal(new["t0_rm"], tp["t0_rm"])
        want = jnet.refresh_cache(jp)
        for k in want:
            np.testing.assert_array_equal(new[k].numpy(), np.asarray(want[k]), err_msg=k)
        plain, _ = nets(ntuple.SJ_2X4, "torch", "xla")
        assert plain.refresh_cache(tp) is tp  # other backends keep their layout


class TestHotPrefixTrainer:
    """The port's ``"cached"`` trainer against its ``"torch"`` trainer from
    the same seed (``tests/test_ntuple.py:671-705``): the permutation only
    relabels the tables' rows, so boards are equal and the logical tables
    exact in step mode, and within ``RTOL, ATOL`` in delayed mode, whose
    sums the kernel reassociates."""

    BASE = dict(tuples=ntuple.SJ_2X4, batch_size=8, steps_per_update=8)

    def train(self, mode: str, backend: str, updates: int = 3):
        cfg = train.NTupleTrainConfig(
            **self.BASE, update_mode=mode, delay_window=4 if mode == "delayed" else None, table_backend=backend,
            cache_prefix_rows=32, cache_refresh_every=2,
        )
        return train.train_ntuple(cfg, num_updates=updates, seed=5, log_every=1, device="cpu")[0], cfg

    @pytest.mark.parametrize("mode", ["step", "delayed"])
    def test_matches_torch_trainer(self, mode):
        names = ("hbm_tables.cached_gather", "hbm_tables.cached_scatter", "ntuple.cached_fast", "ntuple.cached_fallback")
        before = [profiling.counters.get(k, 0) for k in names]
        sc, _ = self.train(mode, "cached")
        st, _ = self.train(mode, "torch")
        counts = [profiling.counters.get(k, 0) - b for k, b in zip(names, before)]
        assert counts[:2] == [0, 0]  # the CPU runs the plain versions
        np.testing.assert_array_equal(sc.env.boards.numpy(), st.env.boards.numpy())
        np.testing.assert_array_equal(sc.prev_after.numpy(), st.prev_after.numpy())
        # A refresh after update 2 saw real heat and moved rows.
        assert not np.array_equal(sc.params["t0_rm"].numpy(), np.arange(512))
        for key in st.params:
            a, b = st.params[key].numpy(), logical(sc.params, key)
            if mode == "step":
                np.testing.assert_array_equal(b, a, err_msg=key)
            else:
                np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=key)
        n_windows = sum(counts[2:])
        assert n_windows == (2 * 3 * 2 if mode == "delayed" else 0)  # tables x updates x windows

    def test_evaluate_matches_unpermuted_torch(self):
        sc, cfg = self.train("delayed", "cached", updates=2)
        plain = {k: torch.from_numpy(logical(sc.params, k)) for k in ("t0", "t1")}
        for depth in (0, 1):
            kw = dict(depth=depth, num_envs=16, num_steps=48, seed=9, protocol="first", chance_chunk=4, device="cpu")
            got = train.evaluate_ntuple(sc.params, cfg, **kw)
            want = train.evaluate_ntuple(plain, dataclasses.replace(cfg, table_backend="torch"), **kw)
            assert got == want, depth

# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's search and evaluation, and the slice as a whole, against JAX.

Tolerances. The search sums the same float32 terms as the JAX package in
another order, so q-values agree to a few float32 ulps: 3.8e-6 measured
on q of size ~20 with a float32 value leaf, hence ``Q_TOL = 2e-5``.
Actions are compared where the top two legal q-values are further apart
than that; the snake heuristic's q-values reach 1e12, so there the gap
is taken relative (``REL_TOL = 1e-5``). On random boards about 5% of
depth-1 heuristic decisions are exact mathematical ties (mirror-symmetric
afterstates) that the two frameworks break by float noise.
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

from rein48_tpu.control import search as jsearch
from rein48_tpu.engine import core as jcore
from rein48_tpu.engine import vector as jvector
from rein48_tpu.models import nets as jnets
from rein48_tpu.models import obs as jobs
from rein48_tpu.train import common as jcommon
from rein48_tpu.train import evaluate as jevaluate
from rein48_tpu_torch import cli
from rein48_tpu_torch.control import search
from rein48_tpu_torch.engine import philox, vector
from rein48_tpu_torch.models import convert
from rein48_tpu_torch.train import common, evaluate
from rein48_tpu_torch.utils import profiling

from test_torch_engine import jax_state, random_boards

torch.set_num_threads(1)

Q_TOL = 2e-5
REL_TOL = 1e-5


def top_two_gap(q: np.ndarray, legal: np.ndarray) -> np.ndarray:
    """Gap between the best and second-best legal q (inf with < 2 legal)."""
    s = np.sort(np.where(legal, q, -np.inf), axis=-1)
    with np.errstate(invalid="ignore"):
        gap = s[..., -1] - s[..., -2]
    return np.where(legal.sum(-1) >= 2, gap, np.inf)


@pytest.fixture(scope="module")
def small_resnet():
    """A small float32 ResNet in both frameworks, from one Flax init."""
    jm = jnets.ResNetPolicy(channels=8, num_blocks=1, dtype=jnp.float32)
    params = jm.init(jax.random.key(7), jobs.encode_onehot(jnp.zeros((1, 4, 4), jnp.uint8)))["params"]
    tm = convert.resnet_from_flax(jax.tree.map(np.asarray, params), dtype=torch.float32).eval()
    return jm, params, tm


def _log2_reward_jax(r):
    return jcommon.transform_reward(r, "log2")


def _log2_reward(r):
    return common.transform_reward(r, "log2")


class TestHeuristicSearch:
    def test_depth1_actions_match_jax(self):
        boards = random_boards(np.random.default_rng(0), 512)
        jq, jlegal = jax.jit(lambda b: jsearch._action_values(b, 1, jsearch.heuristic, lambda r: r, 1.0))(
            jnp.asarray(boards)
        )
        jq, jlegal = np.asarray(jq), np.asarray(jlegal)
        tq, tlegal = search._action_values(torch.from_numpy(boards), 1, search.heuristic, lambda r: r, 1.0)
        np.testing.assert_array_equal(tlegal.numpy(), jlegal)
        np.testing.assert_allclose(np.where(jlegal, tq.numpy(), 0), np.where(jlegal, jq, 0), rtol=REL_TOL)

        actions = search.expectimax_policy(torch.from_numpy(boards), 1).numpy()
        jactions = np.asarray(jax.jit(jsearch.expectimax_policy, static_argnums=1)(jnp.asarray(boards), 1))
        clear = top_two_gap(jq, jlegal) > REL_TOL * np.abs(jq).max(-1)
        assert clear.mean() > 0.75
        np.testing.assert_array_equal(actions[clear], jactions[clear])
        # Never an illegal action while a legal one exists.
        has_legal = jlegal.any(-1)
        assert jlegal[has_legal, actions[has_legal]].all()

    def test_chance_children_match_jax(self):
        after = random_boards(np.random.default_rng(1), 64)
        children, probs = search._chance_children(torch.from_numpy(after))
        jchildren, jprobs = jsearch._chance_children(jnp.asarray(after))
        np.testing.assert_array_equal(children.numpy(), np.asarray(jchildren))
        np.testing.assert_array_equal(probs.numpy(), np.asarray(jprobs))

    def test_dead_board_takes_action_zero(self):
        dead = torch.tensor([[1, 2, 1, 2], [2, 1, 2, 1], [1, 2, 1, 2], [2, 1, 2, 1]], dtype=torch.uint8)
        assert int(search.expectimax_policy(dead[None], 1)[0]) == 0

    def test_bad_chunk_raises(self):
        with pytest.raises(ValueError, match="must divide"):
            search.make_expectimax_policy(1, chance_chunk=5)(torch.zeros((1, 4, 4), dtype=torch.uint8))


class TestValueLeafSearch:
    @pytest.mark.parametrize("depth, chunk", [(0, None), (1, None), (1, 4)])
    def test_q_values_match_jax(self, small_resnet, depth, chunk):
        jm, params, tm = small_resnet
        boards = random_boards(np.random.default_rng(2), 64)
        jq, jlegal = jax.jit(
            lambda b: jsearch._action_values(
                b, depth, jsearch.make_value_leaf(jm, params), _log2_reward_jax, 0.99, 0.0, chunk
            )
        )(jnp.asarray(boards))
        jq, jlegal = np.asarray(jq), np.asarray(jlegal)
        with torch.no_grad():
            tq, tlegal = search._action_values(
                torch.from_numpy(boards), depth, search.make_value_leaf(tm), _log2_reward, 0.99, 0.0, chunk
            )
        tq = tq.numpy()
        np.testing.assert_array_equal(tlegal.numpy(), jlegal)
        np.testing.assert_allclose(np.where(jlegal, tq, 0), np.where(jlegal, jq, 0), atol=Q_TOL, rtol=0)

        policy = search.make_expectimax_policy(
            depth, leaf_value=search.make_value_leaf(tm), reward_fn=_log2_reward, gamma=0.99, death_value=0.0, chance_chunk=chunk
        )
        with torch.no_grad():
            actions = policy(torch.from_numpy(boards)).numpy()
        jactions = np.asarray(search_argmax_jax(jq, jlegal))
        clear = top_two_gap(jq, jlegal) > 2 * Q_TOL
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(actions[clear], jactions[clear])


def search_argmax_jax(q, legal):
    return jsearch._argmax_legal(jnp.asarray(q), jnp.asarray(legal))


class TestLockstepEvaluation:
    """The slice end to end: planner with a ResNet leaf stepping the engine."""

    B, T = 16, 64

    def test_lockstep_matches_jax(self, small_resnet):
        jm, params, tm = small_resnet
        jpolicy_q = jax.jit(
            lambda b: jsearch._action_values(b, 1, jsearch.make_value_leaf(jm, params), _log2_reward_jax, 0.99, 0.0)
        )
        jstep = jax.jit(
            jax.vmap(lambda s, a, w: jvector._step_autoreset_from_bits(s, s.key, a, w, jcore.RewardMode.MERGE_SCORE))
        )
        tpolicy = evaluate._build_search_policy(1, tm, "onehot", 0.99, "log2")

        start = vector.reset_batch(11, self.B, device="cpu")
        tstate, jstate = start, jax_state(start.boards.numpy())
        acc = {
            "finished": jnp.zeros(self.B, bool),
            "score": jnp.zeros(self.B, jnp.float32),
            "tile_sum": jnp.zeros(self.B, jnp.float32),
            "length": jnp.zeros(self.B, jnp.int32),
            "max_tile": jnp.zeros(self.B, jnp.float32),
        }
        min_gap = np.inf
        for _ in range(self.T):
            jq, jlegal = jpolicy_q(jstate.boards)
            jactions = jsearch._argmax_legal(jq, jlegal)
            with torch.no_grad():
                tactions = tpolicy(tstate.boards)
            np.testing.assert_array_equal(tactions.numpy(), np.asarray(jactions))
            min_gap = min(min_gap, top_two_gap(np.asarray(jq), np.asarray(jlegal)).min())

            words = philox.step_words(tstate.seed, tstate.env_id, tstate.counter)[:, philox.SPAWN_RANK :]
            tstate, tout = vector.step_autoreset(tstate, tactions)
            jstate, jout = jstep(jstate, jactions, jnp.asarray(words.numpy().astype(np.uint32)))
            np.testing.assert_array_equal(tstate.boards.numpy(), np.asarray(jstate.boards))
            for f in dataclasses.fields(vector.StepOutput):
                np.testing.assert_array_equal(
                    getattr(tout, f.name).numpy(), np.asarray(getattr(jout, f.name)), err_msg=f.name
                )
            first = jout.done & ~acc["finished"]
            acc = {
                "finished": acc["finished"] | jout.done,
                "score": jnp.where(first, jout.episode_score, acc["score"]),
                "tile_sum": jnp.where(first, jout.episode_tile_sum, acc["tile_sum"]),
                "length": jnp.where(first, jout.episode_length, acc["length"]),
                "max_tile": jnp.where(first, jout.max_tile, acc["max_tile"]),
            }
        # Every decision had a clear winner, so equal actions are no accident.
        assert min_gap > 2 * Q_TOL

        final, stats = evaluate._first_episode_rollout(start, policy_fn=tpolicy, num_steps=self.T)
        assert torch.equal(final.boards, tstate.boards)
        jstats = jevaluate._first_episode_stats(jstate, acc)
        assert set(stats) == set(jstats)
        for k in jstats:
            assert float(stats[k]) == float(jstats[k]), k


class TestEvaluate:
    def test_on_chunk_skips_the_remainder(self):
        calls = []
        stats = evaluate.evaluate_search(
            depth=0, num_envs=8, num_steps=25, protocol="first", launch_chunk=10,
            on_chunk=lambda n, s: calls.append((n, s["unfinished"])), device="cpu",
        )
        assert [n for n, _ in calls] == [10, 20]
        assert stats["episodes"] == 8.0 and 0 <= stats["unfinished"] <= 8

    def test_on_chunk_can_stop_the_sweep(self):
        calls = []
        evaluate.evaluate_search(
            depth=0, num_envs=4, num_steps=30, protocol="first", launch_chunk=10,
            on_chunk=lambda n, s: calls.append(n) or True, device="cpu",
        )
        assert calls == [10]

    def test_window_protocol_counts_completed_episodes(self):
        stats = evaluate.evaluate_search(depth=0, num_envs=16, num_steps=300, device="cpu")
        assert stats["episodes"] > 0 and stats["avg_length"] > 0 and stats["best_tile"] >= 64

    def test_policy_evaluation_with_a_resnet(self, small_resnet):
        _, _, tm = small_resnet
        greedy = evaluate.evaluate_policy(tm, num_envs=8, num_steps=40, device="cpu")
        sampled = evaluate.evaluate_policy(tm, num_envs=8, num_steps=40, greedy=False, device="cpu")
        first = evaluate.evaluate_policy(tm, num_envs=8, num_steps=40, protocol="first", device="cpu")
        assert set(greedy) == set(sampled) and first["episodes"] == 8.0


class TestTorchCli:
    def _run(self, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(argv) == 0
        return json.loads(buf.getvalue().strip().splitlines()[-1])

    def test_bench_on_cpu(self):
        before = profiling.counters.get("fused.rollout_launches", 0)
        out = self._run(["bench", "--device", "cpu", "--batch", "64", "--unroll", "8", "--rounds", "2"])
        assert out["metric"] == "env_steps_per_sec" and out["engine"] == "plain" and out["value"] > 0
        assert {"unit", "vs_baseline", "median", "device"} <= set(out)
        out = self._run(["bench", "--device", "cpu", "--engine", "fused", "--batch", "64", "--unroll", "8", "--rounds", "2"])
        assert out["engine"] == "fused"
        assert profiling.counters.get("fused.rollout_launches", 0) == before  # the plain version on the CPU launches no kernel

    def test_eval_search_on_cpu(self):
        out = self._run(["eval", "--algo", "search", "--depth", "1", "--num-envs", "4", "--max-steps", "6", "--device", "cpu"])
        assert out["episodes"] >= 0 and "frac_2048" in out

    def test_unported_commands_say_so(self, tmp_path, monkeypatch):
        search = ["eval", "--algo", "search", "--device", "cpu"]
        # --mesh is ported: without a card it needs --device cpu, and with it
        # the trainer gets a one-rank mesh; the group is left either way.
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            with contextlib.redirect_stderr(io.StringIO()):
                cli.main(["train", "--algo", "dqn", "--mesh"])
        from rein48_tpu_torch.train import afterstate

        meshes = []

        def train(config, mesh=None, **kw):
            meshes.append(mesh)
            return None, []

        monkeypatch.setattr(afterstate, "train_afterstate_td", train)
        with contextlib.redirect_stderr(io.StringIO()):
            assert cli.main(["train", "--algo", "afterstate", "--mesh", "--device", "cpu"]) == 0
        assert [m.shape for m in meshes] == [{"dp": 1, "tp": 1}] and not torch.distributed.is_initialized()
        # The critic's settings need a checkpoint: the heuristic leaf has no units.
        for flags in (["--gamma", "0.9"], ["--model", "resnet"]):
            with pytest.raises(SystemExit, match="needs --checkpoint-dir"):
                cli.main(search + flags)
        with pytest.raises(SystemExit, match="no checkpoint directory"):
            cli.main(search + ["--checkpoint-dir", str(tmp_path / "missing")])
        assert not (tmp_path / "missing").exists()

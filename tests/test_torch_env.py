# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's single-game surface against the JAX package: the single-env
engine, ``Game``, the spec, rendering, the control policies, the Python
and C oracles and the ``play``/``parity`` subcommands.

Exactness: boards, ``done``, score and reward are bit-equal. The port's
``Game`` draws its spawns from Philox streams where JAX's draws from
threefry keys, so the engine functions are fed JAX's own uniforms, computed
from its keys exactly as ``core.reset`` and ``core.step`` split them. The
oracles and the ``parity`` line hold no randomness of either package and
must be equal outright.
"""

from __future__ import annotations

import contextlib
import io
import json
import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rein48_tpu import cli as jcli
from rein48_tpu import native as jnative
from rein48_tpu import spec as jspec
from rein48_tpu.engine import core as jcore
from rein48_tpu.engine import oracle as joracle
from rein48_tpu.engine import render as jrender
from rein48_tpu.env import Game as JGame
from rein48_tpu_torch import DEFAULT_SPEC, EnvSpec, Game, cli, control, native
from rein48_tpu_torch.engine import core, oracle, philox, render, vector

from test_torch_engine import random_boards

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def t(x):
    return torch.from_numpy(np.asarray(x).copy())


# --- the single-env engine on JAX's uniforms ---------------------------------------


def _spawn_uniforms(key):
    """The two uniforms ``core.random_spawn`` draws from ``key``."""
    k_idx, k_val = jax.random.split(key)
    return jax.random.uniform(k_idx, ()), jax.random.uniform(k_val, ())


@jax.jit
def _reset_uniforms(keys):
    """``core.reset``'s spawn uniforms, per key."""
    return jax.vmap(lambda k: _spawn_uniforms(jax.random.split(k)[0]))(keys)


@jax.jit
def _step_uniforms(keys):
    """``core.step``'s spawn uniforms, per state key."""
    return jax.vmap(lambda k: _spawn_uniforms(jax.random.split(k)[1]))(keys)


def test_random_spawn_matches_jax():
    rng = np.random.default_rng(0)
    boards = random_boards(rng, 512)
    boards[:8] = np.where(boards[:8] == 0, 3, boards[:8])  # full boards: no spawn
    enabled = rng.uniform(size=512) < 0.8
    keys = jax.random.split(jax.random.key(1), 512)
    want = jax.jit(jax.vmap(jcore.random_spawn))(jnp.asarray(boards), keys, jnp.asarray(enabled))
    u_idx, u_val = jax.jit(jax.vmap(_spawn_uniforms))(keys)
    got = core.random_spawn(t(boards), t(u_idx), t(u_val), t(enabled))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != boards).any()


def test_random_spawn_at_the_edges_of_the_uniforms():
    """The float32 product ``u * n`` may round up to ``n``; the clamp keeps
    the last blank cell. Held to numpy's float32 arithmetic."""
    boards = np.zeros((6, 4, 4), np.uint8)
    boards[3:] = 1
    boards[3:, 0, :3] = 0  # three blanks
    u = np.array([0.0, 1 - 2**-24, 1 - 2**-23, 0.0, 1 - 2**-24, 0.5], np.float32)
    v = np.array([0.1, 0.1 + 2**-27, 0.0, 0.9, 0.2, 0.1], np.float32)
    got = core.random_spawn(t(boards), t(u), t(v), torch.ones(6, dtype=torch.bool)).numpy()
    n = (boards == 0).reshape(6, -1).sum(-1)
    rank = np.minimum((u * n.astype(np.float32)).astype(np.int64), n - 1)
    for i in range(6):
        cell = np.flatnonzero(boards[i].reshape(-1) == 0)[rank[i]]
        assert got[i].reshape(-1)[cell] == (1 if v[i] > np.float32(0.1) else 2), i
        assert (got[i] != boards[i]).sum() == 1


def test_reset_matches_jax():
    keys = jax.random.split(jax.random.key(3), 256)
    want = jax.jit(jax.vmap(jcore.reset))(keys)
    got = core.reset(0, torch.arange(256), uniforms=tuple(t(u) for u in _reset_uniforms(keys)))
    np.testing.assert_array_equal(got.boards.numpy(), np.asarray(want.boards))
    assert not got.done.any() and (got.score == 0).all() and (got.steps == 0).all()
    assert ((got.boards > 0).flatten(1).sum(1) == 1).all()


@pytest.mark.parametrize("mode", [jcore.RewardMode.MERGE_SCORE, jcore.RewardMode.PARITY_ZERO])
def test_step_and_step_batch_match_jax(mode):
    """64 games of random actions, 150 steps, no auto-reset: finished games
    keep stepping as no-ops, as in JAX."""
    rng = np.random.default_rng(int(mode == jcore.RewardMode.PARITY_ZERO))
    pmode = core.RewardMode(mode.value)
    keys = jax.random.split(jax.random.key(5), 64)
    jstate = jax.jit(jax.vmap(jcore.reset))(keys)
    state = core.reset(0, torch.arange(64), uniforms=tuple(t(u) for u in _reset_uniforms(keys)))
    jstep = jax.jit(jax.vmap(lambda s, a: jcore.step(s, a, mode)))
    for i in range(150):
        actions = rng.integers(0, 4, 64).astype(np.int32)
        uniforms = tuple(t(u) for u in _step_uniforms(jstate.key))
        jstate, jreward, jdone = jstep(jstate, jnp.asarray(actions))
        fn = vector.step_batch if i % 2 else core.step
        state, reward, done = fn(state, t(actions), pmode, uniforms=uniforms)
        np.testing.assert_array_equal(state.boards.numpy(), np.asarray(jstate.boards), err_msg=f"step {i}")
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(state.done.numpy(), np.asarray(jstate.done))
        np.testing.assert_array_equal(reward.numpy(), np.asarray(jreward))
        np.testing.assert_array_equal(state.score.numpy(), np.asarray(jstate.score))
        np.testing.assert_array_equal(state.steps.numpy(), np.asarray(jstate.steps))
    assert done.any() and not done.all()
    assert state.counter.tolist() == [151] * 64


def test_reset_and_step_draw_from_the_stream():
    """Without injected uniforms: the RESET pair of step 0, then the SPAWN
    pair at the counter, through ``uniform_from_words``."""
    state = core.reset(9, torch.arange(16))
    words0 = philox.step_words(torch.full((16,), 9), torch.arange(16), torch.zeros(16, dtype=torch.int64))
    u = philox.uniform_from_words(words0)
    want = core.random_spawn(torch.zeros((16, 4, 4), dtype=torch.uint8), u[:, philox.RESET_RANK], u[:, philox.RESET_VALUE],
                             torch.ones(16, dtype=torch.bool))
    assert torch.equal(state.boards, want)
    nxt, _, _ = core.step(state, torch.full((16,), core.LEFT))
    words1 = philox.step_words(state.seed, state.env_id, state.counter)
    same, _, _ = core.step(state, torch.full((16,), core.LEFT), uniforms=core.spawn_uniforms(words1))
    assert torch.equal(nxt.boards, same.boards) and torch.equal(nxt.counter, state.counter + 1)
    single = core.reset(9, 3)
    assert single.boards.shape == (4, 4) and torch.equal(single.boards, state.boards[3])


# --- Game, spec, render ----------------------------------------------------------------


class TestGame:
    def test_reset_has_one_tile_and_parity_zero_reward(self):
        game = Game(seed=3, device="cpu")
        state = game.reset()
        assert state.shape == (4, 4) and state.dtype == np.int32 and (state != 0).sum() == 1
        for a in ["U", "D", "L", "R"] * 10:
            s, reward, done = game.step(a)
            assert reward == 0.0 and isinstance(reward, float) and isinstance(done, bool)
            np.testing.assert_array_equal(s, game.state_matrix)
            if done:
                break

    def test_every_alias_steps_like_its_index(self):
        for alias, index in [("UP", 0), ("Up", 0), ("U", 0), ("up", 0), ("u", 0), ("DOWN", 1), ("d", 1), ("l", 2),
                             ("Left", 2), ("R", 3), ("right", 3), (3, 3), (np.int64(1), 1)]:
            a, b = Game(seed=1, device="cpu"), Game(seed=1, device="cpu")
            np.testing.assert_array_equal(a.step(alias)[0], b.step(index)[0], err_msg=str(alias))

    def test_garbage_actions_raise(self):
        game = Game(seed=2, device="cpu")
        for bad in ("sideways", 7, None, [1]):
            with pytest.raises(ValueError, match="Input action signal is wrong"):
                game.step(bad)
        with pytest.raises(ValueError):
            JGame(seed=2).step("sideways")

    def test_merge_score_mode_pays(self):
        game = Game(seed=4, reward_mode=core.RewardMode.MERGE_SCORE, device="cpu")
        total = 0.0
        for a in ["U", "L", "D", "R"] * 50:
            _, reward, done = game.step(a)
            total += reward
            if done:
                break
        assert total > 0.0

    def test_seeded_games_reproduce_and_seeds_differ(self):
        g1, g2 = Game(seed=42, device="cpu"), Game(seed=42, device="cpu")
        others = [Game(seed=s, device="cpu").state_matrix for s in range(43, 51)]
        assert any(not np.array_equal(g1.state_matrix, o) for o in others)
        for a in ["U", "L", "D", "R"] * 25:
            s1, _, d1 = g1.step(a)
            s2, _, d2 = g2.step(a)
            np.testing.assert_array_equal(s1, s2)
            assert d1 == d2
            if d1:
                break
        # A second episode plays the next stream: reset() differs from the first, reproducibly.
        first = Game(seed=42, device="cpu").state_matrix
        assert np.array_equal(g1.reset(), g2.reset()) and g1._episode == 2
        assert np.array_equal(Game(seed=42, device="cpu").state_matrix, first)

    def test_spec_spellings_and_size_clamp(self):
        game = Game(seed=0, device="cpu")
        assert game.action_space_size == game.action_size == 4
        assert game.state_space_size == game.state_size == 4
        assert game.reward_space_size == game.reward_size == 1
        assert DEFAULT_SPEC == EnvSpec() and DEFAULT_SPEC.num_cells == 16
        for name in ("action_space_size", "state_space_size", "reward_space_size", "action_size", "state_size",
                     "reward_size", "num_cells", "board_size", "num_actions", "reward_dims"):
            assert getattr(DEFAULT_SPEC, name) == getattr(jspec.DEFAULT_SPEC, name), name
        assert Game(table_matrix_size=2, seed=0, device="cpu").state_matrix.shape == (4, 4)
        with pytest.raises(NotImplementedError):
            Game(table_matrix_size=5, device="cpu")

    def test_legal_actions_render_and_print(self, capsys):
        game = Game(seed=6, device="cpu")
        mask = game.legal_actions
        assert mask.shape == (4,) and mask.dtype == bool and mask.any()
        np.testing.assert_array_equal(mask, np.asarray(jcore.legal_action_mask(jcore.values_to_boards(game.state_matrix))))
        assert game.render() == jrender.render_values(game.state_matrix)
        Game.print_terminal(game.state_matrix)
        game.reset(display=True)
        assert capsys.readouterr().out.count("|") == 2 * 20

    def test_needs_a_device_without_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present, so the default device is valid")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Game(seed=0)


def test_render_matches_jax():
    rng = np.random.default_rng(8)
    boards = random_boards(rng, 6)
    for b in boards:
        assert render.render_board(t(b)) == jrender.render_board(b)
        assert render.render_board(b) == jrender.render_board(b)
    values = [[2, 0], [16, 2048]]
    assert render.render_values(values) == jrender.render_values(values)
    assert render.render_values(values).split("\n")[0] == "-" * 15


# --- control -------------------------------------------------------------------------------


def test_random_policies():
    a = control.random_policy(5, 0, (4096,))
    assert a.dtype == torch.int64 and torch.equal(a, control.random_policy(5, 0, (4096,)))
    freq = torch.bincount(a, minlength=4).double() / 4096
    assert ((freq - 0.25).abs() < 0.03).all()
    assert control.random_policy(5, 1, ()).shape == ()
    rng = np.random.default_rng(2)
    boards = t(random_boards(rng, 2048))
    boards[0] = t(np.arange(16, dtype=np.uint8).reshape(4, 4) % 12 + 1)  # no legal move
    legal = core.legal_action_mask(boards)
    assert not legal[0].any()
    actions = control.random_legal_policy(7, 0, boards)
    has = legal.any(-1)
    assert legal[has].gather(-1, actions[has, None]).all()
    # Uniform over the legal moves: each board's legal count against the draws.
    many = torch.stack([control.random_legal_policy(7, s, boards[1:2].expand(512, 4, 4)) for s in range(2)])
    assert set(many.flatten().tolist()) == set(torch.nonzero(legal[1]).flatten().tolist())
    assert control.Rand.random_action() in core.ACTION_NAMES
    assert control.Hand.hand_control is control.hand_control


def test_hand_control_reprompts(monkeypatch, capsys):
    answers = iter(["sideways", "7", "u"])
    monkeypatch.setattr("builtins.input", lambda: next(answers))
    assert control.hand_control() == "u"
    assert capsys.readouterr().out.count("invalid") == 2


# --- the oracles ------------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_python_oracle_equals_jax_oracle(seed):
    ra, rb = random.Random(seed), random.Random(seed)
    a, b = oracle.OracleGame(rng=ra), joracle.OracleGame(rng=rb)
    done, steps = False, 0
    while not done and steps < 2000:
        action = oracle.random_action(ra)
        assert action == joracle.random_action(rb)
        state, reward, done = a.step(action)
        assert (state, reward, done) == b.step(action)
        steps += 1
    assert done and [(d.rank, d.value_exp) for d in a.spawn_log] == [(d.rank, d.value_exp) for d in b.spawn_log]
    with pytest.raises(ValueError):
        oracle.update_matrix(a.state_matrix, "sideways")


def test_oracle_c_is_the_jax_source():
    """Byte for byte, but for the header comment's path of the reference."""
    ours = (REPO / "rein48_tpu_torch/native/oracle.c").read_text().splitlines()
    theirs = (REPO / "rein48_tpu/native/oracle.c").read_text().splitlines()
    diff = [(a, b) for a, b in zip(ours, theirs) if a != b]
    assert len(ours) == len(theirs) and len(diff) == 1
    assert diff[0][0].startswith(" * the reference's game/GameClient.py") and diff[0][1].endswith(diff[0][0][len(" * the reference's "):])


def test_native_oracle_equals_jax_native_and_python():
    assert native.available() and jnative.available()
    for seed in (0, 3):
        rng, ref = native.NativeRandom(seed), random.Random(seed)
        jrng = jnative.NativeRandom(seed)
        for _ in range(50):
            x = (rng.randint(0, 9), rng.uniform(0, 1), rng.getrandbits(17), rng.random())
            assert x == (ref.randint(0, 9), ref.uniform(0, 1), ref.getrandbits(17), ref.random())
            assert x == (jrng.randint(0, 9), jrng.uniform(0, 1), jrng.getrandbits(17), jrng.random())
        g, jg, py = native.NativeOracleGame(seed), jnative.NativeOracleGame(seed), oracle.OracleGame(seed=seed)
        assert g.state_matrix == jg.state_matrix == py.state_matrix
        done = False
        while not done:
            action = g.random_action()
            assert action == jg.random_action() == py.rng.randint(0, 3)
            state, _, done = g.step(action)
            assert (state, 0, done) == jg.step(action) == py.step(action)
            assert g.last_spawn == jg.last_spawn == (py.spawn_log[-1].rank, py.spawn_log[-1].value_exp)
        assert g.spawn_count == jg.spawn_count == len(py.spawn_log)
        assert native.NativeOracleGame(seed + 10).play_random() == jnative.NativeOracleGame(seed + 10).play_random()
    assert native.library_path().parent.name == "_build" and native.library_path().exists()


# --- the CLI ------------------------------------------------------------------------------------


def _stdout(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_parity_line_equals_jax():
    rc, out, err = _stdout(cli.main, ["parity", "--seeds", "2", "--max-steps", "300", "--device", "cpu"])
    jrc, jout, jerr = _stdout(jcli.main, ["parity", "--seeds", "2", "--max-steps", "300"])
    assert rc == jrc == 0 and err == jerr
    line = out.strip().splitlines()[-1]
    assert line == jout.strip().splitlines()[-1]
    result = json.loads(line)
    assert result["parity"] and result["native_oracle"] and len(result["games"]) == 2
    rc, out, _ = _stdout(cli.main, ["parity", "--seeds", "1", "--max-steps", "5", "--device", "cpu"])
    assert json.loads(out)["games"] == [{"seed": 0, "steps": 5, "done": False, "parity": True}]


def test_play_runs_with_the_jax_flags():
    parser, jparser = cli.build_parser(), jcli.build_parser()
    args, jargs = parser.parse_args(["play"]), jparser.parse_args(["play"])
    for name in ("control", "visual", "seed", "max_steps", "legal_only", "score"):
        assert getattr(args, name) == getattr(jargs, name), name
    assert args.legal_only is True and parser.parse_args(["play", "-c", "human"]).control == "hand"
    assert parser.parse_args(["parity"]).seeds == 5 and parser.parse_args(["parity"]).max_steps == 3000
    rc, out, _ = _stdout(cli.main, ["play", "--control", "r", "--seed", "0", "--device", "cpu", "--score"])
    last = out.strip().splitlines()[-1]
    assert rc == 0 and last.startswith("game_over=True steps=") and "merge_score=" in last
    # The same seed plays the same game.
    assert _stdout(cli.main, ["play", "--seed", "0", "--device", "cpu", "--score"])[1] == out

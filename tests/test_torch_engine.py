# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's engine (``rein48_tpu_torch.engine``) against the JAX engine.

Integer game state must match bit for bit. Inputs are made with numpy from
a seed and fed to both packages; the random words are fed to both as well,
since the port's Philox streams and JAX's threefry keys differ by design.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rein48_tpu.engine import core as jcore
from rein48_tpu.engine import lut as jlut
from rein48_tpu.engine import vector as jvector
from rein48_tpu_torch.engine import core, lut, philox, vector
from rein48_tpu_torch.utils import profiling

torch.set_num_threads(1)


def random_boards(rng: np.random.Generator, batch: int) -> np.ndarray:
    """Boards of every kind: sparse, dense, nearly full and full."""
    fill = rng.uniform(0.0, 1.0, size=(batch, 1, 1))
    exps = rng.integers(1, 12, size=(batch, 4, 4))
    blank = rng.uniform(size=(batch, 4, 4)) > fill
    return np.where(blank, 0, exps).astype(np.uint8)


def jax_state(boards: np.ndarray, score=None, steps=None) -> jcore.EnvState:
    n = boards.shape[0]
    return jcore.EnvState(
        boards=jnp.asarray(boards),
        key=jax.random.split(jax.random.key(0), n),
        done=jnp.zeros((n,), bool),
        score=jnp.asarray(np.zeros(n, np.float32) if score is None else score),
        steps=jnp.asarray(np.zeros(n, np.int32) if steps is None else steps),
    )


def torch_state(boards: np.ndarray, seed: int = 0) -> core.EnvState:
    state = vector.reset_batch(seed, boards.shape[0], device="cpu")
    state.boards = torch.from_numpy(boards.copy())
    return state


class TestRowKernel:
    def test_all_row_codes(self):
        codes = np.arange(lut.NUM_ROW_CODES, dtype=np.int64)
        rows = ((codes[:, None] >> np.array([0, 4, 8, 12])) & 0xF).astype(np.uint8)
        new_rows, score, changed = core.merge_rows_left(torch.from_numpy(rows))
        new_rows, score, changed = new_rows.numpy(), score.numpy(), changed.numpy()

        packed = lut.build_row_lut()
        np.testing.assert_array_equal(packed, jlut.build_row_lut())
        new_codes = (new_rows.astype(np.int64) << np.array([0, 4, 8, 12])).sum(-1)
        np.testing.assert_array_equal(new_codes, lut.lut_new_code(packed).astype(np.int64))
        np.testing.assert_array_equal(score, lut.lut_score(packed).astype(np.int64))
        np.testing.assert_array_equal(changed, new_codes != codes)

        j_rows, j_score, j_changed = jax.jit(jcore.merge_rows_left)(jnp.asarray(rows))
        np.testing.assert_array_equal(new_rows, np.asarray(j_rows))
        np.testing.assert_array_equal(score, np.asarray(j_score))
        np.testing.assert_array_equal(changed, np.asarray(j_changed))


class TestBoardOps:
    N = 4096

    @pytest.fixture(scope="class")
    def boards(self):
        return random_boards(np.random.default_rng(0), self.N)

    def test_move_boards(self, boards):
        actions = np.random.default_rng(1).integers(0, 4, self.N).astype(np.int32)
        nb, score, changed = core.move_boards(torch.from_numpy(boards), torch.from_numpy(actions))
        jnb, jscore, jchanged = jax.jit(jcore.move_boards)(jnp.asarray(boards), jnp.asarray(actions))
        np.testing.assert_array_equal(nb.numpy(), np.asarray(jnb))
        np.testing.assert_array_equal(score.numpy(), np.asarray(jscore))
        np.testing.assert_array_equal(changed.numpy(), np.asarray(jchanged))
        lnb, lscore, lchanged = core.move_boards_lut(torch.from_numpy(boards), torch.from_numpy(actions))
        np.testing.assert_array_equal(lnb.numpy(), nb.numpy())
        np.testing.assert_array_equal(lscore.numpy(), score.numpy())
        np.testing.assert_array_equal(lchanged.numpy(), changed.numpy())

    def test_predicates_and_sums(self, boards):
        tb, jb = torch.from_numpy(boards), jnp.asarray(boards)
        np.testing.assert_array_equal(
            core.legal_action_mask(tb).numpy(), np.asarray(jcore.legal_action_mask(jb))
        )
        over = core.is_game_over(tb).numpy()
        np.testing.assert_array_equal(over, np.asarray(jcore.is_game_over(jb)))
        assert over.any() and not over.all()
        np.testing.assert_array_equal(
            core.board_tile_sum(tb).numpy(), np.asarray(jcore.board_tile_sum(jb))
        )
        np.testing.assert_array_equal(
            core.boards_to_values(tb).numpy(), np.asarray(jcore.boards_to_values(jb))
        )

    def test_place_tile(self, boards):
        rng = np.random.default_rng(2)
        rank = rng.integers(0, 16, self.N).astype(np.int32)
        value = rng.integers(1, 3, self.N).astype(np.int32)
        enabled = rng.uniform(size=self.N) < 0.8
        out = core.place_tile(
            torch.from_numpy(boards), torch.from_numpy(rank), torch.from_numpy(value), torch.from_numpy(enabled)
        )
        jout = jcore.place_tile(jnp.asarray(boards), jnp.asarray(rank), jnp.asarray(value), jnp.asarray(enabled))
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))

    def test_spawn_decisions_from_words(self):
        words = np.random.default_rng(3).integers(0, 2**32, 8192, dtype=np.uint64)
        words[:2] = [0, 2**32 - 1]
        n = np.random.default_rng(4).integers(0, 17, 8192).astype(np.int32)
        tw = torch.from_numpy(words.astype(np.int64))
        jw = jnp.asarray(words.astype(np.uint32))
        np.testing.assert_array_equal(
            core.spawn_rank_from_bits(tw, torch.from_numpy(n)).numpy(),
            np.asarray(jcore.spawn_rank_from_bits(jw, jnp.asarray(n))),
        )
        np.testing.assert_array_equal(
            core.spawn_exp_from_bits(tw).numpy(), np.asarray(jcore.spawn_exp_from_bits(jw))
        )


class TestPhilox:
    @pytest.mark.parametrize(
        "counter, key, expected",
        [
            ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
            ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ],
    )
    def test_known_answers(self, counter, key, expected):
        # Random123's known-answer vectors for Philox4x32-10.
        args = [torch.tensor(v, dtype=torch.int64) for v in counter + key]
        assert tuple(int(w) for w in philox.philox4x32(*args)) == expected

    def test_stream_layout(self):
        # Step n of env e takes words 5n..5n+4 of stream (seed, e).
        bits = philox.philox_bits(9, 6, 3)
        for t in range(6):
            for w in range(5):
                m = 5 * t + w
                block = philox.stream_blocks(9, torch.tensor(2), torch.tensor(m // 4))
                assert int(block[m % 4]) == int(bits[t, w, 2])
        later = philox.philox_bits(9, 2, 3, start_step=4)
        assert torch.equal(later, bits[4:])


def _jax_step_fn():
    def one(s, a, b):
        return jvector._step_autoreset_from_bits(s, s.key, a, b, jcore.RewardMode.MERGE_SCORE)

    return jax.jit(jax.vmap(one))


class TestAutoresetStep:
    def test_bits_driven_rollout_matches_jax(self):
        B, T = 64, 200
        rng = np.random.default_rng(5)
        boards = random_boards(rng, B)
        actions = rng.integers(0, 4, (T, B)).astype(np.int32)
        words = rng.integers(0, 2**32, (T, B, 4), dtype=np.uint64)
        tstate, jstate = torch_state(boards), jax_state(boards)
        step = _jax_step_fn()
        n_done = 0
        for t in range(T):
            tstate, tout = vector.step_autoreset_from_bits(
                tstate, torch.from_numpy(actions[t]), torch.from_numpy(words[t].astype(np.int64))
            )
            jstate, jout = step(jstate, jnp.asarray(actions[t]), jnp.asarray(words[t].astype(np.uint32)))
            np.testing.assert_array_equal(tstate.boards.numpy(), np.asarray(jstate.boards))
            np.testing.assert_array_equal(tstate.score.numpy(), np.asarray(jstate.score))
            np.testing.assert_array_equal(tstate.steps.numpy(), np.asarray(jstate.steps))
            for f in dataclasses.fields(vector.StepOutput):
                np.testing.assert_array_equal(
                    getattr(tout, f.name).numpy(), np.asarray(getattr(jout, f.name)), err_msg=f.name
                )
            n_done += int(tout.done.sum())
        assert n_done > B  # the rollout crossed many episode boundaries

    def test_parity_zero_reward(self):
        state = vector.reset_batch(0, 8, device="cpu")
        _, out = vector.step_autoreset(state, torch.full((8,), core.LEFT), core.RewardMode.PARITY_ZERO)
        assert not out.reward.any()

    def test_off_the_card_both_entry_points_take_the_plain_step(self):
        state = vector.reset_batch(0, 8, device="cpu")
        before = profiling.snapshot()
        vector.step_autoreset(state, torch.full((8,), core.LEFT))
        vector.step_autoreset_from_bits(state, torch.full((8,), core.UP), torch.zeros((8, 4), dtype=torch.int64))
        after = profiling.snapshot()
        assert after["engine.step_plain"] - before.get("engine.step_plain", 0) == 2
        assert after.get("engine.step_launches", 0) == 0

    @pytest.mark.parametrize(
        "field, value, match",
        [("bits", torch.zeros((8, 5), dtype=torch.int64), "bits must be"),
         ("bits", torch.zeros((8, 4), dtype=torch.int32), "bits must be"),
         ("boards", torch.zeros((8, 16), dtype=torch.uint8), "boards must be"),
         ("boards", torch.zeros((8, 4, 4), dtype=torch.int32), "boards must be"),
         ("actions", torch.zeros(8, dtype=torch.int32), "actions must be"),
         ("actions", 0, "actions must be"),
         ("score", torch.zeros(8, dtype=torch.float64), "state.score must be"),
         ("steps", torch.zeros(1, dtype=torch.int32), "state.steps must be"),
         ("counter", torch.zeros((8, 2), dtype=torch.int64)[:, 0], "state.counter must be")],
    )
    def test_step_kernel_refuses_before_launching(self, field, value, match):
        # The wrapper's checks run on the host, before any launch: it copies
        # and converts no operand, so none can hide a copy from the host.
        state = vector.reset_batch(0, 8, device="cpu")
        actions, bits = torch.zeros(8, dtype=torch.int64), torch.zeros((8, 4), dtype=torch.int64)
        if field == "bits":
            bits = value
        elif field == "actions":
            actions = value
        else:
            setattr(state, field, value)
        with pytest.raises(ValueError, match=match):
            vector._step_kernel(state, actions, bits, core.RewardMode.MERGE_SCORE)


class TestStreams:
    def test_stream_is_batch_size_invariant(self):
        small, out_small = vector.rollout_random(vector.reset_batch(4, 16, device="cpu"), 120)
        large, out_large = vector.rollout_random(vector.reset_batch(4, 64, device="cpu"), 120)
        for f in dataclasses.fields(core.EnvState):
            assert torch.equal(getattr(small, f.name), getattr(large, f.name)[:16]), f.name
        for f in dataclasses.fields(vector.StepOutput):
            assert torch.equal(getattr(out_small, f.name), getattr(out_large, f.name)[:, :16]), f.name
        assert out_large.done.any()

    def test_reset_and_policy_steps_use_the_stream(self):
        state = vector.reset_batch(7, 32, device="cpu")
        assert ((state.boards > 0).flatten(1).sum(1) == 1).all()
        assert torch.equal(state.counter, torch.ones(32, dtype=torch.int64))
        a = vector.step_autoreset(state, torch.full((32,), core.UP))[0]
        b = vector.step_autoreset(state, torch.full((32,), core.UP))[0]
        assert torch.equal(a.boards, b.boards)
        assert torch.equal(a.counter, state.counter + 1)

    def test_entry_points_need_a_device_without_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present, so the default device is valid")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            vector.reset_batch(0, 4)

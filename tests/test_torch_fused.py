# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's fused rollout (``rein48_tpu_torch.engine.fused``).

The plain version is held bit for bit against the JAX package's plain
reference (``rein48_tpu.engine.fused.rollout_bits_reference``) on the same
injected words. The CUDA kernel runs only on the card: its tests are in
``test_torch_cuda.py``, which imports no JAX so that it runs there, and
``chip_smoke.py`` is what proves it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rein48_tpu.engine import fused as jfused
from rein48_tpu_torch.engine import fused, philox, vector
from rein48_tpu_torch.testing import edge_boards

from test_torch_engine import jax_state, random_boards, torch_state

torch.set_num_threads(1)

STAT_FIELDS = ("episodes", "episode_length_sum", "episode_score_sum", "max_exponent")


def assert_rollouts_equal(a, b):
    (sa, ta), (sb, tb) = a, b
    for name in ("boards", "score", "steps"):
        np.testing.assert_array_equal(np.asarray(getattr(sa, name)), np.asarray(getattr(sb, name)), err_msg=name)
    for name in STAT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ta, name)), np.asarray(getattr(tb, name)), err_msg=name)


def _to_numpy(result):
    state, stats = result
    return (
        type("S", (), {k: getattr(state, k).numpy() for k in ("boards", "score", "steps")}),
        type("T", (), {k: getattr(stats, k).numpy() for k in STAT_FIELDS}),
    )


class TestPlainRollout:
    B, T = 256, 250

    @pytest.fixture(scope="class")
    def rollouts(self):
        rng = np.random.default_rng(0)
        boards = random_boards(rng, self.B)
        score = rng.integers(0, 1000, self.B).astype(np.float32)
        steps = rng.integers(0, 50, self.B).astype(np.int32)
        bits = rng.integers(0, 2**32, (self.T, 5, self.B), dtype=np.uint64)
        tstate = torch_state(boards)
        tstate.score, tstate.steps = torch.from_numpy(score), torch.from_numpy(steps)
        port = fused.rollout_bits_reference(tstate, torch.from_numpy(bits.astype(np.int64)))
        ref = jfused.rollout_bits_reference(
            jax_state(boards, score, steps), jnp.asarray(bits.astype(np.uint32))
        )
        return port, ref

    def test_matches_jax_reference(self, rollouts):
        port, ref = rollouts
        assert_rollouts_equal(_to_numpy(port), ref)

    def test_sample_is_nontrivial(self, rollouts):
        (_, stats), _ = rollouts
        assert int(stats.episodes.sum()) > self.B  # many terminal boards
        assert int((stats.episode_score_sum > 0).sum()) > self.B // 2  # merges
        assert int(stats.max_exponent.max()) >= 7


class TestStepEquivalence:
    def test_fused_step_matches_jax(self):
        B = 4096
        rng = np.random.default_rng(1)
        boards = random_boards(rng, B)
        bits = rng.integers(0, 2**32, (5, B), dtype=np.uint64)
        score = rng.integers(0, 1000, B).astype(np.int32)
        steps = np.full(B, 7, np.int32)
        cells = [torch.from_numpy(boards.reshape(B, 16)[:, i].astype(np.int32)) for i in range(16)]
        new_cells, new_score, new_steps, aux = fused.fused_step_soa(
            cells, torch.from_numpy(score), torch.from_numpy(steps), list(torch.from_numpy(bits.astype(np.int64)))
        )
        jcells = [jnp.asarray(boards.reshape(B, 16)[:, i].astype(np.int32)) for i in range(16)]
        jnew, jscore, jsteps, jaux = jax.jit(jfused.fused_step_soa)(
            jcells, jnp.asarray(score), jnp.asarray(steps), list(jnp.asarray(bits.astype(np.uint32)))
        )
        for i in range(16):
            np.testing.assert_array_equal(new_cells[i].numpy(), np.asarray(jnew[i]))
        np.testing.assert_array_equal(new_score.numpy(), np.asarray(jscore))
        np.testing.assert_array_equal(new_steps.numpy(), np.asarray(jsteps))
        for name in jaux:
            np.testing.assert_array_equal(aux[name].numpy(), np.asarray(jaux[name]), err_msg=name)
        # The sample exercises moves, merges, spawns and terminal boards.
        assert int(aux["changed"].sum()) > B // 2
        assert int((aux["reward"] > 0).sum()) > B // 10
        assert int(aux["done"].sum()) > 0


class TestEdgeBoards:
    """Positions random play rarely reaches (``testing.edge_boards``): the
    plain version against JAX's on the same boards and words. The card-only
    tests and ``chip_smoke.py`` hold the kernel to the plain version on
    them."""

    B, T = 512, 67

    @pytest.fixture(scope="class")
    def inputs(self):
        rng = np.random.default_rng(7)
        boards = edge_boards(self.B, 7)
        score = rng.integers(0, 2**20, self.B).astype(np.float32)
        steps = rng.integers(0, 1000, self.B).astype(np.int32)
        bits = rng.integers(0, 2**32, (self.T, 5, self.B), dtype=np.uint64)
        return boards, score, steps, bits

    def test_rollout_matches_jax_reference(self, inputs):
        boards, score, steps, bits = inputs
        tstate = torch_state(boards)
        tstate.score, tstate.steps = torch.from_numpy(score), torch.from_numpy(steps)
        port = fused.rollout_bits_reference(tstate, torch.from_numpy(bits.astype(np.int64)))
        ref = jfused.rollout_bits_reference(jax_state(boards, score, steps), jnp.asarray(bits.astype(np.uint32)))
        assert_rollouts_equal(_to_numpy(port), ref)

    def test_first_step_matches_jax_and_meets_the_edges(self, inputs):
        boards, score, steps, bits = inputs
        cells = [torch.from_numpy(boards.reshape(self.B, 16)[:, i].astype(np.int32)) for i in range(16)]
        _, _, _, aux = fused.fused_step_soa(
            cells, torch.from_numpy(score.astype(np.int32)), torch.from_numpy(steps), list(torch.from_numpy(bits[0].astype(np.int64)))
        )
        jcells = [jnp.asarray(boards.reshape(self.B, 16)[:, i].astype(np.int32)) for i in range(16)]
        _, _, _, jaux = jax.jit(jfused.fused_step_soa)(
            jcells, jnp.asarray(score.astype(np.int32)), jnp.asarray(steps), list(jnp.asarray(bits[0].astype(np.uint32)))
        )
        for name in jaux:
            np.testing.assert_array_equal(aux[name].numpy(), np.asarray(jaux[name]), err_msg=name)
        reward = aux["reward"].numpy()
        assert (reward >= 2**16).any()  # a 15+15 merge (scores 2**16, stays 15)
        assert aux["done"].any() and (~aux["changed"] & aux["done"]).any()  # dead boards reset at once
        assert int(aux["board_max_exp"].max()) == 15
        assert ((boards == 0).all(axis=(1, 2)) & ~aux["changed"].numpy()).any()  # the empty board never moves

    def test_boards_are_legal_and_cover_every_orientation(self):
        boards = edge_boards(4096, 0)
        assert boards.dtype == np.uint8 and boards.shape == (4096, 4, 4) and int(boards.max()) <= 15
        merge_row = np.array([8, 8, 8, 0], np.uint8)
        for rows in (boards, boards.transpose(0, 2, 1)):  # as a row and as a column, both ways round
            assert (rows == merge_row).all(-1).any() and (rows == merge_row[::-1]).all(-1).any()


class TestWrapper:
    def test_cpu_state_takes_the_plain_path(self):
        state = vector.reset_batch(2, 300, device="cpu")
        before = fused.launches
        got = fused.rollout_random_fused(state, 5, 40)
        want = fused.rollout_bits_reference(state, philox.philox_bits(5, 40, 300))
        assert_rollouts_equal(_to_numpy(got), _to_numpy(want))
        bits = philox.philox_bits(6, 40, 300)
        assert_rollouts_equal(
            _to_numpy(fused.rollout_random_fused(state, 0, 40, bits=bits)),
            _to_numpy(fused.rollout_bits_reference(state, bits)),
        )
        assert fused.launches == before

    def test_chunked_philox_equals_one_draw(self):
        # The plain Philox mode draws its words 64 steps at a time.
        state = vector.reset_batch(3, 16, device="cpu")
        got = fused.rollout_random_reference(state, 9, 150)
        want = fused.rollout_bits_reference(state, philox.philox_bits(9, 150, 16))
        assert_rollouts_equal(_to_numpy(got), _to_numpy(want))

    def test_state_streams_are_left_alone(self):
        state = vector.reset_batch(2, 8, device="cpu")
        new_state, _ = fused.rollout_random_fused(state, 1, 10)
        assert torch.equal(new_state.counter, state.counter)
        assert torch.equal(new_state.env_id, state.env_id)
        assert not new_state.done.any()

    def test_illegal_boards_are_refused(self):
        # The kernel packs a cell into 4 bits: an exponent of 16 is refused
        # on entry, on the CPU as on the card, also after an in-place edit
        # of a board a rollout returned.
        state = vector.reset_batch(2, 8, device="cpu")
        state.boards[3, 1, 2] = 16
        with pytest.raises(ValueError, match="at most 15"):
            fused.rollout_random_fused(state, 1, 10)
        state.boards[3, 1, 2] = 15
        out, _ = fused.rollout_random_fused(state, 1, 10)
        out.boards[0, 0, 0] = 16
        with pytest.raises(ValueError, match="at most 15"):
            fused.rollout_random_fused(out, 1, 10)

    def test_other_devices_raise(self):
        state = vector.reset_batch(2, 8, device="cpu").map(lambda t: t.to("meta"))
        with pytest.raises(ValueError, match="no rollout kernel"):
            fused.rollout_random_fused(state, 1, 10)

# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's n-tuple expectimax player against the benchmark's plain
reference (``portbench/reference/search_ntuple.py``), on the CPU.

The policy is the one ``eval --algo ntuple --depth d`` serves
(``train.ntuple._get_ntuple_policy``): the raw merge score as the reward,
no discount, a dead max node worth 0. Tables are drawn from a seed, normal
of standard deviation 1 in score units, as the benchmark draws them.

Tolerance. Port and reference add the same float32 terms in other orders
(the lookups, the chance chunks), so Q agrees to a few ulps of its size:
at most 2.5e-7 of ``max(1, |Q|)`` measured here on Q up to about 370,
hence ``Q_TOL = 2e-6`` relative. Actions are compared wherever the
reference's best and second-best legal Q lie further apart than that.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.reference import ntuple as ref_ntuple  # noqa: E402
from portbench.reference import search as ref_search  # noqa: E402
from portbench.reference import search_ntuple as ref  # noqa: E402
from rein48_tpu_torch.agents import ntuple  # noqa: E402
from rein48_tpu_torch.control import search  # noqa: E402
from rein48_tpu_torch.engine import core, vector  # noqa: E402
from rein48_tpu_torch.train import ntuple as nt  # noqa: E402
from rein48_tpu_torch.utils import profiling  # noqa: E402

torch.set_num_threads(2)

Q_TOL = 2e-6

DEAD = [[1, 2, 1, 2], [2, 1, 2, 1], [1, 2, 1, 2], [2, 1, 2, 1]]
# One blank cell, a few merges open.
NEARLY_FULL = [[5, 3, 2, 1], [6, 4, 4, 0], [7, 5, 3, 2], [9, 8, 6, 6]]
# A 2^15 tile beside a 2^14 one, and two 2^14 tiles that merge into a 2^15:
# a spawn on either cell would lift it past the 16 values a tuple cell holds.
BIG_TILES = [
    [[15, 14, 3, 1], [2, 5, 0, 0], [1, 0, 0, 2], [0, 0, 1, 0]],
    [[14, 14, 2, 0], [3, 0, 0, 1], [0, 1, 0, 0], [0, 0, 0, 2]],
]


def tables_for(tuples, seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {f"t{i}": torch.randn(16 ** len(t), generator=g) for i, t in enumerate(tuples)}


def boards_for(seed: int, n: int = 4, moves: int = 50) -> torch.Tensor:
    """``n`` mid-game boards (``moves`` moves of random legal play from the
    engine's start), then the dead board and the nearly full one."""
    g = torch.Generator().manual_seed(seed)
    env = vector.reset_batch(seed, n, "cpu")
    for _ in range(moves):
        _, _, legal = search._afterstates(env.boards)
        env, _ = vector.step_autoreset(env, torch.multinomial(legal.float() + 1e-9, 1, generator=g)[:, 0])
    extra = torch.tensor([DEAD, NEARLY_FULL], dtype=torch.uint8)
    return torch.cat([env.boards, extra])


def port_q(tuples, params, boards, depth, chance_chunk):
    net = nt.get_network(nt.NTupleTrainConfig(tuples=tuples).network_config("cpu"))
    return search._action_values(boards, depth, net.make_leaf(params), lambda r: r, 1.0, 0.0, chance_chunk)


def top_two_gap(q: torch.Tensor) -> torch.Tensor:
    s = q.sort(-1).values
    gap = s[:, -1] - s[:, -2]
    return torch.where(torch.isfinite(s[:, -2]), gap, torch.inf)


@pytest.mark.parametrize("preset", ["TINY_2X3", "SJ_2X4"])
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("chance_chunk", [8, None])
def test_policy_matches_the_reference(preset, depth, chance_chunk):
    tuples = getattr(ntuple, preset)
    params = tables_for(tuples, seed=11 + depth)
    boards = boards_for(seed=7 + depth, n=3 if depth == 2 else 8)
    q, legal = port_q(tuples, params, boards, depth, chance_chunk)
    want = ref.action_values(ref_ntuple.Network(tuples, "cpu"), [params[f"t{i}"] for i in range(len(tuples))],
                             boards, depth, block=2)
    assert torch.equal(legal, torch.isfinite(want))
    scale = want.abs().clamp(min=1.0)
    err = torch.where(legal, (q - want).abs() / scale, 0.0)
    assert float(err.max()) <= Q_TOL, float(err.max())
    assert float(torch.where(legal, want.abs(), 0.0).max()) > 10.0  # the rewards are in the sums
    actions = nt._get_ntuple_policy(nt.NTupleTrainConfig(tuples=tuples).network_config("cpu"), depth, chance_chunk)(
        params, boards)
    clear = top_two_gap(want) > Q_TOL * want.max(-1).values.abs().clamp(min=1.0)
    live = legal.any(-1)
    assert torch.equal(actions[clear & live], want.argmax(-1)[clear & live])
    assert int(actions[~live].max()) == 0  # the dead board: action 0, as the port's policy picks
    assert not bool(live[-2]) and bool(live[-1])


@pytest.mark.parametrize("chance_chunk", [8, None])
def test_boards_with_2_15_tiles_match_the_reference(chance_chunk):
    """The tree spawns only on blank cells, so no leaf board holds an
    exponent past 15 and every lookup stays inside its table."""
    tuples = ntuple.SJ_2X4
    params = tables_for(tuples, seed=15)
    boards = torch.tensor(BIG_TILES, dtype=torch.uint8)
    q, legal = port_q(tuples, params, boards, 2, chance_chunk)
    want = ref.action_values(ref_ntuple.Network(tuples, "cpu"), [params[f"t{i}"] for i in range(len(tuples))],
                             boards, 2, block=1)
    assert torch.equal(legal, torch.isfinite(want)) and bool(legal.all(-1).any())
    assert bool(torch.isfinite(q[legal]).all())
    err = torch.where(legal, (q - want).abs() / want.abs().clamp(min=1.0), 0.0)
    assert float(err.max()) <= Q_TOL, float(err.max())
    actions = nt._get_ntuple_policy(nt.NTupleTrainConfig(tuples=tuples).network_config("cpu"), 2, chance_chunk)(
        params, boards)
    clear = top_two_gap(want) > Q_TOL * want.max(-1).values.abs().clamp(min=1.0)
    assert torch.equal(actions[clear], want.argmax(-1)[clear])


def test_needed_leaves_counts_the_legal_leaves():
    boards = boards_for(seed=3, n=6)
    _, _, legal = search._afterstates(boards)
    assert ref.needed_leaves(boards, depth=0) == int(legal.sum())
    assert ref.needed_leaves(boards, depth=1, block=4) == ref_search.needed_leaves(boards)
    assert ref.needed_leaves(boards[-2:], depth=2) < 65_536 * 2  # the dead board needs none
    assert ref.needed_leaves(boards[-2:-1], depth=2) == 0


def test_a_chunked_leaf_equals_an_unchunked_one():
    tuples = ntuple.SJ_2X4
    net = nt.get_network(nt.NTupleTrainConfig(tuples=tuples).network_config("cpu"))
    params = tables_for(tuples, seed=5)
    seen = []

    def leaf(b):
        seen.append(b)
        return torch.zeros(b.shape[:-2])

    search._action_values(boards_for(seed=4, n=2), 1, leaf, lambda r: r, 1.0, 0.0, None)
    (after,) = seen
    whole = net.make_leaf(params, max_batch=after.numel() // core.NUM_CELLS)(after)
    chunked = net.make_leaf(params, max_batch=1000)(after)
    assert after.numel() // core.NUM_CELLS > 1000
    assert whole.shape == after.shape[:-2]
    assert torch.equal(chunked, whole)
    assert torch.equal(whole, net.value(params, after))


@pytest.mark.parametrize("chance_chunk, calls", [(8, 16), (None, 1)])
def test_depth2_counts_65536_leaf_boards_a_board(chance_chunk, calls):
    tuples = ntuple.TINY_2X3
    params = tables_for(tuples, seed=2)
    policy = nt._get_ntuple_policy(nt.NTupleTrainConfig(tuples=tuples).network_config("cpu"), 2, chance_chunk)
    boards = boards_for(seed=6, n=2)
    with profiling.tracing() as trace:
        policy(params, boards)
    assert trace.counters == {"search.leaf_boards": 65_536 * boards.shape[0]}
    leaves = [s for s in trace.spans if s.name == "search.leaf"]
    (move,) = [s for s in trace.spans if s.name == "search.policy"]
    assert len(leaves) == calls and all(s.parent == move.id for s in leaves)


def test_the_cpu_player_runs_its_eager_move():
    """Off the card the player holds no graph: each call is its eager move,
    with the spans' switch read from ``profiling.on()``."""
    tuples = ntuple.TINY_2X3
    params = tables_for(tuples, seed=8)
    policy = nt._get_ntuple_policy.__wrapped__(nt.NTupleTrainConfig(tuples=tuples).network_config("cpu"), 2, 8)
    boards = boards_for(seed=9, n=2)
    assert not profiling.on()
    first, second = policy(params, boards), policy(params, boards)
    assert torch.equal(first, second) and torch.equal(first, policy.eager(params, boards))
    assert policy._graph is None
    with profiling.tracing():
        assert profiling.on()
        assert torch.equal(policy(params, boards), first)
    assert not profiling.on()

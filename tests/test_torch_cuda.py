# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Card-only tests of the port's CUDA kernels against their plain versions,
and of the device paths that must agree with the CPU's.

They skip without a CUDA device. This file imports no JAX, so that it runs
where the card is and JAX is not; there, from the repository root:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX.)
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from rein48_tpu_torch import Game, native
from rein48_tpu_torch.agents import ntuple
from rein48_tpu_torch.engine import core, fused, philox, vector
from rein48_tpu_torch.models import nets, obs
from rein48_tpu_torch.ops import hbm_tables, layer_norm, tables
from rein48_tpu_torch.testing import (
    LN_GRAD_TOL, ROLLOUT_STATS, assert_ln_forward_close, assert_ln_grads_close, assert_same_rollout,
    assert_same_step, assert_scatter_matches, assert_sums_close, edge_boards, ln_masked_reference_grads, ln_plain,
)
from rein48_tpu_torch.ops import ntuple_value as value_ops
from rein48_tpu_torch.train import a3c, afterstate, common, dqn, ppo
from rein48_tpu_torch.utils import profiling
from rein48_tpu_torch.utils.checkpoint import Checkpointer

import torch_dist_ranks as ranks

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card: python -m pytest tests/test_torch_cuda.py --noconftest")
    return torch.device("cuda")


def count(name: str) -> int:
    """A counter of the registry (``utils/profiling.counters``); 0 before its first count."""
    return profiling.counters.get(name, 0)


def counts(prefix: str) -> dict:
    """The registry's counters whose names start with ``prefix``."""
    return {k: v for k, v in profiling.counters.items() if k.startswith(prefix)}


@pytest.mark.parametrize("batch, steps", [(1000, 67), (128, 1), (8192, 64)])
def test_rollout_kernel_matches_plain(cuda, batch, steps):
    # Ragged batches mask the last block; T % 4 != 0 ends inside a word group.
    state = vector.reset_batch(1, batch, cuda)
    bits = philox.philox_bits(4, steps, batch, device=cuda)
    want = fused.rollout_bits_reference(state, bits)
    before = count("fused.rollout_launches")
    assert_same_rollout(fused.rollout_random_fused(state, 0, steps, bits=bits), want)
    assert_same_rollout(fused.rollout_random_fused(state, 4, steps), want)
    assert count("fused.rollout_launches") == before + 2


def test_rollout_kernel_slice_draws_the_global_streams(cuda):
    # A rank's share of a batch (envs 300..699) rolls as those envs of the whole.
    whole = vector.reset_batch(2, 1000, cuda)
    want_state, want_stats = fused.rollout_random_fused(whole, 9, 37)
    rows = slice(300, 700)
    part = dataclasses.replace(whole, **{f.name: getattr(whole, f.name)[rows] for f in dataclasses.fields(whole)})
    got = fused.rollout_random_fused(part, 9, 37, env_base=300)
    assert_same_rollout(got, fused.rollout_random_reference(part, 9, 37, env_base=300))
    for name in ("boards", "score", "steps"):
        assert torch.equal(getattr(got[0], name), getattr(want_state, name)[rows]), name
    for name in ROLLOUT_STATS:
        assert torch.equal(getattr(got[1], name), getattr(want_stats, name)[rows]), name


@pytest.mark.parametrize("batch, steps", [(b, t) for b in (1, 513, 1000) for t in (1, 3, 67)] + [(65536, 64)])
def test_rollout_kernel_edge_boards(cuda, batch, steps):
    # Merges at the exponent cap, dead boards, one legal direction, one
    # blank left, rows of equal tiles; ragged batches, and the bench batch;
    # both modes.
    g = torch.Generator().manual_seed(batch * 100 + steps)
    state = vector.reset_batch(3, batch, cuda)
    state.boards = torch.from_numpy(edge_boards(batch, batch + steps)).to(cuda)
    state.score = torch.randint(0, 2**20, (batch,), generator=g).to(torch.float32).to(cuda)
    state.steps = torch.randint(0, 1000, (batch,), generator=g, dtype=torch.int32).to(cuda)
    bits = philox.philox_bits(5, steps, batch, device=cuda)
    want = fused.rollout_bits_reference(state, bits)
    before = count("fused.rollout_launches")
    assert_same_rollout(fused.rollout_random_fused(state, 0, steps, bits=bits), want)
    assert_same_rollout(fused.rollout_random_fused(state, 5, steps), want)
    assert count("fused.rollout_launches") == before + 2


def test_rollout_kernel_table_is_uploaded_once(cuda):
    state = vector.reset_batch(1, 64, cuda)
    fused.rollout_random_fused(state, 1, 4)
    table = fused._device_table(state.boards.device)
    fused.rollout_random_fused(state, 2, 4)
    assert fused._device_table(state.boards.device) is table
    assert torch.equal(table.cpu(), torch.from_numpy(fused.row_table_bytes()))


def test_rollout_kernel_rejects_bad_words(cuda):
    state = vector.reset_batch(1, 256, cuda)
    before = count("fused.rollout_launches")
    with pytest.raises(ValueError, match="bits must be"):
        fused.rollout_random_fused(state, 0, 8, bits=philox.philox_bits(0, 7, 256, device=cuda))
    assert count("fused.rollout_launches") == before


def test_rollout_kernel_refuses_exponent_16(cuda):
    # The kernel packs a cell into 4 bits; a board with an exponent of 16
    # never reaches it, whether it came from outside or is a rollout's
    # output edited in place.
    state = vector.reset_batch(1, 256, cuda)
    state.boards = torch.from_numpy(edge_boards(256, 1)).to(cuda)
    state.boards[7, 2, 3] = 16
    before = count("fused.rollout_launches")
    with pytest.raises(ValueError, match="at most 15"):
        fused.rollout_random_fused(state, 0, 8)
    state.boards[7, 2, 3] = 15
    out, _ = fused.rollout_random_fused(state, 0, 8)
    out.boards[0, 0, 0] = 16
    with pytest.raises(ValueError, match="at most 15"):
        fused.rollout_random_fused(out, 0, 8)
    assert count("fused.rollout_launches") == before + 1


# Step n's words start at lane 5n & 3 = n & 3 of block 5n >> 2; at this n
# the block is 2**32 - 1 and the step's second block crosses 2**32.
CROSSING_COUNTER = (2**34 - 4) // 5


def step_state(batch: int, device, seed: int, counter: int, env_base: int = 0) -> core.EnvState:
    """Edge boards and random ones, scores, steps, seeds and env ids (from
    ``env_base``) as given, counters ``counter .. counter + 3`` (each value
    of ``5n & 3``)."""
    g = torch.Generator().manual_seed(batch + seed % 1000 + counter % 1000)
    state = vector.reset_batch(seed, batch, device)
    boards = torch.from_numpy(edge_boards(batch, batch + counter % 1000))
    sparse = torch.randint(0, 16, (batch, 4, 4), generator=g, dtype=torch.uint8)
    sparse *= torch.rand((batch, 4, 4), generator=g) < 0.6
    mixed = torch.where((torch.arange(batch) % 2 == 0)[:, None, None], boards, sparse)
    return dataclasses.replace(
        state,
        boards=mixed.to(device),
        score=(torch.randint(0, 2**22, (batch,), generator=g) + torch.rand(batch, generator=g)).float().to(device),
        steps=torch.randint(0, 5000, (batch,), generator=g, dtype=torch.int32).to(device),
        env_id=torch.arange(env_base, env_base + batch, dtype=torch.int64, device=device),
        counter=(counter + torch.arange(batch, dtype=torch.int64) % 4).to(device),
    )


def plain_step(state, actions, bits=None, reward_mode=core.RewardMode.MERGE_SCORE):
    """The plain step on the card's tensors: the kernel's oracle."""
    if bits is not None:
        return vector._step_from_bits(state, actions, bits, reward_mode)
    return vector._advance(state, actions, philox.step_words(state.seed, state.env_id, state.counter), reward_mode)


@pytest.mark.parametrize("reward_mode", list(core.RewardMode))
@pytest.mark.parametrize("batch", [1, 256, 1000, 8192])
def test_engine_step_kernel_matches_plain(cuda, batch, reward_mode):
    # Edge boards (full, dead, near-full, 2^15 pairs that saturate) under
    # every action, so illegal moves that spawn nothing too; seeds and env
    # ids at and above 2**32; counters at each lane, and across a 2**32 block.
    g = torch.Generator().manual_seed(batch)
    for seed, counter, env_base in [(7, 1, 0), (2**32 + 7, CROSSING_COUNTER - 2, 2**32 - 5), (2**62 + 3, 2**33, 2**40)]:
        state = step_state(batch, cuda, seed, counter, env_base)
        bits = torch.randint(0, 2**32, (batch, 4), generator=g, dtype=torch.int64).to(cuda)
        for a in [0, 1, 2, 3, None]:
            actions = (torch.randint(0, 4, (batch,), generator=g) if a is None else torch.full((batch,), a)).to(cuda)
            got = vector.step_autoreset(state, actions, reward_mode)
            assert_same_step(got, plain_step(state, actions, reward_mode=reward_mode))
            assert got[0].seed is state.seed and got[0].env_id is state.env_id
            # Injected words: the words of a step, strided, and drawn ones.
            words = philox.step_words(state.seed, state.env_id, state.counter)[:, philox.SPAWN_RANK :]
            for b in (words, bits):
                got = vector.step_autoreset_from_bits(state, actions, b, reward_mode)
                assert_same_step(got, plain_step(state, actions, b, reward_mode))
                assert got[0].counter is state.counter


def test_engine_step_is_one_launch(cuda):
    from torch.profiler import ProfilerActivity, profile

    state = step_state(8192, cuda, 3, 5)
    actions = torch.randint(0, 4, (8192,), device=cuda)
    bits = philox.step_words(state.seed, state.env_id, state.counter)[:, philox.SPAWN_RANK :]
    steps = (lambda: vector.step_autoreset(state, actions), lambda: vector.step_autoreset_from_bits(state, actions, bits))
    for step in steps:
        step()
        torch.cuda.synchronize()
        before = (count("engine.step_launches"), count("engine.step_plain"))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        kernels, launches = profiling.kernel_times(prof)
        assert launches == 1 and sum(calls for _, calls in kernels.values()) == 1, kernels
        assert (count("engine.step_launches"), count("engine.step_plain")) == (before[0] + 1, before[1])


def test_engine_step_replays_in_a_cuda_graph(cuda):
    state = step_state(1000, cuda, 9, 2)
    actions = torch.randint(0, 4, (1000,), device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        vector.step_autoreset(state, actions)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = vector.step_autoreset(state, actions)
    # New inputs in place, then the replay: the plain step of those inputs.
    for k in range(3):
        fresh = step_state(1000, cuda, 9, 11 + k)
        for f in ("boards", "score", "steps", "counter"):
            getattr(state, f).copy_(getattr(fresh, f))
        actions.copy_(torch.randint(0, 4, (1000,), device=cuda))
        graph.replay()
        assert_same_step(captured, plain_step(state, actions))


def table_inputs(n: int, size: int, device, seed: int = 0):
    """Indices with heavy collisions (a third on a few hot entries), values
    with a share of exact zeros of both signs."""
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, size, (n,), generator=g, dtype=torch.int32)
    hot = torch.rand(n, generator=g) < 0.3
    idx[hot] = torch.randint(0, 4, (int(hot.sum()),), generator=g, dtype=torch.int32)
    vals = torch.randn(n, generator=g)
    vals[torch.rand(n, generator=g) < 0.2] = 0.0
    vals[torch.rand(n, generator=g) < 0.05] = -0.0
    return idx.to(device), vals.to(device)


@pytest.mark.parametrize("n", [1, 1000, 65537])
@pytest.mark.parametrize("size", [4096, 65536])
def test_table_gather_kernel_is_bit_equal(cuda, n, size):
    table = torch.randn(size, generator=torch.Generator().manual_seed(n)).to(cuda)
    idx, _ = table_inputs(n, size, cuda)
    before = count("tables.table_gather")
    got = tables.mxu_gather(table, idx.reshape(1, -1))
    assert count("tables.table_gather") == before + 1
    assert got.shape == (1, n) and torch.equal(got[0], tables.gather_reference(table, idx))


def trainer_stream(n: int, device):
    """What the SJ_2X4 trainer (B=1,024, T=128) three updates in feeds table
    0's stats scatter, its tables frozen: each step's 2,048 backups x 8
    lookups, so one step is 16,384 elements and a delayed window of four
    65,536; trained boards repeat many entries."""
    from rein48_tpu_torch.train import ntuple as nt

    cfg = nt.NTupleTrainConfig(tuples=ntuple.SJ_2X4, batch_size=1024, steps_per_update=128)
    state, net = nt.init_ntuple(cfg, 20260, device)
    step = nt.make_ntuple_step(cfg, device)
    for _ in range(3):
        state, _ = step(state)
    env, prev_after, prev_valid, idx, vals = state.env, state.prev_after, state.prev_valid, [], []
    with torch.no_grad():
        while sum(i.numel() for i in idx) < n:
            env, prev_after, done, boards, errs, _ = nt._policy_and_backups(net, state.params, env, prev_after, prev_valid)
            prev_valid = 1.0 - done
            lookups = net.indices(boards)[0]
            idx.append(lookups.reshape(-1))
            vals.append(errs[:, None].expand_as(lookups).reshape(-1))
    idx, vals = torch.cat(idx), torch.cat(vals)
    assert idx.numel() == n
    return idx, vals


def table_stream(stream: str, n: int, size: int, device, seed: int = 0):
    """``table_inputs``; "one-entry": every element on one entry; "all-zero":
    every value an exact zero of either sign; "trainer": ``trainer_stream``
    (SJ_2X4's tables hold 65,536 entries)."""
    if stream == "trainer":
        assert size == 65536
        return trainer_stream(n, device)
    idx, vals = table_inputs(n, size, device, seed)
    if stream == "one-entry":
        idx = torch.full_like(idx, 12345 % size)
    elif stream == "all-zero":
        vals = torch.where(torch.arange(n, device=device) % 3 == 0, -0.0, 0.0)
    return idx, vals


TABLE_SCATTER_CASES = [(n, stream) for n in (1, 1000, 65537) for stream in ("random", "one-entry", "all-zero")] + [
    (16384, "trainer"), (65536, "trainer"),
]


@pytest.mark.parametrize("n, stream", TABLE_SCATTER_CASES)
def test_table_scatter_kernel_matches_plain(cuda, n, stream):
    size = 65536
    idx, vals = table_stream(stream, n, size, cuda, seed=n)
    before = count("tables.table_scatter")
    got = tables.mxu_scatter_stats(size, idx, vals)
    got_sum = tables.mxu_scatter_sum(size, idx, vals)
    assert count("tables.table_scatter") == before + 2
    want = tables.scatter_reference(size, idx, vals, stats=True)
    # Atomics add in an order that changes from run to run: sums to a tolerance.
    assert_sums_close(got[0], want[0], want[1])
    assert_sums_close(got[1], want[1], want[1])
    assert_sums_close(got_sum, want[0], want[1])
    assert torch.equal(got[2], want[2])  # hits: exact counts of nonzero values


@pytest.mark.parametrize("stream", ["random", "one-entry", "all-zero"])
def test_table_scatter_kernel_is_repeatable(cuda, stream):
    # A second run on reused memory gives the same hits, and sums within the tolerance.
    size = 65536
    idx, vals = table_stream(stream, 65536, size, cuda, seed=7)
    first, second = (tables.mxu_scatter_stats(size, idx, vals) for _ in range(2))
    assert torch.equal(first[2], second[2])
    assert_sums_close(first[0], second[0], first[1])
    assert_sums_close(first[1], second[1], first[1])


def test_table_scatter_call_launches(cuda):
    idx, vals = table_inputs(16384, 65536, cuda)
    r = profiling.device_breakdown(lambda: tables.mxu_scatter_stats(65536, idx, vals), reps=1, top=8)
    assert r["launches"] == 2, r  # the zero fill and the kernel


def test_table_kernels_reject_bad_inputs(cuda):
    table = torch.zeros(256, device=cuda)
    idx = torch.zeros(8, dtype=torch.int32, device=cuda)
    before = counts("tables.")
    with pytest.raises(ValueError, match="idx must be torch.int32"):
        tables.mxu_gather(table, idx.long())
    with pytest.raises(ValueError, match="idx must be torch.int32 on cuda"):
        tables.mxu_gather(table, idx.cpu())
    with pytest.raises(ValueError, match="vals must be torch.float32"):
        tables.mxu_scatter_stats(256, idx, torch.zeros(8, dtype=torch.float16, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        tables.mxu_scatter_sum(256, idx, torch.zeros((8, 2), device=cuda)[:, 0])
    assert counts("tables.") == before


@pytest.mark.parametrize("update, n", [("tc", 512), ("delayed", 8192), ("delayed-no-tc", 8192)])
def test_ntuple_mxu_backend_matches_torch_backend(cuda, update, n):
    # Three updates of each kind; a delayed window at the trainer's shape
    # (four steps of 2,048 backups at B=1,024), with and without TC.
    mxu = ntuple.NTupleNetwork(ntuple.NTupleConfig(tuples=ntuple.SJ_2X4, backend="mxu"))
    plain = ntuple.NTupleNetwork(ntuple.NTupleConfig(tuples=ntuple.SJ_2X4, backend="torch"))
    g = torch.Generator().manual_seed(3)
    boards = torch.randint(0, 8, (n, 4, 4), generator=g, dtype=torch.uint8).to(cuda)
    err = torch.randn(n, generator=g).to(cuda)

    def apply(net, params, e):
        if update == "tc":
            return net.td_apply_tc(params, boards, e, 1.0)
        return net.td_apply_delayed(params, boards, e, 1.0, tc=update == "delayed")

    a, b, scale = mxu.init_tc(cuda), plain.init_tc(cuda), plain.init_tc(cuda)
    for _ in range(3):
        apply(mxu, a, err)
        apply(plain, b, err)
        apply(plain, scale, err.abs())  # the same update on magnitudes
    for k in b:
        assert_sums_close(a[k], b[k], scale[k].abs())
    assert_values_match(mxu, plain, a, a, boards)


def assert_values_match(net, plain, params, plain_params, boards):
    """``net.value`` (the fused kernel) bit-equal to its plain version, and
    within the scaled tolerance of the ``"torch"`` backend's value on the
    CPU, which is that plain version run there on the logical tables. The
    scale is the same value on the tables' magnitudes. On the card the
    ``"torch"`` backend takes the kernel too, bit-equal to its plain
    version."""
    got = net.value(params, boards)
    assert torch.equal(got, value_ops.ntuple_value_reference(net.indices(boards), *net.value_tables(params)))
    cpu, cpu_boards = {k: v.cpu() for k, v in plain_params.items()}, boards.cpu()
    scale = plain.value({k: v.abs() for k, v in cpu.items()}, cpu_boards)
    assert_sums_close(got.cpu(), plain.value(cpu, cpu_boards), scale)
    on_card = plain.value(plain_params, boards)
    assert torch.equal(on_card, value_ops.ntuple_value_reference(plain.indices(boards), *plain.value_tables(plain_params)))


def hot_prefix_inputs(n: int, size: int, k: int, device, seed: int = 0):
    """A random row map, its ``k`` hot rows, and ``n`` lookups of which about
    70% fall in hot rows (duplicates included), errors with exact zeros."""
    g = torch.Generator().manual_seed(seed)
    rows = size // hbm_tables.ROW
    rm = torch.randperm(rows, generator=g).to(torch.int32)  # logical row -> physical row
    hot = torch.argsort(rm)[:k].to(torch.int32)  # the logical rows in physical slots 0..k-1
    idx = torch.randint(0, size, (n,), generator=g, dtype=torch.int32)
    in_hot = torch.rand(n, generator=g) < 0.7
    lanes = torch.randint(0, 8, (int(in_hot.sum()),), generator=g, dtype=torch.int32)
    idx[in_hot] = hot[torch.randint(0, k, (int(in_hot.sum()),), generator=g)] * hbm_tables.ROW + lanes
    err = torch.randn(n, generator=g)
    err[torch.rand(n, generator=g) < 0.2] = 0.0
    err[torch.rand(n, generator=g) < 0.05] = -0.0
    return rm.to(device), hot.to(device), idx.to(device), err.to(device)


@pytest.mark.parametrize("n", [1, 1000, 65537])
def test_cached_gather_kernel_is_bit_equal(cuda, n):
    size = 16**5
    rm, hot, idx, _ = hot_prefix_inputs(n, size, 1024, cuda, seed=n)
    table = torch.randn(size, generator=torch.Generator().manual_seed(1)).to(cuda)
    before = count("hbm_tables.cached_gather")
    got = hbm_tables.cached_gather(table, rm, hot, idx.reshape(1, -1), prefix_rows=1024)
    assert count("hbm_tables.cached_gather") == before + 1
    assert got.shape == (1, n) and torch.equal(got[0], hbm_tables.cached_gather_reference(table, rm, idx))


def scatter_stream(stream: str, n: int, k: int, cold_capacity_rows: int, device, seed: int = 0):
    """``k`` hot rows in random order among 131,072 rows, and ``n`` lookups
    (8 lanes a row, so entries repeat) with errors of which a share are
    exact zeros of both signs. "random": about 70% in hot rows;
    "one-entry": all on one hot entry; "all-cold": none in hot rows;
    "at-capacity" / "over-capacity": every 16,384-element block has exactly
    its capacity / one more cold elements."""
    g = torch.Generator().manual_seed(seed)
    rows = torch.randperm(1 << 17, generator=g).to(torch.int32)
    hot, cold_rows = rows[:k], rows[k:]

    def lookups(among):
        at = among[torch.randint(0, among.numel(), (n,), generator=g)]
        return at * hbm_tables.ROW + torch.randint(0, 8, (n,), generator=g, dtype=torch.int32)

    in_hot = torch.rand(n, generator=g) < (0.7 if stream == "random" else 0.0 if stream == "all-cold" else 1.0)
    if stream in ("at-capacity", "over-capacity"):
        cold = cold_capacity_rows * hbm_tables.ROW + (stream == "over-capacity")
        for start in range(0, n, hbm_tables.BLOCK):
            size = min(hbm_tables.BLOCK, n - start)
            in_hot[start + torch.randperm(size, generator=g)[: min(cold, size)]] = False
    idx = torch.where(in_hot, lookups(hot), lookups(cold_rows))
    if stream == "one-entry":
        idx = torch.full_like(idx, int(hot[k // 2]) * hbm_tables.ROW + 5)
    err = torch.randn(n, generator=g)
    err[torch.rand(n, generator=g) < 0.2] = 0.0
    err[torch.rand(n, generator=g) < 0.05] = -0.0
    return hot.to(device), idx.to(device), err.to(device)


SCATTER_CASES = [("random", n, 2048, cr) for n in (1, 16384, 40000) for cr in (16, 1)] + [
    (stream, 40000, k, cr)
    for stream in ("random", "one-entry", "all-cold", "at-capacity", "over-capacity")
    # The smallest prefix the network makes, the cached default, the hash's largest, a binary search.
    for k in (128, 2048, 8192, 16384)
    for cr in (16, 1)
]


@pytest.mark.parametrize("stream, n, k, cold_capacity_rows", SCATTER_CASES)
def test_cached_scatter_kernel_matches_plain(cuda, stream, n, k, cold_capacity_rows):
    hot, idx, err = scatter_stream(stream, n, k, cold_capacity_rows, cuda, seed=n + k + cold_capacity_rows)
    before = count("hbm_tables.cached_scatter")
    got = hbm_tables.cached_scatter_blocks(hot, idx, err, prefix_rows=k, cold_capacity_rows=cold_capacity_rows)
    assert count("hbm_tables.cached_scatter") == before + 1
    want = hbm_tables.cached_scatter_stats_reference(hot, idx, err, cold_capacity_rows)
    assert_scatter_matches(got, want)
    *_, overflow = hbm_tables.cached_scatter_stats(hot, idx, err, prefix_rows=k, cold_capacity_rows=cold_capacity_rows)
    assert overflow.shape == () and overflow.dtype == torch.bool
    assert bool(overflow) == bool(want[5].max() > cold_capacity_rows * hbm_tables.ROW)
    if stream == "at-capacity":
        assert not bool(overflow)
    if stream == "over-capacity":
        assert bool(overflow)


@pytest.mark.parametrize("stream", ["random", "one-entry", "all-cold", "over-capacity"])
@pytest.mark.parametrize("k", [2048, 16384])
def test_cached_scatter_kernel_is_repeatable(cuda, stream, k):
    hot, idx, err = scatter_stream(stream, 65536, k, 16, cuda, seed=3)
    first, second = (hbm_tables.cached_scatter_blocks(hot, idx, err, prefix_rows=k) for _ in range(2))
    for name, a, b in zip(("hits", "cold_idx", "cold_err", "counts"), first[2:], second[2:]):
        assert torch.equal(a, b), name
    assert_sums_close(first[0], second[0], first[1])
    assert_sums_close(first[1], second[1], first[1])


@pytest.mark.parametrize("k", [2048, 8192])
def test_cached_scatter_call_sorts_nothing(cuda, k):
    hot, idx, err = scatter_stream("random", 65536, k, 16, cuda)
    r = profiling.device_breakdown(lambda: hbm_tables.cached_scatter_stats(hot, idx, err, prefix_rows=k), reps=1, top=8)
    assert r["launches"] <= 3 and not any("sort" in t["kernel"].lower() for t in r["top"]), r


def test_hot_prefix_kernels_reject_bad_inputs(cuda):
    rm, hot, idx, err = hot_prefix_inputs(64, 16**4, 128, cuda)
    table = torch.zeros(16**4, device=cuda)
    before = counts("hbm_tables.")
    with pytest.raises(ValueError, match="idx must be torch.int32 on cuda"):
        hbm_tables.cached_gather(table, rm, hot, idx.cpu(), prefix_rows=128)
    with pytest.raises(ValueError, match="hot_rows must have shape"):
        hbm_tables.cached_scatter_stats(hot[:64], idx, err, prefix_rows=128)
    with pytest.raises(ValueError, match="err must be torch.float32"):
        hbm_tables.cached_scatter_stats(hot, idx, err.half(), prefix_rows=128)
    assert counts("hbm_tables.") == before


def test_ntuple_cached_backend_matches_torch_backend(cuda):
    kw = dict(tuples=ntuple.SJ_2X4, prefix_rows=128)
    plain = ntuple.NTupleNetwork(ntuple.NTupleConfig(tuples=ntuple.SJ_2X4, backend="torch"))
    g = torch.Generator().manual_seed(5)
    boards = torch.randint(0, 8, (2048, 4, 4), generator=g, dtype=torch.uint8).to(cuda)
    err = torch.randn(2048, generator=g).to(cuda)
    for cold_capacity_rows, branch in ((128, "fast"), (1, "fallback")):  # 16,384 lookups a table, most cold
        cached = ntuple.NTupleNetwork(ntuple.NTupleConfig(backend="cached", cold_capacity_rows=cold_capacity_rows, **kw))
        a = cached.init_tc(cuda)
        for p in a.values():
            if p.dtype == torch.float32:
                p.copy_(torch.rand(p.shape, generator=g).to(cuda))
        a = cached.refresh_cache(a)
        rows = torch.arange(a["t0"].numel(), dtype=torch.int32, device=cuda)
        b = {k: v[hbm_tables.physical_index(a[f"{k[:2]}_rm"], rows)] for k, v in a.items() if v.dtype == torch.float32}
        scale = {k: v.abs() for k, v in b.items()}
        assert_values_match(cached, plain, a, b, boards)
        before = count(f"ntuple.cached_{branch}")
        cached.td_apply_delayed(a, boards, err, 1.0)
        assert count(f"ntuple.cached_{branch}") == before + 2
        plain.td_apply_delayed(b, boards, err, 1.0)
        plain.td_apply_delayed(scale, boards, err.abs(), 1.0)  # the same update on magnitudes
        for k in b:
            got = a[k][hbm_tables.physical_index(a[f"{k[:2]}_rm"], rows)]
            assert_sums_close(got, b[k], scale[k].abs())


def value_inputs(tuples, symmetric: bool, cached: bool, device, seed: int = 0):
    """A network, its tables (on a random row permutation for ``"cached"``)
    and what the op takes: ``(net, params, tables, rowmaps)``."""
    backend = "cached" if cached else "mxu"
    net = ntuple.NTupleNetwork(ntuple.NTupleConfig(tuples=tuples, symmetric=symmetric, backend=backend, prefix_rows=128))
    g = torch.Generator().manual_seed(seed)
    params = {}
    for i, n in enumerate(net.table_sizes):
        params[f"t{i}"] = torch.randn(n, generator=g).to(device)
        if cached:
            rm = torch.randperm(n // hbm_tables.ROW, generator=g).to(torch.int32)
            params[f"t{i}_rm"] = rm.to(device)
            params[f"t{i}_hot"] = torch.argsort(rm)[:128].to(torch.int32).to(device)
    return (net, params, *net.value_tables(params))


def value_boards(n: int, device, seed: int = 0, offset: int = 0) -> torch.Tensor:
    """``n`` boards of exponents 0..15 (the first all 15) starting ``offset``
    bytes into their buffer."""
    g = torch.Generator().manual_seed(seed)
    raw = torch.randint(0, 16, (16 * n + offset,), generator=g, dtype=torch.uint8)
    raw[offset : offset + 16 * min(n, 1)] = 15
    return raw.to(device)[offset:].view(n, 4, 4)


VALUE_NETS = [
    ("TINY_2X3", True, False), ("TINY_2X3", False, False), ("SJ_2X4", True, False), ("SJ_2X4", False, False),
    ("SJ_2X4", True, True), ("YEH_4X6", True, True), ("YEH_4X6", False, True),
]


@pytest.mark.parametrize("preset, symmetric, cached", VALUE_NETS)
@pytest.mark.parametrize("n, offset", [(0, 0), (1, 0), (33, 0), (4097, 0), (33, 1), (4097, 7)])
def test_ntuple_value_kernel_is_bit_equal(cuda, preset, symmetric, cached, n, offset):
    net, _, tabs, rowmaps = value_inputs(getattr(ntuple, preset), symmetric, cached, cuda, seed=n)
    boards = value_boards(n, cuda, seed=n + offset, offset=offset)
    layout = net._layout
    for b in (boards, boards.mT.contiguous().mT):  # row-major, and stored transposed as the engine's afterstates
        before = count("ntuple_value.launches")
        got = value_ops.ntuple_value(b, tabs, layout, rowmaps)
        assert count("ntuple_value.launches") == before + (n > 0)
        want = value_ops.ntuple_value_reference(net.indices(b), tabs, rowmaps)
        assert got.shape == (n,) and torch.equal(got, want)
        assert torch.equal(value_ops.ntuple_value(b, tabs, layout, rowmaps), got)  # the same bits again


@pytest.mark.parametrize("tuples, symmetric", [(ntuple.TINY_2X3 + ((1, 5, 9), (2, 6, 10), (12, 13, 14)), True),
                                               (tuple((c, c + 1, c + 2) for c in range(10)), False)])
def test_ntuple_value_kernel_groups_continue_the_sum(cuda, tuples, symmetric):
    net, _, tabs, _ = value_inputs(tuples, symmetric, False, cuda)
    boards = value_boards(1000, cuda, seed=2)
    before = count("ntuple_value.launches")
    got = value_ops.ntuple_value(boards, tabs, net._layout)
    assert count("ntuple_value.launches") == before + len(net._layout.groups) == before + 2
    assert torch.equal(got, value_ops.ntuple_value_reference(net.indices(boards), tabs))


@pytest.mark.parametrize("backend", ["mxu", "cached"])
def test_ntuple_value_is_one_launch(cuda, backend):
    tuples = ntuple.SJ_2X4 if backend == "mxu" else ntuple.YEH_4X6
    net, params, _, _ = value_inputs(tuples, True, backend == "cached", cuda)
    after = value_boards(4096, cuda).view(1024, 4, 4, 4).mT  # the trainer's afterstates: transposed boards
    names = ("ntuple_value.launches", "tables.table_gather", "tables.table_scatter", "hbm_tables.cached_gather",
             "hbm_tables.cached_scatter")
    before = {k: count(k) for k in names}
    net.value(params, after)
    assert {k: count(k) - before[k] for k in names} == {
        "ntuple_value.launches": 1, "tables.table_gather": 0, "tables.table_scatter": 0, "hbm_tables.cached_gather": 0,
        "hbm_tables.cached_scatter": 0,
    }
    r = profiling.device_breakdown(lambda: net.value(params, after), reps=1, top=4)
    assert r["launches"] == 1, r


def test_ntuple_value_kernel_rejects_bad_inputs(cuda):
    net, _, tabs, rowmaps = value_inputs(ntuple.SJ_2X4, True, True, cuda)
    boards = value_boards(8, cuda)
    layout = net._layout
    before = count("ntuple_value.launches")
    for args, match in (
        ((boards.to(torch.int32), tabs, layout, rowmaps), "uint8"),
        ((boards.reshape(8, 16), tabs, layout, rowmaps), "uint8"),
        ((boards.cpu(), tabs, layout, rowmaps), "table 0 must be contiguous float32\\[65536\\] on cpu"),
        ((boards, [tabs[0].cpu(), tabs[1]], layout, rowmaps), "table 0 must be contiguous float32"),
        ((boards, [tabs[0].half(), tabs[1]], layout, rowmaps), "table 0 must be contiguous float32"),
        ((boards, tabs[:1], layout, rowmaps), "2 tables"),
        ((boards, tabs, layout, [rowmaps[0].long(), rowmaps[1]]), "row map 0 must be contiguous int32"),
        ((boards[::2], tabs, layout, rowmaps), "16 consecutive bytes"),
    ):
        with pytest.raises(ValueError, match=match):
            value_ops.ntuple_value(*args)
    # A group past the kernel's parameter struct: the grouping path splits
    # such a network, and the packing refuses it.
    with pytest.raises(ValueError, match="1 to 8 tables"):
        value_ops.pack_group([net._cells[0][:1]] * 9)
    assert count("ntuple_value.launches") == before


def test_ntuple_depth2_leaf_is_one_launch_bit_equal_at_yeh4x6(cuda):
    """The depth-2 player of ``eval --algo ntuple --depth 2 --chance-chunk 8``
    at YEH_4X6 ("auto" resolves to "torch" for tables this size) on 256
    games: each leaf call is one launch of the value kernel over 1,048,576
    boards, 16 a move, and its values are bit-equal to the kernel's plain
    version on the same boards (the depth-2 tree's afterstates, stored
    transposed)."""
    from rein48_tpu_torch.control import search
    from rein48_tpu_torch.train import ntuple as nt

    config = nt.NTupleTrainConfig().network_config(cuda)
    assert config.backend == "torch" and config.tuples == ntuple.YEH_4X6
    net = nt.get_network(config)
    g = torch.Generator(device=cuda).manual_seed(20)
    params = {f"t{i}": torch.randn(n, generator=g, device=cuda) for i, n in enumerate(net.table_sizes)}
    env = vector.reset_batch(20, 256, cuda)
    for _ in range(30):  # past the opening: boards with a few tiles
        _, _, legal = search._afterstates(env.boards)
        env, _ = vector.step_autoreset(env, torch.multinomial(legal.float() + 1e-9, 1, generator=g)[:, 0])
    inner, calls = net.make_leaf(params), []

    def leaf(boards):
        before = count("ntuple_value.launches")
        out = inner(boards)
        calls.append((count("ntuple_value.launches") - before, boards, out))
        return out

    names = ("ntuple_value.launches", "search.leaf_boards", "tables.table_gather", "hbm_tables.cached_gather")
    before = {k: count(k) for k in names}
    with torch.no_grad():
        q, legal = search._action_values(env.boards, 2, leaf, lambda r: r, 1.0, 0.0, 8)
    assert {k: count(k) - before[k] for k in names} == {
        "ntuple_value.launches": 16, "search.leaf_boards": 256 * 65_536, "tables.table_gather": 0,
        "hbm_tables.cached_gather": 0,
    }
    assert [c[0] for c in calls] == [1] * 16
    launches, boards, got = calls[0]
    assert boards.numel() // 16 == 1_048_576 and value_ops.board_layout(boards) is True
    want = value_ops.ntuple_value_reference(net.indices(boards), *net.value_tables(params))
    assert torch.equal(got, want)
    assert bool(torch.isfinite(q[legal]).all())
    actions = nt._get_ntuple_policy(config, 2, 8)(params, env.boards)
    assert torch.equal(actions, search._argmax_legal(q, legal))


def test_ntuple_player_replays_a_graph_of_its_eager_move(cuda):
    """The depth-2 player on the card: the first call with a key runs
    eagerly, the second captures a CUDA graph and every later one replays
    it. Each move's actions equal the eager call's on the same boards, and
    each call counts what an eager call counts (16 value launches, 65,536
    leaf boards a board); a table changed in place is read anew by the
    replay, and new tables (a new key) run eagerly first."""
    from rein48_tpu_torch.control import search
    from rein48_tpu_torch.train import ntuple as nt

    config = nt.NTupleTrainConfig(tuples=ntuple.SJ_2X4).network_config(cuda)
    policy = nt._get_ntuple_policy.__wrapped__(config, 2, 8)
    net = nt.get_network(config)
    g = torch.Generator(device=cuda).manual_seed(21)
    params = {f"t{i}": torch.randn(n, generator=g, device=cuda) for i, n in enumerate(net.table_sizes)}
    env = vector.reset_batch(21, 32, cuda)
    names = ("ntuple_value.launches", "search.leaf_boards")
    with torch.no_grad():
        for move in range(8):
            if move == 5:
                params["t0"].add_(torch.randn(params["t0"].shape, generator=g, device=cuda))
            before = {k: count(k) for k in names}
            actions = policy(params, env.boards)
            counted = {k: count(k) - before[k] for k in names}
            assert counted == {"ntuple_value.launches": 16, "search.leaf_boards": 32 * 65_536}, (move, counted)
            assert (policy._graph is not None) == (move >= 1)
            assert torch.equal(actions, policy.eager(params, env.boards)), move
            env, _ = vector.step_autoreset(env, actions)
        held = policy._graph
        fresh = {k: v.clone() for k, v in params.items()}
        assert torch.equal(policy(fresh, env.boards), policy.eager(fresh, env.boards))
        assert policy._graph is held  # eager at a new key's first call
        with profiling.tracing() as trace:
            policy(params, env.boards)
        assert len([s for s in trace.spans if s.name == "search.leaf"]) == 16  # spans on: eager
    q, legal = search._action_values(env.boards, 2, net.make_leaf(params), lambda r: r, 1.0, 0.0, 8)
    assert bool(torch.isfinite(q[legal]).all())


@pytest.mark.parametrize("mode", ["autograd", "inference"])
def test_resnet_player_replays_a_graph_of_its_eager_move(cuda, mode):
    """The depth-1 value-net player as ``search_depth1`` plays it (a ResNet
    64x4 leaf, 256 games, chance children 4 at a time, autograd on), and as
    ``evaluate_search`` plays it (inference mode): the first call with a
    key runs eagerly, the second captures a CUDA graph and every later one
    replays it (``replay.*``). Each replay counts what an eager move counts
    (131,072 leaf boards, 72 launches of the layer norm kernel) and picks
    the eager move's actions on the same boards, but where the top two q
    lie within 1e-5 relative (a float tie that other cuDNN algorithms under
    capture may break the other way). The replay follows weights loaded in
    place; a new module is a new key and runs eagerly first; with spans on
    the move runs eagerly."""
    import copy

    from rein48_tpu_torch.control import search
    from rein48_tpu_torch.train import evaluate

    model = nets.ResNetPolicy(64, 4, generator=torch.Generator().manual_seed(22)).to(cuda)
    policy = evaluate._build_search_policy(1, model, "onehot", 0.997, "log2", 4)
    leaf = search.make_value_leaf(model)

    def in_mode():
        return torch.inference_mode(mode == "inference")

    def eager_or_tied(got, boards):
        q, legal = search._action_values(boards, 1, leaf, lambda r: common.transform_reward(r, "log2"), 0.997, 0.0, 4)
        top = torch.where(legal, q.detach(), -torch.inf).topk(2, -1).values
        tied = top[:, 0] - top[:, 1] <= 1e-5 * top[:, 0].abs()
        return bool(((got == policy.eager(boards)) | tied).all())

    names = ("replay.eager", "replay.captures", "replay.replays", "search.leaf_boards", "layer_norm.forward_launches")
    per_move = {"search.leaf_boards": 256 * 4 * search.CHANCE_BRANCH * 4, "layer_norm.forward_launches": 72}
    env = vector.reset_batch(22, 256, cuda)
    other = nets.ResNetPolicy(64, 4, generator=torch.Generator().manual_seed(23)).state_dict()
    for move in range(9):
        if move == 4:
            model.load_state_dict(other)  # in place: the same key
        if move == 6:
            model.value_out = copy.deepcopy(model.value_out)  # new tensors: a new key
            held = policy._graph
        with in_mode():
            before = {k: count(k) for k in names}
            actions = policy(env.boards)
            counted = {k: count(k) - before[k] for k in names if count(k) != before[k]}
            kind = {0: "eager", 1: "captures", 6: "eager", 7: "captures"}.get(move, "replays")
            assert counted == {f"replay.{kind}": 1, **per_move}, (move, counted)
            assert (policy._graph is held) if move == 6 else (policy._graph is not None) == (move >= 1), move
            assert eager_or_tied(actions, env.boards), move
            env, _ = vector.step_autoreset(env, actions)
    before = count("replay.eager")
    with profiling.tracing() as trace, in_mode():
        policy(env.boards)
    assert count("replay.eager") == before + 1
    assert len([s for s in trace.spans if s.name == "search.leaf"]) == search.CHANCE_BRANCH // 4


def test_ntuple_depth2_boards_with_2_15_tiles_stay_in_the_tables(cuda):
    """Boards with a 2^15 tile through the depth-2 player of ``eval --algo
    ntuple --depth 2 --chance-chunk 8`` at YEH_4X6: the tree spawns only on
    blank cells, so every lookup of the value kernel stays inside its
    table. Q is finite and within the CPU tests' tolerance of the plain
    reference (``portbench/reference/search_ntuple.py``), and the player
    picks the reference's best move wherever it is clear."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from portbench.reference import ntuple as ref_ntuple
    from portbench.reference import search_ntuple as ref
    from rein48_tpu_torch.control import search
    from rein48_tpu_torch.train import ntuple as nt

    q_tol = 2e-6  # tests/test_torch_ntuple_search.py's Q_TOL
    big_tiles = [
        [[15, 14, 3, 1], [2, 5, 0, 0], [1, 0, 0, 2], [0, 0, 1, 0]],
        [[14, 14, 2, 0], [3, 0, 0, 1], [0, 1, 0, 0], [0, 0, 0, 2]],
    ]
    config = nt.NTupleTrainConfig().network_config(cuda)
    assert config.backend == "torch" and config.tuples == ntuple.YEH_4X6
    net = nt.get_network(config)
    g = torch.Generator(device=cuda).manual_seed(15)
    params = {f"t{i}": torch.randn(n, generator=g, device=cuda) for i, n in enumerate(net.table_sizes)}
    boards = torch.tensor(big_tiles, dtype=torch.uint8, device=cuda)
    before = count("ntuple_value.launches")
    with torch.no_grad():
        q, legal = search._action_values(boards, 2, net.make_leaf(params), lambda r: r, 1.0, 0.0, 8)
        actions = nt._get_ntuple_policy(config, 2, 8)(params, boards)
    torch.cuda.synchronize()
    assert count("ntuple_value.launches") - before == 32
    want = ref.action_values(ref_ntuple.Network(config.tuples, cuda),
                             [params[f"t{i}"] for i in range(len(config.tuples))], boards, 2, block=1)
    assert torch.equal(legal, torch.isfinite(want)) and bool(torch.isfinite(q[legal]).all())
    err = torch.where(legal, (q - want).abs() / want.abs().clamp(min=1.0), 0.0)
    assert float(err.max()) <= q_tol, float(err.max())
    top = want.sort(-1).values
    clear = (top[:, -1] - top[:, -2] > q_tol * top[:, -1].abs().clamp(min=1.0)) | ~torch.isfinite(top[:, -2])
    assert torch.equal(actions[clear], want.argmax(-1)[clear])


# The fused layer norm and ReLU (ops/layer_norm.py) against its plain version
# on the card, at the tolerances of rein48_tpu_torch/testing.py (LN_*).
BF16 = torch.bfloat16
LN_CASES = [  # rows, channels, the type of x, the output, dy and dx
    (8192 * 16, 64, BF16), (16384 * 16, 64, BF16), (65536 * 16, 64, BF16),
    (1000, 8, torch.float32), (1000, 128, BF16), (33, 64, BF16),
    (4097, 48, BF16), (777, 256, torch.float32), (300, 1, torch.float32),
    (513, 64, torch.float32), (2049, 256, BF16),
]
LN_COUNTERS = ("layer_norm.forward_launches", "layer_norm.backward_launches", "layer_norm.backward_sum_launches")


def ln_inputs(rows: int, c: int, dtype, device, seed: int = 0):
    """x (its first rows constant: where the variance clamp acts), a scale
    around 1 and a bias around 0, requiring gradients; dy."""
    g = torch.Generator(device).manual_seed(seed)
    x = (torch.randn(rows, c, generator=g, device=device) * 1.5 + 0.25).to(dtype)
    const = min(rows, 5)
    x[:const] = (torch.arange(const, device=device) * 0.375 - 1.0).to(dtype)[:, None]  # exact in either type
    scale = 1.0 + 0.2 * torch.randn(c, generator=g, device=device)
    bias = 0.1 * torch.randn(c, generator=g, device=device)
    dy = torch.randn(rows, c, generator=g, device=device).to(dtype)
    return [t.requires_grad_(True) for t in (x, scale, bias)], dy


@pytest.mark.parametrize("rows, c, dtype", LN_CASES)
def test_layer_norm_kernel_matches_plain(cuda, rows, c, dtype):
    (x, scale, bias), dy = ln_inputs(rows, c, dtype, cuda)
    before = {k: count(k) for k in LN_COUNTERS}
    out = layer_norm.layer_norm_relu(x, scale, bias, 1e-6)
    assert {k: count(k) - before[k] for k in LN_COUNTERS} == dict(zip(LN_COUNTERS, (1, 0, 0)))
    assert_ln_forward_close(out, ln_plain(x, scale, bias))
    assert bool((out >= 0).all())
    with torch.no_grad():  # no statistics kept: the same output
        assert torch.equal(layer_norm.layer_norm_relu(x, scale, bias, 1e-6), out)
    got = torch.autograd.grad(out, (x, scale, bias), dy, retain_graph=True)
    assert {k: count(k) - before[k] for k in LN_COUNTERS} == dict(zip(LN_COUNTERS, (2, 1, 1)))
    assert got[0].dtype == dtype and got[1].dtype == got[2].dtype == torch.float32
    assert_ln_grads_close(got, ln_masked_reference_grads(x, scale, bias, dy, out), x, dy, out)
    # The same bits on a second run: no float atomics.
    again = torch.autograd.grad(out, (x, scale, bias), dy)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_layer_norm_kernel_unaligned_rows(cuda):
    """Rows that start off 16 bytes take the generic layout, a channel a lane,
    which adds the row sums in another order: within the tolerance of the
    plain version, forward and backward, and the same bits twice."""
    (x, scale, bias), dy = ln_inputs(4000 * 64 + 1, 1, BF16, cuda, seed=3)
    x = x.detach()[1:].reshape(4000, 64).requires_grad_(True)  # contiguous, 2 bytes off
    (_, scale, bias), _ = ln_inputs(1, 64, BF16, cuda, seed=4)
    assert x.is_contiguous() and x.data_ptr() % 16
    out = layer_norm.layer_norm_relu(x, scale, bias, 1e-6)
    assert_ln_forward_close(out, ln_plain(x, scale, bias))
    g = dy[1:].reshape(4000, 64)
    got = torch.autograd.grad(out, (x, scale, bias), g, retain_graph=True)
    want = ln_masked_reference_grads(x, scale, bias, g, out)
    dx, wdx = got[0].float(), want[0].float()
    assert bool(((dx - wdx).abs() <= 2.0 ** -7 * wdx.abs() + LN_GRAD_TOL * wdx.abs().max()).all())
    assert all(torch.equal(a, b) for a, b in zip(got, torch.autograd.grad(out, (x, scale, bias), g)))


def test_layer_norm_kernel_rejects_bad_inputs(cuda):
    (x, scale, bias), _ = ln_inputs(64, 64, BF16, cuda)
    before = {k: count(k) for k in LN_COUNTERS}
    for args, match in (
        ((x.detach().half(), scale, bias), "float32 or bfloat16"),
        ((x.detach().t(), scale, bias), "needs x contiguous"),
        ((x, scale.detach().cpu(), bias), "scale must be contiguous float32"),
        ((torch.zeros(4, 300, dtype=BF16, device=cuda), scale, bias), "1 to 256 channels"),
    ):
        with pytest.raises(ValueError, match=match):
            layer_norm.layer_norm_relu(*args)
    assert {k: count(k) for k in LN_COUNTERS} == before


@pytest.mark.parametrize("channels, blocks, dtype", [(64, 4, BF16), (8, 2, torch.float32), (16, 1, BF16)])
def test_resnet_with_layer_norm_kernel_matches_plain_tower(cuda, monkeypatch, channels, blocks, dtype):
    """Every norm of the tower one kernel launch forward and one backward
    (and one partial-sum launch); the outputs within test_torch_models.py's
    ResNet tolerances of the same tower on the plain path (full float32
    convolutions and products, as those tolerances assume: a TF32 rounding of
    a norm's output would move by a TF32 ulp what the kernel moved by a
    float32 ulp)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    model = nets.ResNetPolicy(channels, blocks, dtype=dtype, generator=torch.Generator().manual_seed(5)).to(cuda)
    boards = torch.from_numpy(edge_boards(4096)).to(cuda)
    planes = obs.encode_onehot(boards)
    before = {k: count(k) for k in LN_COUNTERS}
    logits, value = model(planes)
    (logits.square().sum() + value.sum()).backward()
    norms = 2 * blocks + 1
    assert {k: count(k) - before[k] for k in LN_COUNTERS} == dict.fromkeys(LN_COUNTERS, norms)
    grads = [p.grad.clone() for p in model.parameters()]
    model.zero_grad()
    logits2, value2 = model(planes)
    (logits2.square().sum() + value2.sum()).backward()
    assert all(torch.equal(g, p.grad) for g, p in zip(grads, model.parameters()))  # bit-equal reruns
    with torch.no_grad():
        monkeypatch.setattr(layer_norm, "layer_norm_relu", lambda x, scale, bias, eps: ln_plain(x, scale, bias))
        plain_logits, plain_value = model(planes)
    tol = dict(atol=0.03, rtol=0) if dtype == BF16 else dict(atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(logits.detach(), plain_logits, **tol)
    torch.testing.assert_close(value.detach(), plain_value, **tol)


@pytest.mark.parametrize("name", common.OPTIMIZERS)
def test_optimizer_on_card_matches_cpu(cuda, name):
    # Gradients whose norm is above the clip (3.0) and below it (0.001).
    g = torch.Generator().manual_seed(11)
    params = [torch.randn(s, generator=g) for s in ((64, 16, 3, 3), (64,), (4, 64))]
    steps = [[torch.randn(p.shape, generator=g) * (3.0 if i % 2 == 0 else 0.001) for p in params] for i in range(6)]
    cpu, dev = [p.clone() for p in params], [p.to(cuda) for p in params]
    schedule = common.cosine_decay_schedule(0.05, 4, alpha=0.1)
    a = common.make_optimizer(name, schedule, cpu, max_grad_norm=0.5)
    b = common.make_optimizer(name, schedule, dev, max_grad_norm=0.5)
    for grads in steps:
        a.step(grads)
        b.step([x.to(cuda) for x in grads])
    # The clip's norm sums in another order on the card, and its sqrt and
    # division may round differently.
    for x, y in zip(cpu, dev):
        torch.testing.assert_close(y.cpu(), x, rtol=1e-5, atol=1e-7)
    for m in a.moments:
        for x, y in zip(a.moments[m], b.moments[m]):
            torch.testing.assert_close(y.cpu(), x, rtol=1e-5, atol=1e-9)


SMALL_AFTERSTATE = afterstate.AfterstateTDConfig(
    batch_size=256, unroll_len=8, num_minibatches=2, model_kwargs=(("channels", 16), ("num_blocks", 1))
)


def test_afterstate_update_on_card(cuda):
    state, model, opt = afterstate.init_afterstate_td(SMALL_AFTERSTATE, 2, device=cuda)
    before = [p.detach().clone() for p in model.parameters()]
    state, metrics = afterstate.make_afterstate_td_step(SMALL_AFTERSTATE, model, opt)(state)
    assert all(torch.isfinite(torch.as_tensor(v)).all() for v in metrics.values())
    assert float(metrics["env_steps"]) == 256 * 8 and state.update_step == 1
    assert any(not torch.equal(a, b) for a, b in zip(before, model.parameters()))


def test_afterstate_checkpoint_on_card(cuda, tmp_path):
    state, _ = afterstate.train_afterstate_td(SMALL_AFTERSTATE, 2, seed=1, log_every=2, device=cuda)
    ck = Checkpointer(str(tmp_path))
    ck.save(2, state)
    restored = ck.restore(afterstate.init_afterstate_td(SMALL_AFTERSTATE, 5, device=cuda)[0])
    for (k, x), y in zip(state.model.state_dict().items(), restored.model.state_dict().values()):
        assert torch.equal(x, y), k
    for m in state.optimizer.moments:
        assert all(torch.equal(x, y) for x, y in zip(state.optimizer.moments[m], restored.optimizer.moments[m]))
    assert restored.optimizer.count == state.optimizer.count
    assert (restored.seed, restored.update_step) == (state.seed, state.update_step)
    assert all(torch.equal(getattr(state.env, f), getattr(restored.env, f)) for f in ("boards", "counter", "score"))
    # The next rollout gives the same boards from either state.
    runs = []
    for st in (state, restored):
        step = afterstate.make_afterstate_td_step(SMALL_AFTERSTATE, st.model, st.optimizer)
        runs.append(step.rollout(st)[1]["after_boards"])
    assert torch.equal(*runs)
    # Onto the CPU: tensors and counters land there unchanged.
    on_cpu = ck.restore(afterstate.init_afterstate_td(SMALL_AFTERSTATE, 5, device="cpu")[0])
    for (k, x), y in zip(state.model.state_dict().items(), on_cpu.model.state_dict().values()):
        assert y.device.type == "cpu" and torch.equal(x.cpu(), y), k
    assert on_cpu.env.counter.device.type == "cpu" and torch.equal(on_cpu.env.counter, state.env.counter.cpu())
    assert on_cpu.optimizer.count == state.optimizer.count


SMALL_NET = (("channels", 16), ("num_blocks", 1))
SMALL_PPO = ppo.PPOConfig(
    batch_size=256, unroll_len=8, num_epochs=2, num_minibatches=2, model_kwargs=SMALL_NET, after_model_kwargs=SMALL_NET,
    afterstate_critic=True, entropy_beta_final=0.002, entropy_decay_updates=4,
)
SMALL_A3C = a3c.A3CConfig(batch_size=256, unroll_len=8, model_kwargs=SMALL_NET)


@pytest.mark.parametrize("trainer", ["ppo", "a3c"])
def test_actor_critic_update_on_card(cuda, trainer):
    init, make, cfg = (ppo.init_ppo, ppo.make_ppo_step, SMALL_PPO) if trainer == "ppo" else (a3c.init_a3c, a3c.make_a3c_step, SMALL_A3C)
    state, model, opt = init(cfg, 2, device=cuda)
    nets = {"model": model, "after_model": getattr(state, "after_model", None)}
    before = {(k, n): p.detach().clone() for k, m in nets.items() if m is not None for n, p in m.named_parameters()}
    step = make(cfg, model, opt, state.after_model) if trainer == "ppo" else make(cfg, model, opt)
    state, metrics = step(state)
    assert all(torch.isfinite(torch.as_tensor(v)).all() for v in metrics.values())
    assert float(metrics["env_steps"]) == 256 * 8 and state.update_step == 1
    # Both heads of the policy net learn. The afterstate critic's value head
    # and trunk learn; its policy head gets no gradient (JAX's too).
    for (k, n), p in before.items():
        unused = k == "after_model" and n.startswith("policy_")
        assert torch.equal(p, dict(nets[k].named_parameters())[n]) == unused, (k, n)


def test_ppo_rollout_with_the_step_kernel_equals_the_plain_step(cuda, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    cfg = dataclasses.replace(SMALL_PPO, batch_size=1024, unroll_len=32)
    state, model, opt = ppo.init_ppo(cfg, 5, device=cuda)
    step = ppo.make_ppo_step(cfg, model, opt, state.after_model)
    launches = count("engine.step_launches")
    got = step.rollout(state)
    assert count("engine.step_launches") == launches + 32
    with monkeypatch.context() as m:
        m.setattr(vector, "_step_kernel", lambda st, a, bits, mode: plain_step(st, a, bits, mode))
        plain = count("engine.step_plain")
        want = step.rollout(state)
        assert count("engine.step_plain") == plain + 32
    for name in ("boards", "score", "steps", "done", "seed", "env_id", "counter"):
        assert torch.equal(getattr(got[0], name), getattr(want[0], name)), name
    for name, x in want[1].items():
        assert torch.equal(got[1][name], x), name
    for name, x in want[2].items():
        assert torch.equal(got[2][name], x), name


def test_learner_draws_resume_across_devices(cuda, tmp_path):
    """Saved on the card, resumed on the CPU: the same shuffles, epsilon
    draws and sampling noise as the uninterrupted run on the card."""
    cfg = dataclasses.replace(SMALL_AFTERSTATE, epsilon=0.1)
    state, _ = afterstate.train_afterstate_td(cfg, 2, seed=4, log_every=2, device=cuda)
    ck = Checkpointer(str(tmp_path))
    ck.save(2, state)
    on_cpu = ck.restore(afterstate.init_afterstate_td(cfg, 0, device="cpu")[0])
    steps = [afterstate.make_afterstate_td_step(cfg, s.model, s.optimizer) for s in (state, on_cpu)]
    perms = [st.permutations(s, s.env.boards.device).cpu() for st, s in zip(steps, (state, on_cpu))]
    assert torch.equal(*perms)
    for s in (state, on_cpu):
        assert s.seed == 4 and s.update_step == 2
    words = [philox.learner_words(s.seed, s.update_step, p, (8, 2, 256), device=s.env.boards.device).cpu()
             for s in (state, on_cpu) for p in (philox.EPSILON, philox.SAMPLE)]
    assert torch.equal(words[0], words[2]) and torch.equal(words[1], words[3])
    noise = [philox.learner_gumbel(s.seed, s.update_step, (8, 256, 4), device=s.env.boards.device).cpu() for s in (state, on_cpu)]
    # The words are equal; log may round in the last bit on either device.
    torch.testing.assert_close(noise[0], noise[1], rtol=1e-6, atol=1e-6)
    # The same PPO update drawn on both devices shuffles alike.
    ppo_state = ppo.init_ppo(SMALL_PPO, 7, device=cuda)[0]
    ppo_cpu = ppo.init_ppo(SMALL_PPO, 7, device="cpu")[0]
    got = [ppo.make_ppo_step(SMALL_PPO, s.model, s.optimizer, s.after_model).permutations(s, s.env.boards.device).cpu()
           for s in (ppo_state, ppo_cpu)]
    assert torch.equal(*got)


def test_dqn_first_acting_step_on_card_matches_cpu(cuda):
    """At epsilon 1 every action is the Gumbel draw over the legal moves,
    the same words on both devices: the buffer's slots agree bit for bit
    but the log2 reward, which each device rounds to within one ulp."""
    cfg = dqn.DQNConfig(
        num_envs=16, model="qnet", model_kwargs=(("channels", (4, 8)), ("hidden", 16), ("dtype", torch.float32)),
        replay_capacity=64, learn_batch_size=16, epsilon_start=1.0, min_replay_before_learn=16,
    )
    reps = []
    for device in (cuda, "cpu"):
        state, model, opt = dqn.init_dqn(cfg, 3, device=device)
        env, rep, _, _ = dqn.make_dqn_step(cfg, model, state.target_model, opt).act(state)
        reps.append(rep)
    got, want = reps
    assert (got.cursor, got.size) == (want.cursor, want.size) == (16, 16)
    for k in ("board", "action", "next_board", "done"):
        assert torch.equal(got.data[k].cpu(), want.data[k]), k
    torch.testing.assert_close(got.data["reward"].cpu(), want.data["reward"], rtol=2**-23, atol=0)


def test_game_on_card_matches_cpu(cuda):
    a, b = Game(seed=11, device=cuda), Game(seed=11, device="cpu")
    assert a.device.type == "cuda" and (a.state_matrix == b.state_matrix).all()
    for i in range(200):
        legal = b.legal_actions
        action = int(legal.nonzero()[0][0]) if legal.any() else i % 4
        sa, ra, da = a.step(action)
        sb, rb, db = b.step(action)
        assert (sa == sb).all() and ra == rb and da == db, i
        if da:
            assert (a.reset() == b.reset()).all()


def test_native_oracle_builds_and_plays_a_game(cuda):
    assert native.available(), "no C compiler built the oracle"
    game = native.NativeOracleGame(5)
    assert 0 < game.play_random() < 1 << 30 and game.spawn_count > 1


@pytest.mark.parametrize("backend, world", [("gloo", 2), ("nccl", 1)])
def test_data_parallel_update_on_card(cuda, tmp_path, monkeypatch, backend, world):
    """Two A3C updates of two gloo ranks sharing the card (CUDA tensors), and
    of a one-rank NCCL group, against one process on the card."""
    monkeypatch.setattr(ranks, "DEVICE", "cuda")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    ref = ranks.a3c_update(None)
    results = ranks.spawn(tmp_path, {"a3c": ("a3c_update", ranks.A3C_CFG)}, world=world, device="cuda", backend=backend)
    got = [r["a3c"] for r in results]
    ranks.check_family(got, ref, chosen_dim=1)
    if world == 1:  # one rank divides by one: the same bits
        for k, v in ref["params"][0].items():
            assert torch.equal(got[0]["params"][0][k], v), k

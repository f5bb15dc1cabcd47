# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Card-only tests of the port's CUDA kernels against their plain versions.

They skip without a CUDA device. This file imports no JAX, so that it runs
where the card is and JAX is not; there, from the repository root:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX.)
"""

from __future__ import annotations

import pytest
import torch

from rein48_tpu_torch.agents import ntuple
from rein48_tpu_torch.engine import fused, philox, vector
from rein48_tpu_torch.ops import hbm_tables, tables

pytestmark = pytest.mark.cuda

STAT_FIELDS = ("episodes", "episode_length_sum", "episode_score_sum", "max_exponent")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these comparisons on the card")
    return torch.device("cuda")


def assert_same(got, want):
    (gs, gt), (ws, wt) = got, want
    for name in ("boards", "score", "steps"):
        assert torch.equal(getattr(gs, name).cpu(), getattr(ws, name).cpu()), name
    for name in STAT_FIELDS:
        assert torch.equal(getattr(gt, name).cpu(), getattr(wt, name).cpu()), name


@pytest.mark.parametrize("batch, steps", [(1000, 67), (128, 1), (8192, 64)])
def test_rollout_kernel_matches_plain(cuda, batch, steps):
    # Ragged batches mask the last block; T % 4 != 0 ends inside a word group.
    state = vector.reset_batch(1, batch, cuda)
    bits = philox.philox_bits(4, steps, batch, device=cuda)
    want = fused.rollout_bits_reference(state, bits)
    before = fused.launches
    assert_same(fused.rollout_random_fused(state, 0, steps, bits=bits), want)
    assert_same(fused.rollout_random_fused(state, 4, steps), want)
    assert fused.launches == before + 2


def test_rollout_kernel_rejects_bad_words(cuda):
    state = vector.reset_batch(1, 256, cuda)
    before = fused.launches
    with pytest.raises(ValueError, match="bits must be"):
        fused.rollout_random_fused(state, 0, 8, bits=philox.philox_bits(0, 7, 256, device=cuda))
    assert fused.launches == before


def assert_sums_close(got, want, scale):
    """Reassociated float32 sums: |got - want| <= 1e-6 + 1e-5 * scale, where
    ``scale`` sums the magnitudes of each entry's terms (the rounding of a
    sum grows with its terms, not with its result, which may cancel)."""
    excess = (got - want).abs() - (1e-6 + 1e-5 * scale)
    assert float(excess.max()) <= 0.0, float(excess.max())


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
    before = dict(tables.launches)
    got = tables.mxu_gather(table, idx.reshape(1, -1))
    assert tables.launches["table_gather"] == before["table_gather"] + 1
    assert got.shape == (1, n) and torch.equal(got[0], tables.gather_reference(table, idx))


@pytest.mark.parametrize("n", [1, 1000, 65537])
def test_table_scatter_kernel_matches_plain(cuda, n):
    size = 65536
    idx, vals = table_inputs(n, size, cuda, seed=n)
    before = dict(tables.launches)
    got = tables.mxu_scatter_stats(size, idx, vals)
    got_sum = tables.mxu_scatter_sum(size, idx, vals)
    assert tables.launches["table_scatter"] == before["table_scatter"] + 2
    want = tables.scatter_reference(size, idx, vals, stats=True)
    # Atomics add in an order that changes from run to run: sums to a tolerance.
    assert_sums_close(got[0], want[0], want[1])
    assert_sums_close(got[1], want[1], want[1])
    assert_sums_close(got_sum, want[0], want[1])
    assert torch.equal(got[2], want[2])  # hits: exact counts of nonzero values


def test_table_kernels_reject_bad_inputs(cuda):
    table = torch.zeros(256, device=cuda)
    idx = torch.zeros(8, dtype=torch.int32, device=cuda)
    before = dict(tables.launches)
    with pytest.raises(ValueError, match="idx must be torch.int32"):
        tables.mxu_gather(table, idx.long())
    with pytest.raises(ValueError, match="idx must be torch.int32 on cuda"):
        tables.mxu_gather(table, idx.cpu())
    with pytest.raises(ValueError, match="vals must be torch.float32"):
        tables.mxu_scatter_stats(256, idx, torch.zeros(8, dtype=torch.float16, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        tables.mxu_scatter_sum(256, idx, torch.zeros((8, 2), device=cuda)[:, 0])
    assert tables.launches == before


def test_ntuple_mxu_backend_matches_torch_backend(cuda):
    mxu = ntuple.NTupleNetwork(ntuple.NTupleConfig(tuples=ntuple.SJ_2X4, backend="mxu"))
    plain = ntuple.NTupleNetwork(ntuple.NTupleConfig(tuples=ntuple.SJ_2X4, backend="torch"))
    g = torch.Generator().manual_seed(3)
    boards = torch.randint(0, 8, (512, 4, 4), generator=g, dtype=torch.uint8).to(cuda)
    err = torch.randn(512, generator=g).to(cuda)
    a, b, scale = mxu.init_tc(cuda), plain.init_tc(cuda), plain.init_tc(cuda)
    for _ in range(3):
        mxu.td_apply_tc(a, boards, err, 1.0)
        plain.td_apply_tc(b, boards, err, 1.0)
        plain.td_apply_tc(scale, boards, err.abs(), 1.0)  # the same update on magnitudes
    for k in b:
        assert_sums_close(a[k], b[k], scale[k].abs())
    assert torch.equal(mxu.value(a, boards), plain.value(a, boards))


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
    before = dict(hbm_tables.launches)
    got = hbm_tables.cached_gather(table, rm, hot, idx.reshape(1, -1), prefix_rows=1024)
    assert hbm_tables.launches["cached_gather"] == before["cached_gather"] + 1
    assert got.shape == (1, n) and torch.equal(got[0], hbm_tables.cached_gather_reference(table, rm, idx))


@pytest.mark.parametrize("n", [1, 16384, 40000])
@pytest.mark.parametrize("cold_capacity_rows", [16, 1])
def test_cached_scatter_kernel_matches_plain(cuda, n, cold_capacity_rows):
    size, k = 16**5, 2048
    _, hot, idx, err = hot_prefix_inputs(n, size, k, cuda, seed=n + cold_capacity_rows)
    before = dict(hbm_tables.launches)
    got = hbm_tables.cached_scatter_blocks(hot, idx, err, prefix_rows=k, cold_capacity_rows=cold_capacity_rows)
    assert hbm_tables.launches["cached_scatter"] == before["cached_scatter"] + 1
    want = hbm_tables.cached_scatter_stats_reference(hot, idx, err, cold_capacity_rows)
    assert_sums_close(got[0], want[0], want[1])
    assert_sums_close(got[1], want[1], want[1])
    for name, g, w in zip(("hits", "cold_idx", "cold_err", "counts"), got[2:], want[2:]):
        assert torch.equal(g, w), name
    *_, overflow = hbm_tables.cached_scatter_stats(hot, idx, err, prefix_rows=k, cold_capacity_rows=cold_capacity_rows)
    assert bool(overflow) == bool(want[5].max() > cold_capacity_rows * hbm_tables.ROW)


def test_hot_prefix_kernels_reject_bad_inputs(cuda):
    rm, hot, idx, err = hot_prefix_inputs(64, 16**4, 128, cuda)
    table = torch.zeros(16**4, device=cuda)
    before = dict(hbm_tables.launches)
    with pytest.raises(ValueError, match="idx must be torch.int32 on cuda"):
        hbm_tables.cached_gather(table, rm, hot, idx.cpu(), prefix_rows=128)
    with pytest.raises(ValueError, match="hot_rows must have shape"):
        hbm_tables.cached_scatter_stats(hot[:64], idx, err, prefix_rows=128)
    with pytest.raises(ValueError, match="err must be torch.float32"):
        hbm_tables.cached_scatter_stats(hot, idx, err.half(), prefix_rows=128)
    assert hbm_tables.launches == before


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
        assert torch.equal(cached.value(a, boards), plain.value(b, boards))
        before = dict(ntuple.cached_windows)
        cached.td_apply_delayed(a, boards, err, 1.0)
        assert ntuple.cached_windows[branch] == before[branch] + 2
        plain.td_apply_delayed(b, boards, err, 1.0)
        plain.td_apply_delayed(scale, boards, err.abs(), 1.0)  # the same update on magnitudes
        for k in b:
            got = a[k][hbm_tables.physical_index(a[f"{k[:2]}_rm"], rows)]
            assert_sums_close(got, b[k], scale[k].abs())

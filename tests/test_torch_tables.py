# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's table gather and scatter (``ops/tables.py``) against JAX.

The JAX ``mxu_*`` functions run their Pallas kernels in interpret mode on
the CPU, as ``tests/test_ntuple.py`` runs them; the port runs its plain
versions, as a wrapper does for a CPU tensor.

Tolerances. The gather is bit-exact in both packages, so it is compared
for equality. The scatter sums are reassociated: the JAX kernel folds
three bf16 limb sums after accumulating them, the port adds in index
order (and on the card with atomics, in an order that changes from run to
run). The sums are compared at rtol 1e-5, atol 1e-6, the tolerance of
``tests/test_ntuple.py::TestMXUBackend``; ``hits`` counts whole numbers
far below 2**24 and is compared for equality.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rein48_tpu.ops import tables as jtables
from rein48_tpu_torch.agents import ntuple as ntuple_lib
from rein48_tpu_torch.ops import tables
from rein48_tpu_torch.utils import profiling

from test_torch_engine import random_boards

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def early_boards(rng: np.random.Generator, n: int) -> np.ndarray:
    """Sparse boards of small tiles, as early-game trainer boards are."""
    fill = rng.uniform(0.0, 0.3, size=(n, 1, 1))
    exps = rng.integers(1, 4, size=(n, 4, 4))
    return np.where(rng.uniform(size=(n, 4, 4)) > fill, 0, exps).astype(np.uint8)


def colliding_indices(size: int, n_boards: int, seed: int) -> np.ndarray:
    """Flat lookup indices of ``n_boards`` boards into a table of ``size``.

    Taken from ``NTupleNetwork.indices`` of mostly early-game boards, so
    that many elements land on the same few entries (index 0 is the
    all-empty tuple).
    """
    k = {4096: (0, 1, 2), 65536: (0, 1, 2, 3)}[size]
    net = ntuple_lib.NTupleNetwork(ntuple_lib.NTupleConfig(tuples=(k,), backend="torch"))
    rng = np.random.default_rng(seed)
    boards = np.concatenate([early_boards(rng, n_boards - n_boards // 4), random_boards(rng, n_boards // 4)])
    return net.indices(torch.from_numpy(boards))[0].reshape(-1).numpy()


def deltas(rng: np.random.Generator, n: int) -> np.ndarray:
    """Normal values, a share of them exact zeros and negative zeros."""
    v = rng.normal(size=n).astype(np.float32)
    v[rng.uniform(size=n) < 0.2] = 0.0
    v[rng.uniform(size=n) < 0.05] = -0.0
    return v


class TestGather:
    @pytest.mark.parametrize("size", [4096, 65536])
    def test_bit_equal_to_jax(self, size):
        rng = np.random.default_rng(size)
        table = rng.normal(size=size).astype(np.float32)
        idx = np.concatenate([colliding_indices(size, 512, size), rng.integers(0, size, 4096)]).astype(np.int32)
        idx = idx.reshape(-1, 8)
        got = tables.mxu_gather(torch.from_numpy(table), torch.from_numpy(idx))
        want = np.asarray(jtables.mxu_gather(table, idx))
        assert got.shape == want.shape == idx.shape
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), table[idx])


class TestScatter:
    @pytest.mark.parametrize("size", [4096, 65536])
    def test_sum_matches_jax(self, size):
        rng = np.random.default_rng(1 + size)
        idx = colliding_indices(size, 1024, 2 + size).astype(np.int32)
        vals = deltas(rng, idx.size)
        got = tables.mxu_scatter_sum(size, torch.from_numpy(idx), torch.from_numpy(vals))
        want = np.asarray(jtables.mxu_scatter_sum(size, idx, vals))
        assert got.shape == (size,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
        assert np.bincount(idx).max() > 100  # the collisions the test is about

    @pytest.mark.parametrize("size", [4096, 65536])
    def test_stats_match_jax(self, size):
        rng = np.random.default_rng(3 + size)
        idx = colliding_indices(size, 2048, 4 + size).astype(np.int32)
        vals = deltas(rng, idx.size)
        got = tables.mxu_scatter_stats(size, torch.from_numpy(idx), torch.from_numpy(vals))
        want = [np.asarray(w) for w in jtables.mxu_scatter_stats(size, idx, vals)]
        for name, g, w in zip(("err_sum", "abs_sum"), got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL, err_msg=name)
        np.testing.assert_array_equal(got[2].numpy(), want[2])
        # Zeros of either sign are no hits.
        np.testing.assert_array_equal(got[2].numpy(), np.bincount(idx[vals != 0], minlength=size))

    @pytest.mark.parametrize("stream", ["one-entry", "all-zero"])
    @pytest.mark.parametrize("size", [4096, 65536])
    def test_stats_edge_streams_match_jax(self, stream, size):
        # Every element on one entry (the most same-address adds a window can
        # make), or every value an exact zero of either sign (nothing added,
        # no hits).
        rng = np.random.default_rng(5 + size)
        n = 8192
        if stream == "one-entry":
            idx = np.full(n, 77 % size, np.int32)
            vals = deltas(rng, n)
        else:
            idx = colliding_indices(size, n // 8, 6 + size).astype(np.int32)
            vals = np.where(np.arange(idx.size) % 3 == 0, np.float32(-0.0), np.float32(0.0))
        got = tables.mxu_scatter_stats(size, torch.from_numpy(idx), torch.from_numpy(vals))
        want = [np.asarray(w) for w in jtables.mxu_scatter_stats(size, idx, vals)]
        for name, g, w in zip(("err_sum", "abs_sum"), got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL, err_msg=name)
        np.testing.assert_array_equal(got[2].numpy(), want[2])
        np.testing.assert_array_equal(got[2].numpy(), np.bincount(idx[vals != 0], minlength=size))
        if stream == "all-zero":
            assert not got[2].any() and not got[0].any()

    def test_index_shape_is_flattened(self):
        idx = torch.tensor([[0, 5], [5, 127]], dtype=torch.int32)
        vals = torch.tensor([[1.0, 2.0], [3.0, 0.0]])
        err, ab, hits = tables.mxu_scatter_stats(128, idx, vals)
        assert err[5] == 5.0 and ab[0] == 1.0 and hits[5] == 2.0 and hits[127] == 0.0
        assert tables.mxu_scatter_sum(128, idx, -vals)[5] == -5.0


class TestWrapper:
    def test_supports_mxu_as_jax(self):
        for size in (128, 4096, 65536, 65536 + 128, 1 << 20, 100, 16**3, 16**6):
            assert tables.supports_mxu(size) == jtables.supports_mxu(size), size
        assert tables.MXU_TABLE_MAX == jtables.MXU_TABLE_MAX

    def test_cpu_runs_the_plain_version_and_launches_nothing(self):
        names = ("tables.table_gather", "tables.table_scatter")
        before = [profiling.counters.get(k, 0) for k in names]
        table = torch.arange(256, dtype=torch.float32)
        idx = torch.tensor([3, 3, 255], dtype=torch.int32)
        assert tables.mxu_gather(table, idx).tolist() == [3.0, 3.0, 255.0]
        tables.mxu_scatter_stats(256, idx, torch.ones(3))
        tables.mxu_scatter_sum(256, idx, torch.ones(3))
        assert [profiling.counters.get(k, 0) for k in names] == before

    @pytest.mark.parametrize(
        "table, idx, match",
        [
            (torch.zeros(128, dtype=torch.float64), torch.zeros(4, dtype=torch.int32), "table must be torch.float32"),
            (torch.zeros(128), torch.zeros(4, dtype=torch.int64), "idx must be torch.int32"),
            (torch.zeros(128), torch.zeros((4, 2), dtype=torch.int32).t(), "idx must be contiguous"),
            (torch.zeros((2, 64)), torch.zeros(4, dtype=torch.int32), "table must be 1-D"),
        ],
    )
    def test_gather_rejects(self, table, idx, match):
        with pytest.raises(ValueError, match=match):
            tables.mxu_gather(table, idx)

    def test_scatter_rejects(self):
        idx = torch.zeros(4, dtype=torch.int32)
        with pytest.raises(ValueError, match="vals must be torch.float32"):
            tables.mxu_scatter_sum(128, idx, torch.zeros(4, dtype=torch.float64))
        with pytest.raises(ValueError, match="differ in shape"):
            tables.mxu_scatter_stats(128, idx, torch.zeros(5))
        with pytest.raises(ValueError, match="idx must be torch.int32"):
            tables.mxu_scatter_stats(128, idx.long(), torch.zeros(4))

    def test_other_devices_raise(self):
        table = torch.zeros(128, device="meta")
        idx = torch.zeros(4, dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="no table kernel for device meta"):
            tables.mxu_gather(table, idx)
        with pytest.raises(ValueError, match="no table kernel for device meta"):
            tables.mxu_scatter_sum(128, idx, torch.zeros(4, device="meta"))

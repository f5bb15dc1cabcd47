# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's hot-prefix table ops (``ops/hbm_tables.py``) against JAX.

The JAX ``cached_*`` functions run their Pallas kernels in interpret mode
on the CPU, as ``tests/test_hbm_tables.py`` runs them; the port runs its
plain versions, as a wrapper does for a CPU tensor. Inputs are made with
numpy; where a case needs a refreshed permutation, JAX's
``hot_permutation`` makes it and both packages get the same arrays.

Tolerances. The layout functions and the gather are exact in both
packages and compared for equality. The scatter's prefix sums are
reassociated (JAX folds three bf16 limb sums; the port adds in element
order) and are held at rtol 2e-5, atol 1e-5, the tolerance of
``tests/test_hbm_tables.py::TestScatterStats``. ``hits``, the cold indices,
the per-block cold counts and the overflow flag are integers or flags and
are compared for equality; the cold errors are copies, equal as values
(JAX's placement matmul turns -0.0 into +0.0).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rein48_tpu.ops import hbm_tables as jht
from rein48_tpu_torch.ops import hbm_tables as ht
from rein48_tpu_torch.utils import profiling

torch.set_num_threads(1)

SIZE = 16**5  # 1M entries, 8192 rows: the size of tests/test_hbm_tables.py
ROWS = SIZE // ht.ROW


def launches() -> list:
    """The hot-prefix kernels' launch counts."""
    return [profiling.counters.get(f"hbm_tables.{k}", 0) for k in ("cached_gather", "cached_scatter")]


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def physical_table(logical: np.ndarray, rm: np.ndarray) -> np.ndarray:
    """The physical storage whose logical view is ``logical``."""
    out = np.empty_like(logical)
    out[np.asarray(rm)[np.arange(SIZE) >> 7] * ht.ROW + (np.arange(SIZE) & 127)] = logical
    return out


def jax_permutation(heat: np.ndarray, k: int):
    """``(rm, hot)`` after one JAX refresh of the identity map by ``heat``."""
    _, rm, hot = jht.hot_permutation(jnp.asarray(heat), jht.identity_rowmap(SIZE), k)
    return np.asarray(rm), np.asarray(hot)


def integer_heat(rng, high: int) -> np.ndarray:
    """Per-entry heat of small integers: every row sum is exact in any order."""
    return rng.integers(0, high, SIZE).astype(np.float32)


class TestHotPrefixLayout:
    def test_rowmap_and_physical_index_match_jax(self):
        rm = ht.identity_rowmap(SIZE)
        np.testing.assert_array_equal(rm.numpy(), np.asarray(jht.identity_rowmap(SIZE)))
        assert rm.dtype == torch.int32
        jrm, _ = jax_permutation(integer_heat(np.random.default_rng(0), 50), 512)
        idx = np.arange(SIZE, dtype=np.int32)
        got = ht.physical_index(t(jrm), t(idx)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jht.physical_index(jnp.asarray(jrm), jnp.asarray(idx))))
        assert np.unique(got).shape[0] == SIZE  # a bijection of the table

    @pytest.mark.parametrize("heat", ["distinct", "tied", "zero"])
    def test_hot_permutation_matches_jax_over_two_refreshes(self, heat):
        rng = np.random.default_rng(1)
        if heat == "distinct":
            heats = [integer_heat(rng, 1 << 16) for _ in range(2)]
        elif heat == "tied":  # few heat levels: most rows tie with many others
            heats = [integer_heat(rng, 2) * (rng.uniform(size=SIZE) < 0.01) for _ in range(2)]
        else:  # a fresh init: every row ties at 0
            heats = [np.zeros(SIZE, np.float32)] * 2
        rm, jrm = ht.identity_rowmap(SIZE), jht.identity_rowmap(SIZE)
        for h in heats:  # the second heat is in the first refresh's layout
            got = ht.hot_permutation(t(h), rm, 300)
            want = jht.hot_permutation(jnp.asarray(h), jrm, 300)
            for name, g, w in zip(("perm", "rowmap", "hot"), got, want):
                assert g.dtype == torch.int32, name
                np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
            rm, jrm = got[1], want[1]
            np.testing.assert_array_equal(rm.numpy()[got[2].numpy()], np.arange(300))

    def test_apply_row_permutation_matches_jax(self):
        rng = np.random.default_rng(2)
        arr = rng.normal(size=SIZE).astype(np.float32)
        perm = rng.permutation(ROWS).astype(np.int32)
        got = ht.apply_row_permutation(t(arr), t(perm))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jht.apply_row_permutation(jnp.asarray(arr), jnp.asarray(perm))))


def gather_stream(name: str):
    """``(rm, hot, idx, prefix_rows, cold_capacity_rows)`` of one stream of
    ``tests/test_hbm_tables.py::TestCachedGather``, made with numpy."""
    rng = np.random.default_rng(sum(map(ord, name)))
    identity = np.arange(ROWS, dtype=np.int32)
    if name == "uniform":
        return identity, np.arange(4096, dtype=np.int32), rng.integers(0, SIZE, 5000), 4096, 64
    if name == "hot-concentrated":  # ~95% of lookups in 256 hot rows
        rows = rng.integers(0, 256, 16384) * 31 % ROWS
        idx = np.concatenate([rows * ht.ROW + rng.integers(0, ht.ROW, 16384), rng.integers(0, SIZE, 860)])
        heat = np.zeros((ROWS, ht.ROW), np.float32)
        heat[np.unique(rows)] = 1.0
        return *jax_permutation(heat.reshape(-1), 256), idx, 256, 16
    if name == "duplicate-heavy":
        idx = np.concatenate([np.full(4096, 12345), rng.integers(0, 64, 4096) * ht.ROW + 7])
        return identity, np.arange(4096, dtype=np.int32), idx, 4096, 64
    if name == "overflow":
        return identity, np.arange(128, dtype=np.int32), rng.integers(0, SIZE, 4096), 128, 2
    assert name == "after-refresh"
    return *jax_permutation(integer_heat(rng, 1 << 16), 1024), rng.integers(0, SIZE, 8192), 1024, 48


class TestHotPrefixGather:
    @pytest.mark.parametrize("stream", ["uniform", "hot-concentrated", "duplicate-heavy", "overflow", "after-refresh"])
    def test_bit_equal_to_jax(self, stream):
        rm, hot, idx, k, cr = gather_stream(stream)
        idx = idx.astype(np.int32)
        logical = np.random.default_rng(3).normal(size=SIZE).astype(np.float32)
        table = physical_table(logical, rm)
        before = launches()
        got = ht.cached_gather(t(table), t(rm), t(hot), t(idx.reshape(-1, 4)), prefix_rows=k, cold_capacity_rows=cr)
        assert launches() == before  # the CPU runs the plain version
        want = np.asarray(
            jht.cached_gather(
                jnp.asarray(table), jnp.asarray(rm), jnp.asarray(hot), jnp.asarray(idx.reshape(-1, 4)),
                prefix_rows=k, cold_capacity_rows=cr,
            )
        )
        assert got.shape == want.shape == (idx.size // 4, 4) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy().reshape(-1), logical[idx])


def lookups(rng, rows: np.ndarray, n: int) -> np.ndarray:
    """``n`` lookups into ``rows``, 8 lanes a row, so that entries repeat."""
    return rows[rng.integers(0, rows.size, n)] * ht.ROW + rng.integers(0, 8, n)


def exact_cold(rng, hot: np.ndarray, n: int, cold: int) -> np.ndarray:
    """``n`` lookups of which every 16,384-element block has exactly
    ``cold`` (or all its) elements outside ``hot``, at random positions."""
    in_hot = np.ones(n, bool)
    for start in range(0, n, ht.BLOCK):
        size = min(ht.BLOCK, n - start)
        in_hot[start + rng.permutation(size)[: min(cold, size)]] = False
    cold_rows = np.setdiff1d(np.arange(ROWS), hot)
    return np.where(in_hot, lookups(rng, hot, n), lookups(rng, cold_rows, n))


def scatter_case(name: str):
    """``(hot, idx, err, prefix_rows, cold_capacity_rows)``: errors normal,
    a seventh of them exact zeros and some -0.0, on hot and cold elements."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "one-entry":  # every element on one hot entry
        k, cr = 256, 16
        hot = rng.permutation(ROWS)[:k]
        idx = np.full(6000, hot[17] * ht.ROW + 9)
    elif name == "all-cold":  # no element in a hot row; the residue holds them all
        k, cr = 128, 48
        hot = rng.permutation(ROWS)[:k]
        idx = lookups(rng, np.setdiff1d(np.arange(ROWS), hot), 6000)
    elif name in ("at-capacity", "over-capacity"):  # two blocks, each with capacity (+1) cold elements
        k, cr = 256, 8
        hot = rng.permutation(ROWS)[:k]
        idx = exact_cold(rng, hot, 20000, cr * ht.ROW + (name == "over-capacity"))
    elif name == "shuffled-hot":  # hot rows in random order, neither sorted nor by heat
        k, cr = 384, 16
        hot = rng.permutation(ROWS)[:k]
        idx = np.where(rng.uniform(size=9000) < 0.8, lookups(rng, hot, 9000), rng.integers(0, SIZE, 9000))
    elif name == "partition":  # one block, no overflow (tests/test_hbm_tables.py:150)
        _, hot = jax_permutation(integer_heat(rng, 1 << 16), 256)
        idx = np.concatenate([hot[rng.integers(0, 256, 9000)] * ht.ROW + rng.integers(0, ht.ROW, 9000),
                              rng.integers(0, SIZE, 1500)])
        k, cr = 256, 64
    elif name == "three-blocks":  # a ragged last block, duplicates in hot and cold rows
        _, hot = jax_permutation(integer_heat(rng, 1 << 16), 512)
        rows = np.concatenate([hot[rng.integers(0, 64, 30000)], rng.integers(0, ROWS, 6000)])
        idx = rows * ht.ROW + rng.integers(0, 4, rows.size)
        idx = idx[rng.permutation(idx.size)]
        k, cr = 512, 24
    else:  # overflow (tests/test_hbm_tables.py:195)
        assert name == "overflow", name
        hot = np.arange(128, dtype=np.int32)
        idx = rng.integers(0, SIZE, 16384)
        k, cr = 128, 2
    idx = idx.astype(np.int32)
    err = rng.normal(size=idx.size).astype(np.float32)
    err[::7] = 0.0
    err[3::11] = -0.0
    return hot.astype(np.int32), idx, err, k, cr


def jax_counts(hot, idx, err, k, cr) -> np.ndarray:
    """JAX's per-block cold counts, from its kernel call as its wrapper makes it."""
    pad = -idx.size % (jht.G_BLK * jht.ROW)
    idx2 = np.concatenate([idx, np.full(pad, hot[0] * jht.ROW, np.int32)]).reshape(-1, jht.ROW)
    err2 = np.pad(err, (0, pad)).reshape(-1, jht.ROW)
    hot2 = jnp.asarray(hot.astype(np.float32).reshape(1, k))
    *_, cnt = jht._scatter_call(jnp.asarray(idx2), jnp.asarray(err2), hot2, k, cr, True)
    return np.asarray(cnt).reshape(-1, 8, jht.ROW)[:, 0, 0].astype(np.int32)


class TestHotPrefixScatter:
    @pytest.mark.parametrize(
        "case",
        ["partition", "three-blocks", "overflow", "one-entry", "all-cold", "at-capacity", "over-capacity", "shuffled-hot"],
    )
    def test_matches_jax(self, case):
        hot, idx, err, k, cr = scatter_case(case)
        before = launches()
        got = ht.cached_scatter_stats(t(hot), t(idx), t(err), prefix_rows=k, cold_capacity_rows=cr)
        assert launches() == before
        want = [np.asarray(w) for w in jht.cached_scatter_stats(
            jnp.asarray(hot), jnp.asarray(idx), jnp.asarray(err), prefix_rows=k, cold_capacity_rows=cr)]
        n_blocks = -(-idx.size // ht.BLOCK)
        shapes = [(k, ht.ROW)] * 3 + [(n_blocks * cr * ht.ROW,)] * 2 + [()]
        dtypes = [torch.float32] * 3 + [torch.int32, torch.float32, torch.bool]
        assert [tuple(g.shape) for g in got] == shapes == [w.shape for w in want]
        assert [g.dtype for g in got] == dtypes
        for name, g, w in zip(("err_sum", "abs_sum"), got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=2e-5, atol=1e-5, err_msg=name)
        np.testing.assert_array_equal(got[2].numpy(), want[2])  # hits
        np.testing.assert_array_equal(got[3].numpy(), want[3])  # cold_idx
        np.testing.assert_array_equal(got[4].numpy(), want[4])  # cold_err, as values
        assert bool(got[5]) == bool(want[5]) == (case in ("overflow", "over-capacity"))
        counts = ht.cached_scatter_blocks(t(hot), t(idx), t(err), prefix_rows=k, cold_capacity_rows=cr)[5]
        np.testing.assert_array_equal(counts.numpy(), jax_counts(hot, idx, err, k, cr))
        # The hot sums are those of a scatter-add over the prefix rows.
        member = np.isin(idx >> 7, hot)
        if case == "one-entry":
            assert member.all()
        elif case == "all-cold":
            assert not member.any()
        else:
            assert 0 < member.sum() < idx.size and (err[~member] == 0).any()
        slot = np.argsort(hot)[np.searchsorted(np.sort(hot), idx[member] >> 7)]
        np.testing.assert_array_equal(
            got[2].numpy().reshape(-1),
            np.bincount(slot * ht.ROW + (idx[member] & 127), weights=err[member] != 0, minlength=k * ht.ROW),
        )


class TestHotPrefixWrappers:
    def test_padded_size_bound_as_in_jax(self):
        n = 2**24 - 100  # pads to 2**24
        idx, hot = np.zeros(n, np.int32), np.arange(128, dtype=np.int32)
        table, rm = np.zeros(SIZE, np.float32), np.arange(ROWS, dtype=np.int32)
        with pytest.raises(ValueError, match="exceeds the f32-exact position bound 2\\^24"):
            jht.cached_gather(jnp.asarray(table), jnp.asarray(rm), jnp.asarray(hot), jnp.asarray(idx), prefix_rows=128)
        with pytest.raises(ValueError, match="cached_gather call of 16777216 padded elements exceeds"):
            ht.cached_gather(t(table), t(rm), t(hot), t(idx), prefix_rows=128)
        with pytest.raises(ValueError, match="cached_scatter_stats call of 16777216 padded elements exceeds"):
            ht.cached_scatter_stats(t(hot), t(idx), torch.zeros(n), prefix_rows=128)
        # One block short of the bound runs.
        ok = 2**24 - ht.BLOCK
        got = ht.cached_gather(t(table), t(rm), t(hot), torch.zeros(ok, dtype=torch.int32), prefix_rows=128)
        assert got.shape == (ok,)

    def test_rejects(self):
        table, rm, hot = torch.zeros(256), torch.arange(2, dtype=torch.int32), torch.arange(2, dtype=torch.int32)
        idx = torch.zeros(4, dtype=torch.int32)
        for args, match in (
            ((table.double(), rm, hot, idx), "table must be torch.float32"),
            ((torch.zeros(200), rm, hot, idx), "table must be 1-D with a multiple of 128"),
            ((table, rm[:1], hot, idx), "rowmap_flat must have shape \\(2,\\)"),
            ((table, rm, hot[:1], idx), "hot_rows must have shape \\(2,\\)"),
            ((table, rm, hot, idx.long()), "idx must be torch.int32"),
        ):
            with pytest.raises(ValueError, match=match):
                ht.cached_gather(*args, prefix_rows=2)
        with pytest.raises(ValueError, match="differ in shape"):
            ht.cached_scatter_stats(hot, idx, torch.zeros(5), prefix_rows=2)
        with pytest.raises(ValueError, match="err must be torch.float32"):
            ht.cached_scatter_stats(hot, idx, torch.zeros(4, dtype=torch.float64), prefix_rows=2)
        meta = [x.to("meta") for x in (table, rm, hot, idx)]
        with pytest.raises(ValueError, match="no table kernel for device meta"):
            ht.cached_gather(*meta, prefix_rows=2)
        with pytest.raises(ValueError, match="no table kernel for device meta"):
            ht.cached_scatter_stats(meta[2], meta[3], torch.zeros(4, device="meta"), prefix_rows=2)

    def test_empty_calls(self):
        hot = torch.arange(128, dtype=torch.int32)
        es, ab, hits, ci, ce, ovf = ht.cached_scatter_stats(
            hot, torch.zeros(0, dtype=torch.int32), torch.zeros(0), prefix_rows=128
        )
        assert es.shape == (128, ht.ROW) and not es.any() and ci.numel() == 0 and not bool(ovf)
        got = ht.cached_gather(
            torch.zeros(SIZE), ht.identity_rowmap(SIZE), hot, torch.zeros((0, 3), dtype=torch.int32), prefix_rows=128
        )
        assert got.shape == (0, 3)

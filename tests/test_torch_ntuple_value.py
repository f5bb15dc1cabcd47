# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""The fused n-tuple value (``ops/ntuple_value.py``) on the CPU.

On the CPU ``ntuple_value`` runs its plain version,
``ntuple_value_reference``; the card tests (``tests/test_torch_cuda.py``)
hold the kernel bit for bit to that plain version. Here the plain version is
held to the JAX package's ``NTupleNetwork.value`` at rtol 1e-5, atol 1e-6
(``"mxu"`` through the Pallas interpreter, ``"cached"`` on a permuted row
map; the float32 sums are the same adds in the same order, the tolerance of
``tests/test_torch_ntuple.py``), and bit for bit to the composition it
replaces in the port (``NTupleNetwork.gather_value``): ``indices``, the
standalone gather op per table, ``.sum(-1)`` and the adds over the tables.
The packed layout the kernel receives is read back and held to ``indices``
exactly.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rein48_tpu.agents import ntuple as jntuple
from rein48_tpu_torch.agents import ntuple
from rein48_tpu_torch.models import convert
from rein48_tpu_torch.ops import hbm_tables
from rein48_tpu_torch.ops import ntuple_value as value_ops
from rein48_tpu_torch.utils import profiling

from test_torch_engine import random_boards
from test_torch_ntuple import cached_tables

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
PRESETS = {"tiny": ntuple.TINY_2X3, "sj": ntuple.SJ_2X4, "yeh": ntuple.YEH_4X6}
# Five symmetric 3-tuples (40 lookups) and ten asymmetric ones: more than
# one group of the kernel's parameter struct.
WIDE_SYMMETRIC = ntuple.TINY_2X3 + ((1, 5, 9), (2, 6, 10), (12, 13, 14))
WIDE_ASYMMETRIC = tuple((c, c + 1, c + 2) for c in range(0, 10))


def make_boards(lead: tuple, seed: int) -> np.ndarray:
    """Boards of every kind, the first with exponent 15 in every cell."""
    n = int(np.prod(lead))
    boards = random_boards(np.random.default_rng(seed), n)
    if n:
        boards[0] = 15
    return boards.reshape(lead + (4, 4))


def port_net(tuples, backend: str, symmetric: bool = True, prefix_rows: int = 128):
    return ntuple.NTupleNetwork(
        ntuple.NTupleConfig(tuples=tuples, backend=backend, symmetric=symmetric, prefix_rows=prefix_rows)
    )


def jax_net(tuples, backend: str, symmetric: bool = True, prefix_rows: int = 128):
    return jntuple.NTupleNetwork(
        jntuple.NTupleConfig(tuples=tuples, backend=backend, symmetric=symmetric, prefix_rows=prefix_rows)
    )


def logical_tables(jnet, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {f"t{i}": rng.standard_normal(n, dtype=np.float32) for i, n in enumerate(jnet.table_sizes)}


def permuted_tables(jnet, seed: int) -> dict:
    """Random tables on a random row permutation, numpy, JAX key names: the
    ``"cached"`` layout without a refresh (a refresh would rank 16.7M-entry
    heats at YEH_4X6)."""
    rng = np.random.default_rng(seed)
    params = {}
    for i, n in enumerate(jnet.table_sizes):
        rows = n // hbm_tables.ROW
        rm = rng.permutation(rows).astype(np.int32)  # logical row -> physical row
        logical = rng.standard_normal(n, dtype=np.float32).reshape(rows, hbm_tables.ROW)
        physical = np.empty_like(logical)
        physical[rm] = logical
        params[f"t{i}"] = physical.reshape(-1)
        params[f"t{i}_rm"] = rm
        params[f"t{i}_hot"] = np.argsort(rm)[: jnet.prefix_rows[i]].astype(np.int32)
    return params


def unpack_group(words: np.ndarray, transposed: bool = False) -> list:
    """The tables' ``[L_i, K_i]`` flat row-major cells that ``pack_group``
    packed into ``words``, read back from the lanes' byte offsets."""
    words = np.asarray(words).view(np.uint32)
    W = value_ops.MAX_TABLES
    first = words[3 : 4 + W].astype(np.int64)
    lane_bytes, lane_meta = words[4 + W : 4 + W + value_ops.MAX_LANES], words[4 + W + value_ops.MAX_LANES :]
    cell_of = {value_ops._byte_of(c, transposed): c for c in range(16)}
    out = []
    for t in range(int(words[0])):
        lanes = range(first[t], first[t + 1])
        K = int(lane_meta[first[t]]) & 15
        rows = [[cell_of[(int(lane_bytes[lane]) >> (4 * k)) & 15] for k in range(K)] for lane in lanes]
        out.append(np.asarray(rows, np.int64).reshape(len(lanes), K))
    return out


class TestValueLayout:
    @pytest.mark.parametrize("preset", sorted(PRESETS))
    @pytest.mark.parametrize("symmetric", [True, False])
    def test_packed_layout_gives_the_indices(self, preset, symmetric):
        net = port_net(PRESETS[preset], "torch", symmetric)
        layout = value_ops.Layout(net._cells, net.indices)
        boards = torch.from_numpy(make_boards((6, 5), 1))
        flat = boards.reshape(6, 5, 16).to(torch.int32)
        want = net.indices(boards)
        got = [(flat[..., torch.from_numpy(c)] * 16 ** torch.arange(c.shape[1], dtype=torch.int32)).sum(-1, dtype=torch.int32)
               for _, words, _ in layout.groups for c in unpack_group(words)]
        assert len(got) == len(want) == len(layout.sizes)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert layout.sizes == net.table_sizes
        # The transposed words name the same cells, by their bytes in a
        # column-major board: read them off the raw bytes of such boards.
        raw = boards.mT.contiguous().reshape(30, 16).to(torch.int32)
        for group, _, words_t in layout.groups:
            view = np.asarray(words_t).view(np.uint32)
            first, lane_bytes, meta = view[3:12], view[12:44], view[44:]
            for t, table in enumerate(group):
                for lane in range(first[t], first[t + 1]):
                    K = int(meta[lane]) & 15
                    at = [(int(lane_bytes[lane]) >> (4 * k)) & 15 for k in range(K)]
                    idx = sum(raw[:, a] * 16**k for k, a in enumerate(at))
                    assert torch.equal(idx, want[table].reshape(30, -1)[:, lane - first[t]])

    @pytest.mark.parametrize(
        "tuples, symmetric, groups",
        [(ntuple.YEH_4X6, True, ((0, 1, 2, 3),)), (WIDE_SYMMETRIC, True, ((0, 1, 2, 3), (4,))),
         (WIDE_ASYMMETRIC, False, (tuple(range(8)), (8, 9)))],
    )
    def test_groups_follow_the_struct(self, tuples, symmetric, groups):
        net = port_net(tuples, "torch", symmetric)
        layout = value_ops.Layout(net._cells, net.indices)
        assert tuple(g for g, _, _ in layout.groups) == groups
        for _, words, _ in layout.groups:
            assert words.dtype == np.int32 and words.shape == (value_ops.LAYOUT_WORDS,)

    def test_pack_group_rejects_what_the_struct_cannot_hold(self):
        cells = [np.zeros((1, 3), np.int64)]
        with pytest.raises(ValueError, match="1 to 8 tables"):
            value_ops.pack_group(cells * 9)
        with pytest.raises(ValueError, match="1 to 8 tables"):
            value_ops.pack_group([])
        with pytest.raises(ValueError, match="at most 32 lookups"):
            value_ops.pack_group([np.zeros((8, 3), np.int64)] * 5)
        with pytest.raises(ValueError, match="K <= 8"):
            value_ops.pack_group([np.zeros((8, 9), np.int64)])
        with pytest.raises(ValueError, match="lie in"):
            value_ops.pack_group([np.full((8, 3), 16, np.int64)])
        assert value_ops.pack_group(cells * 8)[0] == 8


# (preset, port backend, JAX backend, symmetric, leading shape). YEH_4X6's
# tables are too large for "mxu"; its asymmetric case reads JAX's "xla",
# whose interpreter-free gather keeps the 16.7M-entry case quick.
JAX_CASES = [
    ("tiny", "mxu", "mxu", True, (16, 4)),
    ("tiny", "mxu", "mxu", False, (37,)),
    ("sj", "mxu", "mxu", True, (37,)),
    ("sj", "mxu", "mxu", False, (16, 4)),
    ("sj", "cached", "cached", True, (16, 4)),
    ("sj", "cached", "cached", False, (37,)),
    ("yeh", "cached", "cached", True, (16, 4)),
    ("yeh", "cached", "xla", False, (37,)),
    ("sj", "mxu", "mxu", True, (0,)),
]


class TestFusedValue:
    @pytest.mark.parametrize("preset, backend, jbackend, symmetric, lead", JAX_CASES)
    def test_reference_matches_jax(self, preset, backend, jbackend, symmetric, lead):
        tnet = port_net(PRESETS[preset], backend, symmetric)
        jnet = jax_net(PRESETS[preset], jbackend, symmetric)
        if backend == "cached":
            params = permuted_tables(tnet, 2) if preset == "yeh" else cached_tables(jax_net(PRESETS[preset], "cached", symmetric), 2, tc=False)
        else:
            params = logical_tables(tnet, 2)
        tp = convert.ntuple_params_from_jax(params, "cpu")
        boards = make_boards(lead, 3)
        tb = torch.from_numpy(boards)
        tabs, rowmaps = tnet.value_tables(tp)
        got = value_ops.ntuple_value_reference(tnet.indices(tb), tabs, rowmaps)
        assert torch.equal(tnet.value(tp, tb), got)  # the op on the CPU runs its plain version
        if jbackend == "xla":  # the same tables in logical order
            jparams = {}
            for i, t in enumerate(tabs):
                rows = torch.arange(t.numel(), dtype=torch.int32)
                jparams[f"t{i}"] = jnp.asarray(t[hbm_tables.physical_index(rowmaps[i], rows)].numpy())
        else:
            jparams = {k: jnp.asarray(v) for k, v in params.items()}
        want = np.asarray(jnet.value(jparams, jnp.asarray(boards)))
        assert got.shape == want.shape == lead
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)

    # Every preset on each backend that takes its tables.
    @pytest.mark.parametrize("preset, backend", [("tiny", "mxu"), ("sj", "mxu"), ("sj", "cached"), ("yeh", "cached")])
    @pytest.mark.parametrize("symmetric", [True, False])
    def test_bit_equal_to_the_composed_path(self, preset, backend, symmetric):
        net = port_net(PRESETS[preset], backend, symmetric)
        tp = convert.ntuple_params_from_jax(permuted_tables(net, 4) if backend == "cached" else logical_tables(net, 4), "cpu")
        boards = torch.from_numpy(make_boards((64,), 5))
        launched = profiling.counters.get("ntuple_value.launches", 0)
        for b in (boards, boards.mT.contiguous().mT, boards[::2], boards[:0]):
            assert torch.equal(net.value(tp, b), net.gather_value(tp, b))
        assert profiling.counters.get("ntuple_value.launches", 0) == launched  # the CPU runs the plain version

    @pytest.mark.parametrize("tuples, symmetric", [(WIDE_SYMMETRIC, True), (WIDE_ASYMMETRIC, False)])
    def test_groups_continue_the_sum(self, tuples, symmetric):
        # More tables than one launch holds: the same adds in the same order.
        tnet, jnet = port_net(tuples, "mxu", symmetric), jax_net(tuples, "xla", symmetric)
        params = logical_tables(tnet, 6)
        tp = convert.ntuple_params_from_jax(params, "cpu")
        boards = make_boards((40,), 7)
        got = tnet.value(tp, torch.from_numpy(boards))
        assert torch.equal(got, tnet.gather_value(tp, torch.from_numpy(boards)))
        want = np.asarray(jnet.value({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(boards)))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)

    def test_board_layouts(self):
        boards = torch.zeros((6, 4, 4), dtype=torch.uint8)
        assert value_ops.board_layout(boards) is False
        assert value_ops.board_layout(boards.mT) is True
        assert value_ops.board_layout(boards[::2]) is None
        assert value_ops.board_layout(torch.zeros(97, dtype=torch.uint8)[1:].view(6, 4, 4)) is False

    def test_bad_inputs_raise(self):
        net = port_net(ntuple.SJ_2X4, "cached")
        tp = convert.ntuple_params_from_jax(permuted_tables(net, 8), "cpu")
        tabs, rms = net.value_tables(tp)
        boards = torch.zeros((4, 4, 4), dtype=torch.uint8)
        layout = net._layout
        for args, match in (
            ((boards.to(torch.int32), tabs, layout, rms), "uint8"),
            ((boards.reshape(4, 16), tabs, layout, rms), "uint8"),
            ((boards, tabs[:1], layout, rms), "2 tables"),
            ((boards, tabs, layout, rms[:1]), "got 1 row maps"),
            ((boards, [tabs[0].double(), tabs[1]], layout, rms), "table 0 must be contiguous float32"),
            ((boards, [tabs[0], tabs[1][:-128]], layout, rms), "table 1 must be contiguous float32"),
            ((boards, tabs, layout, [rms[0].long(), rms[1]]), "row map 0 must be contiguous int32"),
            ((boards[::2], tabs, layout, rms), "16 consecutive bytes"),
        ):
            with pytest.raises(ValueError, match=match):
                value_ops.ntuple_value(*args)

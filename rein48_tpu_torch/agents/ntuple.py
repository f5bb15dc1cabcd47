# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""N-tuple network value function (port of ``agents/ntuple.py``).

A board's value is the sum of a handful of table lookups, one per (tuple,
board symmetry) pair; each tuple reads a few cells and indexes its table
by their exponents in base 16 (Szubert & Jaskowski, CIG 2014; temporal
coherence and delayed updates after Jaskowski, TCIAIG 2017). Learning is
a scatter-add into the same tables.

Tables are a plain dict of tensors with the JAX key names
(``{"t0": f32[16^k0], "t0_E": ..., "t0_A": ..., ...}``). Three backends:

* ``"torch"``: plain PyTorch index ops, the counterpart of the JAX
  package's ``"xla"``; any table size;
* ``"mxu"``: the table kernels of ``ops/tables.py`` (CUDA on the card),
  tables of at most 65,536 entries; the same math;
* ``"cached"``: hot-prefix permuted tables (``ops/hbm_tables.py``, CUDA on
  the card), table sizes divisible by 16,384. Tables are stored physically
  permuted by 128-entry rows, with ``t{i}_rm`` (int32 logical -> physical
  row map) and ``t{i}_hot`` (int32 logical rows of the hot prefix) beside
  them; :meth:`NTupleNetwork.refresh_cache` derives the permutation anew.
  Delayed windows go through the ``cached_scatter_stats`` kernel, and every
  other table op but the value runs the plain path on physical ids: the
  same per-entry math on a relabelled domain.

``value`` is one launch per call on the card of the fused kernel of
``ops/ntuple_value.py``, whatever the backend: the indices, the exact
lookups (through the row maps for ``"cached"``) and both sums, in the order
the JAX package sums; the CPU runs its plain version. The standalone gather ops stay; only ``gather_value``, the composition that
the kernel replaced, kept to compare against, calls them.

Unlike the JAX functions, which return new arrays, the update functions
here add into the tables in place (they are the trainer's state and the
flagship's are 67 MB each) and return the same dict; ``refresh_cache``
returns new tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from rein48_tpu_torch.device import resolve_device
from rein48_tpu_torch.engine import core
from rein48_tpu_torch.ops import hbm_tables
from rein48_tpu_torch.ops import ntuple_value as value_ops
from rein48_tpu_torch.ops import tables as table_ops
from rein48_tpu_torch.utils import profiling

BASE = core.MAX_EXPONENT + 1  # exponents 0..15 -> base-16 digits

# Yeh's 4x6-tuple network (flat row-major cells): two 2x3 "snakes" and two
# 2x3 boxes; the JAX CLI's flagship.
YEH_4X6 = (
    (0, 1, 2, 3, 4, 5),
    (4, 5, 6, 7, 8, 9),
    (0, 1, 2, 4, 5, 6),
    (4, 5, 6, 8, 9, 10),
)

# Szubert & Jaskowski's CIG-2014 network: a row 4-tuple and a 2x2 square,
# 2 tables of 65,536 entries (the "mxu" backend's size).
SJ_2X4 = (
    (0, 1, 2, 3),
    (0, 1, 4, 5),
)

# Small shapes for tests: 2 straight 3-tuples (tables of 4096).
TINY_2X3 = (
    (0, 1, 2),
    (0, 4, 8),
)

BACKENDS = ("torch", "mxu", "cached")


def _symmetry_maps() -> np.ndarray:
    """The dihedral group of the board as flat cell permutations.

    Returns ``int32[8, 16]``: ``maps[s, i]`` is the original flat cell
    that position ``i`` reads under symmetry ``s`` (the JAX order).
    """
    grid = np.arange(core.NUM_CELLS).reshape(core.BOARD_SIZE, core.BOARD_SIZE)
    out = []
    for flip in (False, True):
        g = np.fliplr(grid) if flip else grid
        for k in range(4):
            out.append(np.rot90(g, k).reshape(-1))
    return np.stack(out).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class NTupleConfig:
    """Network shape.

    Attributes:
        tuples: cell-index tuples (flat row-major); lengths may differ.
        symmetric: expand each tuple over the 8 board symmetries with
            shared weights (rotation/reflection invariance for free).
        optimistic_init: initial table value (0 is the classic default).
        backend: ``"torch"`` (plain index ops, any size), ``"mxu"`` (the
            ``ops/tables.py`` kernels, tables <= 65,536 entries) or
            ``"cached"`` (hot-prefix permuted tables, the
            ``ops/hbm_tables.py`` kernels, sizes divisible by 16,384).
        prefix_rows: ``"cached"`` only: hot-prefix rows of 128 entries per
            table, clamped to [128, table rows] and rounded down to a
            multiple of 128.
        cold_capacity_rows: ``"cached"`` only: cold slots per 16,384-element
            block of a delayed window, in rows of 128; a window with more
            cold elements in a block takes the dense path.
    """

    tuples: Tuple[Tuple[int, ...], ...] = YEH_4X6
    symmetric: bool = True
    optimistic_init: float = 0.0
    backend: str = "torch"
    prefix_rows: int = 8192
    cold_capacity_rows: int = 16

    @property
    def num_lookups(self) -> int:
        return len(self.tuples) * (8 if self.symmetric else 1)


class NTupleNetwork:
    """Apply/update functions for one :class:`NTupleConfig`.

    Lookup ``l`` of table ``i`` reads cells ``_cells[i][l]``, whose digits
    are weighted by ``16 ** k`` (cell ``k`` of the tuple).
    """

    def __init__(self, config: NTupleConfig = NTupleConfig()):
        self.config = config
        if config.backend not in BACKENDS:
            raise ValueError(
                f"unknown table backend '{config.backend}' (the port's backends are {BACKENDS}; "
                "'torch' is the JAX package's 'xla')"
            )
        syms = _symmetry_maps() if config.symmetric else _symmetry_maps()[:1]
        self._cells = [np.stack([s[np.asarray(t, np.int32)] for s in syms]).astype(np.int64) for t in config.tuples]
        self._weights = [(BASE ** np.arange(len(t))).astype(np.int32) for t in config.tuples]
        self.table_sizes = tuple(int(BASE ** len(t)) for t in config.tuples)
        self.num_lookups = config.num_lookups
        if config.backend == "mxu":
            bad = [s for s in self.table_sizes if not table_ops.supports_mxu(s)]
            if bad:
                raise ValueError(
                    f"backend='mxu' supports tables <= {table_ops.MXU_TABLE_MAX} "
                    f"entries; got {bad} (use backend='torch' for big tuples)"
                )
        if config.backend == "cached":
            bad = [n for n in self.table_sizes if n % hbm_tables.BLOCK]
            if bad:
                raise ValueError(
                    "backend='cached' needs table sizes divisible by "
                    f"16384; got {bad} (use 'torch' for small tuples)"
                )
            # Whole groups of 128 rows, in [128, table rows].
            self.prefix_rows = tuple(
                max(128, min(config.prefix_rows, n // hbm_tables.ROW) // 128 * 128) for n in self.table_sizes
            )
        self._mxu = config.backend == "mxu"
        self._cached = config.backend == "cached"
        self._layout = value_ops.Layout(self._cells, self.indices)
        self._consts: Dict[torch.device, list] = {}

    def _lookup_consts(self, device: torch.device):
        """``[(cells int64[L, K], weights int32[K]), ...]`` on ``device``."""
        consts = self._consts.get(device)
        if consts is None:
            consts = self._consts[device] = [
                (torch.from_numpy(c).to(device), torch.from_numpy(w).to(device))
                for c, w in zip(self._cells, self._weights)
            ]
        return consts

    def init(self, device=None) -> Dict[str, torch.Tensor]:
        """Constant tables ``{"t0": f32[16^k0], ...}`` on ``device``.

        ``"cached"`` adds the identity permutation: ``t{i}_rm`` maps every
        row to itself and ``t{i}_hot`` names rows ``0..K-1``. A constant
        table reads the same under any permutation.
        """
        device = resolve_device(device)
        params = {
            f"t{i}": torch.full((n,), self.config.optimistic_init, dtype=torch.float32, device=device)
            for i, n in enumerate(self.table_sizes)
        }
        if self._cached:
            for i, n in enumerate(self.table_sizes):
                params[f"t{i}_rm"] = hbm_tables.identity_rowmap(n, device)
                params[f"t{i}_hot"] = torch.arange(self.prefix_rows[i], dtype=torch.int32, device=device)
        return params

    def indices(self, boards: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Per-table lookup indices for ``uint8[..., 4, 4]`` boards.

        Returns one ``int32[..., L_i]`` tensor per table.
        """
        # Widen before the base-16 dot: uint8 digits times 16**k overflow.
        flat = boards.reshape(boards.shape[:-2] + (core.NUM_CELLS,)).to(torch.int32)
        out = []
        for cells, weights in self._lookup_consts(boards.device):
            digits = flat[..., cells]  # [..., L, K]
            out.append((digits * weights).sum(-1, dtype=torch.int32))
        return tuple(out)

    def physical_ids(self, params, i: int, ids: torch.Tensor) -> torch.Tensor:
        """Logical -> physical ids of table ``i`` (the plain table ops of
        ``"cached"`` take physical ids; other backends' are the same)."""
        if not self._cached:
            return ids
        return hbm_tables.physical_index(params[f"t{i}_rm"], ids)

    def _stats(self, size: int, ids: torch.Tensor, d: torch.Tensor):
        """Dense ``(err_sum, abs_sum, hits)`` over one table.

        ``hits`` counts nonzero deltas only: masked backups arrive as exact
        zeros and must not dilute means or move the TC accumulators.
        """
        if self._mxu:
            return table_ops.mxu_scatter_stats(size, ids, d)
        return tuple(table_ops.scatter_reference(size, ids, d, stats=True))

    def value(self, params: Dict[str, torch.Tensor], boards: torch.Tensor) -> torch.Tensor:
        """V(board) = sum of all table lookups, ``float32[...]``.

        Summed over each table's lookups first, then over the tables, as
        the JAX package sums. Every backend takes the fused kernel
        (:func:`value_ops.ntuple_value`) on the card and its plain version
        on the CPU; the kernel reads each board in place when it lies in 16
        consecutive bytes (the engine's afterstates are stored transposed)
        and otherwise from a copy.
        """
        if value_ops.board_layout(boards) is None:
            boards = boards.contiguous()
        if self._cached:
            n = boards.numel() // core.NUM_CELLS
            for c in self._cells:
                hbm_tables.check_padded("cached_gather", n * c.shape[0])
        tabs, rowmaps = self.value_tables(params)
        return value_ops.ntuple_value(boards, tabs, self._layout, rowmaps)

    def value_tables(self, params: Dict[str, torch.Tensor]):
        """``(tables, rowmaps)`` of the value op: the float tables in order,
        and for ``"cached"`` their row maps (``None`` otherwise)."""
        ids = range(len(self.table_sizes))
        rowmaps = [params[f"t{i}_rm"] for i in ids] if self._cached else None
        return [params[f"t{i}"] for i in ids], rowmaps

    def gather_value(self, params: Dict[str, torch.Tensor], boards: torch.Tensor) -> torch.Tensor:
        """``value`` through the standalone gather ops, as it was composed
        before the fused kernel: ``indices``, ``mxu_gather`` or
        ``cached_gather`` per table, ``.sum(-1)``, an add per table. Not on
        any path of the port: the comparison for the fused kernel."""
        total = None
        for i, idx in enumerate(self.indices(boards)):
            table = params[f"t{i}"]
            if self._cached:
                vals = hbm_tables.cached_gather(
                    table, params[f"t{i}_rm"], params[f"t{i}_hot"], idx,
                    prefix_rows=self.prefix_rows[i], cold_capacity_rows=self.config.cold_capacity_rows,
                )
            else:
                vals = table_ops.mxu_gather(table, idx)
            v = vals.sum(-1)
            total = v if total is None else total + v
        return total

    @staticmethod
    def _flat_deltas(per_board: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """A per-board value repeated over the board's lookups, flat."""
        return per_board[..., None].expand(idx.shape).reshape(-1)

    @staticmethod
    def _runs(ids: torch.Tensor, d: torch.Tensor):
        """Sort by entry: ``(s_ids, s_d, first, seg)`` of the runs of equal ids."""
        order = torch.argsort(ids, stable=True)
        s_ids, s_d = ids[order], d[order]
        first = torch.ones_like(s_ids, dtype=torch.bool)
        first[1:] = s_ids[1:] != s_ids[:-1]
        seg = torch.cumsum(first, 0) - 1
        return s_ids, s_d, first, seg

    def td_apply(
        self,
        params: Dict[str, torch.Tensor],
        boards: torch.Tensor,
        err: torch.Tensor,
        alpha: float,
        collision: str = "mean",
    ) -> Dict[str, torch.Tensor]:
        """One TD scatter step: every lookup of ``boards`` moves by
        ``alpha * err / num_lookups``, in place.

        ``collision`` says what an entry hit by several boards receives:
        ``"mean"`` the mean of their nonzero deltas (bounded per-entry step
        at any batch size), ``"sum"`` their sum (exact small-batch tabular
        TD). See the JAX docstring.
        """
        if collision not in ("mean", "sum"):
            raise ValueError(f"unknown collision mode '{collision}'")
        delta = (alpha / self.num_lookups) * err
        for i, idx in enumerate(self.indices(boards)):
            ids = self.physical_ids(params, i, idx.reshape(-1))
            d = self._flat_deltas(delta, idx)
            table = params[f"t{i}"]
            if self._mxu:
                size = table.shape[0]
                if collision == "mean":
                    err_sum, _, hits = self._stats(size, ids, d)
                    table.add_(err_sum / torch.clamp(hits, min=1.0))
                else:
                    table.add_(table_ops.mxu_scatter_sum(size, ids, d))
                continue
            if collision == "mean":
                # Divide each delta by the live count of its run of equal
                # ids, so the scatter-add lands the mean on every entry.
                ids, s_d, _, seg = self._runs(ids, d)
                live = (s_d != 0.0).to(s_d.dtype)
                counts = torch.zeros(ids.shape, dtype=s_d.dtype, device=s_d.device).index_add_(0, seg, live)
                d = s_d / torch.clamp(counts[seg], min=1.0)
            table.index_add_(0, ids, d)
        return params

    def init_tc(self, device=None) -> Dict[str, torch.Tensor]:
        """Tables plus temporal-coherence accumulators ``t{i}_E`` (signed
        TD-error sum) and ``t{i}_A`` (absolute sum), zeroed."""
        params = self.init(device)
        for i in range(len(self.table_sizes)):
            params[f"t{i}_E"] = torch.zeros_like(params[f"t{i}"])
            params[f"t{i}_A"] = torch.zeros_like(params[f"t{i}"])
        return params

    @staticmethod
    def _tc_rate(e_acc: torch.Tensor, a_acc: torch.Tensor) -> torch.Tensor:
        """Per-entry modulation ``|E|/A``, 1 while an entry is untouched."""
        return torch.where(a_acc > 0.0, e_acc.abs() / torch.clamp(a_acc, min=1e-30), 1.0)

    def td_apply_tc(
        self,
        params: Dict[str, torch.Tensor],
        boards: torch.Tensor,
        err: torch.Tensor,
        alpha: float,
    ) -> Dict[str, torch.Tensor]:
        """Temporal-coherence TD step (collision-mean semantics), in place.

        Per touched entry ``e`` with batch-mean error ``d_e``:
        ``w_e += alpha/L * (|E_e|/A_e) * d_e``, then ``E_e += d_e`` and
        ``A_e += |d_e|``. Masked backups (exact-0 errors) touch nothing.
        """
        scale = alpha / self.num_lookups
        for i, idx in enumerate(self.indices(boards)):
            ids = self.physical_ids(params, i, idx.reshape(-1))
            d = self._flat_deltas(err, idx)
            table, e_acc, a_acc = params[f"t{i}"], params[f"t{i}_E"], params[f"t{i}_A"]
            if self._mxu:
                # Dense: per-entry mean error and modulation as table passes.
                err_sum, _, hits = self._stats(table.shape[0], ids, d)
                mean_d = err_sum / torch.clamp(hits, min=1.0)
                table.add_(scale * self._tc_rate(e_acc, a_acc) * mean_d)
                e_acc.add_(mean_d)
                a_acc.add_(mean_d.abs())
                continue
            s_ids, s_d, first, seg = self._runs(ids, d)
            n = ids.shape[0]
            live = (s_d != 0.0).to(s_d.dtype)
            counts = torch.zeros(n, dtype=s_d.dtype, device=s_d.device).index_add_(0, seg, live)
            seg_sum = torch.zeros(n, dtype=s_d.dtype, device=s_d.device).index_add_(0, seg, s_d)
            # Per-run mean error, landed once per run (its first element).
            mean_d = (seg_sum / torch.clamp(counts, min=1.0))[seg] * first
            beta = self._tc_rate(e_acc[s_ids], a_acc[s_ids])
            table.index_add_(0, s_ids, scale * beta * mean_d)
            e_acc.index_add_(0, s_ids, mean_d)
            a_acc.index_add_(0, s_ids, mean_d.abs())
        return params

    def td_apply_delayed(
        self,
        params: Dict[str, torch.Tensor],
        boards: torch.Tensor,
        err: torch.Tensor,
        alpha: float,
        tc: bool = True,
    ) -> Dict[str, torch.Tensor]:
        """Windowed ("delayed") TD step, in place.

        ``boards``/``err`` hold every backup of a window (``[N, 4, 4]`` /
        ``[N]``, masked backups as exact-0 errors), gathered while the
        tables were frozen. Each entry with ``h`` nonzero hits of mean
        error ``m`` moves by the sequential-equivalent
        ``(1 - (1 - alpha*beta)**h) * m / num_lookups``; with ``tc`` the
        accumulators receive the full per-hit sums. See the JAX docstring.
        ``"cached"`` takes :meth:`_delayed_apply_cached`.
        """
        for i, idx in enumerate(self.indices(boards)):
            d = self._flat_deltas(err, idx)
            if self._cached:
                self._delayed_apply_cached(params, i, idx.reshape(-1), d, alpha, tc)
                continue
            table = params[f"t{i}"]
            err_sum, abs_sum, hits = self._stats(table.shape[0], idx.reshape(-1), d)
            mean_d = err_sum / torch.clamp(hits, min=1.0)
            if tc:
                s = torch.clamp(alpha * self._tc_rate(params[f"t{i}_E"], params[f"t{i}_A"]), 0.0, 1.0)
            else:
                s = min(max(alpha, 0.0), 1.0)
            # (1-s)^h is 1 at h=0, so untouched entries move by 0.
            gain = 1.0 - torch.pow(1.0 - s, hits)
            table.add_((gain / self.num_lookups) * mean_d)
            if tc:
                params[f"t{i}_E"].add_(err_sum)
                params[f"t{i}_A"].add_(abs_sum)
        return params

    def _delayed_apply_cached(self, params, i: int, ids: torch.Tensor, d: torch.Tensor, alpha: float, tc: bool):
        """The windowed update of table ``i`` for ``"cached"``, in place.

        ``ids`` are LOGICAL. The ``cached_scatter_stats`` kernel sums the
        hot contributions into ``[K, 128]`` prefix statistics, which update
        the prefix elementwise, and hands back the cold contributions
        compacted, which update their few entries by the same formula
        through sorted runs. Entries neither hot nor touched have 0 hits,
        which the dense formula maps to no move, so this is the dense
        result up to the reassociation of the sums. When a block's cold
        elements overflowed its capacity, the window takes the dense path
        on physical ids instead: JAX picks the branch on the device
        (``lax.cond``), the port reads the flag on the host, one sync per
        table per window. The counters ``ntuple.cached_fast`` and
        ``ntuple.cached_fallback`` (``utils/profiling.counters``) count the
        branches.
        """
        K = self.prefix_rows[i]
        w = params[f"t{i}"]
        e_acc, a_acc = (params[f"t{i}_E"], params[f"t{i}_A"]) if tc else (None, None)
        scale = 1.0 / self.num_lookups

        def step_at(at):
            """The per-hit step ``clamp(alpha * beta, 0, 1)`` of the entries ``at``."""
            if not tc:
                return min(max(alpha, 0.0), 1.0)
            return torch.clamp(alpha * self._tc_rate(e_acc[at], a_acc[at]), 0.0, 1.0)

        err_sum, abs_sum, hits, cold_i, cold_e, overflow = hbm_tables.cached_scatter_stats(
            params[f"t{i}_hot"], ids, d, prefix_rows=K, cold_capacity_rows=self.config.cold_capacity_rows
        )
        if bool(overflow):
            profiling.count("ntuple.cached_fallback")
            f_es, f_ab, f_h = self._stats(w.shape[0], self.physical_ids(params, i, ids), d)
            gain = 1.0 - torch.pow(1.0 - step_at(slice(None)), f_h)
            w.add_(gain * scale * (f_es / torch.clamp(f_h, min=1.0)))
            if tc:
                e_acc.add_(f_es)
                a_acc.add_(f_ab)
            return
        profiling.count("ntuple.cached_fast")
        pe = K * hbm_tables.ROW
        es, ab, h = err_sum.reshape(-1), abs_sum.reshape(-1), hits.reshape(-1)
        gain = 1.0 - torch.pow(1.0 - step_at(slice(0, pe)), h)
        w[:pe].add_(gain * scale * (es / torch.clamp(h, min=1.0)))
        if tc:
            e_acc[:pe].add_(es)
            a_acc[:pe].add_(ab)

        # The cold residue, in runs of equal physical ids; each run's update
        # lands on its first element. The others, and the (0, 0.0) slots of
        # unused capacity, have 0 hits and add exactly 0.
        sp, se, first, seg = self._runs(self.physical_ids(params, i, cold_i), cold_e)
        m = sp.shape[0]

        def run_sum(v):
            return torch.zeros(m, dtype=torch.float32, device=se.device).index_add_(0, seg, v)[seg] * first

        c_h = run_sum((se != 0.0).to(torch.float32))
        c_es, c_ab = run_sum(se), run_sum(se.abs())
        # The accumulators are read after the prefix update, as in JAX.
        c_gain = 1.0 - torch.pow(1.0 - step_at(sp), c_h)
        w.index_add_(0, sp, c_gain * scale * (c_es / torch.clamp(c_h, min=1.0)))
        if tc:
            e_acc.index_add_(0, sp, c_es)
            a_acc.index_add_(0, sp, c_ab)

    def refresh_cache(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Derive each table's hot-prefix permutation anew (``"cached"``).

        Heat is the TC ``|err|`` accumulator ``t{i}_A`` when present, else
        ``|t{i}|``. Rows are reordered so that the ``K`` hottest form the
        prefix; every per-entry array moves with them, so training is
        unchanged (the domain is relabelled). Returns a new dict holding
        NEW tensors for ``t{i}``, ``t{i}_E``, ``t{i}_A``, ``t{i}_rm`` and
        ``t{i}_hot`` (a row permutation cannot run in place); callers swap
        it in for the old one. Other backends return ``params`` as it is.
        """
        if not self._cached:
            return params
        new = dict(params)
        for i in range(len(self.table_sizes)):
            heat = params.get(f"t{i}_A")
            if heat is None:
                heat = params[f"t{i}"].abs()
            perm, rm, hot = hbm_tables.hot_permutation(heat, params[f"t{i}_rm"], self.prefix_rows[i])
            for suffix in ("", "_E", "_A"):
                key = f"t{i}{suffix}"
                if key in params:
                    new[key] = hbm_tables.apply_row_permutation(params[key], perm)
            new[f"t{i}_rm"] = rm
            new[f"t{i}_hot"] = hot
        return new

    def make_leaf(self, params, max_batch: int = 4096):
        """Expectimax leaf evaluator (``control/search.py``).

        N-tuple values are afterstate values, the planner's leaf domain.
        On the CPU the leaf batch is cut into chunks of ``max_batch`` boards
        (the JAX package's ``lax.map``), which bounds each gather at
        ``num_lookups * max_batch`` indices; the values are the same. On the
        card a leaf call is one launch of the value kernel over the whole
        batch, which holds no indices.
        """

        def leaf(boards: torch.Tensor) -> torch.Tensor:
            lead = boards.shape[:-2]
            flat = boards.reshape((-1,) + boards.shape[-2:])
            if flat.shape[0] <= max_batch or flat.is_cuda:
                return self.value(params, flat).reshape(lead)
            vals = [self.value(params, chunk) for chunk in flat.split(max_batch)]
            return torch.cat(vals).reshape(lead)

        return leaf

# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""The n-tuple network's value in one kernel: boards -> summed lookups.

In the JAX package ``NTupleNetwork.value`` of the ``"mxu"`` and
``"cached"`` backends is one XLA program around a Pallas gather per table
(``ops/tables.py::_gather_kernel``, ``ops/hbm_tables.py::_gather_kernel``).
Run eagerly, the same composition is about 12 launches per call at
``SJ_2X4`` and 24 at ``YEH_4X6``. On the card :func:`ntuple_value` is one
launch of the kernel of ``csrc/ntuple_value.cu`` per call (see the note at
the top of that file), and ``NTupleNetwork.value`` takes it for every
backend, ``"torch"`` included; a CPU tensor runs the plain version,
:func:`ntuple_value_reference`; any other device raises. The counter
``ntuple_value.launches`` (``utils/profiling.counters``) counts kernel
launches, never those of the plain version.

The kernel's lookups come from a :class:`Layout`, packed once per network
from its cells: per lookup, the board cells of its digits (weighted
``16 ** k``). The plain version takes the network's own lookup indices.
A group holds at most :data:`MAX_TABLES` tables and :data:`MAX_LANES`
lookups, what the kernel's parameter struct holds; a larger network runs
as several groups, one launch each, each continuing the previous group's
sums, so the order of the adds and the result are the same.

Exactness: the gathers are exact and both folds run left to right, over a
table's lookups and then over the tables, as ``table[idx].sum(-1)`` and
``total + v`` add them on the CPU: the kernel is bit-equal to the plain
version.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from rein48_tpu_torch.ops.hbm_tables import ROW, physical_index
from rein48_tpu_torch.ops.tables import _raise_on, _stream
from rein48_tpu_torch.utils import profiling

MAX_TABLES = 8  # tables of one group
MAX_LANES = 32  # lookups per board of one group: one warp
MAX_CELLS = 8  # cells per lookup
NUM_CELLS = 16
# The group's packed words: num_tables, lanes, max_lookups,
# table_first[MAX_TABLES + 1], lane_bytes[MAX_LANES], lane_meta[MAX_LANES].
LAYOUT_WORDS = 3 + MAX_TABLES + 1 + 2 * MAX_LANES

_PtrArray = ctypes.c_void_p * MAX_TABLES
_fns: dict = {}


def _fn():
    """The C function of ``csrc/ntuple_value.cu``, built on first use."""
    fn = _fns.get("rein48_ntuple_value")
    if fn is None:
        from rein48_tpu_torch import build

        fn = build.load("ntuple_value").rein48_ntuple_value
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["rein48_ntuple_value"] = fn
    return fn


def _byte_of(cell: int, transposed: bool) -> int:
    """The byte of a board's 16 that holds flat cell ``cell`` (row-major)."""
    return 4 * (cell % 4) + cell // 4 if transposed else cell


def pack_group(cells: Sequence[np.ndarray], transposed: bool = False) -> np.ndarray:
    """The kernel's ``int32[LAYOUT_WORDS]`` layout of one group of tables.

    ``cells[i]`` is table ``i``'s ``[L_i, K_i]`` flat row-major board cells.
    ``transposed`` packs the byte offsets of a board stored column-major.
    Raises when the group is more than the kernel's parameter struct holds.
    """
    if not 1 <= len(cells) <= MAX_TABLES:
        raise ValueError(f"a group holds 1 to {MAX_TABLES} tables, got {len(cells)}")
    cells = [np.asarray(c) for c in cells]
    lanes = sum(c.shape[0] for c in cells)
    if lanes > MAX_LANES:
        raise ValueError(f"a group holds at most {MAX_LANES} lookups per board, got {lanes}")
    words = np.zeros(LAYOUT_WORDS, np.uint32)
    first = words[3 : 4 + MAX_TABLES]
    lane_bytes = words[4 + MAX_TABLES : 4 + MAX_TABLES + MAX_LANES]
    lane_meta = words[4 + MAX_TABLES + MAX_LANES :]
    lane = 0
    for t, c in enumerate(cells):
        if c.ndim != 2 or c.shape[0] < 1 or c.shape[1] > MAX_CELLS:
            raise ValueError(f"table {t}'s cells must be [L >= 1, K <= {MAX_CELLS}], got shape {c.shape}")
        if c.size and not (0 <= c.min() and c.max() < NUM_CELLS):
            raise ValueError(f"table {t}'s cells must lie in [0, {NUM_CELLS})")
        L, K = c.shape
        first[t] = lane
        for l in range(L):
            lane_bytes[lane + l] = sum(_byte_of(int(x), transposed) << (4 * k) for k, x in enumerate(c[l]))
            lane_meta[lane + l] = K | (t << 4) | (L << 8) | (int(l == 0) << 16)
        lane += L
    first[len(cells) :] = lanes
    words[:3] = (len(cells), lanes, max(c.shape[0] for c in cells))
    return words.view(np.int32)


class Layout:
    """A network's lookups packed for the kernel, once per network.

    ``cells[i]`` is table ``i``'s ``[L_i, K_i]`` flat row-major board
    cells, and ``indices`` maps ``uint8[..., 4, 4]`` boards to the tables'
    ``int32[..., L_i]`` lookup indices from those cells (the network's
    ``indices``), for the plain version. ``groups`` is a tuple of
    ``(tables, words, words_t)``: the indices of a run of consecutive
    tables, and their packed words for row-major and for transposed boards.
    Tables join a group in order while it holds at most :data:`MAX_TABLES`
    tables and :data:`MAX_LANES` lookups.
    """

    def __init__(self, cells: Sequence[np.ndarray], indices: Callable[[torch.Tensor], Sequence[torch.Tensor]]):
        cells = [np.asarray(c) for c in cells]
        if not cells:
            raise ValueError("a network needs at least one table")
        groups, run, lanes = [], [], 0
        for t, c in enumerate(cells):
            if run and (len(run) == MAX_TABLES or lanes + c.shape[0] > MAX_LANES):
                groups.append(run)
                run, lanes = [], 0
            run.append(t)
            lanes += c.shape[0]
        groups.append(run)
        self.num_tables = len(cells)
        self.groups = tuple(
            (tuple(g), pack_group([cells[t] for t in g]), pack_group([cells[t] for t in g], transposed=True))
            for g in groups
        )
        self.sizes = tuple(NUM_CELLS ** c.shape[1] for c in cells)
        self.indices = indices


def ntuple_value_reference(
    indices: Sequence[torch.Tensor],
    tables: Sequence[torch.Tensor],
    rowmaps: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Plain version of the kernel, from each table's ``int32[..., L_i]``
    lookup indices (``NTupleNetwork.indices``): ``table[phys(idx)]`` per
    table, each table's lookups added left to right, then the tables in
    order."""
    total = None
    for i, idx in enumerate(indices):
        if rowmaps is not None:
            idx = physical_index(rowmaps[i], idx)
        vals = tables[i][idx]
        v = vals[..., 0]
        for l in range(1, vals.shape[-1]):
            v = v + vals[..., l]
        total = v if total is None else total + v
    return total


def board_layout(boards: torch.Tensor) -> Optional[bool]:
    """How the kernel reads ``uint8[..., 4, 4]`` boards: ``False`` when
    contiguous, ``True`` when each board is stored transposed (the last two
    dimensions swapped, the rest contiguous), ``None`` when neither."""
    if boards.is_contiguous():
        return False
    if boards.mT.is_contiguous():
        return True
    return None


def _check(boards, tables, layout, rowmaps) -> None:
    dev = boards.device
    if boards.dtype != torch.uint8 or boards.ndim < 2 or tuple(boards.shape[-2:]) != (4, 4):
        raise ValueError(f"boards must be uint8[..., 4, 4], got {boards.dtype}{list(boards.shape)}")
    if len(tables) != layout.num_tables:
        raise ValueError(f"the layout has {layout.num_tables} tables, got {len(tables)}")
    if rowmaps is not None and len(rowmaps) != layout.num_tables:
        raise ValueError(f"the layout has {layout.num_tables} tables, got {len(rowmaps)} row maps")
    for i, (t, size) in enumerate(zip(tables, layout.sizes)):
        if t.dtype != torch.float32 or t.device != dev or t.shape != (size,) or not t.is_contiguous():
            raise ValueError(f"table {i} must be contiguous float32[{size}] on {dev}, got {t.dtype}{list(t.shape)} on {t.device}")
        if rowmaps is not None:
            rm = rowmaps[i]
            if rm.dtype != torch.int32 or rm.device != dev or rm.shape != (size // ROW,) or not rm.is_contiguous():
                raise ValueError(f"row map {i} must be contiguous int32[{size // ROW}] on {dev}, got {rm.dtype}{list(rm.shape)} on {rm.device}")


def _launch(boards, tables, layout, rowmaps, transposed: bool) -> torch.Tensor:
    n = boards.numel() // NUM_CELLS
    out = None
    if n == 0:
        return torch.empty(boards.shape[:-2], dtype=torch.float32, device=boards.device)
    fn = _fn()
    stream = _stream(boards.device)
    with torch.cuda.device(boards.device):
        for group, words, words_t in layout.groups:
            prev, out = out, torch.empty(boards.shape[:-2], dtype=torch.float32, device=boards.device)
            tabs = _PtrArray(*[tables[t].data_ptr() for t in group])
            rms = None if rowmaps is None else _PtrArray(*[rowmaps[t].data_ptr() for t in group])
            err = fn(boards.data_ptr(), n, (words_t if transposed else words).ctypes.data, tabs, rms,
                     None if prev is None else prev.data_ptr(), out.data_ptr(), stream)
            profiling.count("ntuple_value.launches")
            _raise_on(err, "ntuple_value")
    return out


def ntuple_value(
    boards: torch.Tensor,
    tables: Sequence[torch.Tensor],
    layout: Layout,
    rowmaps: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """``float32[...]`` values of ``uint8[..., 4, 4]`` boards.

    ``tables[i]`` is table ``i`` (``float32[16 ** K_i]``), PHYSICAL storage
    when ``rowmaps`` gives its ``int32[16 ** K_i // 128]`` row map (the
    ``"cached"`` layout), logical otherwise. Each board must lie in 16
    consecutive bytes, row-major or transposed (:func:`board_layout`):
    boards in another layout raise, and the caller copies them.
    """
    _check(boards, tables, layout, rowmaps)
    transposed = board_layout(boards)
    if transposed is None:
        raise ValueError("each board must lie in 16 consecutive bytes, row-major or transposed")
    dev = boards.device
    if dev.type == "cuda":
        return _launch(boards, tables, layout, rowmaps, transposed)
    if dev.type != "cpu":
        raise ValueError(f"no n-tuple value kernel for device {dev}")
    return ntuple_value_reference(layout.indices(boards), tables, rowmaps)

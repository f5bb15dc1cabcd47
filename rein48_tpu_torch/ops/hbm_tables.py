# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Hot-prefix permuted tables (port of ``ops/hbm_tables.py``).

The JAX package's ``"cached"`` table backend keeps each n-tuple table
PHYSICALLY permuted by 128-entry rows, so that its hottest ``K`` rows form
the prefix ``table[:K * 128]``. ``t{i}_rm`` maps each logical row to its
physical row and ``t{i}_hot`` names the logical rows of the prefix
(``rm[hot[s]] == s``). Every ``cache_refresh_every`` updates the
permutation is derived anew from the temporal-coherence ``|err|``
accumulator (:func:`hot_permutation`, :func:`apply_row_permutation`).

Two kernels read and write through that layout; on the card they are the
CUDA kernels of ``csrc/hbm_tables.cu`` (see the note at the top of that
file):

* :func:`cached_gather`: ``table_logical[idx]``, bit-exact;
* :func:`cached_scatter_stats`: ``(err_sum, abs_sum, hits)`` over the
  ``K`` hot rows, plus the cold elements compacted per 16,384-element
  block in element order and an overflow flag. For ``K`` up to
  :data:`HASH_MAX_ROWS` a call is two launches (the zero fill of the sums
  and the flag, then the kernel), with no sort of the hot rows.

Each keeps its JAX name, signature, output shapes and dtypes. A CUDA
tensor launches the kernel or raises; a CPU tensor runs the plain version
(:func:`cached_gather_reference`, :func:`cached_scatter_stats_reference`);
any other device raises. ``launches`` counts kernel launches, never those
of the plain versions. The layout functions are plain PyTorch: they run at
refresh time and are no kernels in the JAX package either.
"""

from __future__ import annotations

import ctypes

import torch

from rein48_tpu_torch.ops.tables import _check, _raise_on, _stream

ROW = 128  # table row width
G_BLK = 128  # rows of elements per block of the scatter's cold residue
BLOCK = G_BLK * ROW  # 16,384 elements
# The most hot rows whose hash fits a block's shared memory; above, the
# wrapper sorts the rows and hands the kernel their slots, and the kernel
# binary-searches them.
HASH_MAX_ROWS = 8192

# Kernel launches per kernel since the counts were last set to 0.
launches = {"cached_gather": 0, "cached_scatter": 0}

_ARGTYPES = {
    "rein48_cached_gather": [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p],
    "rein48_cached_scatter": [ctypes.c_void_p] * 2
    + [ctypes.c_longlong]
    + [ctypes.c_void_p] * 2
    + [ctypes.c_int]
    + [ctypes.c_void_p] * 5
    + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
}
_fns: dict = {}


def _fn(name: str):
    """The C function ``name`` of ``csrc/hbm_tables.cu``, built on first use."""
    fn = _fns.get(name)
    if fn is None:
        from rein48_tpu_torch import build

        fn = getattr(build.load("hbm_tables"), name)
        fn.argtypes, fn.restype = _ARGTYPES[name], ctypes.c_int
        _fns[name] = fn
    return fn


def physical_index(rowmap_flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Logical flat index -> physical flat index."""
    return rowmap_flat[idx >> 7] * ROW + (idx & (ROW - 1))


# ------------------------------------------------------------------
# Permutation management (plain PyTorch, at refresh time)
# ------------------------------------------------------------------


def identity_rowmap(size: int, device=None) -> torch.Tensor:
    """Identity logical->physical row map (flat ``int32[size // 128]``)."""
    return torch.arange(size // ROW, dtype=torch.int32, device=device)


def hot_permutation(a_acc_physical: torch.Tensor, rowmap_flat: torch.Tensor, k: int):
    """New permutation putting the ``k`` hottest physical rows first.

    Returns ``(perm, new_rowmap_flat, hot_logical)``: ``perm[new_phys] =
    old_phys`` (row-gather order), the updated logical->physical map, and
    the LOGICAL rows now in physical slots ``0..k-1``. Rows of equal heat
    keep their order, lowest first, as ``lax.top_k`` orders them (a stable
    sort: ``torch.topk`` promises no order among ties, and at a fresh init
    every row's heat is 0). The rows outside the top ``k`` follow in
    physical order.
    """
    heat = a_acc_physical.reshape(-1, ROW).sum(1)
    rows = heat.shape[0]
    top = torch.sort(heat, descending=True, stable=True).indices[:k]
    in_top = torch.zeros(rows, dtype=torch.bool, device=heat.device)
    in_top[top] = True
    perm = torch.cat([top, torch.nonzero(~in_top).reshape(-1)]).to(torch.int32)
    arange = torch.arange(rows, dtype=torch.int32, device=heat.device)
    newpos = torch.empty_like(arange)
    newpos[perm] = arange
    new_rowmap = newpos[rowmap_flat]
    # hot_logical[s] is the logical row in new physical slot s: invert the
    # old map on the new prefix.
    logical_of_oldphys = torch.empty_like(arange)
    logical_of_oldphys[rowmap_flat] = arange
    return perm, new_rowmap, logical_of_oldphys[perm[:k]]


def apply_row_permutation(arr: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Physically reorder a flat table by rows: ``out[r] = rows[perm[r]]``.

    Returns a new tensor.
    """
    return arr.reshape(-1, ROW)[perm].reshape(arr.shape)


# ------------------------------------------------------------------
# Plain versions of the kernels
# ------------------------------------------------------------------


def cached_gather_reference(table: torch.Tensor, rowmap_flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of the gather kernel: ``table[physical_index(rowmap, idx)]``."""
    return table[physical_index(rowmap_flat, idx)]


def cached_scatter_stats_reference(
    hot_rows: torch.Tensor, idx: torch.Tensor, err: torch.Tensor, cold_capacity_rows: int = 16
):
    """Plain version of the scatter kernel on flat ``idx`` and ``err``.

    Returns what the kernel writes: ``(err_sum, abs_sum, hits)`` each
    ``f32[K, 128]``, ``cold_idx int32[M]``, ``cold_err f32[M]`` and the
    per-block cold counts ``int32[n_blocks]``, where ``n_blocks =
    ceil(n / 16384)`` and ``M = n_blocks * cold_capacity_rows * 128``.

    An element is hot when its logical row ``idx >> 7`` is one of
    ``hot_rows`` (which must be distinct), at slot ``s``: with ``err != 0``
    it adds ``err``, ``|err|`` and 1 at ``[s, idx & 127]``; with ``err``
    0 (either sign) it adds nothing. Every other element is cold: block
    ``b``'s cold elements fill its ``cold_capacity_rows * 128`` slots in
    element order, those past the capacity are dropped, and unused slots
    hold ``(0, 0.0)``. ``counts[b]`` counts all of block ``b``'s cold
    elements, dropped ones included.
    """
    dev = idx.device
    k = hot_rows.shape[0]
    cap = cold_capacity_rows * ROW
    sorted_rows, slot_of = torch.sort(hot_rows)
    row = idx >> 7
    at = torch.searchsorted(sorted_rows, row).clamp(max=k - 1)
    member = sorted_rows[at] == row
    live = member & (err != 0.0)
    where = slot_of[at[live]] * ROW + (idx[live] & (ROW - 1))
    vals = err[live]
    stats = torch.zeros((3, k * ROW), dtype=torch.float32, device=dev)
    for out, c in zip(stats, (vals, vals.abs(), torch.ones_like(vals))):
        out.index_add_(0, where, c)

    n = idx.shape[0]
    n_blocks = -(-n // BLOCK)
    cold = torch.zeros(n_blocks * BLOCK, dtype=torch.bool, device=dev)
    cold[:n] = ~member
    cold = cold.reshape(n_blocks, BLOCK)
    rank = torch.cumsum(cold, 1, dtype=torch.int32)
    counts = rank[:, -1].contiguous()
    rank = rank - 1
    keep = cold & (rank < cap)
    dest = (torch.arange(n_blocks, device=dev)[:, None] * cap + rank)[keep]
    src = keep.reshape(-1).nonzero().reshape(-1)
    cold_idx = torch.zeros(n_blocks * cap, dtype=torch.int32, device=dev)
    cold_err = torch.zeros(n_blocks * cap, dtype=torch.float32, device=dev)
    cold_idx[dest] = idx[src]
    cold_err[dest] = err[src]
    err_sum, abs_sum, hits = (s.reshape(k, ROW) for s in stats)
    return err_sum, abs_sum, hits, cold_idx, cold_err, counts


# ------------------------------------------------------------------
# Wrappers
# ------------------------------------------------------------------


def check_padded(what: str, n: int) -> None:
    """Raises when a call of ``n`` elements passes the JAX kernels' bound."""
    # The TPU kernels carry cold positions as float32, exact below 2**24;
    # the bound is kept so that both packages accept the same calls.
    padded = n + (-n % BLOCK)
    if padded >= 2**24:
        raise ValueError(
            f"{what} call of {padded} padded elements exceeds "
            f"the f32-exact position bound 2^24; chunk the call"
        )


def _check_hot(hot_rows: torch.Tensor, prefix_rows: int, device: torch.device) -> None:
    _check("hot_rows", hot_rows, torch.int32, device)
    if tuple(hot_rows.shape) != (prefix_rows,):
        raise ValueError(f"hot_rows must have shape ({prefix_rows},), got {tuple(hot_rows.shape)}")


def _launch_gather(table, rowmap_flat, idx) -> torch.Tensor:
    out = torch.empty(idx.shape, dtype=torch.float32, device=table.device)  # the kernel writes all of it
    n = idx.numel()
    if n == 0:
        return out
    fn = _fn("rein48_cached_gather")
    dev = table.device
    with torch.cuda.device(dev):
        err = fn(table.data_ptr(), rowmap_flat.data_ptr(), idx.data_ptr(), out.data_ptr(), n, _stream(dev))
    launches["cached_gather"] += 1
    _raise_on(err, "cached_gather")
    return out


def cached_gather(
    table: torch.Tensor,
    rowmap_flat: torch.Tensor,
    hot_rows: torch.Tensor,
    idx: torch.Tensor,
    *,
    prefix_rows: int,
    cold_capacity_rows: int = 16,
) -> torch.Tensor:
    """Exact ``table_logical[idx]`` for a hot-prefix permuted table.

    ``table`` is PHYSICAL storage (``f32[S]``, ``S`` a multiple of 128),
    ``rowmap_flat`` its ``int32[S // 128]`` row map, ``hot_rows`` the
    ``int32[prefix_rows]`` logical rows of the prefix, ``idx`` LOGICAL
    int32 indices of any shape. The Hopper kernel reads every element
    through the row map, so it needs neither ``hot_rows`` nor a cold
    capacity: ``cold_capacity_rows`` is kept for the JAX signature, and
    ``hot_rows`` must match ``rowmap_flat`` (``rm[hot[s]] == s``).
    """
    dev = table.device
    if table.ndim != 1 or table.shape[0] % ROW:
        raise ValueError(f"table must be 1-D with a multiple of {ROW} entries, got shape {tuple(table.shape)}")
    _check("table", table, torch.float32, dev)
    _check("rowmap_flat", rowmap_flat, torch.int32, dev)
    if tuple(rowmap_flat.shape) != (table.shape[0] // ROW,):
        raise ValueError(f"rowmap_flat must have shape ({table.shape[0] // ROW},), got {tuple(rowmap_flat.shape)}")
    _check_hot(hot_rows, prefix_rows, dev)
    _check("idx", idx, torch.int32, dev)
    check_padded("cached_gather", idx.numel())
    if dev.type == "cuda":
        return _launch_gather(table, rowmap_flat, idx)
    if dev.type != "cpu":
        raise ValueError(f"no table kernel for device {dev}")
    return cached_gather_reference(table, rowmap_flat, idx)


def _launch_scatter(hot_rows, idx, err, cold_capacity_rows: int):
    dev = idx.device
    k, n = hot_rows.shape[0], idx.shape[0]
    cap = cold_capacity_rows * ROW
    n_blocks = -(-n // BLOCK)
    # The three [K, 128] sums, then one word whose first byte is the
    # overflow flag: zeroed in one launch.
    buf = torch.zeros(3 * k * ROW + 1, dtype=torch.float32, device=dev)
    stats = buf[: 3 * k * ROW].view(3, k, ROW)
    flag_at = 4 * 3 * k * ROW
    overflow = buf.view(torch.uint8)[flag_at : flag_at + 1].view(torch.bool).reshape(())
    # The kernel writes every slot of the residue and every count.
    cold_idx = torch.empty(n_blocks * cap, dtype=torch.int32, device=dev)
    cold_err = torch.empty(n_blocks * cap, dtype=torch.float32, device=dev)
    counts = torch.empty(n_blocks, dtype=torch.int32, device=dev)
    if n == 0:
        return stats[0], stats[1], stats[2], cold_idx, cold_err, counts, overflow
    rows, slot_of = hot_rows, None
    if k > HASH_MAX_ROWS:
        rows, slot_of = torch.sort(hot_rows)
        slot_of = slot_of.to(torch.int32)
    fn = _fn("rein48_cached_scatter")
    base = buf.data_ptr()
    with torch.cuda.device(dev):
        status = fn(
            idx.data_ptr(), err.data_ptr(), n, rows.data_ptr(), 0 if slot_of is None else slot_of.data_ptr(), k,
            base, base + 4 * k * ROW, base + 8 * k * ROW, cold_idx.data_ptr(), cold_err.data_ptr(),
            cap, counts.data_ptr(), base + flag_at, _stream(dev),
        )
    launches["cached_scatter"] += 1
    _raise_on(status, "cached_scatter")
    return stats[0], stats[1], stats[2], cold_idx, cold_err, counts, overflow


def _scatter(hot_rows, idx, err, prefix_rows: int, cold_capacity_rows: int):
    """The scatter's outputs: those of :func:`cached_scatter_blocks`, then the overflow flag."""
    dev = idx.device
    if idx.shape != err.shape:
        raise ValueError(f"idx {tuple(idx.shape)} and err {tuple(err.shape)} differ in shape")
    _check_hot(hot_rows, prefix_rows, dev)
    _check("idx", idx, torch.int32, dev)
    _check("err", err, torch.float32, dev)
    check_padded("cached_scatter_stats", idx.numel())
    idx, err = idx.reshape(-1), err.reshape(-1)
    if dev.type == "cuda":
        return _launch_scatter(hot_rows, idx, err, cold_capacity_rows)
    if dev.type != "cpu":
        raise ValueError(f"no table kernel for device {dev}")
    out = cached_scatter_stats_reference(hot_rows, idx, err, cold_capacity_rows)
    return (*out, (out[5] > cold_capacity_rows * ROW).any())


def cached_scatter_blocks(
    hot_rows: torch.Tensor,
    idx: torch.Tensor,
    err: torch.Tensor,
    *,
    prefix_rows: int,
    cold_capacity_rows: int = 16,
):
    """The scatter kernel's outputs, per-block cold counts included.

    Returns ``(err_sum, abs_sum, hits, cold_idx, cold_err, counts)`` as
    :func:`cached_scatter_stats_reference` describes them.
    """
    return _scatter(hot_rows, idx, err, prefix_rows, cold_capacity_rows)[:6]


def cached_scatter_stats(
    hot_rows: torch.Tensor,
    idx: torch.Tensor,
    err: torch.Tensor,
    *,
    prefix_rows: int,
    cold_capacity_rows: int = 16,
):
    """Windowed TD statistics, split hot/cold for a hot-prefix table.

    Returns ``(err_sum, abs_sum, hits)`` each ``f32[K, 128]`` over the
    PREFIX (physical slot space), plus the compacted cold residue
    ``(cold_idx int32[M], cold_err f32[M])`` in LOGICAL index space and
    ``overflow``, a 0-d bool tensor on the input's device: true when a
    block had more cold elements than its ``cold_capacity_rows * 128``
    slots, so that the residue misses some. ``hits`` counts ``err != 0``
    exactly; the sums are reassociated against a sequential scatter-add
    (on the card by atomics, in an order that changes from run to run).
    """
    err_sum, abs_sum, hits, cold_idx, cold_err, _, overflow = _scatter(
        hot_rows, idx, err, prefix_rows, cold_capacity_rows
    )
    return err_sum, abs_sum, hits, cold_idx, cold_err, overflow

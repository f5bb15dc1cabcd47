# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Gather and scatter for small value tables (port of ``ops/tables.py``).

The JAX package's ``"mxu"`` table backend runs two Pallas kernels that
turn a gather and a scatter-add into one-hot bf16 matrix products, a TPU
workaround for its lack of fast random access. On Hopper the kernels of
``csrc/tables.cu`` compute the same functions with plain loads and
warp-aggregated atomics; see the note at the top of that file.

Each function keeps its JAX name, semantics and shapes. A CUDA tensor
launches the kernel or raises; a CPU tensor runs the plain version
(:func:`gather_reference`, :func:`scatter_reference`); any other device
raises. ``launches`` counts kernel launches per kernel, never those of the
plain versions.

Exactness: the gather is bit-exact. The scatter's float sums are
reassociated, and on the card their order changes from run to run
(atomics); ``hits`` is exact.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

# Largest table the "mxu" backend takes (the JAX package's limit, kept so
# that table_backend="auto" resolves alike in both packages).
MXU_TABLE_MAX = 1 << 16

# Kernel launches per kernel since the counts were last set to 0.
launches = {"table_gather": 0, "table_scatter": 0}

_ARGTYPES = {
    "rein48_table_gather": [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p],
    "rein48_table_scatter": [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    "rein48_empty": [ctypes.c_void_p],
}
_fns: dict = {}


def supports_mxu(table_size: int) -> bool:
    """True if the table is small enough for the ``"mxu"`` backend."""
    return table_size <= MXU_TABLE_MAX and table_size % 128 == 0


def gather_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of the gather kernel: ``table[idx]``."""
    return table[idx]


def scatter_reference(size: int, idx: torch.Tensor, vals: torch.Tensor, stats: bool) -> torch.Tensor:
    """Plain version of the scatter kernel on flat ``idx`` and ``vals``.

    Returns ``f32[1, size]`` (the sum) or ``f32[3, size]`` (sum, sum of
    ``|vals|``, count of nonzero ``vals``), one ``index_add_`` per channel.
    """
    chans = [vals]
    if stats:
        chans += [vals.abs(), (vals != 0.0).to(torch.float32)]
    out = torch.zeros((len(chans), size), dtype=torch.float32, device=vals.device)
    for row, c in zip(out, chans):
        row.index_add_(0, idx, c)
    return out


def _check(what: str, t: torch.Tensor, dtype: torch.dtype, device: torch.device) -> None:
    if t.dtype != dtype or t.device != device:
        raise ValueError(f"{what} must be {dtype} on {device}, got {t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _fn(name: str):
    """The C function ``name`` of ``csrc/tables.cu``, built on first use."""
    fn = _fns.get(name)
    if fn is None:
        from rein48_tpu_torch import build

        fn = getattr(build.load("tables"), name)
        fn.argtypes, fn.restype = _ARGTYPES[name], ctypes.c_int
        _fns[name] = fn
    return fn


def _raise_on(err: int, kernel: str) -> None:
    if err:
        raise RuntimeError(f"{kernel} kernel launch failed with CUDA error {err}")


def _launch_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    out = torch.empty(idx.shape, dtype=torch.float32, device=table.device)  # the kernel writes all of it
    n = idx.numel()
    if n == 0:
        return out
    fn = _fn("rein48_table_gather")
    with torch.cuda.device(table.device):
        err = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(), n, _stream(table.device))
    launches["table_gather"] += 1
    _raise_on(err, "table_gather")
    return out


def _launch_scatter(size: int, idx: torch.Tensor, vals: torch.Tensor, stats: bool) -> torch.Tensor:
    dev = vals.device
    out = torch.zeros((3 if stats else 1, size), dtype=torch.float32, device=dev)
    n = idx.numel()
    if n == 0:
        return out
    fn = _fn("rein48_table_scatter")
    base = out.data_ptr()
    ptrs = [base + 4 * size * k for k in range(3)] if stats else [base, 0, 0]
    with torch.cuda.device(dev):
        err = fn(idx.data_ptr(), vals.data_ptr(), *ptrs, n, int(stats), _stream(dev))
    launches["table_scatter"] += 1
    _raise_on(err, "table_scatter")
    return out


def empty_launch(device: torch.device) -> None:
    """Launch ``csrc/tables.cu``'s empty kernel once on ``device``.

    Its device time is the card's launch floor, the least time any kernel
    takes; ``chip_smoke.py`` measures it beside the table kernels. No path
    runs it, and ``launches`` does not count it.
    """
    with torch.cuda.device(device):
        _raise_on(_fn("rein48_empty")(_stream(device)), "empty")


def mxu_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for float32 ``table[S]``, int32 ``idx`` of any shape.

    Bit-exact. ``idx`` must hold valid indices; the kernel does not check.
    """
    dev = table.device
    if table.ndim != 1:
        raise ValueError(f"table must be 1-D, got shape {tuple(table.shape)}")
    _check("table", table, torch.float32, dev)
    _check("idx", idx, torch.int32, dev)
    if dev.type == "cuda":
        return _launch_gather(table, idx)
    if dev.type != "cpu":
        raise ValueError(f"no table kernel for device {dev}")
    return gather_reference(table, idx)


def _scatter(size: int, idx: torch.Tensor, vals: torch.Tensor, stats: bool) -> torch.Tensor:
    dev = vals.device
    if idx.shape != vals.shape:
        raise ValueError(f"idx {tuple(idx.shape)} and vals {tuple(vals.shape)} differ in shape")
    _check("vals", vals, torch.float32, dev)
    _check("idx", idx, torch.int32, dev)
    idx, vals = idx.reshape(-1), vals.reshape(-1)
    if dev.type == "cuda":
        return _launch_scatter(size, idx, vals, stats)
    if dev.type != "cpu":
        raise ValueError(f"no table kernel for device {dev}")
    return scatter_reference(size, idx, vals, stats)


def mxu_scatter_sum(size: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Dense ``f32[size]`` holding the sum of ``vals`` scattered at ``idx``.

    Equal to a sequential scatter-add up to float32 reassociation.
    """
    return _scatter(size, idx, vals, stats=False)[0]


def mxu_scatter_stats(
    size: int, idx: torch.Tensor, vals: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One pass -> ``(err_sum, abs_sum, hits)``, each ``f32[size]``.

    ``hits`` counts the elements with ``vals != 0`` (masked backups carry
    exact-0 errors and must not count) and is exact; the two sums match a
    sequential scatter-add up to float32 reassociation.
    """
    err_sum, abs_sum, hits = _scatter(size, idx, vals, stats=True)
    return err_sum, abs_sum, hits

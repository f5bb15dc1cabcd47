# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Explicit collectives of the data-parallel learners (port of ``parallel/spmd.py``).

JAX's sharded trainers let XLA insert the ``psum`` of the gradients; this
module places them by hand. Only ``all_reduce`` and ``broadcast`` are used,
the collectives that gloo runs on CUDA tensors as well as on CPU ones, so
the same code runs on gloo (CPU, or ranks that share a card) and on NCCL.
An all-gather is written as an all-reduce of zero-padded slices, as JAX's
``psum`` of a one-hot placement: every element has one nonzero contributor,
so the sum is exact, and it is taken over the bytes, so it is exact for
every dtype (a -0.0 stays -0.0).

Every function takes a process group; ``None`` means an axis of extent 1
and runs no collective.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    return [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in like]), like)]


def _like(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``v`` (contiguous) in ``g``'s dtype and memory layout: a convolution's
    channels-last weight gradient stays channels last, so that what is
    reduced over it afterwards (the global norm) adds in the same order as
    without a group."""
    return v.to(g.dtype) if g.is_contiguous() else torch.empty_like(g).copy_(v)


def psum_grads(grads: Sequence[Optional[torch.Tensor]], params: Sequence[torch.Tensor], group) -> list[torch.Tensor]:
    """Sum a gradient list over ``group``: every gradient in one flat float32
    buffer, one ``all_reduce``; every rank receives the same bits, each
    gradient in its own layout. ``None`` (an unused parameter) counts as
    zero."""
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
    if group is None:
        return grads
    flat = _flat([g.to(torch.float32) for g in grads])
    dist.all_reduce(flat, group=group)
    return [_like(v, g) for v, g in zip(_unflat(flat, grads), grads)]


def psum_mean_grads(grads: Sequence[Optional[torch.Tensor]], group, params: Sequence[torch.Tensor] | None = None):
    """All-reduce-mean a gradient list over the data-parallel group.

    Each rank contributes its local-batch mean gradient; the sum over the
    group divided by its size is the global-batch mean, the single-process
    gradient, when every rank holds the same count (JAX's
    ``psum(g) / psum(1)``). One flat buffer, one ``all_reduce``.
    """
    params = grads if params is None else params
    n = group_size(group)
    summed = psum_grads(grads, params, group)
    return summed if n == 1 else [g / n for g in summed]


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """``[group_size, *x.shape]``: every rank's ``x`` in group-rank order, on
    every rank, bit for bit (one ``all_reduce`` of zero-padded bytes)."""
    if group is None:
        return x[None]
    n, r = dist.get_world_size(group), dist.get_rank(group)
    raw = x.contiguous().reshape(-1).view(torch.uint8) if x.dtype != torch.bool else x.reshape(-1).to(torch.uint8)
    buf = torch.zeros((n, raw.numel()), dtype=torch.uint8, device=x.device)
    buf[r] = raw
    dist.all_reduce(buf, group=group)
    out = buf if x.dtype == torch.uint8 else (buf.bool() if x.dtype == torch.bool else buf.view(x.dtype))
    return out.reshape((n,) + tuple(x.shape))


def global_mean_std(x: torch.Tensor, group):
    """Mean and population std of ``x`` over the union of every rank's ``x``
    (``jnp.mean``, ``jnp.std`` of the global array), in two passes; one
    rank's own, as one process takes them, when it is the only one."""
    if group_size(group) == 1:
        return x.mean(), x.std(correction=0)
    total = torch.stack([x.sum(), torch.tensor(float(x.numel()), device=x.device, dtype=x.dtype)])
    dist.all_reduce(total, group=group)
    mean = total[0] / total[1]
    sq = torch.square(x - mean).sum()
    dist.all_reduce(sq, group=group)
    return mean, torch.sqrt(sq / total[1])


def reduce_metrics(
    metrics: Dict[str, torch.Tensor], group, *, sums: Iterable[str] = (), maxes: Iterable[str] = ()
) -> Dict[str, torch.Tensor]:
    """Every rank's metrics, combined alike on every rank: the keys in
    ``sums`` summed, those in ``maxes`` maxed, the others averaged (means
    over equal shares). One gather of all the scalars, then the same float32
    arithmetic in rank order everywhere, so every rank reports the same bits.
    Entries that are not tensors pass through."""
    keys = [k for k, v in metrics.items() if torch.is_tensor(v)]
    if group is None or not keys:
        return metrics
    sums, maxes = set(sums), set(maxes)
    table = all_gather(torch.stack([metrics[k].to(torch.float32) for k in keys]), group)  # [n, k]
    out = dict(metrics)
    for j, k in enumerate(keys):
        col = table[:, j]
        if k in maxes:
            out[k] = col.max()
        else:
            total = col[0]
            for v in col[1:]:
                total = total + v
            out[k] = total if k in sums else total / col.shape[0]
    return out


def broadcast_from_first(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` of the group's first rank, on every rank, in place."""
    if group is not None:
        dist.broadcast(x, src=dist.get_global_rank(group, 0), group=group)
    return x


def assert_replicated(tensors: Sequence[torch.Tensor], group, what: str = "parameters") -> None:
    """Raise unless ``tensors`` hold the same bits on every rank of ``group``
    (a broadcast from its first rank and a compare)."""
    if group is None:
        return
    mine = _flat([t.detach().reshape(-1).view(torch.uint8) if t.dtype != torch.bool else t.to(torch.uint8) for t in tensors])
    if not torch.equal(broadcast_from_first(mine.clone(), group), mine):
        raise RuntimeError(f"{what} differ between ranks: every rank must build them from the same seed")

# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Process meshes over ``torch.distributed`` (port of ``parallel/mesh.py``).

JAX lays a ``(dp, tp)`` device mesh over the devices of one program and
lets XLA insert the collectives. Here every rank of a process group is one
program on one device, and the mesh says which ranks share what:

* axis ``"dp"``, data parallelism: each dp rank steps a contiguous slice of
  the global env batch (and of the replay buffer's envs); the gradients are
  all-reduced over the dp group before the optimizer step
  (``parallel/spmd.py``);
* axis ``"tp"``, tensor parallelism: :func:`shard_params` keeps each tp
  rank's slice of every dense or convolution weight's output features
  (Megatron-style 1D sharding, the same leaves JAX's :func:`param_specs`
  shards), and the sharded layer's forward gathers the full features over
  the tp group.

The ranks are laid out as ``arange(world).reshape(dp, tp)``, tp innermost,
as JAX reshapes its device list.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from rein48_tpu_torch.models import nets
from rein48_tpu_torch.parallel import spmd

DP_AXIS = "dp"
TP_AXIS = "tp"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Mesh shape; ``dp=None`` means "all remaining ranks"."""

    dp: Optional[int] = None
    tp: int = 1


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ``(dp, tp)`` layout of the process group's ranks, and this rank's place.

    Attributes:
        ranks: ``int[dp, tp]``, the global rank at each mesh position.
        rank: this process's global rank.
        dp_group, tp_group: the process groups of this rank's row over "dp"
            (the ranks that share its tp index) and over "tp"; None where
            the axis has extent 1 (but dp at world 1, so that a one-rank
            mesh still runs its collectives), and on a layout made without
            a process group (:func:`make_mesh` with ``world`` and no group):
            None runs no collective.
        group: the whole group (every rank of the mesh), or None likewise.
    """

    ranks: np.ndarray
    rank: int
    dp_group: Any = None
    tp_group: Any = None
    group: Any = None

    @property
    def dp(self) -> int:
        return self.ranks.shape[0]

    @property
    def tp(self) -> int:
        return self.ranks.shape[1]

    @property
    def shape(self) -> dict:
        return {DP_AXIS: self.dp, TP_AXIS: self.tp}

    @property
    def dp_rank(self) -> int:
        return int(np.argwhere(self.ranks == self.rank)[0, 0])

    @property
    def tp_rank(self) -> int:
        return int(np.argwhere(self.ranks == self.rank)[0, 1])

    @property
    def is_primary(self) -> bool:
        """Rank 0 logs and writes checkpoints."""
        return self.rank == 0

    def __repr__(self) -> str:
        return f"Mesh(dp={self.dp}, tp={self.tp}, rank={self.rank})"


def make_mesh(config: MeshConfig = MeshConfig(), world: Optional[int] = None, rank: Optional[int] = None) -> Mesh:
    """Build a ``(dp, tp)`` mesh over the process group's ranks.

    With a process group, ``world`` defaults to its size and the dp and tp
    sub-groups are made (``dist.new_group``: every rank must call this with
    the same config). Without one, ``world`` must be given and the mesh is a
    layout only, for rank ``rank`` (default 0): shapes, slices and
    :func:`param_specs`, no collectives. Raises JAX's ``ValueError`` when
    ``dp * tp`` is not ``world``.
    """
    joined = dist.is_available() and dist.is_initialized()
    if joined and world is None:
        world = dist.get_world_size()
    if world is None:
        raise ValueError("no process group: call parallel.multihost.initialize() first, or pass world")
    tp = config.tp
    dp = config.dp if config.dp is not None else world // tp
    if dp * tp != world or (joined and world != dist.get_world_size()):
        raise ValueError(f"mesh {dp}x{tp} != {world} devices; pass devices or fix shape")
    ranks = np.arange(world).reshape(dp, tp)
    if not joined:
        return Mesh(ranks=ranks, rank=0 if rank is None else rank)
    me = dist.get_rank()
    world_group = dist.group.WORLD
    # An axis of extent 1 needs no collective (None); one that spans the
    # world is the world's group.
    dp_group = world_group if tp == 1 else None
    tp_group = world_group if dp == 1 and tp > 1 else None
    # new_group is collective: every rank makes every sub-group, in one order.
    if tp > 1 and dp > 1:
        for j in range(tp):
            g = dist.new_group(ranks[:, j].tolist())
            if me in ranks[:, j]:
                dp_group = g
        for i in range(dp):
            g = dist.new_group(ranks[i].tolist())
            if me in ranks[i]:
                tp_group = g
    return Mesh(ranks=ranks, rank=me, dp_group=dp_group, tp_group=tp_group, group=world_group)


def batch_slice(mesh: Mesh, batch: int) -> slice:
    """This rank's contiguous rows of a global batch sharded over "dp".

    Raises JAX's multi-host ``ValueError`` when ``dp`` does not divide it.
    """
    if batch % mesh.dp:
        raise ValueError(f"global batch {batch} % {mesh.dp} hosts != 0")
    n = batch // mesh.dp
    return slice(mesh.dp_rank * n, (mesh.dp_rank + 1) * n)


def data_shard(mesh: Optional[Mesh], batch: int) -> tuple[slice, int, Any]:
    """``(rows, n, group)`` of a learner's global batch of ``batch``: this
    rank's rows, their count, and the dp group its means are reduced over;
    without a mesh the whole batch and no group."""
    if mesh is None:
        return slice(None), batch, None
    rows = batch_slice(mesh, batch)
    return rows, rows.stop - rows.start, mesh.dp_group


def _map_tensors(fn, tree):
    if torch.is_tensor(tree):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: _map_tensors(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    return tree


def shard_batch(tree, mesh: Mesh):
    """This rank's rows of every tensor of ``tree`` (a tensor, a dataclass or
    a dict of them), each with the global batch as axis 0. The rows keep
    their global identity: a sharded ``EnvState`` holds env ids ``lo..hi``
    of the global batch, so each env steps on its own Philox stream."""
    return _map_tensors(lambda x: x[batch_slice(mesh, x.shape[0])].clone(), tree)


def shard_env_state(env_state, mesh: Mesh):
    """Place a batched ``EnvState``: this rank's slice of the global batch.

    Every field of ``EnvState`` (boards, Philox seeds, env ids and counters,
    flags, accumulators) has the env batch as axis 0, so one slice fits all.
    """
    return shard_batch(env_state, mesh)


def gather_batch(tree, mesh: Mesh):
    """The inverse of :func:`shard_batch`: every rank's rows, in rank order
    over "dp", on every rank (a collective over the dp group)."""
    return _map_tensors(lambda x: spmd.all_gather(x, mesh.dp_group).flatten(0, 1), tree)


def _is_sharded(name: str, weight: torch.Tensor, tp: int) -> bool:
    # A Dense weight is [out, in], a Conv's [out, in, kh, kw]: out is axis 0,
    # where a Flax kernel keeps its features last.
    return tp > 1 and name.endswith("weight") and weight.ndim >= 2 and weight.shape[0] % tp == 0


def param_specs(params, mesh: Mesh) -> dict:
    """``{name: spec}`` for a module's parameters (or a ``state_dict``).

    A spec is the tuple of mesh axes per tensor axis, JAX's
    ``PartitionSpec`` as a tuple: ``("tp", None, ...)`` for every weight of
    rank >= 2 whose output-feature axis (axis 0 in torch) divides the "tp"
    extent, ``()`` (replicated) for everything else: biases, norm scales and
    indivisible weights. With tp=1 every entry is replicated. Adam's moments
    mirror the parameters, so they follow the same specs.
    """
    named = params.named_parameters() if isinstance(params, nn.Module) else params.items()
    return {
        name: (TP_AXIS,) + (None,) * (w.ndim - 1) if _is_sharded(name, w, mesh.tp) else ()
        for name, w in named
    }


class _GatherFeatures(torch.autograd.Function):
    """Forward: this tp rank's output features, gathered over the tp group
    along ``dim``. Backward: the rank's slice of the gradient, which every tp
    rank computes alike, since each holds the whole graph downstream."""

    @staticmethod
    def forward(ctx, y, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, y.shape[dim]
        parts = spmd.all_gather(y.contiguous(), group)  # [tp, ...]
        return torch.cat(parts.unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        r = dist.get_rank(ctx.group)
        return grad.narrow(ctx.dim, r * ctx.n, ctx.n), None, None


class _ReduceInputGrad(torch.autograd.Function):
    """Forward: the identity. Backward: the input gradient summed over the tp
    group, since each rank's sliced weight sees only its share of it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _sharded_forward(module: nn.Module, group):
    """The forward of a ``Dense`` or ``Conv`` whose weight holds this rank's
    output features: the layer without its bias on the rank's slice, the
    features gathered over the tp group, then the whole bias."""
    dense = isinstance(module, nets.Dense)

    def forward(x):
        x = _ReduceInputGrad.apply(x, group)
        if dense:
            y = torch.nn.functional.linear(x.to(module.dtype), module.weight.to(module.dtype))
        else:
            y = torch.nn.functional.conv2d(
                x.to(module.dtype).permute(0, 3, 1, 2),
                module.weight.to(module.dtype, memory_format=torch.channels_last),
                padding=module.padding,
            ).permute(0, 2, 3, 1)
        # Both layouts keep features last at the module's edge.
        return _GatherFeatures.apply(y, group, y.ndim - 1) + module.bias.to(module.dtype)

    return forward


def shard_params(model: nn.Module, mesh: Mesh, optimizer=None) -> dict:
    """Keep this tp rank's slice of every weight :func:`param_specs` shards,
    in place, and of its optimizer moments; returns the specs.

    The sliced layers (``nets.Dense`` and ``nets.Conv``) then compute their
    output slice and gather the full features over the tp group. With tp=1
    nothing changes. ``optimizer`` (a ``train.common.Optimizer`` over the
    model's parameters) learns which of its tensors are sharded, so that its
    global-norm clip sums their squares over the tp group once.
    """
    specs = param_specs(model, mesh)
    sharded = {name for name, spec in specs.items() if spec}
    if not sharded:
        return specs
    r, tp = mesh.tp_rank, mesh.tp
    params = dict(model.named_parameters())
    for mod_name, module in model.named_modules():
        name = f"{mod_name}.weight" if mod_name else "weight"
        if name not in sharded:
            continue
        if not isinstance(module, (nets.Dense, nets.Conv)):
            raise TypeError(f"cannot shard {name}: {type(module).__name__} is not a Dense or Conv layer")
        w = module.weight
        n = w.shape[0] // tp
        module.weight = nn.Parameter(w.detach()[r * n : (r + 1) * n].clone())
        module.forward = _sharded_forward(module, mesh.tp_group)
        module.tp_sharded = True
        if optimizer is not None:
            i = next(k for k, p in enumerate(optimizer.params) if p is params[name])
            optimizer.params[i] = module.weight
            for moments in optimizer.moments.values():
                moments[i] = moments[i][r * n : (r + 1) * n].clone()
            optimizer.sharded.add(i)
    if optimizer is not None:
        optimizer.tp_group = mesh.tp_group
    return specs


def place_learner(mesh: Mesh, optimizer, *models: nn.Module) -> None:
    """Put a learner (``models``, whose parameters ``optimizer`` holds) on
    the mesh: check that every rank built the same parameters (drawn on the
    CPU from the seed, so they must be equal), keep this tp rank's slices
    (:func:`shard_params`), and have ``optimizer`` reduce its gradients over
    the dp group."""
    spmd.assert_replicated(optimizer.params, mesh.group)
    for model in models:
        shard_params(model, mesh, optimizer)
    optimizer.dp_group = mesh.dp_group


def full_state_dict(model: nn.Module, mesh: Mesh) -> dict:
    """The model's ``state_dict`` with every tp-sharded weight gathered whole
    over the tp group (a collective); the tensors as they are at tp=1."""
    sharded = {f"{n}.weight" for n, m in model.named_modules() if getattr(m, "tp_sharded", False)}
    return {
        name: spmd.all_gather(t.contiguous(), mesh.tp_group).flatten(0, 1) if name in sharded else t
        for name, t in model.state_dict().items()
    }

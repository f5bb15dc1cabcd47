# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Joining the process group, and sharded-run helpers (port of
``parallel/multihost.py``).

JAX runs one controller per host over all its chips; here every rank is one
process on one device, launched by ``torchrun`` (or spawned), and joins one
``torch.distributed`` group:

* :func:`initialize` joins it from explicit arguments or from torchrun's
  ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_ADDR``/``MASTER_PORT``;
* the backend is NCCL where every rank has a card of its own, gloo where
  the ranks outnumber the cards (ranks that share a card) or on the CPU;
* ONE global mesh over every rank (:func:`global_mesh`); each rank steps
  its slice of the env batch alone, and the gradient all-reduce is the only
  recurring collective;
* rank 0 owns logging and checkpointing.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from rein48_tpu_torch.parallel import mesh as mesh_lib

# The arguments of the join this process made, to tell a repeated call
# (a no-op) from a conflicting one.
_joined: Optional[tuple] = None


@dataclasses.dataclass(frozen=True)
class HostTopology:
    """``process_index`` is the rank, ``process_count`` the world size,
    ``local_device_count`` the cards this rank sees (1 for a CPU rank), and
    ``global_device_count`` the mesh's devices, one per rank."""

    process_index: int
    process_count: int
    local_device_count: int
    global_device_count: int

    @property
    def is_primary(self) -> bool:
        return self.process_index == 0


def choose_backend(device: str | torch.device | None, ranks_per_host: int) -> str:
    """``"nccl"`` when every rank of a host has a card of its own, ``"gloo"``
    when they outnumber the cards or run on the CPU."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    if not torch.cuda.is_available() or torch.cuda.device_count() < ranks_per_host:
        return "gloo"
    return "nccl"


def rank_device(device: str | torch.device | None = None) -> torch.device:
    """The device of this rank: the CPU when named, else its own card
    (``LOCAL_RANK`` modulo the cards, so ranks beyond the cards share them)."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    local = int(os.environ.get("LOCAL_RANK", 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def _topology() -> HostTopology:
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return HostTopology(process_index=rank, process_count=world, local_device_count=local, global_device_count=world)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device: str | torch.device | None = None,
) -> HostTopology:
    """Join (or skip joining) the process group; return the topology.

    ``coordinator_address`` is an ``init_method`` (``tcp://host:port`` or
    ``file:///path``); without one, torchrun's environment variables are
    read (``env://``). One process (``num_processes=1``) needs no address.
    With neither, this is a no-op: call it unconditionally at program start.
    ``backend`` defaults to :func:`choose_backend` for ``device``. A second
    call with the same arguments returns the topology; one with other
    arguments raises, since the group cannot be joined twice.
    """
    global _joined
    if coordinator_address is None and num_processes is None and "MASTER_ADDR" in os.environ:
        coordinator_address = "env://"
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    if coordinator_address is None and num_processes is None:
        return _topology()
    if num_processes is None or process_id is None:
        raise ValueError("initialize needs num_processes and process_id with a coordinator address")
    ranks_per_host = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    backend = backend or choose_backend(device, ranks_per_host)
    args = (coordinator_address, num_processes, process_id, backend)
    if dist.is_initialized():
        if _joined != args:
            raise RuntimeError(
                f"the process group was already joined with {_joined}; "
                f"initialize() cannot join it again with {args}"
            )
        return _topology()
    if backend == "nccl":
        torch.cuda.set_device(rank_device(device))
    if coordinator_address is None:
        # One process: an in-memory store, no address to agree on.
        dist.init_process_group(backend, store=dist.HashStore(), rank=process_id, world_size=num_processes)
    else:
        dist.init_process_group(backend, init_method=coordinator_address, rank=process_id, world_size=num_processes)
    _joined = args
    return _topology()


def shutdown() -> None:
    """Leave the process group (a no-op when none was joined)."""
    global _joined
    if dist.is_initialized():
        dist.destroy_process_group()
    _joined = None


def global_mesh(tp: int = 1) -> mesh_lib.Mesh:
    """The group-wide ``(dp, tp)`` mesh over every rank, ranks in order."""
    return mesh_lib.make_mesh(mesh_lib.MeshConfig(dp=None, tp=tp))


def host_local_batch(global_batch: int) -> int:
    """Per-rank share of a global env batch (must divide evenly)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} % {n} hosts != 0")
    return global_batch // n

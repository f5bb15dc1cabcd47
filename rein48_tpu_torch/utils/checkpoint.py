# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Checkpoints of a whole trainer state (counterpart of ``utils/checkpoint.py``).

The JAX package writes orbax checkpoints; this module has its own format
and reads no orbax checkpoint (JAX parameters come across through
``models/convert.py``). A checkpoint is ``<directory>/<step>/state.pt``, one
``torch.save`` of the state's fields: a module as its ``state_dict``, an
optimizer as its ``state_dict``, a dataclass (an ``EnvState``, a replay
buffer) field by field, a dict of tensors as tensors, and plain values (the
learner's seed, the update step, an absent second net) as they are. Tensors
are stored on the CPU and restored onto the devices of the state they are
restored into, so a run saved on one device resumes on another. The env's Philox counters come back bit for
bit, and the learner's draws are named by the seed and the update step
(``engine/philox.py``), so a resumed run continues as the uninterrupted one
would, on any device.

On a mesh (``parallel/``) the state is saved whole: every rank calls
:meth:`Checkpointer.maybe_save` with a ``gather`` that puts the global state
together (the env batch and a replay buffer in global order over "dp"; the
tp-sharded weights and their optimizer moments gathered whole over "tp",
``train.common.gather_learners``), and rank 0 writes it. A checkpoint of
any mesh therefore holds what one of the same trainer in one process
holds, key for key, shape for shape, dtype for dtype. Every rank restores
the global state and takes its own slice, so a checkpoint of any mesh
resumes on any other, or in one process.

A save is written under a temporary name and renamed into place, so a
crash mid-save never leaves a directory that looks like a step; opening
the directory sweeps such leftovers, as orbax's
``cleanup_tmp_directories=True`` does.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from rein48_tpu_torch.train.common import Optimizer

_STATE_FILE = "state.pt"
_TMP_SUFFIX = ".tmp"


def _pack(value: Any) -> Any:
    if isinstance(value, nn.Module):
        return {k: v.detach().cpu() for k, v in value.state_dict().items()}
    if isinstance(value, Optimizer):
        return value.state_dict()
    if dataclasses.is_dataclass(value):
        return {f.name: _pack(getattr(value, f.name)) for f in dataclasses.fields(value)}
    if isinstance(value, dict):
        return {k: _pack(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_pack(v) for v in value]
    if torch.is_tensor(value):
        return value.detach().cpu()
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    raise TypeError(f"cannot checkpoint a {type(value).__name__}")


def pack_state(state: Any) -> Dict[str, Any]:
    """What :meth:`Checkpointer.save` writes for ``state`` (a dataclass):
    each field packed, every tensor on the CPU."""
    return {f.name: _pack(getattr(state, f.name)) for f in dataclasses.fields(state)}


def is_primary() -> bool:
    """Whether this process writes: the only one, or rank 0 of its group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _unpack(like: Any, saved: Any) -> Any:
    if isinstance(like, nn.Module):
        like.load_state_dict(saved)
        return like
    if isinstance(like, Optimizer):
        like.load_state_dict(saved)
        return like
    if dataclasses.is_dataclass(like):
        return dataclasses.replace(like, **{f.name: _unpack(getattr(like, f.name), saved[f.name]) for f in dataclasses.fields(like)})
    if isinstance(like, dict):
        if set(like) != set(saved):
            raise ValueError(f"checkpoint holds keys {sorted(saved)}, the state {sorted(like)}")
        return {k: _unpack(like[k], saved[k]) for k in like}
    if torch.is_tensor(like):
        if saved.shape != like.shape or saved.dtype != like.dtype:
            raise ValueError(f"checkpoint holds {saved.dtype}{list(saved.shape)}, the state {like.dtype}{list(like.shape)}")
        return saved.to(like.device)
    return saved


class Checkpointer:
    """Interval-based saving of a trainer state (a dataclass).

    Args:
        directory: checkpoint root (created if missing).
        save_every: ``maybe_save(step, ...)`` saves when ``step`` is a multiple.
        max_to_keep: checkpoints kept; older ones are deleted after a save.
    """

    def __init__(self, directory: str, save_every: int = 100, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.save_every = save_every
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        for name in os.listdir(self.directory) if is_primary() else ():
            if name.endswith(_TMP_SUFFIX):
                shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step), _STATE_FILE)

    def all_steps(self) -> list[int]:
        """Saved steps, oldest first."""
        return sorted(int(n) for n in os.listdir(self.directory) if n.isdigit() and os.path.isfile(self._path(int(n))))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> None:
        """Write ``state`` as step ``step`` (replacing one saved before)."""
        payload = pack_state(state)
        tmp = tempfile.mkdtemp(prefix=f"{step}.", suffix=_TMP_SUFFIX, dir=self.directory)
        try:
            torch.save(payload, os.path.join(tmp, _STATE_FILE))
            final = os.path.join(self.directory, str(step))
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for old in self.all_steps()[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def maybe_save(self, step: int, state: Any, gather=None) -> bool:
        """Save when ``save_every`` divides ``step``. On a mesh every rank
        calls this with ``gather`` (rank state -> global state, a
        collective), and only rank 0 writes."""
        if step % self.save_every:
            return False
        if gather is not None:
            state = gather(state)
        if is_primary():
            self.save(step, state)
        return True

    def _load(self, step: Optional[int]) -> Dict[str, Any]:
        step = step if step is not None else self.latest_step()
        if step is None or not os.path.isfile(self._path(step)):
            raise FileNotFoundError(f"no checkpoint{'' if step is None else f' of step {step}'} under {self.directory}")
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    def restore(self, state_like: Any, step: Optional[int] = None) -> Any:
        """Restore into the structure and devices of ``state_like``.

        ``state_like`` is a state built by the trainer's ``init_*``: its
        modules and optimizer are loaded in place and returned in a new
        state with the saved fields.
        """
        saved = self._load(step)
        fields = {f.name for f in dataclasses.fields(state_like)}
        if set(saved) != fields:
            raise ValueError(f"checkpoint holds fields {sorted(saved)}, the state {sorted(fields)}")
        return dataclasses.replace(state_like, **{k: _unpack(getattr(state_like, k), saved[k]) for k in fields})

    def restore_field(self, field: str, step: Optional[int] = None) -> Any:
        """One field of the saved state as stored (a module as its
        ``state_dict``, tensors on the CPU); needs no template state."""
        return self._load(step)[field]

    @property
    def _config_path(self) -> str:
        return os.path.join(self.directory, "train_config.json")

    def save_config(self, config: Any) -> None:
        """Persist the trainer config as JSON beside the checkpoints, in the
        JAX package's format: the dataclass as a dict, enums by name, any
        other value that JSON lacks as its ``str``. Evaluation reads back
        the settings that trained the checkpoint (gamma, reward transform,
        model, ...). On a mesh only rank 0 writes."""
        if not is_primary():
            return
        if dataclasses.is_dataclass(config):
            config = dataclasses.asdict(config)

        def jsonable(v):
            if isinstance(v, enum.Enum):
                return v.name
            return str(v)

        with open(self._config_path, "w") as f:
            json.dump(config, f, indent=2, sort_keys=True, default=jsonable)

    def load_config(self) -> Optional[Dict[str, Any]]:
        """The persisted trainer config, or None when there is none."""
        try:
            with open(self._config_path) as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    def close(self) -> None:
        """Nothing runs in the background; kept for the JAX interface."""

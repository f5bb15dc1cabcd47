# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Training-loop plumbing: observation/reward transforms, optimizers
(port of ``train/common.py``).

The optimizers are written out to optax's formulas rather than taken from
``torch.optim``, where the two differ: the global-norm clip leaves a
gradient untouched below ``max_norm`` and otherwise scales it by
``max_norm / norm`` (``torch.nn.utils.clip_grad_norm_`` always scales by
``max_norm / (norm + 1e-6)``), and RMSprop adds eps inside the square root
(``torch.optim.RMSprop`` adds it outside). Every step runs on the device
of the parameters and reads nothing back to the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from rein48_tpu_torch.engine import philox
from rein48_tpu_torch.models import obs as obs_lib
from rein48_tpu_torch.parallel import mesh as mesh_lib
from rein48_tpu_torch.parallel import spmd
from rein48_tpu_torch.utils import profiling

OBS_ENCODERS = {
    "onehot": obs_lib.encode_onehot,
    "raw": obs_lib.encode_raw,
    "log2": obs_lib.encode_log2_scalar,
}

OPTIMIZERS = ("adam", "adamw", "sgd", "rmsprop")
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
ADAMW_WEIGHT_DECAY = 1e-4
# The reference A3C's tf.train.RMSPropOptimizer defaults.
RMSPROP_DECAY, RMSPROP_EPS = 0.9, 1e-10
# The episode metrics that add up over the ranks of a mesh (the best tile
# is their max, the losses their mean).
EPISODE_SUMS = ("episodes", "episode_tile_sum_sum", "episode_length_sum")


def encode_obs(boards: torch.Tensor, encoding: str) -> torch.Tensor:
    """Encode exponent boards for the model; non-onehot encodings get a
    trailing channel axis, as conv models need one."""
    x = OBS_ENCODERS[encoding](boards)
    if encoding != "onehot":
        x = x[..., None]
    return x


def obs_channels(encoding: str) -> int:
    """Channels of ``encode_obs(boards, encoding)``: a model's input width."""
    return obs_lib.NUM_PLANES if encoding == "onehot" else 1


def transform_reward(reward: torch.Tensor, transform: str) -> torch.Tensor:
    """Reward shaping: ``identity``, ``log2`` (log2(1 + r)) or ``scaled`` (r / 256)."""
    if transform == "identity":
        return reward
    if transform == "log2":
        return torch.log2(1.0 + reward)
    if transform == "scaled":
        return reward / 256.0
    raise ValueError(f"unknown reward transform '{transform}'")


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule``: ``count -> lr``, the full ``init_value``
    at count 0, held at ``alpha * init_value`` from ``decay_steps`` on."""
    if not decay_steps > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got decay_steps={decay_steps}.")

    def schedule(count: int) -> float:
        decay = 0.5 * (1.0 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
        return init_value * ((1.0 - alpha) * decay + alpha)

    return schedule


def shuffles(
    seed: int, update_step: int, num_epochs: int, unroll_len: int, batch_size: int, shard_friendly: bool, device
) -> torch.Tensor:
    """Every epoch's shuffle of one update, from one draw of the learner's
    ``SHUFFLE`` stream (``engine/philox.py``).

    With ``shard_friendly`` each epoch permutes the time axis within each
    env: int64 ``[num_epochs, T, B]``, the stable argsort of the words over
    time. Without, one permutation of all ``T * B`` samples per epoch:
    ``[num_epochs, T * B]``. Stable sorts, so equal words order the same on
    every device.
    """
    words = philox.learner_words(seed, update_step, philox.SHUFFLE, (num_epochs, unroll_len, batch_size), device=device)
    if shard_friendly:
        return words.argsort(dim=1, stable=True)
    return words.reshape(num_epochs, -1).argsort(dim=-1, stable=True)


def tree_norm(tensors: Sequence[torch.Tensor | None]) -> torch.Tensor:
    """Global L2 norm over tensors (``None`` counts as zeros), as ``optax.global_norm``."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors if t is not None))


def _bias_correction(decay: float, count: int) -> float:
    # optax computes 1 - decay**count in float32.
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


class Optimizer:
    """``optax.chain(clip_by_global_norm(max_grad_norm), <name>)`` over a
    fixed list of parameters, updating them in place.

    ``count`` (the updates taken, a host int) indexes the learning-rate
    schedule before its increment, as optax's ``scale_by_schedule`` does.
    The moments ``mu``/``nu`` are float32 tensors beside the parameters,
    zero at the start. :meth:`state_dict` and :meth:`load_state_dict` carry
    the whole state (a checkpoint or another device).

    On a mesh (``parallel/``) the learner passes its gradients through
    :meth:`reduce` before the step, so the clip sees the global batch's
    gradient as optax does; ``dp_group`` is the group they are reduced over,
    ``sharded`` the indices of the parameters that hold a tp rank's slice
    (``parallel.mesh.shard_params``) and ``tp_group`` the group over which
    the global norm sums their squares.
    """

    def __init__(self, name: str, learning_rate, params: Sequence[torch.Tensor], *, max_grad_norm: float | None):
        if name not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer '{name}'")
        self.name, self.learning_rate, self.max_grad_norm = name, learning_rate, max_grad_norm
        self.params = list(params)
        self.count = 0
        moments = {"adam": ("mu", "nu"), "adamw": ("mu", "nu"), "rmsprop": ("nu",), "sgd": ()}[name]
        self.moments = {m: [torch.zeros_like(p, memory_format=torch.preserve_format) for p in self.params] for m in moments}
        self.dp_group = self.tp_group = None
        self.sharded: set[int] = set()

    def lr(self) -> float:
        """The learning rate of the next step."""
        return self.learning_rate(self.count) if callable(self.learning_rate) else self.learning_rate

    @torch.no_grad()
    def reduce(self, grads: Sequence[torch.Tensor | None], *, average: bool = True) -> list:
        """The gradients of the global batch: summed over ``dp_group`` in one
        flat buffer and, with ``average``, divided by its size (local means
        of equal shares). Without a group they are returned as they are."""
        if self.dp_group is None:
            return list(grads)
        if average:
            return spmd.psum_mean_grads(grads, self.dp_group, self.params)
        return spmd.psum_grads(grads, self.params, self.dp_group)

    def global_norm(self, grads: Sequence[torch.Tensor | None]) -> torch.Tensor:
        """``tree_norm`` of the whole parameter set's gradient: with tp the
        squares of the sharded tensors summed over the tp group, once, and
        the replicated tensors counted once."""
        if not self.sharded or self.tp_group is None:
            return tree_norm(grads)
        zero = torch.zeros((), device=self.params[0].device)
        sharded = sum((torch.sum(g * g) for i, g in enumerate(grads) if g is not None and i in self.sharded), zero)
        replicated = sum((torch.sum(g * g) for i, g in enumerate(grads) if g is not None and i not in self.sharded), zero)
        dist.all_reduce(sharded, group=self.tp_group)
        return torch.sqrt(sharded + replicated)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor | None]) -> None:
        """One update from ``grads`` (aligned with ``params``; ``None`` is
        zero), already passed through :meth:`reduce` on a mesh; one
        ``optim.step`` span."""
        with profiling.span("optim.step"):
            if len(grads) != len(self.params):
                raise ValueError(f"{len(grads)} gradients for {len(self.params)} parameters")
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
            if self.max_grad_norm is not None:
                norm = self.global_norm(grads)
                keep = norm < self.max_grad_norm
                grads = [torch.where(keep, g, (g / norm) * self.max_grad_norm) for g in grads]
            neg_lr = -self.lr()
            count = self.count + 1
            if self.name in ("adam", "adamw"):
                bc1, bc2 = _bias_correction(ADAM_B1, count), _bias_correction(ADAM_B2, count)
            for i, (p, g) in enumerate(zip(self.params, grads)):
                if self.name in ("adam", "adamw"):
                    mu, nu = self.moments["mu"][i], self.moments["nu"][i]
                    mu.copy_((1 - ADAM_B1) * g + ADAM_B1 * mu)
                    nu.copy_((1 - ADAM_B2) * (g * g) + ADAM_B2 * nu)
                    u = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
                    if self.name == "adamw":
                        u = u + ADAMW_WEIGHT_DECAY * p
                elif self.name == "rmsprop":
                    nu = self.moments["nu"][i]
                    nu.copy_((1 - RMSPROP_DECAY) * (g * g) + RMSPROP_DECAY * nu)
                    u = torch.rsqrt(nu + RMSPROP_EPS) * g
                else:
                    u = g
                p.add_(u * neg_lr)
            self.count = count

    def state_dict(self) -> dict:
        return {"name": self.name, "count": self.count, **{m: [t.detach().cpu() for t in ts] for m, ts in self.moments.items()}}

    def load_state_dict(self, state: dict) -> None:
        if state["name"] != self.name or set(state) - {"name", "count"} != set(self.moments):
            raise ValueError(f"optimizer state of '{state['name']}' cannot load into '{self.name}'")
        for m, ts in self.moments.items():
            if len(state[m]) != len(ts) or any(a.shape != b.shape for a, b in zip(state[m], ts)):
                raise ValueError(f"optimizer state '{m}' does not match the parameters")
            for dst, src in zip(ts, state[m]):
                dst.copy_(src)
        self.count = int(state["count"])


def make_optimizer(
    name: str, learning_rate: float | Callable[[int], float], params: Sequence[torch.Tensor], *, max_grad_norm: float | None = 1.0
) -> Optimizer:
    """Optimizer factory with the JAX package's choices.

    ``rmsprop``: decay 0.9, eps 1e-10 inside the root (the reference A3C's
    RMSProp); ``adam``: b1 0.9, b2 0.999, eps 1e-8 outside the root, bias
    corrected; ``adamw``: adam plus weight decay 1e-4 on every parameter;
    ``sgd``: plain. Each behind the global-norm clip unless
    ``max_grad_norm`` is None. ``learning_rate`` is a float or a schedule
    ``count -> lr``.
    """
    return Optimizer(name, learning_rate, params, max_grad_norm=max_grad_norm)


def place_on_mesh(mesh, state, optimizer: Optimizer | None, *models, batched=("env",)):
    """A trainer's state on a mesh (``parallel/``): this rank's rows of the
    ``batched`` fields (each with the global batch as axis 0), and the
    learner placed (``parallel.mesh.place_learner``; a learner without an
    optimizer has nothing to place). Without a mesh the state as it is.
    ``state`` is whole (built, or restored from any checkpoint), so a run
    resumes on any mesh."""
    if mesh is None:
        return state
    if mesh.group is None and mesh.dp * mesh.tp > 1:
        raise ValueError(f"a mesh of {mesh.dp * mesh.tp} ranks needs their process group: make it after multihost.initialize()")
    state = dataclasses.replace(state, **{k: mesh_lib.shard_batch(getattr(state, k), mesh) for k in batched})
    if optimizer is not None:
        mesh_lib.place_learner(mesh, optimizer, *models)
    return state


def gather_learners(state, mesh):
    """``state`` with its learners whole (a collective over the tp group):
    every module as its ``state_dict`` with the tp-sharded weights gathered
    (``parallel.mesh.full_state_dict``), every :class:`Optimizer` as its
    ``state_dict`` with the moments of the sharded parameters gathered
    (``parallel.mesh.full_optimizer_state``). The result packs as the state
    of a run at tp=1 does. At tp=1 the state as it is."""
    if mesh.tp == 1:
        return state

    def whole(value):
        if isinstance(value, torch.nn.Module):
            return mesh_lib.full_state_dict(value, mesh)
        if isinstance(value, Optimizer):
            return mesh_lib.full_optimizer_state(value, mesh)
        return value

    return dataclasses.replace(state, **{f.name: whole(getattr(state, f.name)) for f in dataclasses.fields(state)})


def log_and_save(record: dict, logger, checkpointer, step: int, state, mesh=None, batched=("env",), gather=None) -> None:
    """Log a record and save at the points ``save_every`` divides. On a mesh
    rank 0 logs; every rank takes part in a save, which gathers the global
    state (the ``batched`` fields over "dp", or ``gather``, then the
    learners over "tp": :func:`gather_learners`), and rank 0 writes it."""
    if logger is not None and (mesh is None or mesh.is_primary):
        logger.write(record)
    if checkpointer is None:
        return
    if mesh is None:
        checkpointer.maybe_save(step, state)
        return
    if gather is None:
        def gather(s):
            return dataclasses.replace(s, **{k: mesh_lib.gather_batch(getattr(s, k), mesh) for k in batched})
    checkpointer.maybe_save(step, state, gather=lambda s: gather_learners(gather(s), mesh))

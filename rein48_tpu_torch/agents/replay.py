# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Circular replay buffer on the device (port of ``agents/replay.py``).

The data is preallocated as ``[capacity, ...]`` tensors, one per transition
field, on the device of the example transition; an add writes a batch at
the cursor, wrapping, and a sample is one gather at given indices. Nothing
leaves the device. ``cursor`` and ``size`` depend only on how many
transitions were added, so they are host ints: a learner's gate on the
buffer's size costs no sync.

Sampling takes its indices as a tensor; the trainers draw them from the
learner's ``REPLAY`` stream (``engine/philox.py``) with
:func:`sample_indices`, where JAX draws ``jax.random.randint``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from rein48_tpu_torch.engine import philox


@dataclasses.dataclass
class ReplayState:
    """Replay buffer state.

    Attributes:
        data: transition field -> ``[capacity, ...]`` tensor.
        cursor: next write slot (wraps modulo the capacity).
        size: valid slots (saturates at the capacity).
    """

    data: Dict[str, torch.Tensor]
    cursor: int
    size: int

    @property
    def capacity(self) -> int:
        return next(iter(self.data.values())).shape[0]


def replay_init(example: Dict[str, torch.Tensor], capacity: int) -> ReplayState:
    """Allocate a buffer shaped like ``example`` (one unbatched transition),
    zeroed, on the example's devices."""
    data = {k: torch.zeros((capacity,) + tuple(x.shape), dtype=x.dtype, device=x.device) for k, x in example.items()}
    return ReplayState(data=data, cursor=0, size=0)


def replay_add(state: ReplayState, batch: Dict[str, torch.Tensor]) -> ReplayState:
    """Write a batch of ``n`` transitions at the cursor, wrapping at the
    capacity; the buffer's tensors are written in place. A batch larger
    than the buffer raises ``ValueError``."""
    n = next(iter(batch.values())).shape[0]
    cap = state.capacity
    if n > cap:
        raise ValueError(f"a batch of {n} transitions does not fit a buffer of {cap}")
    head = min(n, cap - state.cursor)
    for k, buf in state.data.items():
        x = batch[k]
        buf[state.cursor : state.cursor + head] = x[:head]
        buf[: n - head] = x[head:]
    return ReplayState(data=state.data, cursor=(state.cursor + n) % cap, size=min(state.size + n, cap))


def sample_indices(seed: int, update_step: int, batch_size: int, n: int, device=None) -> torch.Tensor:
    """``batch_size`` uniform integers in ``[0, n)`` from the learner's
    ``REPLAY`` stream of ``(seed, update_step)``: int64 ``[batch_size]``."""
    words = philox.learner_words(seed, update_step, philox.REPLAY, (batch_size,), device=device)
    return philox.below_from_words(words, n)


def replay_sample(state: ReplayState, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The transitions at slots ``idx``: uniform with replacement over the
    valid prefix when ``idx`` is drawn in ``[0, max(size, 1))``."""
    return {k: buf[idx] for k, buf in state.data.items()}


def nstep_valid(state: ReplayState, n_step: int, stride: int) -> int:
    """How many chains of ``n_step`` transitions ``stride`` slots apart lie
    wholly in the valid window: ``max(size - (n_step - 1) * stride, 1)``."""
    return max(state.size - (n_step - 1) * stride, 1)


def replay_sample_nstep(
    state: ReplayState, j: torch.Tensor, *, n_step: int, stride: int, gamma: float
) -> Dict[str, torch.Tensor]:
    """n-step transitions: chains starting at age index ``j``.

    The buffer is written in batches of ``stride`` lockstep envs, so the
    transition that follows slot ``i`` for the same env is slot ``i +
    stride``. ``j`` (int64 ``[B]``, drawn in ``[0, nstep_valid(...))``)
    counts from the oldest valid slot: the chain is ``base + k * stride``
    for ``k < n_step``, ``base = (cursor - size + j) mod capacity``.
    Returns a 1-step-shaped batch: ``reward`` the sum of ``gamma**k r_k``
    cut at the first episode end by the products of ``(1 - done)``,
    ``done`` whether any of the steps ended the episode, ``next_board`` the
    chain's last next board, and every other field the first transition's.
    The loss then discounts by ``gamma**n_step``.

    Raises ``ValueError`` for ``n_step < 1`` or ``n_step * stride`` past the
    capacity, as JAX does.
    """
    if n_step < 1:
        raise ValueError(f"n_step must be >= 1, got {n_step}")
    cap = state.capacity
    if n_step * stride > cap:
        raise ValueError(f"n_step*stride={n_step * stride} exceeds capacity {cap}")
    return nstep_from_slots(state.data, nstep_slots(state.cursor, state.size, cap, j, n_step, stride), gamma)


def nstep_slots(cursor: int, size: int, capacity: int, j: torch.Tensor, n_step: int, stride: int) -> torch.Tensor:
    """The slots ``[B, n_step]`` of the chains that start at age index ``j``
    (:func:`replay_sample_nstep`)."""
    base = (cursor - size + j) % capacity
    offs = torch.arange(n_step, dtype=torch.int64, device=j.device) * stride
    return (base[:, None] + offs[None, :]) % capacity


def nstep_from_slots(data: Dict[str, torch.Tensor], slots: torch.Tensor, gamma: float) -> Dict[str, torch.Tensor]:
    """The chains at ``slots`` (``[B, n_step]``, rows of ``data``) in 1-step
    form (:func:`replay_sample_nstep`)."""
    n_step = slots.shape[1]
    rewards = data["reward"][slots]
    dones = data["done"][slots].to(rewards.dtype)
    # cont[k] = prod_{l <= k} (1 - done_l); the reward of step k counts while cont[k - 1] is 1.
    cont = torch.cumprod(1.0 - dones, dim=1)
    cont_before = torch.cat([torch.ones_like(cont[:, :1]), cont[:, :-1]], dim=1)
    discounts = gamma ** torch.arange(n_step, dtype=rewards.dtype, device=slots.device)
    reward_n = torch.sum(rewards * cont_before * discounts, dim=1)
    first = {k: buf[slots[:, 0]] for k, buf in data.items()}
    return {**first, "reward": reward_n, "done": cont[:, -1] < 0.5, "next_board": data["next_board"][slots[:, -1]]}


def replay_filled(state: ReplayState) -> bool:
    """True once the buffer has wrapped (the reference's ``filled()``)."""
    return state.size >= state.capacity

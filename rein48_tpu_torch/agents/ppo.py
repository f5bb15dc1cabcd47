# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Generalized advantage estimation and afterstate targets (port of part
of ``agents/ppo.py``).

Both are shape-polymorphic over the trailing axes (``[T, B]`` or
``[T]``). The PPO loss waits for the PPO trainer.
"""

from __future__ import annotations

from typing import Tuple

import torch


def gae(
    rewards: torch.Tensor,
    values: torch.Tensor,
    bootstrap: torch.Tensor,
    gamma: float,
    lam: float,
    *,
    dones: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GAE(lambda) over the leading time axis.

    ``delta[t] = r[t] + gamma * cont[t] * V[t+1] - V[t]`` and
    ``adv[t] = delta[t] + gamma * lam * cont[t] * adv[t+1]``, with
    ``V[T] = bootstrap`` and ``cont = 1 - dones`` cutting both recursions
    at episode ends. Returns ``(advantages, returns)``, with
    ``returns = advantages + values`` (the critic's targets).
    """
    cont = torch.ones_like(rewards) if dones is None else 1.0 - dones.to(rewards.dtype)
    next_values = torch.cat([values[1:], bootstrap[None]], dim=0)
    deltas = rewards + gamma * cont * next_values - values
    adv = torch.zeros_like(bootstrap)
    out = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        adv = deltas[t] + gamma * lam * cont[t] * adv
        out.append(adv)
    advantages = torch.stack(out[::-1])
    return advantages, advantages + values


def afterstate_targets(returns: torch.Tensor, bootstrap: torch.Tensor, dones: torch.Tensor) -> torch.Tensor:
    """Targets for an afterstate critic: the next step's return.

    ``V_after(as_t) = E_spawn[V(s_{t+1})]``, so the sample target of the
    afterstate of step ``t`` is ``returns[t+1]`` (``bootstrap`` past the
    horizon), and 0 where the episode ended at ``t``.
    """
    cont = 1.0 - dones.to(returns.dtype)
    return cont * torch.cat([returns[1:], bootstrap[None]], dim=0)

# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""PPO losses, generalized advantage estimation and afterstate targets
(port of ``agents/ppo.py``).

All are shape-polymorphic over the trailing axes (``[T, B]`` or ``[T]``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class PPOLossConfig(NamedTuple):
    """Clipped-surrogate hyperparameters (PPO defaults).

    clip_eps: the ratio's clip radius (ratio in 1 +- eps). entropy_beta:
    entropy bonus weight. value_coef: critic loss weight. clip_value: clip
    the value prediction around its rollout-time estimate (PPO2) before the
    squared error, by the absolute radius ``value_clip_eps``.
    """

    clip_eps: float = 0.2
    entropy_beta: float = 0.01
    value_coef: float = 0.5
    clip_value: bool = False
    value_clip_eps: float = 10.0


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


def ppo_loss(
    logits: torch.Tensor,
    values: torch.Tensor,
    actions: torch.Tensor,
    behavior_logp: torch.Tensor,
    behavior_values: torch.Tensor,
    advantages: torch.Tensor,
    returns: torch.Tensor,
    config: PPOLossConfig = PPOLossConfig(),
):
    """Clipped-surrogate PPO loss over a (mini)batch.

    ``ratio = exp(log pi(a) - behavior_logp)``; actor ``-mean(min(ratio * A,
    clip(ratio, 1 +- eps) * A))``; critic the mean squared error to
    ``returns``, with ``clip_value`` the larger of the clipped and unclipped
    errors; minus ``entropy_beta`` times the mean entropy. ``logits`` must be
    masked as at sampling time. Returns ``(loss, aux)`` with ``loss``,
    ``actor_loss``, ``critic_loss``, ``entropy``, ``approx_kl`` (``E[(r - 1)
    - log r]``) and ``clip_frac``.
    """
    advantages, returns = advantages.detach(), returns.detach()
    logp = torch.log_softmax(logits, -1)
    p = torch.softmax(logits, -1)
    logp_a = logp.gather(-1, actions[..., None].long())[..., 0]
    log_ratio = logp_a - behavior_logp
    ratio = torch.exp(log_ratio)
    unclipped = ratio * advantages
    clipped = torch.clamp(ratio, 1.0 - config.clip_eps, 1.0 + config.clip_eps) * advantages
    actor_loss = -torch.mean(torch.minimum(unclipped, clipped))
    if config.clip_value:
        v_clip = behavior_values + torch.clamp(values - behavior_values, -config.value_clip_eps, config.value_clip_eps)
        critic_loss = torch.mean(torch.maximum(torch.square(values - returns), torch.square(v_clip - returns)))
    else:
        critic_loss = torch.mean(torch.square(values - returns))
    entropy = -torch.sum(p * logp, -1)
    loss = actor_loss + config.value_coef * critic_loss - config.entropy_beta * entropy.mean()
    aux = {
        "loss": loss,
        "actor_loss": actor_loss,
        "critic_loss": critic_loss,
        "entropy": entropy.mean(),
        "approx_kl": torch.mean((ratio - 1.0) - log_ratio),
        "clip_frac": torch.mean((torch.abs(ratio - 1.0) > config.clip_eps).to(torch.float32)),
    }
    return loss, aux

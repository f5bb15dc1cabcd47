# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""A3C losses, n-step returns and action sampling (port of ``agents/a3c.py``).

* ``n_step_returns``: discounted targets built backward from a bootstrap
  value, cut at episode ends, with the reference's off-by-one behind
  ``parity_drop_last_reward``;
* ``a3c_loss``: critic ``mean(td^2)``, actor ``-mean(log pi(a) * td + beta *
  entropy)``;
* ``sample_actions``: Gumbel-max sampling. ``jax.random.categorical(key,
  logits)`` is ``argmax(logits + gumbel(key, logits.shape))``; the port
  takes the Gumbel noise as a tensor (the learner stream's, from
  ``engine/philox.learner_gumbel``, or injected), so the same noise gives
  the same actions in both packages.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rein48_tpu_torch.parallel import spmd


class A3CLossConfig(NamedTuple):
    """Loss hyperparameters (defaults = the reference's values).

    gamma: discount. entropy_beta: entropy bonus weight. value_coef: critic
    loss weight. normalize_advantage: zero-mean, unit-(population-)std
    advantages over the whole batch before the policy-gradient term.
    parity_drop_last_reward: the reference's unconsumed last reward.
    """

    gamma: float = 0.9
    entropy_beta: float = 0.001
    value_coef: float = 1.0
    normalize_advantage: bool = False
    parity_drop_last_reward: bool = False


def n_step_returns(
    rewards: torch.Tensor,
    bootstrap: torch.Tensor,
    gamma: float,
    *,
    dones: torch.Tensor | None = None,
    parity_drop_last_reward: bool = False,
) -> torch.Tensor:
    """Discounted n-step targets over the leading time axis.

    ``targets[t] = rewards[t] + gamma * (1 - dones[t]) * targets[t+1]``,
    seeded with ``targets[T] = bootstrap``. With ``parity_drop_last_reward``
    ``targets[T-1] = bootstrap`` exactly and the recursion runs over the
    first ``T - 1`` steps.
    """
    cont = torch.ones_like(rewards) if dones is None else 1.0 - dones.to(rewards.dtype)
    steps = rewards.shape[0] - 1 if parity_drop_last_reward else rewards.shape[0]
    carry, out = bootstrap, []
    for t in range(steps - 1, -1, -1):
        carry = rewards[t] + gamma * cont[t] * carry
        out.append(carry)
    if parity_drop_last_reward:
        return torch.stack(out[::-1] + [bootstrap])
    return torch.stack(out[::-1])


def masked_logits(logits: torch.Tensor, legal_mask: torch.Tensor) -> torch.Tensor:
    """Push illegal actions to -1e9 (leaving an all-illegal row as it is)."""
    out = torch.where(legal_mask, logits, torch.full_like(logits, -1e9))
    all_illegal = ~legal_mask.any(-1, keepdim=True)
    return torch.where(all_illegal, logits, out)


def sample_actions(gumbel: torch.Tensor, logits: torch.Tensor, legal_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Sample from ``softmax(logits)``, optionally masked to legal moves:
    ``argmax(logits + gumbel)`` for standard Gumbel noise of ``logits``'s shape."""
    if legal_mask is not None:
        logits = masked_logits(logits, legal_mask)
    return (logits + gumbel).argmax(-1)


def normalize(adv: torch.Tensor, group=None) -> torch.Tensor:
    """``(adv - mean) / (std + 1e-6)`` with the population std, as ``jnp.std``.

    With a process ``group`` (the data-parallel ranks, ``parallel/``) the
    mean and std are those of every rank's ``adv`` together: the global
    batch's, as JAX's sharded ``jnp.std`` takes them.
    """
    mean, std = spmd.global_mean_std(adv, group)
    return (adv - mean) / (std + 1e-6)


def a3c_loss(
    logits: torch.Tensor,
    values: torch.Tensor,
    actions: torch.Tensor,
    targets: torch.Tensor,
    config: A3CLossConfig = A3CLossConfig(),
    group=None,
):
    """Joint actor+critic loss over a rollout batch.

    ``td = target - V``; critic ``mean(td^2)``; actor ``-mean(log pi(a) *
    td + beta * entropy)`` with no gradient through ``td`` in the actor
    term. ``logits`` ``[..., 4]`` (masked as when sampling), ``values``,
    ``actions`` and ``targets`` of the leading shape. Returns ``(loss,
    aux)`` with ``loss``, ``actor_loss``, ``critic_loss``, ``entropy``
    and ``td_abs``. ``group``: normalize the advantages over the global
    batch of the data-parallel ranks (:func:`normalize`); the means stay the
    rank's own, which the gradient all-reduce averages.
    """
    targets = targets.detach()
    td = targets - values
    critic_loss = torch.mean(torch.square(td))
    adv = td.detach()
    if config.normalize_advantage:
        adv = normalize(adv, group)
    logp = torch.log_softmax(logits, -1)
    p = torch.softmax(logits, -1)
    logp_a = logp.gather(-1, actions[..., None].long())[..., 0]
    entropy = -torch.sum(p * logp, -1)
    actor_loss = -torch.mean(logp_a * adv + config.entropy_beta * entropy)
    loss = actor_loss + config.value_coef * critic_loss
    aux = {
        "loss": loss,
        "actor_loss": actor_loss,
        "critic_loss": critic_loss,
        "entropy": entropy.mean(),
        "td_abs": td.abs().mean(),
    }
    return loss, aux

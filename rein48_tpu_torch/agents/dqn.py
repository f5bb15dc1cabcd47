# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""DQN loss, exploration and target sync (port of ``agents/dqn.py``).

The replay learner that the reference's unfinished DDPG stack (its
``algorithm/ddpg/``) gestures at: per-sample TD targets against a separate
target network kept by Polyak averaging (``tau`` the KEEP fraction, the
reference's ``agent.py:9`` convention) or by periodic hard copies.

Exploration takes its draws as tensors, as the port's samplers do: the
explore uniforms (the learner's ``EPSILON`` stream) and, for the random
action, Gumbel noise over the legal actions (``SAMPLE``) or words without a
mask. ``jax.random.categorical`` is the same argmax over threefry's Gumbel
noise, so given JAX's noise the port picks JAX's actions.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from rein48_tpu_torch.engine import philox


class DQNLossConfig(NamedTuple):
    """DQN hyperparameters (gamma 0.99, the reference DDPG's ``ddpg.py:9``)."""

    gamma: float = 0.99
    double_dqn: bool = True
    huber_delta: float = 1.0


def epsilon_greedy(
    q_values: torch.Tensor,
    epsilon: float,
    legal_mask: torch.Tensor | None,
    explore_u: torch.Tensor,
    random_draw: torch.Tensor,
) -> torch.Tensor:
    """Batched epsilon-greedy over Q(s, .), optionally legality-masked.

    Args:
        q_values: float ``[..., 4]``.
        epsilon: the exploration rate.
        legal_mask: bool ``[..., 4]`` or None. A board with no legal action
            falls back to all four (JAX's ``agents/dqn.py:52-57``).
        explore_u: float ``[...]`` uniforms; a board explores where
            ``explore_u < epsilon``.
        random_draw: the random action's draw: standard Gumbel noise
            ``[..., 4]`` with a mask (``argmax`` over 0/-inf logits plus it),
            int64 words ``[...]`` without (``(word * 4) >> 32``).

    Returns:
        int64 ``[...]`` actions.
    """
    if legal_mask is not None:
        allowed = legal_mask | ~legal_mask.any(-1, keepdim=True)
        greedy = torch.where(allowed, q_values, torch.full_like(q_values, -1e9)).argmax(-1)
        random_a = (torch.where(allowed, 0.0, -torch.inf) + random_draw).argmax(-1)
    else:
        greedy = q_values.argmax(-1)
        random_a = philox.below_from_words(random_draw, q_values.shape[-1])
    return torch.where(explore_u < epsilon, random_a, greedy)


def huber(x: torch.Tensor, delta: float) -> torch.Tensor:
    absx = x.abs()
    return torch.where(absx <= delta, 0.5 * torch.square(x), delta * (absx - 0.5 * delta))


def dqn_loss(
    q_online: torch.Tensor,
    q_online_next: torch.Tensor,
    q_target_next: torch.Tensor,
    actions: torch.Tensor,
    rewards: torch.Tensor,
    dones: torch.Tensor,
    config: DQNLossConfig = DQNLossConfig(),
):
    """TD loss over a sampled batch.

    ``target = r + gamma * (1 - done) * Q_target(s', a*)`` with ``a*`` the
    argmax of ``Q_online(s', .)`` under double DQN (else of the target net);
    the loss is the mean Huber of ``target - Q_online(s, a)`` with no
    gradient through the target. ``q_*`` are float ``[B, 4]``; the
    transition fields ``[B]``. Returns ``(loss, aux)`` with ``loss``,
    ``td_abs``, ``q_mean`` and ``target_mean``.
    """
    q_a = q_online.gather(-1, actions[..., None].long())[..., 0]
    next_a = (q_online_next if config.double_dqn else q_target_next).argmax(-1)
    q_next = q_target_next.gather(-1, next_a[..., None])[..., 0]
    target = rewards + config.gamma * (1.0 - dones.to(torch.float32)) * q_next
    td = target.detach() - q_a
    loss = huber(td, config.huber_delta).mean()
    aux = {"loss": loss, "td_abs": td.abs().mean(), "q_mean": q_a.mean(), "target_mean": target.mean()}
    return loss, aux


@torch.no_grad()
def polyak_update(target_params: Sequence[torch.Tensor], online_params: Sequence[torch.Tensor], tau: float) -> None:
    """Soft target update ``t = tau * t + (1 - tau) * o``, in place.

    ``tau`` is the KEEP fraction, as in the reference (``actor.py:38-40``,
    ``agent.py:9``: tau 0.9 keeps 90% of the target). The products round
    as JAX's ``tau * t`` and ``(1 - tau) * o`` do, then add; the foreach
    ops take a few launches for all the tensors.
    """
    targets = list(target_params)
    torch._foreach_mul_(targets, tau)
    torch._foreach_add_(targets, torch._foreach_mul(list(online_params), 1.0 - tau))

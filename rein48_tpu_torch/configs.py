# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Named workload presets of the five graded configurations (port of
``configs.py``), built on the port's trainer configs:

1. ``parity-single``: one board, random policy, fixed-seed trajectory
   parity against the reference (``parity`` of the CLI).
2. ``vector-16k``: 16k lockstep boards with auto-reset.
3. ``dqn-4k``: DQN with a small CNN and a replay buffer on the device,
   4k envs, one card.
4. ``a3c-8chip``: A3C with the ResNet policy; multi-device training is not
   yet ported, so the preset runs on one card.
5. ``multihost``: the same trainer over a slice-wide batch.
"""

from __future__ import annotations

from typing import Any, Dict

from rein48_tpu_torch.train.a3c import A3CConfig
from rein48_tpu_torch.train.dqn import DQNConfig


def parity_single() -> Dict[str, Any]:
    """Config 1 is a check, not a trainer: ``parity``'s seed and length."""
    return {"seed": 0, "max_steps": 3000}


def vector_16k() -> Dict[str, Any]:
    """Config 2: the engine's scale point."""
    return {"batch_size": 16384, "unroll_len": 256}


def dqn_4k() -> DQNConfig:
    """Config 3: DQN on 4k envs, one card."""
    return DQNConfig(num_envs=4096, model="qnet", replay_capacity=1 << 20, learn_batch_size=8192)


def a3c_8chip(batch_size: int = 16384) -> A3CConfig:
    """Config 4: the ResNet A3C (its batch shards over devices in JAX)."""
    return A3CConfig(batch_size=batch_size, unroll_len=32, model="resnet", model_kwargs=(("channels", 64), ("num_blocks", 4)))


def multihost(global_batch: int = 65536) -> A3CConfig:
    """Config 5: the same trainer; the batch divides over hosts in JAX."""
    return A3CConfig(batch_size=global_batch, unroll_len=32, model="resnet", model_kwargs=(("channels", 64), ("num_blocks", 4)))


PRESETS = {
    "parity-single": parity_single,
    "vector-16k": vector_16k,
    "dqn-4k": dqn_4k,
    "a3c-8chip": a3c_8chip,
    "multihost": multihost,
}

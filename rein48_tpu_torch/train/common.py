# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Observation and reward transforms (port of part of ``train/common.py``).

``make_optimizer`` waits for the trainer slice.
"""

from __future__ import annotations

import torch

from rein48_tpu_torch.models import obs as obs_lib

OBS_ENCODERS = {
    "onehot": obs_lib.encode_onehot,
    "raw": obs_lib.encode_raw,
    "log2": obs_lib.encode_log2_scalar,
}


def encode_obs(boards: torch.Tensor, encoding: str) -> torch.Tensor:
    """Encode exponent boards for the model; non-onehot encodings get a
    trailing channel axis, as conv models need one."""
    x = OBS_ENCODERS[encoding](boards)
    if encoding != "onehot":
        x = x[..., None]
    return x


def transform_reward(reward: torch.Tensor, transform: str) -> torch.Tensor:
    """Reward shaping: ``identity``, ``log2`` (log2(1 + r)) or ``scaled`` (r / 256)."""
    if transform == "identity":
        return reward
    if transform == "log2":
        return torch.log2(1.0 + reward)
    if transform == "scaled":
        return reward / 256.0
    raise ValueError(f"unknown reward transform '{transform}'")

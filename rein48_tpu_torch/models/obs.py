# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Observation encodings of the log2 board (port of ``models/obs.py``)."""

from __future__ import annotations

import torch

NUM_PLANES = 16  # exponents 0..15; plane 0 = empty cell


def encode_onehot(boards: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """``uint8[..., 4, 4]`` exponents -> one-hot ``[..., 4, 4, 16]`` planes."""
    planes = boards[..., None] == torch.arange(NUM_PLANES, dtype=boards.dtype, device=boards.device)
    return planes.to(dtype)


def encode_raw(boards: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Exponents -> raw tile values ``[..., 4, 4]`` (0 for empty, ``2**k``).

    Integer shifts, exact on every device (the JAX version uses ``exp2``).
    """
    b = boards.to(torch.int32)
    return torch.where(b > 0, 1 << b, 0).to(dtype)


def encode_log2_scalar(boards: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Exponents scaled to [0, 1] as a single plane."""
    return (boards.to(torch.float32) / float(NUM_PLANES - 1)).to(dtype)

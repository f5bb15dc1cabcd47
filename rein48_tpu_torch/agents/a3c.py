# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Actor-critic helpers (port of part of ``agents/a3c.py``).

Only :func:`masked_logits`, which evaluation needs; the A3C loss waits for
the trainer slice.
"""

from __future__ import annotations

import torch


def masked_logits(logits: torch.Tensor, legal_mask: torch.Tensor) -> torch.Tensor:
    """Push illegal actions to -1e9 (leaving an all-illegal row as it is)."""
    out = torch.where(legal_mask, logits, torch.full_like(logits, -1e9))
    all_illegal = ~legal_mask.any(-1, keepdim=True)
    return torch.where(all_illegal, logits, out)

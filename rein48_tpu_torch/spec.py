# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Canonical environment spec shared by every consumer (port of ``spec.py``).

The reference has two incompatible env APIs: ``Game`` exposes
``action_space_size/state_space_size/reward_space_size``
(the reference's ``game/GameClient.py:21-27``) while the DDPG agent reads
``action_size/state_size/reward_size`` (``algorithm/ddpg/agent.py:12-14``)
and is therefore dead on arrival. This dataclass is the single source of
truth; both attribute spellings are provided so either style works.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    """Static shape/space description of the 2048 environment."""

    board_size: int = 4
    num_actions: int = 4
    reward_dims: int = 1

    # Reference-style names (GameClient.py:21-27).
    @property
    def action_space_size(self) -> int:
        return self.num_actions

    @property
    def state_space_size(self) -> int:
        return self.board_size

    @property
    def reward_space_size(self) -> int:
        return self.reward_dims

    # DDPG-agent-style names (algorithm/ddpg/agent.py:12-14).
    @property
    def action_size(self) -> int:
        return self.num_actions

    @property
    def state_size(self) -> int:
        return self.board_size

    @property
    def reward_size(self) -> int:
        return self.reward_dims

    @property
    def num_cells(self) -> int:
        return self.board_size * self.board_size


DEFAULT_SPEC = EnvSpec()

# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Stateful Gym-like wrapper over the tensor engine (port of ``env.py``).

The counterpart of the reference's ``Game`` class (its
``game/GameClient.py:15-51``) for interactive and CLI use: the same
``reset()``/``step(action)`` shape, the same action aliases, raw tile values
in and out. Training code steps ``engine.vector`` batches instead.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from rein48_tpu_torch import spec as spec_lib
from rein48_tpu_torch.device import resolve_device
from rein48_tpu_torch.engine import core, render
from rein48_tpu_torch.engine.core import RewardMode


class Game:
    """Single-board 2048 with the reference's public API.

    Differences from the reference, all deliberate (as in the JAX package):
    the board comes back as a numpy int32 array, ``reward_mode`` chooses
    the reference's zero reward or the merge score, and the randomness is
    keyed by ``seed``. Episode ``n`` of a game (``n`` counts the resets,
    from 0) plays on the Philox stream ``(seed, n)`` (``engine/philox.py``);
    the game holds no generator. The board lives on ``device`` (``cuda``
    unless ``"cpu"`` is passed); every method returns host values.
    """

    def __init__(
        self,
        table_matrix_size: int = 4,
        seed: Optional[int] = None,
        reward_mode: RewardMode = RewardMode.PARITY_ZERO,
        device=None,
    ):
        # The reference clamps sizes below 4 up to 4 (GameClient.py:24-27);
        # the engine is specialized to 4, so larger sizes are rejected.
        if table_matrix_size > 4:
            raise NotImplementedError(f"rein48-tpu's engine is specialized to 4x4 boards (got {table_matrix_size})")
        self.spec = spec_lib.DEFAULT_SPEC
        self.reward_space_size = self.spec.reward_space_size
        self.action_space_size = self.spec.action_space_size
        self.state_space_size = self.spec.state_space_size
        # The DDPG-style spellings (the reference's algorithm/ddpg/agent.py:12-14).
        self.action_size = self.spec.action_size
        self.state_size = self.spec.state_size
        self.reward_size = self.spec.reward_size

        self.device = resolve_device(device)
        self._reward_mode = reward_mode
        self._seed = seed if seed is not None else 0
        self._episode = 0
        self._state: Optional[core.EnvState] = None
        self.reset()

    @property
    def state_matrix(self) -> np.ndarray:
        """Current board as raw tile values (the reference's representation)."""
        return core.boards_to_values(self._state.boards).cpu().numpy()

    def reset(self, display: bool = False) -> np.ndarray:
        """Zero board and one random tile (``GameClient.py:33-38``)."""
        self._state = core.reset(self._seed, self._episode, device=self.device)
        self._episode += 1
        if display:
            print(self.render())
        return self.state_matrix

    def step(self, action) -> Tuple[np.ndarray, float, bool]:
        """Move, spawn where the board changed, report game over
        (``GameClient.py:40-51``). Accepts every reference alias ("U", "up",
        0, ...); raises ``ValueError`` for anything else."""
        try:
            act = core.ACTION_ALIASES.get(action)
        except TypeError:
            act = None
        if act is None:
            try:
                act = core.ACTION_ALIASES[int(action)]
            except (KeyError, TypeError, ValueError):
                raise ValueError(
                    "Input action signal is wrong:\n You must input valid inputs, such as  [U] [D] [L] [R]... "
                ) from None
        self._state, reward, done = core.step(self._state, torch.tensor(act), self._reward_mode)
        return self.state_matrix, float(reward), bool(done)

    @property
    def legal_actions(self) -> np.ndarray:
        """bool[4] mask (UP, DOWN, LEFT, RIGHT), an addition over the reference."""
        return core.legal_action_mask(self._state.boards).cpu().numpy()

    def render(self) -> str:
        return render.render_board(self._state.boards)

    @staticmethod
    def print_terminal(matrix) -> None:
        """Reference-compatible static printer (``GameClient.py:257-269``)."""
        print(render.render_values(matrix))

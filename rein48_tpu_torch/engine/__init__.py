# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""2048 engine in PyTorch: move algebra, single-env and batched engines, fused rollout kernel."""

from rein48_tpu_torch.engine.core import (  # noqa: F401
    ACTION_ALIASES,
    ACTION_NAMES,
    BOARD_SIZE,
    DOWN,
    LEFT,
    NUM_ACTIONS,
    NUM_CELLS,
    RIGHT,
    UP,
    EnvState,
    RewardMode,
    board_tile_sum,
    boards_to_values,
    is_game_over,
    legal_action_mask,
    move_boards,
    place_tile,
    random_spawn,
    reset,
    step,
    values_to_boards,
)
from rein48_tpu_torch.engine.vector import (  # noqa: F401
    StepOutput,
    reset_batch,
    rollout_random,
    step_autoreset,
    step_batch,
)

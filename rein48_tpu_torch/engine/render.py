# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Host-side ASCII board rendering (port of ``engine/render.py``).

The reference's terminal grid (its ``game/GameClient.py:257-269``): 6-char
cells, ``|`` separators, dashed rules, blanks for zeros.
"""

from __future__ import annotations

import numpy as np
import torch

from rein48_tpu_torch.engine import core


def render_values(matrix) -> str:
    """Render a board of raw tile values as the reference's ASCII grid."""
    matrix = np.asarray(matrix)
    height, width = matrix.shape
    rule = "-" * (1 + 7 * width)
    lines = [rule]
    for i in range(height):
        cells = ["|"]
        for j in range(width):
            v = int(matrix[i, j])
            cells.append((str(v).center(6) if v != 0 else " " * 6) + "|")
        lines.append("".join(cells))
        lines.append(rule)
    return "\n".join(lines)


def render_board(board) -> str:
    """Render an exponent board (``uint8[4, 4]``, a tensor on any device or
    an array) as tile values."""
    board = board.cpu() if torch.is_tensor(board) else torch.as_tensor(np.asarray(board))
    return render_values(core.boards_to_values(board).numpy())


def print_board(board) -> None:
    print(render_board(board))

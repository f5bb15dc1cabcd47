# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Inputs for checking the port's kernels against their plain versions.

Nothing on a main path reads this module; the tests and ``chip_smoke.py``
do. It imports numpy only, so that it loads without a card and without JAX.
"""

from __future__ import annotations

import numpy as np

# Positions random play rarely reaches (tile exponents): merges at and
# into the exponent cap, dead boards, a single legal direction, one blank
# left, rows of equal tiles, and the empty and one-tile boards.
EDGE_BASES = (
    ((15, 15, 0, 0), (14, 14, 0, 0), (15, 15, 15, 15), (14, 14, 15, 15)),  # 15+15 -> 15, 14+14 -> 15
    ((15, 14, 14, 15), (15, 0, 15, 0), (14, 0, 14, 15), (13, 13, 14, 14)),
    ((1, 2, 1, 2), (2, 1, 2, 1), (1, 2, 1, 2), (2, 1, 2, 1)),  # dead: resets on the next step
    ((15, 14, 15, 14), (14, 15, 14, 15), (15, 14, 15, 14), (14, 15, 14, 15)),
    ((1, 2, 3, 4), (2, 3, 4, 1), (3, 4, 1, 2), (4, 1, 2, 3)),
    ((3, 5, 7, 9), (11, 13, 15, 1), (2, 4, 6, 8), (10, 12, 14, 3)),
    ((1, 2, 3, 3), (2, 3, 4, 1), (3, 4, 1, 2), (4, 1, 2, 3)),  # full, one equal pair: one axis
    ((1, 2, 3, 0), (2, 3, 1, 0), (3, 1, 2, 0), (1, 2, 3, 0)),  # exactly one legal direction
    ((15, 14, 13, 0), (14, 13, 15, 0), (13, 15, 14, 0), (15, 14, 13, 0)),
    ((1, 2, 1, 2), (2, 0, 2, 1), (1, 2, 1, 2), (2, 1, 2, 1)),  # one blank left
    ((1, 2, 3, 4), (2, 3, 4, 1), (3, 4, 0, 2), (4, 1, 2, 3)),
    ((15, 14, 15, 14), (14, 15, 14, 15), (15, 14, 15, 14), (14, 15, 14, 0)),
    ((2, 2, 2, 2), (8, 8, 8, 0), (0, 8, 8, 8), (2, 0, 2, 2)),  # rows of equal tiles
    ((1, 1, 1, 1), (1, 1, 1, 1), (1, 1, 1, 1), (1, 1, 1, 1)),
    ((0, 0, 0, 0), (0, 0, 0, 0), (0, 0, 0, 0), (0, 0, 0, 0)),  # empty: never moves, never spawns
    ((0, 0, 0, 0), (0, 0, 0, 0), (0, 0, 0, 0), (0, 0, 0, 15)),
)


def edge_boards(n: int, seed: int = 0) -> np.ndarray:
    """``uint8[n, 4, 4]`` boards drawn (from ``seed``) from ``EDGE_BASES``
    in all eight orientations, so that every crafted row is also a column
    and each move meets it from every side."""
    bases = np.asarray(EDGE_BASES, np.uint8)
    turns = [np.rot90(bases, k, axes=(1, 2)) for k in range(4)]
    variants = np.concatenate(turns + [t.transpose(0, 2, 1) for t in turns])
    pick = np.random.default_rng(seed).integers(0, len(variants), n)
    return np.ascontiguousarray(variants[pick])


def capped_evaluations(evaluations, **caps):
    """A recipe's ``evaluations`` (``rein48_tpu_torch.examples``) with each
    call's keywords capped, e.g. ``num_steps=32``: the same calls, each
    keyword at most its cap (a ``None`` stays ``None``)."""

    def capped(*args, **kwargs):
        return [
            (tag, {k: min(v, caps[k]) if k in caps and v is not None else v for k, v in kw.items()})
            for tag, kw in evaluations(*args, **kwargs)
        ]

    return capped

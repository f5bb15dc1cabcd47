# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Non-learned control policies (port of ``rein48_tpu/control/__init__.py``).

* :func:`random_policy`: uniform-random actions from the learner's Philox
  stream ``(seed, step, SAMPLE)`` (``engine/philox.py``), on any device.
* :func:`random_legal_policy`: uniform over the legal actions by Gumbel-max
  over 0/-inf logits on the same stream, as the trainers sample.
* :func:`hand_control`: stdin-driven human play with the reference's
  re-prompt loop (its ``control/hand.py:7-21``).
* :class:`Rand` / :class:`Hand`: reference-API shims.
"""

from __future__ import annotations

import random as _pyrandom

import torch

from rein48_tpu_torch.engine import core, philox

_VALID_INPUTS = set(core.ACTION_ALIASES.keys())


def random_policy(seed: int, step: int, batch_shape=(), device=None) -> torch.Tensor:
    """Uniform-random actions, int64 ``[batch_shape]`` in [0, 4): ``(word * 4) >> 32``."""
    words = philox.learner_words(seed, step, philox.SAMPLE, tuple(batch_shape), device=device)
    return philox.below_from_words(words, core.NUM_ACTIONS)


def random_legal_policy(seed: int, step: int, boards: torch.Tensor) -> torch.Tensor:
    """Uniform-random over the *legal* actions of each board (uniform over
    all four where none is legal): ``argmax`` of 0/-inf logits plus the
    stream's Gumbel noise."""
    mask = core.legal_action_mask(boards)
    logits = torch.where(mask | ~mask.any(-1, keepdim=True), 0.0, -torch.inf)
    noise = philox.learner_gumbel(seed, step, tuple(logits.shape), device=boards.device)
    return (logits + noise).argmax(-1)


def hand_control(*_args) -> str:
    """Blocking stdin action prompt (the reference's ``control/hand.py:7-21``)."""
    print("Input action direction, then press ENTER button: ", end="")
    action = input()
    while action not in _VALID_INPUTS:
        print(
            "\n##########[Error]########## \n"
            "Input action signal is invalid, you must input valid value...\n"
            "########################### \n"
        )
        action = input()
    return action


class Rand:
    """Reference-API shim (``control/rand.py``): host RNG, string actions."""

    @staticmethod
    def random_action(*_args) -> str:
        return core.ACTION_NAMES[_pyrandom.randint(0, 3)]


class Hand:
    """Reference-API shim (``control/hand.py``)."""

    hand_control = staticmethod(hand_control)

# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Model FLOPs and MFU (counterpart of ``utils/flops.py``).

FLOPs come from ``torch.utils.flop_counter.FlopCounterMode``, which counts
the matrix products and convolutions a forward dispatches, at 2 per
multiply-add, and no elementwise work. The convention differs from the JAX
package's, which reads XLA's cost analysis: for ``ResNetPolicy(64, 4)``
this module counts all 9 taps of every padded 3x3 convolution, 9,994,880
FLOPs per board, where XLA counts only the taps that land inside the 4x4
board (100 of 144 per channel pair) and adds elementwise work, 7,219,126
(``PERF.md`` gives the ratio). The count needs no device: it runs on the
CPU at a small batch.

MFU is model FLOPs per second over the card's peak dense bf16 rate.
:func:`program_flops` counts any function the same way, the counterpart of
the JAX package's count of a compiled program.
"""

from __future__ import annotations

import copy
from typing import Any, Callable

import torch
from torch.utils.flop_counter import FlopCounterMode

from rein48_tpu_torch.engine import core
from rein48_tpu_torch.train import common

# Peak dense (no sparsity) bf16 tensor-core rate of one H100 SXM at its
# 700 W limit: NVIDIA H100 Tensor Core GPU data sheet, "BF16 Tensor Core
# 1,979 teraFLOPS" with sparsity, half of it dense.
PEAK_BF16_H100_SXM = 989e12


def program_flops(fn: Callable, *args, **kwargs) -> float:
    """FLOPs of one call of ``fn(*args, **kwargs)``, as ``FlopCounterMode``
    counts them: matrix products and convolutions at 2 per multiply-add,
    forward and (if ``fn`` runs one) backward, no elementwise work. It runs
    ``fn`` once, on whatever device its inputs are."""
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def model_forward_flops(model: Any, obs_encoding: str = "onehot", batch: int = 8) -> float:
    """Per-board forward FLOPs of a ``models/nets.py`` module.

    Counts one forward of ``batch`` zero boards on the CPU (a copy of the
    module, so that ``model`` may live on any device) and divides by
    ``batch``; every counted operation scales linearly in the batch.
    """
    cpu_model = copy.deepcopy(model).to("cpu")
    obs = common.encode_obs(torch.zeros((batch, core.BOARD_SIZE, core.BOARD_SIZE), dtype=torch.uint8), obs_encoding)
    with torch.no_grad():
        return program_flops(cpu_model, obs) / batch


def train_flops_per_frame(
    forward_flops: float,
    *,
    rollout_forwards: int = 1,
    reuse_passes: int = 0,
    extra_forward_flops: float = 0.0,
    extra_reuse_passes: int = 0,
) -> float:
    """Model FLOPs per environment frame of a trainer, the JAX package's
    formula: a backward costs 2 forwards, so one optimisation pass is 3.

    Args:
        forward_flops: per-sample forward FLOPs of the net.
        rollout_forwards: acting forwards per frame (4 for the afterstate
            trainer: one per afterstate).
        reuse_passes: forward+backward passes per frame through the net
            (epochs: each frame is in one minibatch per epoch).
        extra_forward_flops: per-sample forward FLOPs of a second net.
        extra_reuse_passes: forward+backward passes per frame through it.
    """
    return forward_flops * (rollout_forwards + 3.0 * reuse_passes) + extra_forward_flops * 3.0 * extra_reuse_passes


def ppo_flops_per_frame(num_epochs: int, forward_flops: float, after_forward_flops: float = 0.0) -> float:
    """The PPO trainer's model FLOPs per frame (``benchmarks/mfu_report.py``):
    one acting forward and ``num_epochs`` forward+backward passes through
    the policy net, and as many through an afterstate critic of
    ``after_forward_flops`` (0 without one)."""
    return train_flops_per_frame(
        forward_flops, reuse_passes=num_epochs, extra_forward_flops=after_forward_flops,
        extra_reuse_passes=num_epochs if after_forward_flops else 0,
    )


def a3c_flops_per_frame(forward_flops: float) -> float:
    """The A3C trainer's model FLOPs per frame: one acting forward and one
    forward+backward pass (``benchmarks/mfu_report.py``)."""
    return train_flops_per_frame(forward_flops, reuse_passes=1)


def mfu(frames_per_sec: float, flops_per_frame: float, peak: float = PEAK_BF16_H100_SXM) -> float:
    """Model FLOPs utilisation in [0, 1]: achieved over ``peak``."""
    return frames_per_sec * flops_per_frame / peak


def dqn_flops_per_frame(forward_flops: float, learn_batch_size: int, frames_per_update: int) -> float:
    """The DQN trainer's model FLOPs per frame (``benchmarks/mfu_report.py``):
    one acting forward, and per learned sample two forwards (online and
    target at s') and one forward+backward (online at s), scaled by the
    samples learned per frame."""
    return forward_flops * (1.0 + learn_batch_size / frames_per_update * (2.0 + 3.0))

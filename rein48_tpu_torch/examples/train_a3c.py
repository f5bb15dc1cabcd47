# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""ResNet A3C at flagship scale, with a greedy evaluation at the end
(counterpart of ``examples/train_a3c_tpu.py``).

    python -m rein48_tpu_torch.examples.train_a3c [num_updates]

B=8192, T=32 at the trainer's defaults. Writes ``runs/a3c_cuda/metrics.csv``
and ``ckpt/a3c_cuda/`` (resumable) and prints the evaluation, as the JAX
recipe does (it writes no ``eval.json``).
"""

from __future__ import annotations

from rein48_tpu_torch.device import resolve_device
from rein48_tpu_torch.examples import _recipe
from rein48_tpu_torch.train.a3c import A3CConfig, train_a3c
from rein48_tpu_torch.train.evaluate import evaluate_policy
from rein48_tpu_torch.utils.checkpoint import Checkpointer

TAG = "a3c_cuda"
# It writes metrics only; the repo holds the flagship's run of the same trainer.
JAX_RECORDS = {f"runs/{TAG}/metrics.csv": "runs/a3c_flagship_tpu/metrics.csv"}


def parse(argv=None) -> list:
    """``[num_updates]``."""
    return _recipe.positional(argv, (int, 10000))


def make_config(num_updates: int) -> A3CConfig:
    return A3CConfig(batch_size=8192, unroll_len=32, model="resnet")


def evaluations(config: A3CConfig) -> list:
    """``(tag, evaluate_policy keywords)``: a greedy window."""
    return [("eval", dict(num_envs=1024, num_steps=8192, seed=123, greedy=True))]


def main(argv=None, *, device=None) -> None:
    (num_updates,) = parse(argv)
    device = resolve_device(device)
    config = make_config(num_updates)
    ckpt = Checkpointer(f"ckpt/{TAG}", save_every=1000, max_to_keep=2)
    state, _, _ = _recipe.train(train_a3c, config, num_updates, tag=TAG, ckpt=ckpt, log_every=25, device=device)

    (_, kwargs), = evaluations(config)
    print("EVAL:", evaluate_policy(state.model, device=device, **kwargs), flush=True)


if __name__ == "__main__":
    main()

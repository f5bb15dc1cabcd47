# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""The DQN flagship on one card, with a first-episode evaluation
(counterpart of ``examples/train_dqn_tpu.py``).

    python -m rein48_tpu_torch.examples.train_dqn [num_updates] [num_envs]

ResNet double DQN over a 2**20-slot buffer on the card; epsilon anneals
over the first 10M env-steps to 0.03, and two acting steps per update make
8,192 samples learned per 8,192 new frames. Learning starts once the
buffer holds 50,000 transitions (update 7 at 4,096 envs). Writes
``runs/dqn_cuda/`` (``metrics.csv``, ``eval.json``) and ``ckpt/dqn_cuda_r4/``
(resumable; a checkpoint directory per tuning generation, as in JAX).
"""

from __future__ import annotations

from rein48_tpu_torch.device import resolve_device
from rein48_tpu_torch.examples import _recipe
from rein48_tpu_torch.train.dqn import DQNConfig, train_dqn
from rein48_tpu_torch.train.evaluate import evaluate_policy
from rein48_tpu_torch.utils.checkpoint import Checkpointer

TAG = "dqn_cuda"
CKPT = "dqn_cuda_r4"
JAX_RECORDS = {f"runs/{TAG}/{f}": f"runs/dqn_tpu/{f}" for f in ("eval.json", "metrics.csv")}


def parse(argv=None) -> list:
    """``[num_updates, num_envs]``."""
    return _recipe.positional(argv, (int, 12000), (int, 4096))


def make_config(num_updates: int, num_envs: int) -> DQNConfig:
    return DQNConfig(
        num_envs=num_envs,
        model="resnet",
        acting_steps_per_update=2,
        epsilon_decay_steps=10_000_000,
        epsilon_end=0.03,
    )


def evaluations(config: DQNConfig) -> list:
    """``(tag, evaluate_policy keywords)``."""
    return [("eval", dict(obs_encoding=config.obs_encoding, num_envs=1024, num_steps=8192, seed=123, protocol="first"))]


def record_config(config: DQNConfig) -> dict:
    """The ``config`` block of the record: the acting schedule."""
    return {
        "num_envs": config.num_envs,
        "acting_steps_per_update": config.acting_steps_per_update,
        "epsilon_decay_steps": config.epsilon_decay_steps,
        "epsilon_end": config.epsilon_end,
    }


def main(argv=None, *, device=None) -> dict:
    num_updates, num_envs = parse(argv)
    device = resolve_device(device)
    config = make_config(num_updates, num_envs)
    ckpt = Checkpointer(f"ckpt/{CKPT}", save_every=2000, max_to_keep=2)
    state, history, train_sec = _recipe.train(train_dqn, config, num_updates, tag=TAG, ckpt=ckpt, log_every=20, device=device)

    (_, kwargs), = evaluations(config)
    stats = evaluate_policy(state.model, device=device, **kwargs)
    print("EVAL:", stats, flush=True)
    out = _recipe.training_record(
        state, history, train_sec, config=record_config(config), protocol="first_episode", eval=stats
    )
    _recipe.write_json(f"runs/{TAG}/eval.json", out)
    return out


if __name__ == "__main__":
    main()

# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""PPO at flagship scale on one card, with a first-episode evaluation
(counterpart of ``examples/train_ppo_tpu.py``).

    python -m rein48_tpu_torch.examples.train_ppo [num_updates] [batch_size]

Writes ``runs/ppo_cuda/`` (``metrics.csv``, ``eval.json``) and
``ckpt/ppo_cuda/`` (resumable).
"""

from __future__ import annotations

from rein48_tpu_torch.device import resolve_device
from rein48_tpu_torch.examples import _recipe
from rein48_tpu_torch.train.evaluate import evaluate_policy
from rein48_tpu_torch.train.ppo import PPOConfig, train_ppo
from rein48_tpu_torch.utils.checkpoint import Checkpointer

TAG = "ppo_cuda"
JAX_RECORDS = {f"runs/{TAG}/{f}": f"runs/ppo_tpu/{f}" for f in ("eval.json", "metrics.csv")}


def parse(argv=None) -> list:
    """``[num_updates, batch_size]``."""
    return _recipe.positional(argv, (int, 2000), (int, 4096))


def make_config(num_updates: int, batch: int) -> PPOConfig:
    return PPOConfig(batch_size=batch, unroll_len=32, model="resnet")


def evaluations(config: PPOConfig) -> list:
    """``(tag, evaluate_policy keywords)``."""
    return [("eval", dict(obs_encoding=config.obs_encoding, num_envs=1024, num_steps=8192, seed=123, protocol="first"))]


def main(argv=None, *, device=None) -> dict:
    num_updates, batch = parse(argv)
    device = resolve_device(device)
    config = make_config(num_updates, batch)
    ckpt = Checkpointer(f"ckpt/{TAG}", save_every=500, max_to_keep=2)
    state, history, train_sec = _recipe.train(train_ppo, config, num_updates, tag=TAG, ckpt=ckpt, log_every=20, device=device)

    (_, kwargs), = evaluations(config)
    stats = evaluate_policy(state.model, device=device, **kwargs)
    print("EVAL:", stats, flush=True)
    out = _recipe.training_record(state, history, train_sec, protocol="first_episode", eval=stats)
    _recipe.write_json(f"runs/{TAG}/eval.json", out)
    return out


if __name__ == "__main__":
    main()

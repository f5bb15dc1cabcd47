# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""A3C with the PPO flagship's recipe (counterpart of
``examples/train_a3c_flagship_tpu.py``).

    python -m rein48_tpu_torch.examples.train_a3c_flagship [num_updates] [batch_size]

The same net, gamma 0.997 and schedules as ``train_ppo_flagship``; one pass
over all B x T = 262,144 boards per update, the port's largest. Writes
``runs/a3c_flagship_cuda/`` (``metrics.csv``, ``eval.json``) and
``ckpt/a3c_flagship_cuda/`` (resumable).
"""

from __future__ import annotations

from rein48_tpu_torch.device import resolve_device
from rein48_tpu_torch.examples import _recipe
from rein48_tpu_torch.train.a3c import A3CConfig, train_a3c
from rein48_tpu_torch.train.evaluate import evaluate_policy
from rein48_tpu_torch.utils.checkpoint import Checkpointer

TAG = "a3c_flagship_cuda"
JAX_RECORDS = {f"runs/{TAG}/{f}": f"runs/a3c_flagship_tpu/{f}" for f in ("eval.json", "metrics.csv")}


def parse(argv=None) -> list:
    """``[num_updates, batch_size]``."""
    return _recipe.positional(argv, (int, 12000), (int, 8192))


def make_config(num_updates: int, batch: int) -> A3CConfig:
    return A3CConfig(
        batch_size=batch,
        unroll_len=32,
        model="resnet",
        gamma=0.997,
        learning_rate=3e-4,
        lr_decay_updates=num_updates,
        lr_final_frac=0.1,
        entropy_beta=0.01,
        entropy_beta_final=0.002,
        entropy_decay_updates=max(1, int(num_updates * 0.8)),
    )


def evaluations(config: A3CConfig) -> list:
    """``(tag, evaluate_policy keywords)``."""
    return [("eval", dict(obs_encoding=config.obs_encoding, num_envs=1024, num_steps=16384, seed=123, protocol="first"))]


def main(argv=None, *, device=None) -> dict:
    num_updates, batch = parse(argv)
    device = resolve_device(device)
    config = make_config(num_updates, batch)
    ckpt = Checkpointer(f"ckpt/{TAG}", save_every=2000, max_to_keep=2)
    state, history, train_sec = _recipe.train(train_a3c, config, num_updates, tag=TAG, ckpt=ckpt, log_every=50, device=device)

    (_, kwargs), = evaluations(config)
    stats = evaluate_policy(state.model, device=device, **kwargs)
    print("EVAL:", stats, flush=True)
    out = _recipe.training_record(
        state, history, train_sec, config.batch_size * config.unroll_len,
        config=_recipe.schedule(config), protocol="first_episode", eval=stats,
    )
    _recipe.write_json(f"runs/{TAG}/eval.json", out)
    return out


if __name__ == "__main__":
    main()

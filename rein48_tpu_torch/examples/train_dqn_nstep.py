# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""DQN with n-step returns and a long-horizon gamma (counterpart of
``examples/train_dqn_nstep_tpu.py``).

    python -m rein48_tpu_torch.examples.train_dqn_nstep [num_updates] [num_envs] [n_step] [gamma] [huber] [tag]

``train_dqn``'s flagship with 5-step targets from the buffer's strided
layout and gamma 0.997. Writes ``runs/<tag>/`` (``metrics.csv``,
``eval.json``) and ``ckpt/<tag>/``, the tag defaulting to ``dqn_r5_cuda``.
"""

from __future__ import annotations

from rein48_tpu_torch.device import resolve_device
from rein48_tpu_torch.examples import _recipe
from rein48_tpu_torch.examples.train_dqn import record_config
from rein48_tpu_torch.train.dqn import DQNConfig, train_dqn
from rein48_tpu_torch.train.evaluate import evaluate_policy
from rein48_tpu_torch.utils.checkpoint import Checkpointer

TAG = "dqn_r5_cuda"
# At the default tag. The repo holds this recipe's metrics, and the eval
# record of the 1-step DQN recipe, which writes the same fields but the
# n-step ones.
JAX_RECORDS = {f"runs/{TAG}/eval.json": "runs/dqn_tpu/eval.json", f"runs/{TAG}/metrics.csv": "runs/dqn_r5_tpu/metrics.csv"}


def adjust_jax_keys(keys: dict) -> None:
    """train_dqn_nstep_tpu.py:93-101: the n-step settings in ``config``."""
    keys[f"runs/{TAG}/eval.json"]["config"].update(n_step=None, gamma=None, huber_delta=None)


def parse(argv=None) -> list:
    """``[num_updates, num_envs, n_step, gamma, huber, tag]``."""
    return _recipe.positional(argv, (int, 12000), (int, 4096), (int, 5), (float, 0.997), (float, 1.0), (str, TAG))


def make_config(num_updates: int, num_envs: int, n_step: int, gamma: float, huber: float) -> DQNConfig:
    return DQNConfig(
        num_envs=num_envs,
        model="resnet",
        acting_steps_per_update=2,
        epsilon_decay_steps=10_000_000,
        epsilon_end=0.03,
        n_step=n_step,
        gamma=gamma,
        huber_delta=huber,
    )


def evaluations(config: DQNConfig) -> list:
    """``(tag, evaluate_policy keywords)``."""
    return [("eval", dict(obs_encoding=config.obs_encoding, num_envs=1024, num_steps=8192, seed=123, protocol="first"))]


def main(argv=None, *, device=None) -> dict:
    num_updates, num_envs, n_step, gamma, huber, tag = parse(argv)
    device = resolve_device(device)
    config = make_config(num_updates, num_envs, n_step, gamma, huber)
    ckpt = Checkpointer(f"ckpt/{tag}", save_every=2000, max_to_keep=2)
    state, history, train_sec = _recipe.train(train_dqn, config, num_updates, tag=tag, ckpt=ckpt, log_every=20, device=device)

    (_, kwargs), = evaluations(config)
    stats = evaluate_policy(state.model, device=device, **kwargs)
    print("EVAL:", stats, flush=True)
    settings = dict(record_config(config), n_step=config.n_step, gamma=config.gamma, huber_delta=config.huber_delta)
    out = _recipe.training_record(state, history, train_sec, config=settings, protocol="first_episode", eval=stats)
    _recipe.write_json(f"runs/{tag}/eval.json", out)
    return out


if __name__ == "__main__":
    main()

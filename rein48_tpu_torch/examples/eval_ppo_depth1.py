# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Value-guided depth-1 evaluation of the PPO flagship checkpoint
(counterpart of ``examples/eval_ppo_depth1_tpu.py``).

    python -m rein48_tpu_torch.examples.eval_ppo_depth1 [num_envs] [num_steps] [chunk] [launch_chunk]

One exact expectimax ply over the policy net's own critic (the leaf of
``eval --algo search``), with the chance expansion chunked. A short probe
first (labelled ``probe``: a 256-step window finishes almost no episode),
then the first-episode row. Writes ``runs/ppo_flagship_cuda/eval_depth1.json``
after each.
"""

from __future__ import annotations

from rein48_tpu_torch.device import resolve_device
from rein48_tpu_torch.examples import _recipe
from rein48_tpu_torch.train.evaluate import evaluate_search
from rein48_tpu_torch.train.ppo import PPOConfig, init_ppo
from rein48_tpu_torch.utils.checkpoint import Checkpointer

TAG = "ppo_flagship_cuda"
OUT = f"runs/{TAG}/eval_depth1.json"
JAX_RECORDS = {OUT: "runs/ppo_flagship_tpu/eval_depth1.json"}


def adjust_jax_keys(keys: dict) -> None:
    """eval_ppo_depth1_tpu.py:73-76 labels the probe, which the committed
    record predates."""
    keys[OUT]["results"]["probe"]["probe"] = None


def parse(argv=None) -> list:
    """``[num_envs, num_steps, chunk, launch_chunk]``."""
    return _recipe.positional(argv, (int, 512), (int, 16384), (int, 4), (int, 512))


def make_config(saved: dict) -> PPOConfig:
    """The settings the checkpoint was trained with, from its saved config."""
    return PPOConfig(
        batch_size=int(saved.get("batch_size", 8192)),
        model=saved.get("model", "resnet"),
        gamma=float(saved.get("gamma", 0.997)),
        reward_transform=saved.get("reward_transform", "log2"),
        obs_encoding=saved.get("obs_encoding", "onehot"),
    )


def evaluations(config: PPOConfig, num_envs: int, num_steps: int, chunk: int, launch_chunk: int) -> list:
    """``(tag, evaluate_search keywords)``: the probe, then the row."""
    search = dict(
        depth=1, obs_encoding=config.obs_encoding, gamma=config.gamma, reward_transform=config.reward_transform,
        chance_chunk=chunk,
    )
    return [
        ("probe", dict(search, num_envs=32, num_steps=256, seed=77, protocol="window")),
        ("depth1_value_guided", dict(
            search, num_envs=num_envs, num_steps=num_steps, seed=123, protocol="first", launch_chunk=launch_chunk
        )),
    ]


def main(argv=None, *, device=None) -> dict:
    num_envs, num_steps, chunk, launch_chunk = parse(argv)
    device = resolve_device(device)
    ckpt = Checkpointer(f"ckpt/{TAG}")
    config = make_config(ckpt.load_config() or {})
    state, model, _ = init_ppo(config, 0, device)
    state = ckpt.restore(state)
    print(f"restored PPO checkpoint step {state.update_step}", flush=True)

    def run(kwargs):
        stats = evaluate_search(model=model, device=device, **kwargs)
        if kwargs["protocol"] == "window":
            # Not a capability measurement: labelled so that no reader takes it for one.
            stats["probe"] = True
        return stats

    out = {"checkpoint_step": state.update_step}
    return _recipe.evaluate(
        evaluations(config, num_envs, num_steps, chunk, launch_chunk), run, out, OUT, sized=lambda tag: tag != "probe"
    )


if __name__ == "__main__":
    main()

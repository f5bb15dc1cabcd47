# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""PPO with a co-trained afterstate critic, warm-started from the PPO
flagship (counterpart of ``examples/train_ppo_afterstate_tpu.py``).

    python -m rein48_tpu_torch.examples.train_ppo_afterstate [num_updates] [batch_size]

Trains a second value net V_after on the rollout's afterstates beside the
policy, at a fine-tuning learning rate, the policy starting from the latest
``ckpt/ppo_flagship_cuda`` checkpoint (``train_ppo_flagship``) unless this
run has its own checkpoint to resume. Without either it raises, as the JAX
recipe does. Evaluates three ways: the policy head alone (``greedy``),
``argmax_a r(a) + gamma V_after(after(s, a))`` (``after_greedy``) and one
expectimax ply over V_after (``depth1_after``). Writes
``runs/ppo_afterstate_cuda/`` (``eval.json`` after each evaluation) and
``ckpt/ppo_afterstate_cuda/``, whose critic ``train_afterstate_td``
warm-starts from.
"""

from __future__ import annotations

from rein48_tpu_torch.device import resolve_device
from rein48_tpu_torch.examples import _recipe
from rein48_tpu_torch.train.evaluate import evaluate_policy, evaluate_search
from rein48_tpu_torch.train.ppo import PPOConfig, train_ppo
from rein48_tpu_torch.utils.checkpoint import Checkpointer

TAG = "ppo_afterstate_cuda"
DONOR = "ppo_flagship_cuda"
JAX_RECORDS = {f"runs/{TAG}/{f}": f"runs/ppo_afterstate_tpu/{f}" for f in ("eval.json", "metrics.csv")}


def parse(argv=None) -> list:
    """``[num_updates, batch_size]``."""
    return _recipe.positional(argv, (int, 6000), (int, 8192))


def make_config(num_updates: int, batch: int) -> PPOConfig:
    return PPOConfig(
        batch_size=batch,
        unroll_len=32,
        model="resnet",
        gamma=0.997,
        # A fine-tuning schedule: the policy arrives trained, the critic
        # starts cold.
        learning_rate=1.2e-4,
        lr_decay_updates=num_updates,
        lr_final_frac=0.1,
        entropy_beta=0.003,
        entropy_beta_final=0.001,
        entropy_decay_updates=max(1, int(num_updates * 0.8)),
        afterstate_critic=True,
        after_model="resnet",
    )


def evaluations(config: PPOConfig) -> list:
    """``(tag, keywords)``: ``greedy`` for ``evaluate_policy`` on the policy,
    then ``after_greedy`` and ``depth1_after`` for ``evaluate_search`` on
    the critic."""
    search = dict(
        obs_encoding=config.obs_encoding, gamma=config.gamma, reward_transform=config.reward_transform, protocol="first"
    )
    return [
        ("greedy", dict(obs_encoding=config.obs_encoding, num_envs=1024, num_steps=16384, seed=123, protocol="first")),
        ("after_greedy", dict(search, depth=0, num_envs=1024, num_steps=16384, seed=123, launch_chunk=2048)),
        ("depth1_after", dict(search, depth=1, num_envs=256, num_steps=16384, seed=123, chance_chunk=4, launch_chunk=512)),
    ]


def main(argv=None, *, device=None) -> dict:
    num_updates, batch = parse(argv)
    device = resolve_device(device)
    config = make_config(num_updates, batch)
    ckpt = Checkpointer(f"ckpt/{TAG}", save_every=500, max_to_keep=2)
    warm, warm_src = None, f"resumed ckpt/{TAG}"
    if ckpt.latest_step() is None:
        donor = Checkpointer(f"ckpt/{DONOR}")
        warm = donor.restore_field("model")  # FileNotFoundError without a donor
        warm_src = f"ckpt/{DONOR} step {donor.latest_step()}"
        print(f"loaded the flagship policy ({warm_src}) for the warm start", flush=True)
    state, history, train_sec = _recipe.train(
        train_ppo, config, num_updates, tag=TAG, ckpt=ckpt, log_every=25, device=device, warm_start_policy=warm
    )

    settings = dict(_recipe.schedule(config), afterstate_critic=True, warm_start=warm_src)
    out = _recipe.training_record(
        state, history, train_sec, config.batch_size * config.unroll_len, config=settings, protocol="first_episode"
    )

    def run(kwargs):
        if "depth" not in kwargs:  # the policy's greedy row
            return evaluate_policy(state.model, device=device, **kwargs)
        return evaluate_search(model=state.after_model, device=device, **kwargs)

    return _recipe.evaluate(evaluations(config), run, out, f"runs/{TAG}/eval.json", sized=lambda tag: tag == "depth1_after")


if __name__ == "__main__":
    main()

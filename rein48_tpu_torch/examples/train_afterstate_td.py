# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""The deep afterstate-TD flagship run (counterpart of
``examples/train_afterstate_td_tpu.py``).

    python -m rein48_tpu_torch.examples.train_afterstate_td [num_updates] [batch_size] [tag]

On-policy afterstate TD(lambda) on the ResNet: acting is the depth-0
planner and V_after regresses its own greedy policy's targets. V_after
starts from the afterstate critic co-trained by ``train_ppo_afterstate``
(the ``after_model`` of the latest ``ckpt/ppo_afterstate_cuda``
checkpoint), or from its fresh init when there is no donor, which it
prints. Evaluates ``after_greedy`` (depth 0) and ``depth1``. Writes
``runs/<tag>/`` and ``ckpt/<tag>/``, the tag defaulting to
``afterstate_td_cuda``.
"""

from __future__ import annotations

from rein48_tpu_torch.device import resolve_device
from rein48_tpu_torch.examples import _recipe
from rein48_tpu_torch.train.afterstate import AfterstateTDConfig, train_afterstate_td
from rein48_tpu_torch.train.evaluate import evaluate_search
from rein48_tpu_torch.utils.checkpoint import Checkpointer

TAG = "afterstate_td_cuda"
DONOR = "ppo_afterstate_cuda"
# At the default tag.
JAX_RECORDS = {f"runs/{TAG}/{f}": f"runs/afterstate_td_tpu/{f}" for f in ("eval.json", "metrics.csv")}


def parse(argv=None) -> list:
    """``[num_updates, batch_size, tag]``."""
    return _recipe.positional(argv, (int, 3000), (int, 8192), (str, TAG))


def make_config(num_updates: int, batch: int) -> AfterstateTDConfig:
    return AfterstateTDConfig(
        batch_size=batch,
        unroll_len=32,
        model="resnet",
        gamma=0.997,
        td_lambda=0.7,
        learning_rate=1e-4,
        lr_decay_updates=num_updates,
        lr_final_frac=0.1,
        num_epochs=2,
        num_minibatches=4,
    )


def evaluations(config: AfterstateTDConfig) -> list:
    """``(tag, evaluate_search keywords)``: depth 0, then depth 1."""
    search = dict(
        obs_encoding=config.obs_encoding, gamma=config.gamma, reward_transform=config.reward_transform, protocol="first"
    )
    return [
        ("after_greedy", dict(search, depth=0, num_envs=1024, num_steps=16384, seed=123, launch_chunk=2048)),
        ("depth1", dict(search, depth=1, num_envs=256, num_steps=16384, seed=123, chance_chunk=4, launch_chunk=512)),
    ]


def main(argv=None, *, device=None) -> dict:
    num_updates, batch, tag = parse(argv)
    device = resolve_device(device)
    config = make_config(num_updates, batch)
    ckpt = Checkpointer(f"ckpt/{tag}", save_every=500, max_to_keep=2)
    warm, warm_src = None, f"resumed ckpt/{tag}"
    if ckpt.latest_step() is None:
        warm_src = "none (fresh init)"
        try:
            # The PPO state holds the critic as its own module, ``after_model``
            # (JAX's ``params["after"]``).
            warm = Checkpointer(f"ckpt/{DONOR}").restore_field("after_model")
            warm_src = f"ckpt/{DONOR} after_model"
            print("warm start: ppo_afterstate co-trained critic", flush=True)
        except FileNotFoundError:
            print("no donor checkpoint; training V_after from fresh init", flush=True)
    state, history, train_sec = _recipe.train(
        train_afterstate_td, config, num_updates, tag=tag, ckpt=ckpt, log_every=25, device=device,
        warm_start_params=warm,
    )

    settings = {
        "batch_size": config.batch_size,
        "gamma": config.gamma,
        "td_lambda": config.td_lambda,
        "lr": config.learning_rate,
        "warm_start": warm_src,
    }
    out = _recipe.training_record(
        state, history, train_sec, config.batch_size * config.unroll_len, config=settings, protocol="first_episode"
    )
    return _recipe.evaluate(
        evaluations(config), lambda kwargs: evaluate_search(model=state.model, device=device, **kwargs), out,
        f"runs/{tag}/eval.json", sized=lambda name: name == "depth1",
    )


if __name__ == "__main__":
    main()

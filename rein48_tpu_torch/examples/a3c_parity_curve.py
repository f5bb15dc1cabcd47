# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""A3C in the reference's regime, scored under the reference's protocol
(counterpart of ``examples/a3c_parity_curve.py``).

    python -m rein48_tpu_torch.examples.a3c_parity_curve [num_updates] [seeds]

Trains ``A3CConfig.reference_parity()`` (reward identically zero, raw board
obs, the MLP, no legal mask, gamma 0.9, RMSprop 1e-3, the dropped last
reward) from several seeds, then plays 256 episodes of each trained policy
under the reference's protocol: softmax sampling, episodes capped at 100
steps, the score the final board's tile sum. A uniform-random policy is
scored the same way, and the reference's own replicas are summarised where
``runs/a3c_reference/scores*.json`` exist under the working directory. With
no reward signal, the match is that both stay at the random-play level with
no trend. Writes ``runs/a3c_parity_cuda/parity.json`` (the tag gains
``_cuda`` so that the JAX run's ``runs/a3c_parity/`` stays as it is).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from rein48_tpu_torch.agents import a3c as a3c_agent
from rein48_tpu_torch.device import resolve_device
from rein48_tpu_torch.engine import philox, vector
from rein48_tpu_torch.examples import _recipe
from rein48_tpu_torch.train import common
from rein48_tpu_torch.train.a3c import A3CConfig, train_a3c

TAG = "a3c_parity_cuda"
CAP = 100  # the reference's MAX_STEP_NUM
EVAL_EPISODES = 256
JAX_RECORDS = {f"runs/{TAG}/parity.json": "runs/a3c_parity/parity.json"}


def parse(argv=None) -> list:
    """``[num_updates, seeds]``."""
    return _recipe.positional(argv, (int, 16), (int, 3))


def make_config() -> A3CConfig:
    return A3CConfig.reference_parity()


@torch.inference_mode()
def capped_episode_scores(policy_logits_fn, seed: int, device, num_envs: int = EVAL_EPISODES) -> np.ndarray:
    """The reference's scoring: softmax sampling (Gumbel-max on the learner
    stream of ``seed``), the first episode of each env, capped at ``CAP``
    steps; the score is the board's tile sum at the end, finished or not."""
    state = vector.reset_batch(seed, num_envs, device)
    finished = torch.zeros(num_envs, dtype=torch.bool, device=device)
    score = torch.zeros(num_envs, dtype=torch.float32, device=device)
    for step in range(CAP):
        logits = policy_logits_fn(state.boards)
        actions = a3c_agent.sample_actions(philox.learner_gumbel(seed, step, logits.shape, device=device), logits)
        state, out = vector.step_autoreset(state, actions)
        score = torch.where(out.done & ~finished, out.episode_tile_sum.to(torch.float32), score)
        finished |= out.done
    boards = state.boards.to(torch.float32)
    live = torch.where(boards > 0, torch.exp2(boards), torch.zeros_like(boards)).sum((-2, -1))
    return torch.where(finished, score, live).cpu().numpy()


def model_logits_fn(model, obs_encoding: str):
    def fn(boards):
        return model(common.encode_obs(boards, obs_encoding))[0]

    return fn


def reference_replicas(ref_dir: str = "runs/a3c_reference") -> list:
    """Mean, spread and trend of each measured reference replica."""
    refs = []
    if not os.path.isdir(ref_dir):
        return refs
    for name in sorted(os.listdir(ref_dir)):
        if name.startswith("scores"):
            with open(os.path.join(ref_dir, name)) as f:
                scores = np.asarray(json.load(f)["scores"], np.float64)
            refs.append({
                "file": name,
                "episodes": len(scores),
                "mean": float(scores.mean()),
                "std": float(scores.std()),
                "max": float(scores.max()),
                # Any learning? The slope of score against episode, per 100 episodes.
                "slope_per_100eps": float(np.polyfit(np.arange(len(scores)), scores, 1)[0] * 100),
            })
    return refs


def main(argv=None, *, device=None) -> dict:
    num_updates, seeds = parse(argv)
    device = resolve_device(device)
    results = {"config": "A3CConfig.reference_parity", "seeds": {}}
    for seed in range(seeds):
        cfg = make_config()
        state, hist = train_a3c(cfg, num_updates=num_updates, seed=seed, log_every=1, device=device)
        trained = capped_episode_scores(model_logits_fn(state.model, cfg.obs_encoding), 1000 + seed, device)
        results["seeds"][seed] = {
            "curve": hist,
            "capped_scores_mean": float(trained.mean()),
            "capped_scores_std": float(trained.std()),
            "capped_scores_max": float(trained.max()),
            "env_steps_trained": num_updates * cfg.batch_size * cfg.unroll_len,
        }
        print(
            f"seed {seed}: trained capped score {trained.mean():.1f} ± {trained.std():.1f} "
            f"(max {trained.max():.0f}); entropy {hist[-1]['entropy']:.3f}",
            flush=True,
        )

    # Uniform-random play under the same protocol.
    rand = capped_episode_scores(lambda boards: torch.zeros(boards.shape[:-2] + (4,), device=device), 7777, device)
    results["random_baseline"] = {
        "capped_scores_mean": float(rand.mean()),
        "capped_scores_std": float(rand.std()),
        "capped_scores_max": float(rand.max()),
    }
    print(f"random baseline: {rand.mean():.1f} ± {rand.std():.1f}", flush=True)
    results["reference_replicas"] = reference_replicas()
    _recipe.write_json(f"runs/{TAG}/parity.json", results)
    return results


if __name__ == "__main__":
    main()

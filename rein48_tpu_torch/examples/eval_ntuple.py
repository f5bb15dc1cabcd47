# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Expectimax sweep over a trained n-tuple checkpoint (counterpart of
``examples/eval_ntuple_tpu.py``).

    python -m rein48_tpu_torch.examples.eval_ntuple [max_depth] [num_envs] [num_steps]

Plays the greedy policy (depth 0) and the value-guided planner (depths 1 to
``max_depth``) from the latest ``ckpt/ntuple_cuda`` checkpoint under the
first-episode protocol, fewer envs and steps the deeper it goes, and times
the whole state's restore onto the card (``Checkpointer.restore`` to a
fence) under JAX's key ``restore_full_state_sec``. Writes
``runs/ntuple_cuda/eval.json`` after every depth.
"""

from __future__ import annotations

from rein48_tpu_torch.device import resolve_device
from rein48_tpu_torch.examples import _recipe
from rein48_tpu_torch.train.ntuple import NTupleTrainConfig, evaluate_ntuple

TAG = "ntuple_cuda"
OUT = f"runs/{TAG}/eval.json"
# The repo holds no run of this sweep: its record is built from the
# training recipe's (adjust_jax_keys).
JAX_RECORDS = {OUT: "runs/ntuple_tpu/eval.json"}


def adjust_jax_keys(keys: dict) -> None:
    """eval_ntuple_tpu.py:102-113 at the default ``max_depth`` 1: the
    training record's stats with their sizes and wall time, and the restore
    timings."""
    stats = dict(keys[OUT]["results"]["depth0"], num_envs=None, num_steps=None, wall_sec=None)
    keys[OUT] = {
        "checkpoint_step": None, "protocol": None, "results": {"depth0": stats, "depth1": stats},
        "timings": {"restore_full_state_sec": None, "params_bytes": None},
    }


def parse(argv=None) -> list:
    """``[max_depth, num_envs, num_steps]``."""
    return _recipe.positional(argv, (int, 1), (int, 1024), (int, 20000))


def make_config(saved: dict) -> NTupleTrainConfig:
    return _recipe.ntuple_config(saved)


def evaluations(max_depth: int, num_envs: int, num_steps: int) -> list:
    """``(tag, evaluate_ntuple keywords)`` per depth: each level costs about
    17x the one before, so envs shrink 4x and steps 2x a level."""
    return [
        (f"depth{depth}", dict(
            depth=depth, num_envs=max(num_envs // (4**depth), 32), num_steps=max(num_steps // (2**depth), 1024),
            seed=123 + depth, protocol="first",
        ))
        for depth in range(max_depth + 1)
    ]


def main(argv=None, *, device=None) -> dict:
    max_depth, num_envs, num_steps = parse(argv)
    device = resolve_device(device)
    config, state, step, t_init, t_restore = _recipe.restore_ntuple(make_config, device, TAG)
    nbytes = sum(t.nbytes for t in state.params.values())
    print(
        f"checkpoint step {step}; tables: {sorted(state.params)}; {nbytes / 1e6:.0f}MB params; "
        f"init {t_init:.1f}s; restore {t_restore:.1f}s",
        flush=True,
    )
    out = {
        "checkpoint_step": step,
        "protocol": "first_episode",
        "timings": {"restore_full_state_sec": round(t_restore, 2), "params_bytes": int(nbytes)},
    }
    return _recipe.evaluate(
        evaluations(max_depth, num_envs, num_steps),
        lambda kwargs: evaluate_ntuple(state.params, config, device=device, **kwargs), out, OUT,
    )


if __name__ == "__main__":
    main()

# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Capability run: the full 4x6-tuple afterstate-TD network on one card
(counterpart of ``examples/train_ntuple_tpu.py``).

    python -m rein48_tpu_torch.examples.train_ntuple [num_updates] [batch_size] [mode]

``mode`` is ``delayed`` (windowed TD, the default) or ``step`` (classic
per-step TD). The tables are ``YEH_4X6``'s four 16,777,216-entry tables
(with TC's accumulators, about 800 MB); ``table_backend="auto"`` resolves to
``"torch"`` for them, as JAX's resolves to ``"xla"``. Writes
``runs/ntuple_cuda/`` (``metrics.csv``, ``eval.json``: depth-0 and depth-1
first-episode play of the final tables) and ``ckpt/ntuple_cuda/``
(resumable); ``eval_ntuple`` sweeps deeper from that checkpoint.
"""

from __future__ import annotations

from rein48_tpu_torch.device import resolve_device
from rein48_tpu_torch.examples import _recipe
from rein48_tpu_torch.train.ntuple import NTupleTrainConfig, evaluate_ntuple, train_ntuple
from rein48_tpu_torch.utils.checkpoint import Checkpointer

TAG = "ntuple_cuda"
# What it writes -> the JAX recipe's committed record with the same keys.
JAX_RECORDS = {f"runs/{TAG}/eval.json": "runs/ntuple_tpu/eval.json", f"runs/{TAG}/metrics.csv": "runs/ntuple_tpu/metrics.csv"}


def parse(argv=None) -> list:
    """``[num_updates, batch_size, mode]``."""
    return _recipe.positional(argv, (int, 2000), (int, 4096), (str, "delayed"))


def make_config(num_updates: int, batch: int, mode: str) -> NTupleTrainConfig:
    return NTupleTrainConfig(batch_size=batch, steps_per_update=128, update_mode=mode)


def evaluations() -> list:
    """``(tag, evaluate_ntuple keywords)`` of the in-process check: depth 0
    and depth 1 with chance chunks and launch chunks (the same sums)."""
    return [
        (f"depth{depth}", dict(
            depth=depth, num_envs=envs, num_steps=steps, seed=123 + depth, protocol="first",
            chance_chunk=4 if depth else None, launch_chunk=1024 if depth else 4096,
        ))
        for depth, envs, steps in ((0, 1024, 16384), (1, 256, 16384))
    ]


def main(argv=None, *, device=None) -> dict:
    num_updates, batch, mode = parse(argv)
    device = resolve_device(device)
    config = make_config(num_updates, batch, mode)
    ckpt = Checkpointer(f"ckpt/{TAG}", save_every=500, max_to_keep=2)
    state, _, _ = _recipe.train(train_ntuple, config, num_updates, tag=TAG, ckpt=ckpt, log_every=20, device=device)

    results = {}
    for tag, kwargs in evaluations():
        results[tag] = evaluate_ntuple(state.params, config, device=device, **kwargs)
        print(f"EVAL {tag} (envs={kwargs['num_envs']}, steps={kwargs['num_steps']}):", results[tag], flush=True)
    out = {"checkpoint_step": state.update_step, "results": results}
    _recipe.write_json(f"runs/{TAG}/eval.json", out)
    return out


if __name__ == "__main__":
    main()

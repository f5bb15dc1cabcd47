# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Depth-1 expectimax evaluation of the n-tuple checkpoint on the card
(counterpart of ``examples/eval_ntuple_depth1_tpu.py``).

    python -m rein48_tpu_torch.examples.eval_ntuple_depth1 [num_envs] [num_steps] [chunk] [launch_chunk]

The spawn expansion runs in groups of ``chunk`` children and the sweep in
launches of ``launch_chunk`` steps, with JAX's values, so the statistics are
the same computation. A short probe (32 envs, 512 steps) runs first, then
the first-episode row. Writes ``runs/ntuple_cuda/eval_depth1_cuda.json``
after each.
"""

from __future__ import annotations

from rein48_tpu_torch.device import resolve_device
from rein48_tpu_torch.examples import _recipe
from rein48_tpu_torch.train.ntuple import NTupleTrainConfig, evaluate_ntuple

TAG = "ntuple_cuda"
OUT = f"runs/{TAG}/eval_depth1_cuda.json"
JAX_RECORDS = {OUT: "runs/ntuple_tpu/eval_depth1_tpu.json"}


def parse(argv=None) -> list:
    """``[num_envs, num_steps, chunk, launch_chunk]``."""
    return _recipe.positional(argv, (int, 256), (int, 16384), (int, 4), (int, 512))


def make_config(saved: dict) -> NTupleTrainConfig:
    return _recipe.ntuple_config(saved)


def evaluations(num_envs: int, num_steps: int, chunk: int, launch_chunk: int) -> list:
    """``(tag, evaluate_ntuple keywords)``: the probe, then the row."""
    return [
        ("probe_depth1", dict(depth=1, num_envs=32, num_steps=512, seed=321, protocol="window", chance_chunk=chunk)),
        ("depth1", dict(
            depth=1, num_envs=num_envs, num_steps=num_steps, seed=124, protocol="first", chance_chunk=chunk,
            launch_chunk=launch_chunk,
        )),
    ]


def main(argv=None, *, device=None) -> dict:
    num_envs, num_steps, chunk, launch_chunk = parse(argv)
    device = resolve_device(device)
    config, state, step, _, t_restore = _recipe.restore_ntuple(make_config, device, TAG)
    print(f"checkpoint step {step} restored on {device} in {t_restore:.1f}s", flush=True)
    out = {"checkpoint_step": step, "protocol": "first_episode", "backend": device.type, "chance_chunk": chunk}
    return _recipe.evaluate(
        evaluations(num_envs, num_steps, chunk, launch_chunk),
        lambda kwargs: evaluate_ntuple(state.params, config, device=device, **kwargs), out, OUT,
        sized=lambda tag: tag == "depth1",
    )


if __name__ == "__main__":
    main()

# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Depth-2 expectimax over the n-tuple checkpoint (counterpart of
``examples/eval_ntuple_depth2_tpu.py``).

    python -m rein48_tpu_torch.examples.eval_ntuple_depth2 probe [num_envs] [num_steps] [chance_chunk] [launch_chunk]
    python -m rein48_tpu_torch.examples.eval_ntuple_depth2 run [num_envs] [num_steps] [chance_chunk] [launch_chunk]

Depth 2 feeds the leaf 65,536 afterstates per board per move
(``control/search.py``: 4 moves x 32 spawns x 4 moves x 32 spawns x 4
moves); 16,384 is the number of its depth-0 max nodes, whose afterstates
those are. On the card a leaf call is one launch of the value kernel, 16 a
move at ``chance_chunk`` 8.
``probe`` plays ``launch_chunk`` steps twice (the first pays the warm-up)
and projects the full run's time; ``run`` plays the first-episode row and
writes ``runs/ntuple_cuda/eval_depth2.json``.
"""

from __future__ import annotations

import time

from rein48_tpu_torch.device import resolve_device
from rein48_tpu_torch.examples import _recipe
from rein48_tpu_torch.train.ntuple import NTupleTrainConfig, evaluate_ntuple

TAG = "ntuple_cuda"
OUT = f"runs/{TAG}/eval_depth2.json"


def parse(argv=None) -> list:
    """``[mode, num_envs, num_steps, chance_chunk, launch_chunk]``."""
    return _recipe.positional(
        argv, (str, "probe"), (int, lambda mode: 8 if mode == "probe" else 32), (int, 20480), (int, 8), (int, 128)
    )


def make_config(saved: dict) -> NTupleTrainConfig:
    return _recipe.ntuple_config(saved)


def evaluations(mode: str, num_envs: int, num_steps: int, chance_chunk: int, launch_chunk: int) -> list:
    """``(tag, evaluate_ntuple keywords)``: two probe launches, or the row."""
    common = dict(depth=2, num_envs=num_envs, protocol="first", chance_chunk=chance_chunk, launch_chunk=launch_chunk)
    if mode == "probe":
        return [(tag, dict(common, num_steps=launch_chunk, seed=99)) for tag in ("compile+run", "steady")]
    return [("depth2", dict(common, num_steps=num_steps, seed=123))]


def main(argv=None, *, device=None) -> dict:
    mode, num_envs, num_steps, chance_chunk, launch_chunk = parse(argv)
    device = resolve_device(device)
    config, state, step, _, t_restore = _recipe.restore_ntuple(make_config, device, TAG)
    print(f"restored n-tuple checkpoint step {step} in {t_restore:.1f}s", flush=True)
    plan = evaluations(mode, num_envs, num_steps, chance_chunk, launch_chunk)

    def run(kwargs):
        return evaluate_ntuple(state.params, config, device=device, **kwargs)

    if mode == "probe":
        return _recipe.probe(plan, run, num_envs, num_steps)
    (_, kwargs), = plan
    t0 = time.perf_counter()
    stats = run(kwargs)
    wall = time.perf_counter() - t0
    stats["wall_sec"] = round(wall, 1)
    print("EVAL depth2:", stats, flush=True)
    out = {
        "checkpoint_step": step,
        "depth": 2,
        "num_envs": num_envs,
        "num_steps": num_steps,
        "chance_chunk": chance_chunk,
        "launch_chunk": launch_chunk,
        "sec_per_move_per_env": round(wall / (num_steps * num_envs), 6),
        "results": stats,
    }
    _recipe.write_json(OUT, out)
    return out


if __name__ == "__main__":
    main()

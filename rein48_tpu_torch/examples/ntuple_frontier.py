# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Capability per wall-clock second: per-step TD against delayed windows
(counterpart of ``examples/ntuple_frontier_tpu.py``).

    python -m rein48_tpu_torch.examples.ntuple_frontier [budget_sec] [out_json] [backend] [mode:window ...]

Every leg trains the flagship 4x6-tuple network (B=1024, 128 steps per
update) from ``init_ntuple`` at seed 0 for the same ``budget_sec`` of
stepping (the warm-up update excluded), then plays 512 greedy first
episodes. The default legs are per-step TD and delayed TD at windows 4, 16
and 64; a leg is ``mode:window``, the window ``none`` for a whole update.
``backend`` is a table backend of the port (``"torch"``, ``"mxu"``,
``"cached"``, ``"auto"``), the JAX name ``xla`` read as ``"torch"``. Writes
``runs/ntuple_frontier_cuda/frontier.json`` by default, after every leg.
"""

from __future__ import annotations

import sys

from rein48_tpu_torch.device import resolve_device
from rein48_tpu_torch.examples import _recipe
from rein48_tpu_torch.train.ntuple import NTupleTrainConfig

OUT = "runs/ntuple_frontier_cuda/frontier.json"
JAX_RECORDS = {OUT: "benchmarks/frontier_r3.json"}
KEYS_IN_LISTS = True
# The JAX package's "xla" backend is the port's "torch" (agents/ntuple.py).
JAX_BACKENDS = {"xla": "torch"}
LEGS = (("step", None), ("delayed", 4), ("delayed", 16), ("delayed", 64))
BATCH = 1024
CHECK_EVERY = 20


def adjust_jax_keys(keys: dict) -> None:
    """``frontier_r3.json`` predates the script's ``backend`` key
    (``ntuple_frontier_tpu.py:120-131``)."""
    keys[OUT]["legs"] = [dict(leg, backend=None) for leg in keys[OUT]["legs"]]


def parse_leg(leg: str) -> tuple:
    """``mode:window`` -> ``(mode, window)``, ``none`` as ``None``."""
    mode, window = leg.split(":")
    return mode, None if window.lower() == "none" else int(window)


def parse(argv=None) -> list:
    """``[budget_sec, out_json, backend, legs]``."""
    argv = sys.argv[1:] if argv is None else list(argv)
    budget, out, backend = _recipe.positional(argv[:3], (float, 420.0), (str, OUT), (str, "xla"))
    return [budget, out, JAX_BACKENDS.get(backend, backend), tuple(map(parse_leg, argv[3:])) or LEGS]


def make_config(mode: str, window: int | None, batch: int, backend: str) -> NTupleTrainConfig:
    return NTupleTrainConfig(
        batch_size=batch, steps_per_update=128, update_mode=mode, delay_window=window, table_backend=backend
    )


def evaluations() -> list:
    """``(tag, evaluate_ntuple keywords)`` of each leg's scoring."""
    return [("eval", dict(depth=0, num_envs=512, num_steps=16384, seed=321, protocol="first"))]


def legs(backend: str, modes: tuple) -> list:
    """``(label, record fields, config, check_every)`` of each leg."""
    return [
        (f"{mode}/{window}", {"mode": mode, "delay_window": window, "backend": backend},
         make_config(mode, window, BATCH, backend), CHECK_EVERY)
        for mode, window in modes
    ]


def main(argv=None, *, device=None) -> dict:
    budget, out, *spec = parse(argv)
    device = resolve_device(device)
    (_, evaluation), = evaluations()
    return _recipe.frontier(legs(*spec), evaluation, budget, out, device)


if __name__ == "__main__":
    main()

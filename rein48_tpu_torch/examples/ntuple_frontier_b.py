# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Capability per wall-clock second over the batch size (counterpart of
``examples/ntuple_frontier_b_tpu.py``).

    python -m rein48_tpu_torch.examples.ntuple_frontier_b [budget_sec] [out_json] [B ...]

Delayed TD at window 4 and 128 steps per update, the same ``budget_sec`` of
stepping at each batch size (1024, 4096 and 16384 by default), the clock
read every ``max(1, 20480 // B)`` updates, then 512 greedy first episodes,
as in :mod:`ntuple_frontier`. Writes
``runs/ntuple_frontier_b_cuda/frontier.json`` by default, after every leg.
"""

from __future__ import annotations

import sys

from rein48_tpu_torch.device import resolve_device
from rein48_tpu_torch.examples import _recipe
from rein48_tpu_torch.examples.ntuple_frontier import evaluations, make_config

OUT = "runs/ntuple_frontier_b_cuda/frontier.json"
JAX_RECORDS = {OUT: "benchmarks/frontier_r5.json"}
KEYS_IN_LISTS = True
BATCHES = (1024, 4096, 16384)


def parse(argv=None) -> list:
    """``[budget_sec, out_json, batches]``."""
    argv = sys.argv[1:] if argv is None else list(argv)
    budget, out = _recipe.positional(argv[:2], (float, 420.0), (str, OUT))
    return [budget, out, tuple(int(b) for b in argv[2:]) or BATCHES]


def legs(batches: tuple) -> list:
    """``(label, record fields, config, check_every)`` of each leg."""
    return [
        (f"B={batch}", {"batch_size": batch, "mode": "delayed", "delay_window": 4},
         make_config("delayed", 4, batch, "auto"), max(1, 20480 // batch))
        for batch in batches
    ]


def main(argv=None, *, device=None) -> dict:
    budget, out, *spec = parse(argv)
    device = resolve_device(device)
    (_, evaluation), = evaluations()
    return _recipe.frontier(legs(*spec), evaluation, budget, out, device)


if __name__ == "__main__":
    main()

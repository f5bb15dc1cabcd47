"""Readings that the limits of ``correct`` of the n-tuple search cells are
set from, on the card.

    python3 -m portbench.calibrate_search_ntuple <workload> --seeds N --control-seeds K [--faults [F,...]] [--fault-seeds M] [--seconds S] [--out FILE]

In one process, at the cell's own size, each run a short window of ``S``
seconds after set-up: the numbers compared for the program on ``N`` seeds;
for the control on ``K`` seeds (the reference put in the program's place
one precision below the configuration's: its tables stored in bfloat16,
the actions it puts first judged against float32); and with ``--faults``
for each planted fault of :data:`FAULTS` on ``M`` seeds (``K`` unless
given). Each line also gives the check's seconds (``check_s``), which size
the cell's ``checked_moves``. Prints one JSON line per reading, then a summary per
kind; the benchmark's own runs never run this.

The faults patch the port underneath the run for the length of a ``with``
block, as ``faults.py`` does:

* ``unchanged``: the engine returns the games unchanged;
* ``half``: half of the games play action 0;
* ``altered``: a quarter of the games' actions are turned by one;
* ``depth1``: the player searches one chance level less than the traffic says;
* ``dropped_table``: the value leaves the network's last table out.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from portbench import faults, harness
from portbench.drivers import search_ntuple

FAULTS = ("unchanged", "half", "altered", "depth1", "dropped_table")


def fault(name: str):
    from rein48_tpu_torch.agents import ntuple as agent
    from rein48_tpu_torch.train import ntuple as port

    if name == "unchanged":
        return faults.search_move("unchanged")
    if name == "dropped_table":
        inner_value = agent.NTupleNetwork.value
        zeros: dict = {}

        def dropped(self, params, boards):
            last = f"t{len(self.table_sizes) - 1}"
            t = params[last]
            z = zeros.setdefault((t.shape, t.device), torch.zeros_like(t))
            return inner_value(self, {**params, last: z}, boards)

        return faults._patch(agent.NTupleNetwork, "value", dropped)
    inner = port._get_ntuple_policy
    if name == "depth1":
        return faults._patch(port, "_get_ntuple_policy", lambda cfg, depth, cc=None: inner(cfg, depth - 1, cc))
    if name not in ("half", "altered"):
        raise ValueError(name)

    def build(cfg, depth, cc=None):
        policy = inner(cfg, depth, cc)

        def half(params, boards):
            n = boards.shape[0] // 2
            rest = torch.zeros(boards.shape[0] - n, dtype=torch.int64, device=boards.device)
            return torch.cat([policy(params, boards[:n]), rest])

        def altered(params, boards):
            a = policy(params, boards)
            return torch.where(faults._quarter(a.shape[0], a.device), (a + 1) % 4, a)

        return {"half": half, "altered": altered}[name]

    return faults._patch(port, "_get_ntuple_policy", build)


def played(cell, seed: int, device, seconds: float):
    """The driver's run after set-up and a window of ``seconds``, released."""
    ctx = harness.Ctx(cell=cell, seed=seed, device=device, sync=harness.make_sync(device))
    run = search_ntuple.setup(ctx)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        run.unit(None)
        ctx.sync()
    run.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return run


def fresh_players() -> None:
    """Drop the program's cached players, and the CUDA graphs they hold, so
    that each reading captures its own under the fault it runs with."""
    from rein48_tpu_torch.train import ntuple as port

    port._get_ntuple_policy.cache_clear()


def reading(cell, seed: int, device, seconds: float, control=None) -> dict:
    run = played(cell, seed, device, seconds)
    t0 = time.perf_counter()
    out = search_ntuple.judge(run.side, run.tables, cell, seed, device, control=control)
    out["check_s"] = time.perf_counter() - t0
    out["moves"] = len(run.side["boards"])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.calibrate_search_ntuple")
    p.add_argument("workload")
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--faults", nargs="?", const="all", default=None,
                   help="every planted fault, or those named, comma-separated")
    p.add_argument("--fault-seeds", type=int, default=None)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--first-seed", type=int, default=2_400_000_001)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    cell = harness.find_cell(a.workload)
    if cell.workload["driver"] != "search_ntuple":
        raise SystemExit(f"{a.workload} is not an n-tuple search cell; see portbench.calibrate")
    device = torch.device(a.device)
    out = open(a.out, "a") if a.out else sys.stdout
    kinds = [("program", a.seeds, None), ("control", a.control_seeds, None)]
    if a.faults:
        n = a.control_seeds if a.fault_seeds is None else a.fault_seeds
        kinds += [(f"fault:{f}", n, f) for f in FAULTS if a.faults == "all" or f in a.faults.split(",")]
    readings: dict = {}
    for kind, n, name in kinds:
        for i in range(n):
            seed = a.first_seed + 7919 * i
            t0 = time.perf_counter()
            fresh_players()
            if kind == "control":
                r = reading(cell, seed, device, a.seconds, control=torch.bfloat16)
            elif name is None:
                r = reading(cell, seed, device, a.seconds)
            else:
                with fault(name):
                    r = reading(cell, seed, device, a.seconds)
            line = {"workload": a.workload, "kind": kind, "seed": seed, "s": round(time.perf_counter() - t0, 2), **r}
            print(json.dumps(line), file=out, flush=True)
            readings.setdefault(kind, []).append(r)
    for kind, rs in readings.items():
        summary = {k: {"min": min(r[k] for r in rs), "median": statistics.median(r[k] for r in rs),
                       "max": max(r[k] for r in rs)} for k in rs[0]}
        print(json.dumps({"workload": a.workload, "summary": kind, **summary}), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

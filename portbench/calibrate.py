"""Readings that the limits of ``correct`` are set from, on the card.

    python3 -m portbench.calibrate <workload> --seeds N --control-seeds K [--faults [F,...]] [--seconds S] [--out FILE]

In one process, at the cell's own size: the numbers compared for the
program on ``N`` seeds, for the control (the reference put in the
program's place one precision below the configuration's: fp8 for the bf16
tower, bfloat16 for the float32 tables) on ``K`` seeds, and with
``--faults`` for each planted fault of ``faults.py`` on ``K`` seeds. The
trainers' readings need no window; the search cell's program reads a short
one of ``S`` seconds. Prints one JSON line per reading; the benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from portbench import faults, harness
from portbench.drivers import ntuple_update, ppo_update, search_move
from portbench.reference import ntuple as ref_ntuple
from portbench.reference import ppo as ref_ppo
from portbench.reference import resnet as ref_resnet


def program(cell, seed: int, device, seconds: float) -> dict:
    """The program's numbers on one seed: set-up's units (and, for a cell
    that is not a trainer, a short window), then the check."""
    ctx = harness.Ctx(cell=cell, seed=seed, device=device, sync=harness.make_sync(device))
    run = harness.load_module("drivers", cell.workload["driver"], cell.pkg).setup(ctx)
    if cell.workload["driver"] == "search_move":
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            run.unit(None)
            ctx.sync()
    run.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return run.check()


def control(cell, seed: int, device, seconds: float) -> dict:
    """The control's numbers on one seed."""
    driver = cell.workload["driver"]
    if driver == "ppo_update":
        cfg, c = cell.traffic["ppo"], cell.config
        w0 = ref_resnet.make_params(c, seed, device)
        lr = ref_ppo.new_learner(w0, seed, cfg["batch_size"], device)
        side = {"updates": [ref_ppo.update(lr, cfg, seed, c, quant=ref_resnet.fp8)
                            for _ in range(ppo_update.CHECK_UPDATES)]}
        side["change"] = {k: float(torch.linalg.vector_norm(lr.params[k] - w0[k])) for k in w0}
        side.update(minibatches=lr.first_minibatches, unused=lr.first_unused, first_grad=ppo_update.norms(lr.first_grad))
        del lr
        return ppo_update.judge(side, w0, cell, seed, device)
    if driver == "ntuple_update":
        t, c = cell.traffic, cell.config
        lr = ref_ntuple.new_learner(c["tuples"], seed, t["batch_size"], device, bf16=True)
        side = {"updates": []}
        for u in range(ntuple_update.CHECK_UPDATES):
            side["updates"].append(ref_ntuple.update(lr, t["steps_per_update"], t["delay_window"], c["alpha"]))
            if u == 0:
                side["first"] = ref_ntuple.leaf_norms(lr)
        side["last"] = ref_ntuple.leaf_norms(lr)
        del lr
        return ntuple_update.judge(side, cell, seed, device)
    ctx = harness.Ctx(cell=cell, seed=seed, device=device, sync=harness.make_sync(device))
    run = search_move.Run(ctx)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        run.unit(None)
    run.release()
    return search_move.judge(run.side, run.weights, cell, seed, device, control=ref_resnet.fp8)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.calibrate")
    p.add_argument("workload")
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--faults", nargs="?", const="all", default=None,
                   help="every planted fault of the cell's driver, or those named, comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--first-seed", type=int, default=2_400_000_001)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    cell = harness.find_cell(a.workload)
    device = torch.device(a.device)
    out = open(a.out, "a") if a.out else sys.stdout
    kinds = [("program", a.seeds, None), ("control", a.control_seeds, None)]
    if a.faults:
        planted = faults.FAULTS[cell.workload["driver"]]
        kinds += [(f"fault:{f}", a.control_seeds, f) for f in planted if a.faults == "all" or f in a.faults.split(",")]
    readings: dict = {}
    for kind, n, fault in kinds:
        for i in range(n):
            seed = a.first_seed + 7919 * i
            t0 = time.perf_counter()
            if kind == "control":
                r = control(cell, seed, device, a.seconds)
            elif fault is None:
                r = program(cell, seed, device, a.seconds)
            else:
                with getattr(faults, cell.workload["driver"])(fault):
                    r = program(cell, seed, device, a.seconds)
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

#!/usr/bin/env python3
# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Smoke test of the PyTorch/CUDA port (``rein48_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``rein48_tpu_torch/csrc`` with ``nvcc``, holds
each kernel against its plain PyTorch version at the shapes its main path
gives it, drives the port's main paths through their entry points (the
``bench`` rollout, full-width ResNet depth-0/depth-1 ``evaluate_search``,
the ``SJ_2X4`` n-tuple trainer ``train_ntuple`` in both update modes with
its depth-0/depth-1 ``evaluate_ntuple``, the ``YEH_4X6`` trainer on the
``"cached"`` hot-prefix backend in both update modes with its depth-0
``evaluate_ntuple``, and ``train --algo ntuple`` of the CLI), checks what
comes out, and prints one line per phase. Each path runs
with the kernels' launch counts set to 0 just before it and read just
after. A failing phase raises, so the script exits non-zero. The
second-to-last line is a JSON object describing every ported kernel; the
last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Without a CUDA device it exits 1 and prints no result. It imports no JAX.
"""

from __future__ import annotations

import ast
import contextlib
import dataclasses
import io
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 20260
BENCH_B, BENCH_T, BENCH_ROUNDS = 65536, 2048, 8
# The card's rates (H100 SXM data sheet: 67 TFLOP/s float32 is 132 SMs x
# 128 lanes x 2 flops x 1.98 GHz; HBM3 at 3.35 TB/s). An SM issues four
# warp instructions (128 thread instructions) per clock, and its INT32 pipe
# has 64 lanes (CUDA C++ Programming Guide, arithmetic instruction
# throughput for compute capability 9.0: 64 results per clock per SM for
# 32-bit integer add, compare, logic and shift).
ISSUE_PER_S = 132 * 128 * 1.98e9
INT32_PIPE_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
# SASS opcodes counted on the INT32 pipe. IMAD, VIADD and the like may run
# on the FMA pipe, so they count toward the issue bound only.
INT32_PIPE_OPS = {"IADD3", "LOP3", "ISETP", "SEL", "SHF", "PRMT", "IMNMX", "LEA", "PLOP3", "FLO", "POPC"}
# Depth-1 q-values of the bf16 net on the card against the float32 net on
# the CPU: a leaf value in [0.4, 1.4] rounds to 2**-7 steps in bf16 and the
# tower rounds ~10 times; the leaf error measured 0.012 and the q error
# 0.007 with bf16 on the CPU. 0.04 leaves 3x over the leaf error.
Q_BF16_TOL = 0.04
# The n-tuple trainer on the "mxu" path at the shape the JAX package measures
# it (examples/bench_mxu_trainer_tpu.py:54-60): SJ_2X4 (2 tables of 65,536
# entries, 8 lookups each), B=1024, 128 steps per update.
NT_B, NT_T = 1024, 128
NT_UPDATES = {"step": 16, "delayed": 8}  # step mode's tables are then played
NT_EVAL_ENVS, NT_EVAL_STEPS = 512, 2000
NT_D1_ENVS, NT_D1_STEPS = 256, 48
# The "cached" trainer at the flagship's width and the JAX package's cached
# defaults (examples/bench_cached_trainer_tpu.py:51-57): YEH_4X6 (4 tables of
# 16,777,216 entries), 2048 prefix rows, 16 cold rows per block, B=1024,
# T=128, delayed/4 with TC; a refresh every 2 updates, so that one falls
# inside the run. 8192 prefix rows (NTupleConfig's default) runs only if
# 2048 never takes the fast branch.
HP_PREFIX_ROWS = (2048, 8192)
HP_UPDATES = {"delayed": 4, "step": 2}
HP_REFRESH_EVERY = 2
HP_EVAL_ENVS, HP_EVAL_STEPS = 512, 1500
# Scatter sums are reassociated (atomics, in an order that changes from run
# to run; index_add_ on the card uses atomics too). The rounding of a float32
# sum grows with the magnitude of its terms, not of its result, so a sum of
# thousands of TD errors that nearly cancels has no small elementwise relative
# error. Entries are held at |got - want| <= ATOL + RTOL * S, where S is what
# the same computation gives on the absolute values of its inputs (the sum of
# |terms|); S = |want| where no term cancels. RTOL, ATOL are the tolerance
# of tests/test_ntuple.py::TestMXUBackend.
TABLE_RTOL, TABLE_ATOL = 1e-5, 1e-6


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def cuda_ms(fn, reps: int = 1) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rollout_max_err(a, b) -> int:
    """Largest absolute difference over every output of two rollouts."""
    (sa, ta), (sb, tb) = a, b
    pairs = [(sa.boards, sb.boards), (sa.score, sb.score), (sa.steps, sb.steps)]
    pairs += [(getattr(ta, f), getattr(tb, f)) for f in ("episodes", "episode_length_sum", "episode_score_sum", "max_exponent")]
    return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max()) for x, y in pairs)


def fixed_boards(n: int, seed: int) -> np.ndarray:
    """Boards from sparse to full, made from a seed."""
    rng = np.random.default_rng(seed)
    fill = rng.uniform(0.0, 1.0, size=(n, 1, 1))
    exps = rng.integers(1, 12, size=(n, 4, 4))
    return np.where(rng.uniform(size=(n, 4, 4)) > fill, 0, exps).astype(np.uint8)


def sass_per_step(lib, kernel: str, steps_per_iteration: int) -> tuple[float, float]:
    """SASS instructions per env-step of a kernel's main loop: (all, INT32 pipe).

    Disassembles the built library with ``cuobjdump`` and takes the loop
    closed by the function's longest backward branch. It counts the
    shortest path through that loop, so that the bound stays a lower
    bound: a branch inside a BSSY..BSYNC region (divergent control flow)
    may go either way; a conditional branch outside one is warp-uniform
    (the ``t0 + j < num_steps`` guards) and falls through when T is a
    multiple of ``steps_per_iteration``, as at the bench shape.
    """
    from rein48_tpu_torch import build

    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    func = next(f for f in sass.split("Function : ")[1:] if kernel in f.split("\n", 1)[0])
    ins = []  # (address, conditional, opcode, target)
    for addr, pred, op, rest in re.findall(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", func):
        target = re.search(r"0x([0-9a-f]+)", rest)
        cond = bool(pred) or bool(re.match(r"\s*!?U?P\d", rest))
        ins.append((int(addr, 16), cond, op.split(".")[0], int(target.group(1), 16) if target else None))
    index = {a: i for i, (a, *_) in enumerate(ins)}
    back = [i for i, (a, _, op, t) in enumerate(ins) if op == "BRA" and t is not None and t < a]
    end = max(back, key=lambda i: i - index[ins[i][3]])
    start = index[ins[end][3]]
    region = set()
    for i in range(start, end):
        if ins[i][2] == "BSSY":
            region.update(range(i, index[ins[i][3]] + 1))
    dist, prev = {start: 1}, {}
    for i in range(start, end):
        if i not in dist:
            continue
        _, cond, op, t = ins[i]
        nxt = [i + 1]
        if op == "BRA":
            if index[t] <= i:
                raise AssertionError(f"inner backward branch at {ins[i][0]:#x}")
            nxt = [index[t]] if not cond else [i + 1, index[t]] if i in region else [i + 1]
        for j in nxt:
            if j <= end and dist[i] + 1 < dist.get(j, len(ins) + 1):
                dist[j], prev[j] = dist[i] + 1, i
    path = [end]
    while path[-1] != start:
        path.append(prev[path[-1]])
    pipe = sum(ins[i][2] in INT32_PIPE_OPS for i in path)
    return len(path) / steps_per_iteration, pipe / steps_per_iteration


def timed(fn, reps: int = 50) -> dict:
    """Device and host time of one call of ``fn()``, after an untimed call.

    ``ms`` sums the device time of every kernel ``fn`` launches (the
    profiler's CUDA activity), so a launch-bound call is not timed by its
    host; ``call_ms`` is the host-bound time per call of a back-to-back
    loop (CUDA events); ``kernels`` the device time of each kernel.
    """
    from rein48_tpu_torch.utils import profiling

    r = profiling.device_breakdown(fn, warmup=1, reps=reps, top=4)
    call_ms = cuda_ms(fn, reps)
    return {"ms": r["device_ms"], "call_ms": call_ms, "kernels": {t["kernel"][:40]: t["ms"] for t in r["top"]}}


def zero_table_counts() -> None:
    """Set the launch counts of both table modules and the cached window
    branch counts to 0."""
    from rein48_tpu_torch.agents import ntuple
    from rein48_tpu_torch.ops import hbm_tables, tables

    for counts in (tables.launches, hbm_tables.launches, ntuple.cached_windows):
        for k in counts:
            counts[k] = 0


def close_tables(got, want, scales) -> tuple[bool, float, float]:
    """Each ``got`` against ``want`` at ``TABLE_ATOL + TABLE_RTOL * scale``.

    Returns (all within, largest absolute difference, largest difference
    over what the tolerance allows: at most 1 when all are within).
    """
    err, ratio = 0.0, 0.0
    for g, w, sc in zip(got, want, scales):
        d = (g - w).abs()
        err = max(err, float(d.max()))
        ratio = max(ratio, float((d / (TABLE_ATOL + TABLE_RTOL * sc)).max()))
    return ratio <= 1.0, err, ratio


class Clock:
    """A trainer logger that keeps each record with the host time it came."""

    def __init__(self):
        self.records = []

    def write(self, record):
        self.records.append((time.perf_counter(), record))

    def per_update_s(self) -> list[float]:
        t = [at for at, _ in self.records]
        return [b - a for a, b in zip(t, t[1:])]


def ntuple_trainer_inputs(dev):
    """A state a few updates into SJ_2X4 training, and what its steps feed the kernels.

    Returns ``(state, net, gathers, window)``: ``gathers`` maps a call of
    ``value`` to the lookup indices of table 0 it gathers; ``window`` holds
    the backups of four steps with the tables frozen, as ``(boards, errs)``
    pairs, the first of which is one "step" update.
    """
    from rein48_tpu_torch.agents import ntuple
    from rein48_tpu_torch.train import ntuple as nt

    cfg = nt.NTupleTrainConfig(tuples=ntuple.SJ_2X4, batch_size=NT_B, steps_per_update=NT_T)
    state, net = nt.init_ntuple(cfg, SEED, dev)
    step = nt.make_ntuple_step(cfg, dev)
    for _ in range(3):
        state, _ = step(state)
    with torch.no_grad():
        after, _, _ = nt._all_afterstates(state.env.boards)
        gathers = {"value(afterstates)": net.indices(after)[0], "value(prev_after)": net.indices(state.prev_after)[0]}
        env, prev_after, prev_valid, window = state.env, state.prev_after, state.prev_valid, []
        for _ in range(4):
            env, prev_after, done, boards, errs, _ = nt._policy_and_backups(net, state.params, env, prev_after, prev_valid)
            prev_valid = 1.0 - done
            window.append((boards, errs))
    return state, net, gathers, window


def table_kernel_phase(state, net, gathers, window):
    """The table kernels against their plain versions at the main path's
    shapes, their times, the library call's, and the bound by bytes."""
    from rein48_tpu_torch.ops import tables

    table = state.params["t0"]
    size = table.numel()
    lookups = net.num_lookups // len(net.table_sizes)

    gather = {}
    for what, idx in gathers.items():
        got, want = tables.mxu_gather(table, idx), tables.gather_reference(table, idx)
        equal = bool(torch.equal(got, want))
        n = idx.numel()
        touched = int(torch.unique(idx).numel())
        k = timed(lambda idx=idx: tables.mxu_gather(table, idx))
        # The library call is table[idx], which is also the plain version.
        p = timed(lambda idx=idx: tables.gather_reference(table, idx))
        # Each index read and each value written once, each touched entry read once.
        bound_ms = 1e3 * (8 * n + 4 * touched) / HBM_BYTES_PER_S
        log("tables/gather", call=what, n=n, table=size, touched=touched, equal=equal, ms=k["ms"],
            call_ms=round(k["call_ms"], 5), plain_ms=p["ms"], plain_call_ms=round(p["call_ms"], 5),
            bound_ms=round(bound_ms, 6), kernels=json.dumps(k["kernels"]), plain_kernels=json.dumps(p["kernels"]))
        if not equal:
            raise AssertionError(f"gather kernel differs from table[idx] ({what})")
        gather[what] = dict(n=n, ms=k["ms"], plain_ms=p["ms"], library_ms=p["ms"], bound_ms=bound_ms)

    scatter = {}
    forms = [("stats", 1), ("stats", 4), ("sum", 1)]  # one "step" update, a delayed window of 4
    for form, steps in forms:
        boards = torch.cat([b for b, _ in window[:steps]])
        errs = torch.cat([e for _, e in window[:steps]])
        idx = net.indices(boards)[0].reshape(-1)
        vals = errs[:, None].expand(-1, lookups).reshape(-1).contiguous()
        stats = form == "stats"
        if stats:
            got = tables.mxu_scatter_stats(size, idx, vals)
            kernel = lambda idx=idx, vals=vals: tables.mxu_scatter_stats(size, idx, vals)
        else:
            got = (tables.mxu_scatter_sum(size, idx, vals),)
            kernel = lambda idx=idx, vals=vals: tables.mxu_scatter_sum(size, idx, vals)
        want = tables.scatter_reference(size, idx, vals, stats)
        abs_terms = tables.scatter_reference(size, idx, vals.abs(), stats=False)[0]
        ok, err, ratio = close_tables(got[:2], want[:2], [abs_terms, abs_terms])
        hits_equal = not stats or bool(torch.equal(got[2], want[2]))
        again = kernel() if stats else (kernel(),)
        rerun_equal = all(bool(torch.equal(a, b)) for a, b in zip(again, got))
        n = idx.numel()
        k = timed(kernel)
        p = timed(lambda idx=idx, vals=vals, stats=stats: tables.scatter_reference(size, idx, vals, stats))
        chans = [vals, vals.abs(), (vals != 0).to(torch.float32)] if stats else [vals]

        def library(idx=idx, chans=chans):
            out = torch.zeros((len(chans), size), dtype=torch.float32, device=idx.device)
            for row, c in zip(out, chans):
                row.index_add_(0, idx, c)

        lib = timed(library)
        # Each index and value read once, each dense output written once.
        bound_ms = 1e3 * (8 * n + 4 * size * len(chans)) / HBM_BYTES_PER_S
        hot = int(torch.bincount(idx[vals != 0], minlength=size).max())
        log("tables/scatter", form=form, n=n, table=size, zeros=int((vals == 0).sum()), hottest_entry_hits=hot,
            within_tol=ok, hits_equal=hits_equal, max_abs_err=f"{err:.3g}", err_over_tol=f"{ratio:.3g}",
            second_run_bit_equal=rerun_equal, ms=k["ms"], call_ms=round(k["call_ms"], 5), plain_ms=p["ms"],
            plain_call_ms=round(p["call_ms"], 5), library_ms=lib["ms"], library_call_ms=round(lib["call_ms"], 5),
            bound_ms=round(bound_ms, 6), kernels=json.dumps(k["kernels"]), library_kernels=json.dumps(lib["kernels"]))
        if not (ok and hits_equal):
            raise AssertionError(f"scatter kernel ({form}, n={n}) disagrees with its plain version")
        scatter[(form, n)] = dict(n=n, ms=k["ms"], plain_ms=p["ms"], library_ms=lib["ms"], bound_ms=bound_ms, err=err, ratio=ratio)
    return gather, scatter


def ntuple_network_phase(state, net, window):
    """``"mxu"`` against ``"torch"`` on the card: value and the TD updates."""
    from rein48_tpu_torch.train import ntuple as nt

    plain = nt.get_network(dataclasses.replace(net.config, backend="torch"))
    boards = torch.cat([b for b, _ in window])
    errs = torch.cat([e for _, e in window])
    with torch.no_grad():
        equal = bool(torch.equal(net.value(state.params, boards), plain.value(state.params, boards)))
        log("ntuple/mxu-vs-torch", fn="value", boards=boards.shape[0], equal=equal)
        ok, worst = equal, 0.0
        checks = [("td_apply_tc", lambda n, p, e: n.td_apply_tc(p, window[0][0], e, 1.0), window[0][1], True)]
        for tc in (True, False):
            checks.append((f"td_apply_delayed(tc={tc})", lambda n, p, e, tc=tc: n.td_apply_delayed(p, boards, e, 1.0, tc=tc), errs, tc))
        for name, fn, e, tc in checks:
            keys = [k for k in state.params if tc or "_" not in k]
            a = fn(net, {k: state.params[k].clone() for k in keys}, e)
            b = fn(plain, {k: state.params[k].clone() for k in keys}, e)
            # The same update on absolute values bounds each entry's terms.
            scale = fn(plain, {k: state.params[k].abs() for k in keys}, e.abs())
            ok_k, err_k, ratio = close_tables([a[k] for k in keys], [b[k] for k in keys], [scale[k] for k in keys])
            log("ntuple/mxu-vs-torch", fn=name, within_tol=ok_k, max_abs_err=f"{err_k:.3g}", err_over_tol=f"{ratio:.3g}")
            ok &= ok_k
            worst = max(worst, err_k)
    if not ok:
        raise AssertionError("the mxu backend disagrees with the torch backend on the card")
    return worst


def paired_updates(dev, mode: str, backends=("mxu", "torch"), rounds: int = 2, **cfg) -> dict:
    """Host seconds per update of ``make_ntuple_step`` under two backends,
    taken in turns (a, b, b, a) after a warm-up update each through
    ``train_ntuple``, so that both backends see the same host. ``cfg``
    defaults to SJ_2X4; ``"cached"`` refreshes its permutation after the
    warm-up, from real heat."""
    from rein48_tpu_torch.agents import ntuple
    from rein48_tpu_torch.train import ntuple as nt

    cfg = {"tuples": ntuple.SJ_2X4, **cfg}
    states, steps, times = {}, {}, {b: [] for b in backends}
    for backend in backends:
        c = nt.NTupleTrainConfig(batch_size=NT_B, steps_per_update=NT_T, update_mode=mode, table_backend=backend, **cfg)
        steps[backend] = nt.make_ntuple_step(c, dev)
        state = nt.train_ntuple(c, 1, seed=SEED, device=dev)[0]
        net = nt.get_network(c.network_config(dev))
        states[backend] = dataclasses.replace(state, params=net.refresh_cache(state.params))
    a, b = backends
    for _ in range(rounds):
        for backend in (a, b, b, a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states[backend], metrics = steps[backend](states[backend])
            float(metrics["td_abs_err"])  # waits for the update
            times[backend].append(time.perf_counter() - t0)
    return times


def ntuple_trainer_phase(dev):
    """``train_ntuple`` through its entry point with ``table_backend="auto"``
    (the kernels) in both update modes, ``"mxu"`` against ``"torch"`` paired
    update by update, and depth-0 play of the trained tables against the
    untrained ones."""
    from rein48_tpu_torch.agents import ntuple
    from rein48_tpu_torch.ops import tables
    from rein48_tpu_torch.train import ntuple as nt

    launched = {k: 0 for k in tables.launches}
    trained = None
    for mode, updates in NT_UPDATES.items():
        cfg = nt.NTupleTrainConfig(tuples=ntuple.SJ_2X4, batch_size=NT_B, steps_per_update=NT_T, update_mode=mode)
        resolved = cfg.network_config(dev).backend
        if resolved != "mxu":
            raise AssertionError(f"table_backend='auto' resolved to {resolved!r} for SJ_2X4 on {dev}")
        clock = Clock()
        zero_table_counts()
        state, history = nt.train_ntuple(cfg, updates, seed=SEED, log_every=1, logger=clock, device=dev)
        counts = dict(tables.launches)
        # Per env step: 2 tables x (afterstates + prev_after) gathers; per
        # step ("step") or per window ("delayed"), one stats scatter per table.
        scatters = NT_T if mode == "step" else NT_T // cfg.delay_window
        want = {"table_gather": 4 * NT_T * updates, "table_scatter": 2 * scatters * updates}
        if counts != want:
            raise AssertionError(f"train_ntuple({mode}) launched {counts}, expected {want}")
        for k in launched:
            launched[k] += counts[k]
        rates = [NT_B * NT_T / dt for dt in clock.per_update_s()]  # after the first update
        last = history[-1]
        log(
            "ntuple/train", mode=mode, table_backend="auto", resolved=resolved, B=NT_B, T=NT_T, updates=updates,
            launches=json.dumps(counts), launches_per_update=json.dumps({k: v // updates for k, v in counts.items()}),
            env_steps_per_s_median=round(float(np.median(rates)), 1), env_steps_per_s=[round(r, 1) for r in rates],
            td_abs_err=round(last["td_abs_err"], 4), avg_episode_score=round(last["avg_episode_score"], 1),
            best_tile=last["best_tile"],
        )
        if not all(np.isfinite(v) for v in last.values()):
            raise AssertionError(f"train_ntuple({mode}) metrics not finite: {last}")
        if mode == "step":
            trained = state
        times = paired_updates(dev, mode)
        log("ntuple/train-paired", mode=mode, tuples="SJ_2X4", order="mxu,torch,torch,mxu x2", **{
            f"{b}_env_steps_per_s": [round(NT_B * NT_T / t, 1) for t in ts] for b, ts in times.items()
        }, mxu_over_torch=round(float(np.median(times["torch"]) / np.median(times["mxu"])), 4))
    cfg = nt.NTupleTrainConfig(tuples=ntuple.SJ_2X4)
    net = nt.get_network(cfg.network_config(dev))
    scores = {}
    for name, params in (("untrained", net.init_tc(dev)), ("trained", trained.params)):
        zero_table_counts()
        t0 = time.perf_counter()
        stats = nt.evaluate_ntuple(
            params, cfg, depth=0, num_envs=NT_EVAL_ENVS, num_steps=NT_EVAL_STEPS, seed=SEED, protocol="first", device=dev
        )
        wall = time.perf_counter() - t0
        for k in launched:
            launched[k] += tables.launches[k]
        scores[name] = stats["avg_score"]
        log("ntuple/eval-depth0", tables=name, envs=NT_EVAL_ENVS, steps=NT_EVAL_STEPS, wall_s=round(wall, 3),
            gathers=tables.launches["table_gather"], stats=json.dumps({k: round(v, 3) for k, v in stats.items()}))
    if not scores["trained"] > 1.3 * scores["untrained"]:
        raise AssertionError(f"trained tables do not beat the untrained ones at depth 0: {scores}")
    return trained, launched


def ntuple_depth1_phase(trained, dev):
    """Depth-1 ``evaluate_ntuple`` with the trained tables, timed after a
    warm-up, and every chosen action legal."""
    from rein48_tpu_torch.agents import ntuple
    from rein48_tpu_torch.engine import core, vector
    from rein48_tpu_torch.ops import tables
    from rein48_tpu_torch.train import evaluate
    from rein48_tpu_torch.train import ntuple as nt

    cfg = nt.NTupleTrainConfig(tuples=ntuple.SJ_2X4)

    def run(num_steps):
        return nt.evaluate_ntuple(
            trained.params, cfg, depth=1, num_envs=NT_D1_ENVS, num_steps=num_steps, seed=SEED + 5,
            protocol="first", chance_chunk=4, device=dev,
        )

    run(4)  # untimed warm-up at the same shapes
    walls = []
    zero_table_counts()
    for _ in range(2):
        t0 = time.perf_counter()
        stats = run(NT_D1_STEPS)
        walls.append(time.perf_counter() - t0)
    launched = dict(tables.launches)
    # Per step: 8 chance chunks, each of envs x 64 leaf boards that make_leaf
    # cuts into chunks of 4,096, each gathering from 2 tables (64 at 256 envs).
    per_step = 8 * -(-NT_D1_ENVS * 64 // 4096) * 2
    if launched != {"table_gather": per_step * 2 * NT_D1_STEPS, "table_scatter": 0}:
        raise AssertionError(f"depth-1 evaluate_ntuple launched {launched}")
    if not all(np.isfinite(v) for v in stats.values()) or stats["episodes"] != NT_D1_ENVS:
        raise AssertionError(f"depth-1 n-tuple stats malformed: {stats}")
    log("ntuple/eval-depth1", envs=NT_D1_ENVS, steps=NT_D1_STEPS, chance_chunk=4, launches=json.dumps(launched),
        ms_per_step=[round(1e3 * w / NT_D1_STEPS, 3) for w in walls], stats=json.dumps({k: round(v, 3) for k, v in stats.items()}))

    policy = nt._get_ntuple_policy(cfg.network_config(dev), 1, 4)
    bad = torch.zeros((), dtype=torch.int64, device=dev)

    def checked(boards):
        nonlocal bad
        actions = policy(trained.params, boards)
        legal = core.legal_action_mask(boards)
        bad = bad + (legal.any(-1) & ~legal.gather(-1, actions[:, None])[:, 0]).sum()
        return actions

    with torch.no_grad():
        evaluate._first_episode_rollout(vector.reset_batch(SEED + 5, NT_D1_ENVS, dev), policy_fn=checked, num_steps=32)
    log("ntuple/eval-depth1/legal", steps=32, illegal_choices=int(bad))
    if int(bad):
        raise AssertionError("depth-1 n-tuple planner chose an illegal action")
    return launched


def logical_tables(params: dict) -> dict:
    """The float tables of a ``"cached"`` state in logical order (new tensors)."""
    from rein48_tpu_torch.ops import hbm_tables

    out = {}
    for k, v in params.items():
        if v.dtype == torch.float32:
            rows = torch.arange(v.numel(), dtype=torch.int32, device=v.device)
            out[k] = v[hbm_tables.physical_index(params[k.split("_")[0] + "_rm"], rows)]
    return out


def cached_trainer_inputs(dev):
    """A YEH_4X6 ``"cached"`` state two delayed updates in, just refreshed,
    and what its steps feed the hot-prefix kernels.

    Returns ``(state, net, idx, window)``: ``idx`` the lookup indices of
    table 0 that ``value(afterstates)`` gathers (32,768), ``window`` the
    backups of four steps with the tables frozen, as ``(boards, errs)``.
    """
    from rein48_tpu_torch.train import ntuple as nt

    cfg = nt.NTupleTrainConfig(batch_size=NT_B, steps_per_update=NT_T, update_mode="delayed", table_backend="cached")
    state, net = nt.train_ntuple(cfg, 2, seed=SEED + 7, log_every=2, device=dev)[0], nt.get_network(cfg.network_config(dev))
    state = dataclasses.replace(state, params=net.refresh_cache(state.params))
    with torch.no_grad():
        idx = net.indices(nt._all_afterstates(state.env.boards)[0])[0]
        env, prev_after, prev_valid, window = state.env, state.prev_after, state.prev_valid, []
        for _ in range(4):
            env, prev_after, done, boards, errs, _ = nt._policy_and_backups(net, state.params, env, prev_after, prev_valid)
            prev_valid = 1.0 - done
            window.append((boards, errs))
    boards = torch.cat([b for b, _ in window])
    return state, net, idx, (boards, torch.cat([e for _, e in window]))


def hbm_kernel_phase(state, net, idx, window):
    """The hot-prefix kernels against their plain versions at the trainer's
    shapes, their times, the plain versions', and the bound by bytes."""
    from rein48_tpu_torch.ops import hbm_tables

    p = state.params
    table, rm, hot, k = p["t0"], p["t0_rm"], p["t0_hot"], net.prefix_rows[0]
    cap = net.config.cold_capacity_rows * hbm_tables.ROW

    got = hbm_tables.cached_gather(table, rm, hot, idx, prefix_rows=k)
    equal = bool(torch.equal(got, hbm_tables.cached_gather_reference(table, rm, idx)))
    n = idx.numel()
    rows, touched = int(torch.unique(idx >> 7).numel()), int(torch.unique(idx).numel())
    hot_share = float(torch.isin(idx >> 7, hot).float().mean())
    kt = timed(lambda: hbm_tables.cached_gather(table, rm, hot, idx, prefix_rows=k))
    # The library call is table[physical_index(rm, idx)], which is also the plain version.
    pt = timed(lambda: hbm_tables.cached_gather_reference(table, rm, idx))
    # Each index read and each value written once, each touched row-map and table entry read once.
    bound_ms = 1e3 * (8 * n + 4 * rows + 4 * touched) / HBM_BYTES_PER_S
    log("hbm/gather", call="value(afterstates)", n=n, table=table.numel(), prefix_rows=k, hot_share=round(hot_share, 4),
        touched_rows=rows, touched=touched, equal=equal, ms=kt["ms"], call_ms=round(kt["call_ms"], 5), plain_ms=pt["ms"],
        plain_call_ms=round(pt["call_ms"], 5), bound_ms=round(bound_ms, 6), kernels=json.dumps(kt["kernels"]),
        plain_kernels=json.dumps(pt["kernels"]))
    if not equal:
        raise AssertionError("cached_gather kernel differs from table[physical_index(rm, idx)]")
    gather = dict(n=n, ms=kt["ms"], plain_ms=pt["ms"], library_ms=pt["ms"], bound_ms=bound_ms)

    boards, errs = window
    lookups = net.num_lookups // len(net.table_sizes)
    sidx = net.indices(boards)[0].reshape(-1)
    d = errs[:, None].expand(-1, lookups).reshape(-1).contiguous()
    got = hbm_tables.cached_scatter_blocks(hot, sidx, d, prefix_rows=k)
    want = hbm_tables.cached_scatter_stats_reference(hot, sidx, d)
    # want[1] sums |err| per entry: the magnitudes of each sum's terms.
    ok, err, ratio = close_tables(got[:2], want[:2], [want[1], want[1]])
    exact = {name: bool(torch.equal(g, w)) for name, g, w in zip(("hits", "cold_idx", "cold_err", "counts"), got[2:], want[2:])}
    counts = got[5]
    ns = sidx.numel()
    n_blocks = counts.numel()
    kt = timed(lambda: hbm_tables.cached_scatter_stats(hot, sidx, d, prefix_rows=k))
    pt = timed(lambda: hbm_tables.cached_scatter_stats_reference(hot, sidx, d), reps=10)
    # Each index and error read once; the three [K, 128] sums, the residue and the counts written once.
    bound_ms = 1e3 * (8 * ns + 3 * 4 * k * hbm_tables.ROW + 8 * n_blocks * cap + 4 * n_blocks) / HBM_BYTES_PER_S
    log("hbm/scatter", call="one delayed window", n=ns, prefix_rows=k, capacity=cap,
        hot_share=round(1.0 - float(counts.sum()) / ns, 4), cold_per_block=counts.tolist(),
        overflow=bool(counts.max() > cap), hottest_entry_hits=int(got[2].max()), within_tol=ok, exact=json.dumps(exact),
        max_abs_err=f"{err:.3g}", err_over_tol=f"{ratio:.3g}", ms=kt["ms"], call_ms=round(kt["call_ms"], 5),
        plain_ms=pt["ms"], plain_call_ms=round(pt["call_ms"], 5), bound_ms=round(bound_ms, 6),
        kernels=json.dumps(kt["kernels"]), plain_kernels=json.dumps(pt["kernels"]))
    if not (ok and all(exact.values())):
        raise AssertionError("cached_scatter kernel disagrees with its plain version")
    return gather, dict(n=ns, ms=kt["ms"], plain_ms=pt["ms"], bound_ms=bound_ms, err=err, ratio=ratio)


def cached_network_phase(state, net, window):
    """``"cached"`` against ``"torch"`` on the card, the torch backend reading
    the same tables unpermuted: value bit-equal, and the delayed TC update
    within the scaled tolerance on both branches."""
    from rein48_tpu_torch.agents import ntuple
    from rein48_tpu_torch.ops import hbm_tables
    from rein48_tpu_torch.train import ntuple as nt

    plain = nt.get_network(dataclasses.replace(net.config, backend="torch"))
    boards, errs = window
    flat = logical_tables(state.params)
    with torch.no_grad():
        equal = bool(torch.equal(net.value(state.params, boards), plain.value(flat, boards)))
        log("hbm/cached-vs-torch", fn="value", boards=boards.shape[0], equal=equal)
        ok, worst = equal, 0.0
        b = plain.td_apply_delayed({k: v.clone() for k, v in flat.items()}, boards, errs, 1.0)
        scale = plain.td_apply_delayed({k: v.abs() for k, v in flat.items()}, boards, errs.abs(), 1.0)
        # The trainer's capacity, and one that holds a whole block: never overflows.
        for rows in (net.config.cold_capacity_rows, hbm_tables.G_BLK):
            cached = nt.get_network(dataclasses.replace(net.config, cold_capacity_rows=rows))
            before = dict(ntuple.cached_windows)
            a = cached.td_apply_delayed({k: v.clone() for k, v in state.params.items()}, boards, errs, 1.0)
            branches = {k: ntuple.cached_windows[k] - before[k] for k in before}
            got = logical_tables(a)
            ok_k, err_k, ratio = close_tables([got[k] for k in b], [b[k] for k in b], [scale[k] for k in b])
            log("hbm/cached-vs-torch", fn="td_apply_delayed(tc=True)", cold_capacity_rows=rows, branches=json.dumps(branches),
                within_tol=ok_k, max_abs_err=f"{err_k:.3g}", err_over_tol=f"{ratio:.3g}")
            ok &= ok_k
            worst = max(worst, err_k)
            del a, got
    if not ok:
        raise AssertionError("the cached backend disagrees with the torch backend on the card")
    return worst


def cached_trainer_phase(dev):
    """``train_ntuple`` through its entry point with ``table_backend="cached"``
    at YEH_4X6 in both update modes, launches checked per update; again at
    8192 prefix rows if the defaults never took the fast branch; then
    ``"cached"`` against ``"torch"`` paired update by update."""
    from rein48_tpu_torch.agents import ntuple
    from rein48_tpu_torch.ops import hbm_tables, tables
    from rein48_tpu_torch.train import ntuple as nt

    launched = {k: 0 for k in hbm_tables.launches}
    fast, trained = 0, None
    for prefix_rows in HP_PREFIX_ROWS:
        for mode, updates in HP_UPDATES.items():
            cfg = nt.NTupleTrainConfig(
                batch_size=NT_B, steps_per_update=NT_T, update_mode=mode, table_backend="cached",
                cache_prefix_rows=prefix_rows, cache_refresh_every=HP_REFRESH_EVERY,
            )
            clock = Clock()
            zero_table_counts()
            torch.cuda.reset_peak_memory_stats(dev)
            state, history = nt.train_ntuple(cfg, updates, seed=SEED, log_every=1, logger=clock, device=dev)
            counts, windows = dict(hbm_tables.launches), dict(ntuple.cached_windows)
            # Per env step: 4 tables x (afterstates + prev_after) gathers; per
            # window ("delayed"), one scatter per table; "step" scatters nothing.
            scatters = 4 * (NT_T // cfg.delay_window) * updates if mode == "delayed" else 0
            want = {"cached_gather": 8 * NT_T * updates, "cached_scatter": scatters}
            if counts != want or any(tables.launches.values()) or sum(windows.values()) != scatters:
                raise AssertionError(
                    f"train_ntuple(cached, {mode}) launched {counts} and {tables.launches}, windows {windows}; expected {want}"
                )
            for k in launched:
                launched[k] += counts[k]
            fast += windows["fast"]
            rates = [NT_B * NT_T / dt for dt in clock.per_update_s()]
            last = history[-1]
            log(
                "hbm/train", mode=mode, table_backend="cached", tuples="YEH_4X6", prefix_rows=prefix_rows, B=NT_B, T=NT_T,
                updates=updates, refreshed_before_update=1,
                refreshed_after_updates=list(range(HP_REFRESH_EVERY, updates + 1, HP_REFRESH_EVERY)),
                launches=json.dumps(counts), windows=json.dumps(windows),
                launches_per_update=json.dumps({k: v // updates for k, v in counts.items()}),
                env_steps_per_s=[round(r, 1) for r in rates], peak_gib=round(torch.cuda.max_memory_allocated(dev) / 2**30, 3),
                td_abs_err=round(last["td_abs_err"], 4), avg_episode_score=round(last["avg_episode_score"], 1),
                best_tile=last["best_tile"],
            )
            if not all(np.isfinite(v) for v in last.values()):
                raise AssertionError(f"train_ntuple(cached, {mode}) metrics not finite: {last}")
            if (prefix_rows, mode) == (HP_PREFIX_ROWS[0], "delayed"):
                trained = state
            del state
        if fast:
            break
    if not fast:
        raise AssertionError("the cached trainer never took the fast branch")
    times = paired_updates(dev, "delayed", ("cached", "torch"), tuples=ntuple.YEH_4X6)
    log("hbm/train-paired", mode="delayed", tuples="YEH_4X6", order="cached,torch,torch,cached x2", **{
        f"{b}_env_steps_per_s": [round(NT_B * NT_T / t, 1) for t in ts] for b, ts in times.items()
    }, cached_over_torch=round(float(np.median(times["torch"]) / np.median(times["cached"])), 4))
    return trained, launched


def cached_eval_phase(trained, dev):
    """Depth-0 ``evaluate_ntuple`` of the cached-trained tables against the
    same tables unpermuted, read on ``"torch"``: equal stats."""
    from rein48_tpu_torch.ops import hbm_tables, tables
    from rein48_tpu_torch.train import ntuple as nt

    cfg = nt.NTupleTrainConfig(table_backend="cached")
    kw = dict(depth=0, num_envs=HP_EVAL_ENVS, num_steps=HP_EVAL_STEPS, seed=SEED, protocol="first", device=dev)
    zero_table_counts()
    t0 = time.perf_counter()
    stats = nt.evaluate_ntuple(trained.params, cfg, **kw)
    wall = time.perf_counter() - t0
    launched = dict(hbm_tables.launches)
    plain = nt.evaluate_ntuple(logical_tables(trained.params), dataclasses.replace(cfg, table_backend="torch"), **kw)
    log("hbm/eval-depth0", envs=HP_EVAL_ENVS, steps=HP_EVAL_STEPS, wall_s=round(wall, 3), launches=json.dumps(launched),
        equal_to_torch=stats == plain, stats=json.dumps({k: round(v, 3) for k, v in stats.items()}))
    if stats != plain or launched["cached_gather"] <= 0 or any(tables.launches.values()):
        raise AssertionError(f"depth-0 evaluation of cached tables: {stats} launches {launched}, torch reads {plain}")
    return launched


def ntuple_cli_phase(dev):
    """``train --algo ntuple`` at the CLI's defaults: the YEH_4X6 flagship
    (4 tables of 16.7M entries with TC accumulators) on the plain path."""
    from rein48_tpu_torch import cli
    from rein48_tpu_torch.ops import hbm_tables, tables

    argv = ["train", "--algo", "ntuple", "--updates", "3", "--batch-size", "1024", "--unroll", "64", "--log-every", "1"]
    out, err = io.StringIO(), io.StringIO()
    zero_table_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    final = ast.literal_eval(err.getvalue().split("final: ", 1)[1].strip())
    walls = [float(ln.split("wall_time=")[1].split()[0]) for ln in out.getvalue().splitlines() if "wall_time=" in ln]
    per_update = [b - a for a, b in zip(walls, walls[1:])]
    kernel_launches = {**tables.launches, **hbm_tables.launches}
    log("ntuple/cli", argv=" ".join(argv), rc=rc, table_launches=json.dumps(kernel_launches),
        env_steps_per_s_after_first=[round(1024 * 64 / dt, 1) for dt in per_update if dt > 0],
        final=json.dumps(final), peak_gib=round(torch.cuda.max_memory_allocated(dev) / 2**30, 3))
    if rc != 0 or final["update"] != 3 or not np.isfinite(final["td_abs_err"]) or any(kernel_launches.values()):
        raise AssertionError(f"train --algo ntuple failed: {final}")


def run_cli(argv) -> dict:
    from rein48_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"cli {argv} returned {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from rein48_tpu_torch import build
    from rein48_tpu_torch.control import search
    from rein48_tpu_torch.engine import core, fused, philox, vector
    from rein48_tpu_torch.models import nets
    from rein48_tpu_torch.train import common, evaluate

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)

    # 1. Build every kernel, one nvcc each, all at once.
    t0 = time.perf_counter()
    report = build.build()
    for name, r in report.items():
        regs = [ln.split("info    : ")[-1] for ln in r["log"].splitlines() if "registers" in ln or "spill" in ln]
        log("build", kernel=name, seconds=f"{r['seconds']:.1f}", ptxas="; ".join(regs))
    log("build", total_seconds=f"{time.perf_counter() - t0:.1f}", torch=torch.__version__, cuda=torch.version.cuda)

    # 2. Kernel vs plain on injected words: bit-equal at B=65536, T=256.
    B, T = 65536, 256
    state = vector.reset_batch(SEED, B, dev)
    state, _ = fused.rollout_random_reference(state, SEED, 37)  # mid-episode boards
    bits = philox.philox_bits(SEED + 1, T, B, device=dev)
    want = fused.rollout_bits_reference(state, bits)
    got = fused.rollout_random_fused(state, 0, T, bits=bits)
    err_bits = rollout_max_err(got, want)
    log("kernel-vs-plain/bits", B=B, T=T, max_abs_err=err_bits, episodes=int(want[1].episodes.sum()))
    if err_bits:
        raise AssertionError("rollout kernel (injected words) differs from its plain version")
    del bits

    # 3. Kernel in Philox mode vs plain on philox_bits: bit-equal.
    B3, T3 = 8192, 64
    state3 = vector.reset_batch(SEED + 2, B3, dev)
    want = fused.rollout_bits_reference(state3, philox.philox_bits(SEED + 3, T3, B3, device=dev))
    err_philox = rollout_max_err(fused.rollout_random_fused(state3, SEED + 3, T3), want)
    log("kernel-vs-plain/philox", B=B3, T=T3, max_abs_err=err_philox)
    if err_philox:
        raise AssertionError("rollout kernel (Philox) differs from its plain version")
    torch.cuda.synchronize()

    # 4-5. The main paths, through their entry points, with the counts at 0.
    fused.launches = 0
    bench = run_cli(["bench", "--batch", str(BENCH_B), "--unroll", str(BENCH_T), "--rounds", str(BENCH_ROUNDS)])
    if bench["engine"] != "fused" or bench["value"] <= 0:
        raise AssertionError(f"bench did not run the kernel: {bench}")
    log(
        "bench", engine=bench["engine"], B=BENCH_B, T=BENCH_T, rounds=BENCH_ROUNDS,
        steps_per_s=bench["value"], median_steps_per_s=bench["median"],
        ms_per_launch=bench["ms_per_launch"], launches=fused.launches,
    )
    plain_bench = run_cli(["bench", "--engine", "plain", "--batch", str(BENCH_B), "--unroll", "64", "--rounds", "2"])
    log("bench/plain-engine", B=BENCH_B, T=64, steps_per_s=plain_bench["value"], ms_per_round=plain_bench["ms_per_launch"])

    model = nets.ResNetPolicy(64, 4, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(SEED)).to(dev).eval()
    serving = {}
    for depth, envs, steps, chunk, launch in ((0, 1024, 512, None, 256), (1, 256, 256, 4, 128)):
        def run(num_steps, depth=depth, envs=envs, chunk=chunk, launch=launch):
            return evaluate.evaluate_search(
                depth=depth, num_envs=envs, num_steps=num_steps, seed=123, model=model,
                chance_chunk=chunk, protocol="first", launch_chunk=launch, device=dev,
            )

        run(4)  # untimed warm-up at the same shapes: cuDNN loads and picks its algorithms
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            stats = run(steps)
            walls.append(time.perf_counter() - t0)
        if not all(np.isfinite(v) for v in stats.values()) or stats["episodes"] != envs:
            raise AssertionError(f"depth-{depth} stats malformed: {stats}")
        serving[depth] = dict(envs=envs, steps=steps, chunk=chunk)
        log(
            f"serve/depth{depth}", envs=envs, steps=steps, chance_chunk=chunk,
            wall_s=[round(w, 3) for w in walls], ms_per_step=[round(1e3 * w / steps, 3) for w in walls],
            us_per_env_step=[round(1e6 * w / (steps * envs), 3) for w in walls],
            stats=json.dumps({k: round(v, 3) for k, v in stats.items()}),
        )
    launches = fused.launches
    if launches <= 0:
        raise AssertionError("the bench path launched no rollout kernel")

    # Every chosen action is legal wherever one exists (64 steps replayed
    # through the same policy and sweep that evaluate_search runs).
    for depth, cfg in serving.items():
        policy = evaluate._build_search_policy(depth, model, "onehot", 0.99, "log2", cfg["chunk"])
        bad = torch.zeros((), dtype=torch.int64, device=dev)

        def checked(boards, policy=policy):
            nonlocal bad
            actions = policy(boards)
            legal = core.legal_action_mask(boards)
            bad = bad + (legal.any(-1) & ~legal.gather(-1, actions[:, None])[:, 0]).sum()
            return actions

        with torch.inference_mode():
            evaluate._first_episode_rollout(vector.reset_batch(123, cfg["envs"], dev), policy_fn=checked, num_steps=64)
        log(f"serve/depth{depth}/legal", steps=64, illegal_choices=int(bad))
        if int(bad):
            raise AssertionError(f"depth-{depth} planner chose an illegal action")

    # Depth-1 q on the card (bf16) against the float32 net on the CPU.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = nets.ResNetPolicy(64, 4, dtype=torch.float32).eval()
    ref.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    boards = torch.from_numpy(fixed_boards(64, SEED))

    def reward(r):
        return common.transform_reward(r, "log2")

    with torch.inference_mode():
        q_card, legal = search._action_values(boards.to(dev), 1, search.make_value_leaf(model), reward, 0.99, 0.0, 4)
        q_ref, legal_ref = search._action_values(boards, 1, search.make_value_leaf(ref), reward, 0.99, 0.0, 4)
        a_card = search._argmax_legal(q_card, legal).cpu()
        a_ref = search._argmax_legal(q_ref, legal_ref)
    q_card, legal = q_card.cpu(), legal.cpu()
    if not torch.equal(legal, legal_ref):
        raise AssertionError("legal masks differ between the card and the CPU")
    q_err = float((q_card - q_ref).abs()[legal].max())
    top2 = torch.where(legal_ref, q_ref, -torch.inf).topk(2, -1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * Q_BF16_TOL
    same = bool(torch.equal(a_card[clear], a_ref[clear]))
    log("serve/depth1/q-vs-f32", boards=64, max_abs_err=f"{q_err:.5f}", tol=Q_BF16_TOL, clear_gap=int(clear.sum()), actions_equal=same)
    if q_err > Q_BF16_TOL or not same:
        raise AssertionError("depth-1 q-values on the card disagree with the float32 reference")

    # 6. The kernel at the bench shape: bit-equal to its plain version there,
    # its time, the plain version's, and the bound from its own SASS.
    state = vector.reset_batch(SEED + 4, BENCH_B, dev)
    saved = fused.launches
    got = fused.rollout_random_fused(state, 2, BENCH_T)  # also the warm-up
    ms = cuda_ms(lambda: fused.rollout_random_fused(state, 2, BENCH_T), reps=10)
    fused.launches = saved
    plain = []
    plain_ms = cuda_ms(lambda: plain.append(fused.rollout_random_reference(state, 2, BENCH_T)))
    err_bench = rollout_max_err(got, plain[0])
    log("kernel-vs-plain/philox", B=BENCH_B, T=BENCH_T, max_abs_err=err_bench, episodes=int(plain[0][1].episodes.sum()))
    if err_bench:
        raise AssertionError("rollout kernel (Philox) differs from its plain version at the bench shape")
    per_step, per_step_int32 = sass_per_step(build.library_path("rollout"), "rollout_kernelILb0E", 4)
    env_steps = BENCH_B * BENCH_T
    bound_issue_ms = 1e3 * per_step * env_steps / ISSUE_PER_S
    bound_int32_ms = 1e3 * per_step_int32 * env_steps / INT32_PIPE_PER_S
    bound_ops_ms = max(bound_issue_ms, bound_int32_ms)
    log(
        "kernel-bound", sass_per_env_step=per_step, int32_pipe_per_env_step=per_step_int32,
        issue_bound_ms=round(bound_issue_ms, 4), int32_pipe_bound_ms=round(bound_int32_ms, 4),
    )
    # Each board (16 B), score, steps read once; board, score, steps and 4 stats written once.
    bound_bytes_ms = 1e3 * BENCH_B * (16 + 8 + 16 + 8 + 16) / HBM_BYTES_PER_S
    kernels = [
        {
            "name": "rollout",
            "route": "cuda",
            "source": "rein48_tpu_torch/csrc/rollout.cu",
            "replaces": "rein48_tpu/engine/fused.py:269",
            "launches": launches,
            "equal": err_bits == 0 and err_philox == 0 and err_bench == 0,
            "max_abs_err": max(err_bits, err_philox, err_bench),
            "ms": round(ms, 4),
            "plain_ms": round(plain_ms, 1),
            "bound_ms": round(max(bound_ops_ms, bound_bytes_ms), 4),
            "bound_by": "operations" if bound_ops_ms >= bound_bytes_ms else "bytes",
            "sass_per_env_step": per_step,
            "int32_pipe_per_env_step": per_step_int32,
            "library_ms": None,
        }
    ]
    # 7-11. The n-tuple family: the table kernels against their plain
    # versions at the trainer's shapes, the network's two backends on the
    # card, then the main paths with the counts at 0: the trainer in both
    # update modes with its depth-0 and depth-1 evaluation, and the CLI.
    state, net, gathers, window = ntuple_trainer_inputs(dev)
    gather, scatter = table_kernel_phase(state, net, gathers, window)
    net_err = ntuple_network_phase(state, net, window)
    del state
    trained, table_launches = ntuple_trainer_phase(dev)
    for k, v in ntuple_depth1_phase(trained, dev).items():
        table_launches[k] += v
    del trained
    # 12-15. The "cached" backend at YEH_4X6: its kernels against their plain
    # versions, the backend against "torch" on the card, then its main paths
    # with the counts at 0: the trainer in both update modes and depth-0
    # evaluation of what it trained.
    state, net, idx, window = cached_trainer_inputs(dev)
    hp_gather, hp_scatter = hbm_kernel_phase(state, net, idx, window)
    hp_net_err = cached_network_phase(state, net, window)
    del state, window
    trained, hp_launches = cached_trainer_phase(dev)
    for k, v in cached_eval_phase(trained, dev).items():
        hp_launches[k] += v
    del trained
    ntuple_cli_phase(dev)
    for k, v in {**table_launches, **hp_launches}.items():
        if v <= 0:
            raise AssertionError(f"the n-tuple main paths launched no {k} kernel")
    g, sc = gather["value(afterstates)"], scatter[("stats", NT_B * 2 * 8)]
    kernels += [
        {
            "name": "table_gather",
            "route": "cuda",
            "source": "rein48_tpu_torch/csrc/tables.cu",
            "replaces": "rein48_tpu/ops/tables.py:102",
            "launches": table_launches["table_gather"],
            "equal": True,
            "max_abs_err": 0.0,
            "n": g["n"],
            "ms": g["ms"],
            "plain_ms": g["plain_ms"],
            "bound_ms": round(g["bound_ms"], 6),
            "bound_by": "bytes",
            "library_ms": g["library_ms"],
        },
        {
            "name": "table_scatter",
            "route": "cuda",
            "source": "rein48_tpu_torch/csrc/tables.cu",
            "replaces": "rein48_tpu/ops/tables.py:161",
            "launches": table_launches["table_scatter"],
            "equal": True,
            "max_abs_err": max(max(v["err"] for v in scatter.values()), net_err),
            "tolerance": {"rtol": TABLE_RTOL, "atol": TABLE_ATOL},
            "err_over_tol": max(v["ratio"] for v in scatter.values()),
            "n": sc["n"],
            "ms": sc["ms"],
            "plain_ms": sc["plain_ms"],
            "bound_ms": round(sc["bound_ms"], 6),
            "bound_by": "bytes",
            "library_ms": sc["library_ms"],
        },
        {
            "name": "cached_gather",
            "route": "cuda",
            "source": "rein48_tpu_torch/csrc/hbm_tables.cu",
            "replaces": "rein48_tpu/ops/hbm_tables.py:222",
            "launches": hp_launches["cached_gather"],
            "equal": True,
            "max_abs_err": 0.0,
            "n": hp_gather["n"],
            "ms": hp_gather["ms"],
            "plain_ms": hp_gather["plain_ms"],
            "bound_ms": round(hp_gather["bound_ms"], 6),
            "bound_by": "bytes",
            "library_ms": hp_gather["library_ms"],
        },
        {
            "name": "cached_scatter",
            "route": "cuda",
            "source": "rein48_tpu_torch/csrc/hbm_tables.cu",
            "replaces": "rein48_tpu/ops/hbm_tables.py:421",
            "launches": hp_launches["cached_scatter"],
            "equal": True,
            "max_abs_err": max(hp_scatter["err"], hp_net_err),
            "tolerance": {"rtol": TABLE_RTOL, "atol": TABLE_ATOL},
            "err_over_tol": hp_scatter["ratio"],
            "n": hp_scatter["n"],
            "ms": hp_scatter["ms"],
            "plain_ms": hp_scatter["plain_ms"],
            "bound_ms": round(hp_scatter["bound_ms"], 6),
            "bound_by": "bytes",
            "library_ms": None,
        },
    ]
    log("kernels", total_seconds=f"{time.perf_counter() - t_start:.1f}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

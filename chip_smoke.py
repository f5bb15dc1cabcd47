#!/usr/bin/env python3
# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Smoke test of the PyTorch/CUDA port (``rein48_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``rein48_tpu_torch/csrc`` with ``nvcc``, then
drives the port's main paths through their entry points and checks what
comes out: the ``bench`` rollout, full-width ResNet depth-0/depth-1
``evaluate_search`` (every action legal, depth-1 q in bf16 against the
float32 net on the CPU), the ``SJ_2X4`` n-tuple trainer ``train_ntuple`` in
both update modes with its depth-0/depth-1 ``evaluate_ntuple``, the
``YEH_4X6`` trainer on the ``"cached"`` hot-prefix backend in both update
modes with its depth-0 ``evaluate_ntuple`` (equal to the same evaluation
through the value kernel's plain version), ``train --algo ntuple`` of the
CLI, and the deep afterstate-TD trainer ``train_afterstate_td`` at its
flagship configuration with its bf16-against-float32 loss, its checkpoint,
``eval --algo search --checkpoint-dir`` of what it trained at depth 0 and 1,
and ``train --algo afterstate`` with a resume; then the actor-critic family:
``train_ppo`` at the PPO flagship, with and without the afterstate critic,
its bf16-against-float32 loss, ``train_a3c`` at the A3C flagship and in the
reference-parity regime, the critic-carrying PPO checkpoint restored on the
card and on the CPU, and ``train --algo ppo --afterstate`` with a resume,
``eval --algo ppo`` greedy and sampled and ``eval --algo search`` on the
afterstate critic); then the single-game surface (``Game`` on the card,
``play``, ``parity`` with the C oracle) and the replay family: the DQN
flagship (ResNet 64x4 bf16, a 2**20-slot buffer on the card) through
``train_dqn`` with its learn gate, checkpoint (resumed bit for bit), bf16
against float32 and ``eval --algo dqn``, 5-step DQN, the ``dqn-4k``
preset, ``train_ddpg``, and ``train --algo dqn|ddpg``; then multi-process
training (``parallel/``): a flagship afterstate update of a one-rank NCCL
group bit for bit against the same update without one, two gloo ranks
sharing the card for the rollout kernel on half the bench batch each, the
flagship afterstate trainer, the ``SJ_2X4`` n-tuple trainers on the table
kernels, PPO with the critic, A3C, the DQN flagship's learn gate and the
A3C MLP over tensor parallelism, each against one process, the tp runs'
checkpoints (the A3C MLP's and the full-width ResNet afterstate
learner's) resumed in a fresh pair of ranks bit for bit and the A3C one in
one process, and, beside them, ``train --mesh`` under ``torchrun``; then the recipes of
``examples/`` through their ``main`` (``rein48_tpu_torch.examples``, at their
full widths, cut in updates and evaluation steps, the warm-start chain in
order) and the two frontier sweeps one leg each, their records held to the
JAX recipes' keys; then the learning of four recipes through their ``main``
held to the JAX runs' recorded curves (``rein48_tpu_torch.testing``): the
n-tuple recipe over 40 updates under ``"auto"`` and ``"cached"``, and PPO,
the fresh afterstate-TD flagship and the A3C flagship over 40-50 updates at
their JAX runs' schedule horizons, above random play measured on the same
engine, and DQN and n-step DQN past the first wrap of their buffer. Each
path runs with the kernels' launch counts set to 0 just before it and read
just after, and checked. A failing phase raises, so the script exits
non-zero; it prints one line per phase and a ``[timing]`` line of seconds
per section.

It also times each kernel at the shapes its main path gives it: the device
time of a call, of its plain version and of a library call where one
exists, its bound by bytes or operations, the device time of an empty
kernel (the card's launch floor), and the launches of a main path (an
``SJ_2X4`` update and depth-1 step, a PPO update's layer norms). Where it
runs a kernel and its plain version on the same inputs for these times, it
holds the two outputs to each other at the tolerances of
``rein48_tpu_torch.testing`` (the rollout kernel at the bench shape, the
layer norm, the table and hot-prefix gathers and scatters, the value
kernel). The second-to-last line is a JSON object of these figures for
every ported kernel (``kernels``); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

``tests/test_torch_cuda.py`` (``python -m pytest tests/test_torch_cuda.py
--noconftest``) holds each kernel against its plain version over its range
of shapes and inputs; the benchmark's cells (``portbench``,
``BENCHMARK.json``) time the PPO flagship and the expectimax players.

Without a CUDA device it exits 1 and prints no result. It imports no JAX.
"""

from __future__ import annotations

import ast
import contextlib
import csv
import dataclasses
import importlib
import io
import json
import re
import shutil
import subprocess
import sys
import tempfile
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
# The work of one env-step of the rollout that any design must do: the 5
# Philox words the stream contract fixes (engine/philox.py), 1.25
# Philox4x32-10 blocks of 10 rounds, each round 2 widening multiplies and 2
# three-input XORs: 1.25 x 10 x 4 = 50 instructions. The move itself is one
# table read per row (engine/lut.py) and is not counted.
PHILOX_INSTR_PER_STEP = 1.25 * 10 * (2 + 2)
# The fused layer norm and ReLU at the PPO minibatch: 65,536 boards x 16
# cells, 64 bf16 channels a row. Its bounds by bytes: the forward reads x
# and writes the output (2 + 2 B a channel) and the row's float32 mean and
# rstd (8 B); the backward reads x, dy and the statistics and writes dx.
LN_BOARDS, LN_CHANNELS = 65536, 64
LN_FORWARD_BYTES_PER_ROW = 4 * LN_CHANNELS + 8
LN_BACKWARD_BYTES_PER_ROW = 6 * LN_CHANNELS + 8
# Depth-1 q-values of the bf16 net on the card against the float32 net on
# the CPU: a leaf value in [0.4, 1.4] rounds to 2**-7 steps in bf16 and the
# tower rounds ~10 times; the leaf error measured 0.012 and the q error
# 0.007 with bf16 on the CPU. 0.04 leaves 3x over the leaf error.
Q_BF16_TOL = 0.04
# The n-tuple trainer on the "mxu" path at the shape the JAX package measures
# it (examples/bench_mxu_trainer_tpu.py:54-60): SJ_2X4 (2 tables of 65,536
# entries, 8 lookups each), B=1024, 128 steps per update.
NT_B, NT_T = 1024, 128
NT_UPDATES = {"step": 6, "delayed": 2}  # step mode's tables are then played
NT_EVAL_ENVS, NT_EVAL_STEPS = 512, 600
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
HP_EVAL_ENVS, HP_EVAL_STEPS = 512, 250
# The deep afterstate-TD trainer at its flagship configuration
# (examples/train_afterstate_td_tpu.py:49-60): B=8192, T=32, ResNet 64x4 in
# bf16, adam at 1e-4 on a cosine over the run's updates to 0.1 of it, gamma
# 0.997, lambda 0.7, 2 epochs x 4 minibatches of 65,536 boards. The first
# update is a warm-up (cuDNN picks its algorithms). Four updates:
# [capability/afterstate] trains fifty more at this width.
AS_UPDATES = 4
# One minibatch's loss and gradient norm of the bf16 net on the card
# against the float32 net on the CPU, relative: values near 14 round to
# 2**-4 steps in bf16; on the CPU, bf16 against float32 moved the loss by
# 0.21% and the gradient norm by 0.10% three updates into a run (2,048
# boards of a B=256 rollout). 2% leaves 10x. The CPU side takes the first
# AS_BF16_BOARDS boards of the minibatch, the size of that CPU reading: a
# float32 backward of all 65,536 would take minutes there.
LOSS_BF16_RTOL = 0.02
AS_BF16_BOARDS = 2048
# eval --algo search --checkpoint-dir: (depth, envs, steps, chance_chunk).
AS_EVAL = ((0, 1024, 150, None), (1, 256, 50, 4))
# The PPO flagship (examples/train_ppo_flagship_tpu.py:42-52): B=8192, T=32,
# ResNet 64x4 in bf16, gamma 0.997, adam at 3e-4 on a cosine over the
# example's 8,000 updates to 0.1 of it, entropy weight 0.01 -> 0.002 over
# 6,400 updates, 4 epochs x 4 minibatches of 65,536 boards, clip norm 0.5.
# The first update is a warm-up. With the afterstate critic
# (examples/train_ppo_afterstate_tpu.py:51-67): two ResNets 64x4, lr 1.2e-4
# over 6,000 updates, entropy 0.003 -> 0.001 over 4,800. Few updates:
# [capability/ppo] trains forty more of the same net and epochs at B=4096.
PPO_UPDATES, PPOC_UPDATES = 3, 2
# The A3C flagship (examples/train_a3c_flagship_tpu.py:43-54): B=8192, T=32,
# ResNet 64x4 bf16, gamma 0.997, adam at 3e-4 over 12,000 updates, entropy
# 0.01 -> 0.002 over 9,600; one pass over all 262,144 boards per update.
# Then the reference-parity regime (B=64, T=100, the MLP on raw tiles).
# [capability/a3c] trains fifty more flagship updates.
A3C_UPDATES, A3C_PARITY_UPDATES = 3, 3
# The first minibatch's approx_kl before any optimizer step: acting ran the
# net at 8,192 boards and the learn phase runs it at 65,536, where cuDNN
# may pick other bf16 algorithms, so the ratios are 1 only up to rounding.
KL_AT_BEHAVIOR_TOL = 1e-3
# eval --algo dqn --checkpoint-dir of the DQN flagship, and DDPG's updates
# (DDPGConfig(): learning from update 10 of 12).
DQN_EVAL_ENVS, DQN_EVAL_STEPS = 1024, 500
DDPG_UPDATES = 12
# The recipes of examples/ as the port's entry points
# (rein48_tpu_torch.examples), in the order they feed each other (their
# checkpoints are the next ones' donors), at their full widths: cut only in
# updates (2; the DQN recipes up to their first learning update, 50,000
# transitions at 4,096 envs x 2 acting steps: update 7) and in evaluation
# steps (each evaluation call capped at RECIPE_EVAL_STEPS; the depth-2
# recipes in probe mode, RECIPE_EVAL_STEPS // 2 steps a probe).
RECIPE_EVAL_STEPS = 16
PROBE = ["probe", "8"]
RECIPES = (
    ("train_ntuple", ["2"]),
    ("eval_ntuple", []),
    ("eval_ntuple_depth1", []),
    ("eval_ntuple_depth2", PROBE + ["20480", "8", str(RECIPE_EVAL_STEPS // 2)]),
    ("train_ppo", ["2"]),
    ("train_ppo_flagship", ["2"]),
    ("eval_ppo_depth1", []),
    ("train_ppo_afterstate", ["2"]),
    ("train_afterstate_td", ["2"]),
    ("eval_afterstate_depth2", PROBE + ["16384", "8", str(RECIPE_EVAL_STEPS // 2)]),
    ("train_a3c", ["2"]),
    ("train_a3c_flagship", ["2"]),
    ("train_dqn", ["7"]),
    ("train_dqn_nstep", ["7"]),
    ("a3c_parity_curve", ["2"]),
)
# The frontier sweeps through their main, one leg each at a small budget: the
# clock is read every 20 updates of YEH_4X6 at B=1024 on "cached"
# (delayed/4), about 18 s, so that leg trains one check; and after every
# update at B=16384 (the plain path, as JAX's default backend, with the value
# kernel), about 0.8 s, so that one trains a few. Evaluations capped at
# RECIPE_EVAL_STEPS.
FRONTIER_BUDGET_S = 1.0
FRONTIERS = (
    ("ntuple_frontier", ["cached", "delayed:4"], 20, "cached"),
    ("ntuple_frontier_b", ["16384"], 1, "torch"),
)
# [capability/<name>]: a recipe's main at its full width, its learning held to
# the JAX run's recorded curve (rein48_tpu_torch.testing.LEARNING_CHECKS:
# the argv, the JAX run, the check updates and the held columns): the mean of
# each held column at the check updates must lie within CAPABILITY_BAND of the
# JAX run's, and a tile sum above random play's (measured here, on the plain
# engine, RANDOM_ENVS first episodes). The n-tuple recipe (YEH_4X6, B=1024,
# T=128, delayed/4, 40 updates; JAX 27,540.1) runs under "auto" (the plain
# path, as JAX's "xla", its values through the value kernel) and "cached"
# (the kernels); PPO (40 updates at B=4096; 525.6), the fresh
# afterstate-TD flagship (50 at B=8192; 571.4) and the A3C flagship (50 at
# B=8192; 519.5) act through the plain engine and launch no kernel. So do the
# DQN recipes (300 updates at 4,096 envs x 2 acting steps, the buffer full from
# update 128), held in q_mean and td_abs at updates 240-300: 1-step 5.434 and
# 1.033, n-step (n=5, gamma 0.997) 22.981 and 3.193. Each config is built at its
# JAX run's horizon (eval.json's updates), so the schedules decay as they did
# there. The columns of CAPABILITY_BESIDE that a check does not hold are
# logged beside it.
RANDOM_ENVS = 8192
CAPABILITY_BAND = (0.7, 1.3)
CAPABILITY_BESIDE = ("avg_episode_tile_sum", "td_abs_err", "q_mean", "td_abs")


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


# The least share of a timed session's launches whose kernels the profiler
# must record. It can drop kernel events: 1 of 50 launches after the n-tuple
# trainers, in every session; 46 of 50 once.
TIMED_MIN_RECORDED = 0.9


def timed(fn, reps: int = 50, kernel: str | None = None) -> dict:
    """Device and host time of one call of ``fn()``, after an untimed call.

    ``ms`` sums the device time of every kernel ``fn`` launches (the
    profiler's CUDA activity, copies and fills included), so a launch-bound
    call is not timed by its host; ``call_ms`` is the host-bound time per
    call of a back-to-back loop (CUDA events); ``launches`` the kernels
    launched per call; ``kernels`` the device time of each kernel;
    ``kernel_ms`` that of the kernels whose name holds ``kernel``. A session
    whose kernels number under ``TIMED_MIN_RECORDED`` of its launches is
    taken again; in one that lost fewer, the kernels' time is scaled by the
    launches over the kernels recorded, and a ``[timed]`` line says so.
    """
    from torch.profiler import ProfilerActivity, profile

    from rein48_tpu_torch.utils import profiling

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events, launches = profiling.kernel_times(prof)
        copies = {k for k in events if k.startswith(("Memcpy", "Memset"))}
        recorded = sum(calls for k, (_, calls) in events.items() if k not in copies)
        if launches and recorded >= TIMED_MIN_RECORDED * launches:
            break
    else:
        raise AssertionError(f"the profiler recorded {recorded} kernels of {launches} launches, three times")
    scale = max(1.0, launches / recorded)
    if scale > 1.0:
        log("timed", lost_kernel_events=launches - recorded, launches=launches, kernels_scaled_by=round(scale, 5))
    per = {k: (1.0 if k in copies else scale) * us / 1e3 / reps for k, (us, _) in events.items()}
    ranked = sorted(per.items(), key=lambda kv: kv[1], reverse=True)
    out = {"ms": round(sum(per.values()), 6), "call_ms": cuda_ms(fn, reps), "launches": launches // reps,
           "kernels": {k[:40]: round(v, 6) for k, v in ranked[:4]}}
    if kernel:
        out["kernel_ms"] = round(sum(v for k, v in per.items() if kernel in k), 6)
    return out


def floor_phase(dev) -> float:
    """The card's launch floor: the device time of an empty kernel (one
    warp), timed as the table kernels are."""
    from rein48_tpu_torch.ops import tables

    f = timed(lambda: tables.empty_launch(dev))
    log("floor", kernel="empty_kernel (1 warp)", ms=f["ms"], call_ms=round(f["call_ms"], 5), launches_per_call=f["launches"])
    if f["launches"] != 1 or not f["ms"] > 0:
        raise AssertionError(f"the empty kernel did not time as one launch: {f}")
    return f["ms"]


def layer_norm_phase(dev) -> dict:
    """The fused layer norm and ReLU (``ops/layer_norm.py``) at the PPO
    minibatch against its plain version at ``testing``'s tolerances, the
    backward twice bit for bit; the device time of the forward that keeps
    the statistics (a learning forward), the one that does not, and the
    backward (two launches); the plain version's, and ``F.layer_norm`` then
    ``relu``'s (exact variance, bf16 weights; a yardstick the port never
    calls); the bounds by bytes."""
    import torch.nn.functional as F

    from rein48_tpu_torch import testing
    from rein48_tpu_torch.ops import layer_norm as ln

    rows, c, bf16 = LN_BOARDS * 16, LN_CHANNELS, torch.bfloat16
    g = torch.Generator(dev).manual_seed(SEED)
    x = (torch.randn(rows, c, generator=g, device=dev) * 1.5 + 0.25).to(bf16).requires_grad_(True)
    scale = (1.0 + 0.2 * torch.randn(c, generator=g, device=dev)).requires_grad_(True)
    bias = (0.1 * torch.randn(c, generator=g, device=dev)).requires_grad_(True)
    dy = torch.randn(rows, c, generator=g, device=dev).to(bf16)
    params = (x, scale, bias)

    def plain_version():
        return testing.ln_plain(x, scale, bias)

    out = ln.layer_norm_relu(x, scale, bias, 1e-6)
    plain_out = plain_version()
    testing.assert_ln_forward_close(out, plain_out)
    got = torch.autograd.grad(out, params, dy, retain_graph=True)
    testing.assert_ln_grads_close(got, testing.ln_masked_reference_grads(x, scale, bias, dy, out), x, dy, out)
    if not all(bool(torch.equal(a, b)) for a, b in zip(got, torch.autograd.grad(out, params, dy, retain_graph=True))):
        raise AssertionError("the layer norm kernel's backward differs from one run to the next")
    del got
    lib_params = [p.detach().to(bf16).requires_grad_(True) for p in (scale, bias)]

    def library():
        return F.relu(F.layer_norm(x, (c,), *lib_params, 1e-6))

    lib_out = library()

    def no_stats():
        with torch.no_grad():
            return ln.layer_norm_relu(x, scale, bias, 1e-6)

    t = {
        "forward": timed(lambda: ln.layer_norm_relu(x, scale, bias, 1e-6)),
        "forward_no_stats": timed(no_stats),
        "backward": timed(lambda: torch.autograd.grad(out, params, dy, retain_graph=True)),
        "plain_forward": timed(plain_version),
        "plain_backward": timed(lambda: torch.autograd.grad(plain_out, params, dy, retain_graph=True)),
        "library_forward": timed(library),
        "library_backward": timed(lambda: torch.autograd.grad(lib_out, [x] + lib_params, dy, retain_graph=True)),
    }
    bound_f = 1e3 * rows * LN_FORWARD_BYTES_PER_ROW / HBM_BYTES_PER_S
    bound_b = 1e3 * rows * LN_BACKWARD_BYTES_PER_ROW / HBM_BYTES_PER_S
    log("layer-norm", rows=rows, channels=c,
        **{f"{k}_ms": round(v["ms"], 5) for k, v in t.items()},
        **{f"{k}_launches": v["launches"] for k, v in t.items()},
        forward_bound_ms=round(bound_f, 5), backward_bound_ms=round(bound_b, 5),
        kernels=json.dumps(t["forward"]["kernels"]), backward_kernels=json.dumps(t["backward"]["kernels"]))
    if (t["forward"]["launches"], t["forward_no_stats"]["launches"], t["backward"]["launches"]) != (1, 1, 2):
        raise AssertionError(f"the layer norm made {t['forward']['launches']} / {t['backward']['launches']} launches")
    return {"rows": rows, "t": t, "bound_f": bound_f, "bound_b": bound_b}


# The engine step kernel's bytes a board: it reads the board (16 B), score
# and steps (4 each), the action, seed, env id and counter (8 each), and
# writes the board, score, steps, done (1) and counter and the seven
# StepOutput fields (22). Its batches: a search move's and a PPO acting step's.
STEP_BYTES_PER_BOARD = 56 + 55
STEP_BATCHES = (256, 8192)


def engine_step_phase(dev) -> dict:
    """The engine's step kernel (``vector.step_autoreset`` on the card) at
    ``STEP_BATCHES`` beside the plain step it replaced (``vector._advance``
    on the stream's words), its output held to the plain step's bit for bit:
    device time, launches a call, and the bound by bytes."""
    from rein48_tpu_torch import testing
    from rein48_tpu_torch.engine import core, philox, vector

    out = {}
    for b in STEP_BATCHES:
        g = torch.Generator().manual_seed(SEED + b)
        state = vector.reset_batch(SEED + b, b, dev)
        edge = torch.from_numpy(testing.edge_boards(b, SEED + b)).to(dev)
        state.boards = torch.where((torch.arange(b, device=dev) % 2 == 0)[:, None, None], edge, state.boards)
        actions = torch.randint(0, 4, (b,), generator=g).to(dev)

        def plain():
            words = philox.step_words(state.seed, state.env_id, state.counter)
            return vector._advance(state, actions, words, core.RewardMode.MERGE_SCORE)

        testing.assert_same_step(vector.step_autoreset(state, actions), plain())
        kernel, ref = timed(lambda: vector.step_autoreset(state, actions)), timed(plain)
        bound = 1e3 * b * STEP_BYTES_PER_BOARD / HBM_BYTES_PER_S
        log(f"engine-step/b{b}", ms=kernel["ms"], call_ms=round(kernel["call_ms"], 5), launches=kernel["launches"],
            plain_ms=ref["ms"], plain_call_ms=round(ref["call_ms"], 5), plain_launches=ref["launches"],
            bound_ms=round(bound, 6), outputs_equal=True)
        if kernel["launches"] != 1:
            raise AssertionError(f"the engine step made {kernel['launches']} launches at B={b}")
        out[b] = {"ms": kernel["ms"], "plain_ms": ref["ms"], "plain_launches": ref["launches"], "bound_ms": bound}
    return out


# The layer norm kernel's counters (``ops/layer_norm.py``) by the names this
# script reports them under, and the part of its kernels' names that the
# profiler shows. ``actor_critic_train_phase`` keeps them per trainer: the
# launches, the device ms and the bound by bytes of one update.
LN_COUNTERS = {
    "forward": "layer_norm.forward_launches", "backward": "layer_norm.backward_launches",
    "backward_sum": "layer_norm.backward_sum_launches", "bound_bytes": "layer_norm.bound_bytes",
}
LN_KERNEL = "layer_norm_relu"
LN_PER_UPDATE: dict = {}


# The launch counters of the table and value kernels in the port's registry
# (``utils/profiling.counters``), by the names this script reports them under.
TABLE_COUNTERS = {
    "table_gather": "tables.table_gather", "table_scatter": "tables.table_scatter",
    "cached_gather": "hbm_tables.cached_gather", "cached_scatter": "hbm_tables.cached_scatter",
    "ntuple_value": "ntuple_value.launches",
}
# The "cached" backend's delayed windows by branch.
WINDOW_COUNTERS = {"fast": "ntuple.cached_fast", "fallback": "ntuple.cached_fallback"}
ROLLOUT_COUNTER = "fused.rollout_launches"
# The engine step's counters (``engine/vector.py``): launches of its kernel,
# and steps of the plain path, which no path on the card may take.
STEP_COUNTERS = {"engine_step": "engine.step_launches", "engine_step_plain": "engine.step_plain"}
# Per trainer, the step kernel's launches in its profiled update.
STEP_PER_UPDATE: dict = {}


def counter(name: str) -> int:
    from rein48_tpu_torch.utils import profiling

    return profiling.counters.get(name, 0)


def set_counter(name: str, value: int) -> None:
    from rein48_tpu_torch.utils import profiling

    profiling.counters[name] = value


def zero_table_counts() -> None:
    """Set the launch counts of the table and value kernels, the cached
    window branch counts and the engine step's counts to 0."""
    for name in (*TABLE_COUNTERS.values(), *WINDOW_COUNTERS.values(), *STEP_COUNTERS.values()):
        set_counter(name, 0)


def step_counts() -> dict:
    """The engine step's kernel launches and plain steps."""
    return {k: counter(name) for k, name in STEP_COUNTERS.items()}


def check_steps(name: str, counts: dict, steps: int | None = None) -> None:
    """Raise unless the engine steps in ``counts`` (a change of
    :func:`step_counts`) all launched the step kernel: ``steps`` launches
    where given, else at least one, and no plain step."""
    launched, plain = counts["engine_step"], counts["engine_step_plain"]
    if plain or (launched != steps if steps is not None else not launched):
        want = "some" if steps is None else steps
        raise AssertionError(f"{name} launched the step kernel {launched} times (want {want}) and took {plain} plain steps")


def check_other_paths(name: str, launched: dict, steps: int | None = None) -> None:
    """Raise unless ``launched`` (a change of :func:`kernel_launches`) holds
    no kernel of another path and the engine steps :func:`check_steps` wants."""
    if any(v for k, v in launched.items() if k not in STEP_COUNTERS):
        raise AssertionError(f"{name} launched a kernel of another path: {launched}")
    check_steps(name, launched, steps)


def cached_windows() -> dict:
    """The cached backend's delayed windows by branch."""
    return {k: counter(name) for k, name in WINDOW_COUNTERS.items()}


class LegalityCheck:
    """A policy that counts the actions it chooses that are illegal where a
    legal one exists (``illegal``, a device scalar)."""

    def __init__(self, policy):
        self.policy, self.illegal = policy, 0

    def __call__(self, boards):
        from rein48_tpu_torch.engine import core

        actions = self.policy(boards)
        legal = core.legal_action_mask(boards)
        self.illegal = self.illegal + (legal.any(-1) & ~legal.gather(-1, actions[:, None])[:, 0]).sum()
        return actions


class Clock:
    """A trainer logger that keeps each record with the host time it came."""

    def __init__(self):
        self.records = []

    def write(self, record):
        self.records.append((time.perf_counter(), record))

    def per_update_s(self) -> list[float]:
        t = [at for at, _ in self.records]
        return [b - a for a, b in zip(t, t[1:])]


def table_counts() -> dict:
    """The launch counts of the table and value kernels."""
    return {k: counter(name) for k, name in TABLE_COUNTERS.items()}


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
    """The table kernels at the main path's shapes against their plain
    versions (gathers bit for bit, scatters at ``testing``'s tolerance):
    their times, the plain versions', the library call's, and the bound by
    bytes."""
    from rein48_tpu_torch import testing
    from rein48_tpu_torch.ops import tables

    table = state.params["t0"]
    size = table.numel()
    lookups = net.num_lookups // len(net.table_sizes)

    gather = {}
    for what, idx in gathers.items():
        if not torch.equal(tables.mxu_gather(table, idx), tables.gather_reference(table, idx)):
            raise AssertionError(f"gather kernel differs from table[idx] ({what})")
        n = idx.numel()
        touched = int(torch.unique(idx).numel())
        k = timed(lambda idx=idx: tables.mxu_gather(table, idx))
        # The library call is table[idx], which is also the plain version.
        p = timed(lambda idx=idx: tables.gather_reference(table, idx))
        # Each index read and each value written once, each touched entry read once.
        bound_ms = 1e3 * (8 * n + 4 * touched) / HBM_BYTES_PER_S
        log("tables/gather", call=what, n=n, table=size, touched=touched, ms=k["ms"],
            call_ms=round(k["call_ms"], 5), plain_ms=p["ms"], plain_call_ms=round(p["call_ms"], 5),
            bound_ms=round(bound_ms, 6), kernels=json.dumps(k["kernels"]), plain_kernels=json.dumps(p["kernels"]))
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
            kernel = lambda idx=idx, vals=vals: tables.mxu_scatter_stats(size, idx, vals)
        else:
            kernel = lambda idx=idx, vals=vals: tables.mxu_scatter_sum(size, idx, vals)
        want = tables.scatter_reference(size, idx, vals, stats=True)
        got = kernel()
        if stats:
            testing.assert_sums_close(got[0], want[0], want[1])
            testing.assert_sums_close(got[1], want[1], want[1])
            if not torch.equal(got[2], want[2]):
                raise AssertionError(f"scatter kernel ({form}) counts hits other than its plain version")
        else:
            testing.assert_sums_close(got, want[0], want[1])
        del got, want
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
            ms=k["ms"], call_ms=round(k["call_ms"], 5), launches_per_call=k["launches"],
            plain_ms=p["ms"], plain_call_ms=round(p["call_ms"], 5), library_ms=lib["ms"], library_call_ms=round(lib["call_ms"], 5),
            bound_ms=round(bound_ms, 6), kernels=json.dumps(k["kernels"]), library_kernels=json.dumps(lib["kernels"]))
        if k["launches"] != 2:  # the zero fill and the kernel
            raise AssertionError(f"scatter call ({form}, n={n}) made {k['launches']} launches, not 2")
        scatter[(form, n)] = dict(n=n, ms=k["ms"], plain_ms=p["ms"], library_ms=lib["ms"], bound_ms=bound_ms,
                                  launches_per_call=k["launches"])
    return gather, scatter


def ntuple_trainer_phase(dev):
    """``train_ntuple`` through its entry point with ``table_backend="auto"``
    (the kernels) in both update modes, and depth-0 play of the trained
    tables against the untrained ones."""
    from rein48_tpu_torch.agents import ntuple
    from rein48_tpu_torch.train import ntuple as nt

    launched = {k: 0 for k in table_counts()}
    trained = None
    for mode, updates in NT_UPDATES.items():
        cfg = nt.NTupleTrainConfig(tuples=ntuple.SJ_2X4, batch_size=NT_B, steps_per_update=NT_T, update_mode=mode)
        resolved = cfg.network_config(dev).backend
        if resolved != "mxu":
            raise AssertionError(f"table_backend='auto' resolved to {resolved!r} for SJ_2X4 on {dev}")
        clock = Clock()
        zero_table_counts()
        state, history = nt.train_ntuple(cfg, updates, seed=SEED, log_every=1, logger=clock, device=dev)
        counts = table_counts()
        check_steps(f"train_ntuple({mode})", step_counts(), NT_T * updates)
        # Per env step: one fused value call for the afterstates and one for
        # prev_after, no standalone gather; per step ("step") or per window
        # ("delayed"), one stats scatter per table.
        scatters = NT_T if mode == "step" else NT_T // cfg.delay_window
        want = {"table_gather": 0, "table_scatter": 2 * scatters * updates, "cached_gather": 0, "cached_scatter": 0,
                "ntuple_value": 2 * NT_T * updates}
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
        counts = table_counts()
        check_steps(f"depth-0 evaluate_ntuple of the {name} tables", step_counts(), NT_EVAL_STEPS)
        for k in launched:
            launched[k] += counts[k]
        scores[name] = stats["avg_score"]
        log("ntuple/eval-depth0", tables=name, envs=NT_EVAL_ENVS, steps=NT_EVAL_STEPS, wall_s=round(wall, 3),
            launches=json.dumps(counts), stats=json.dumps({k: round(v, 3) for k, v in stats.items()}))
        # One value call per step: 512 envs x 4 afterstates, one leaf chunk.
        if counts != {**{k: 0 for k in counts}, "ntuple_value": NT_EVAL_STEPS}:
            raise AssertionError(f"depth-0 evaluate_ntuple launched {counts}")
    if not scores["trained"] > 1.3 * scores["untrained"]:
        raise AssertionError(f"trained tables do not beat the untrained ones at depth 0: {scores}")
    return trained, launched


def ntuple_depth1_phase(trained, dev):
    """Depth-1 ``evaluate_ntuple`` with the trained tables, timed after a
    warm-up, and every chosen action legal."""
    from rein48_tpu_torch.agents import ntuple
    from rein48_tpu_torch.engine import vector
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
    launched = table_counts()
    # Per step: 8 chance chunks, each one leaf call of envs x 64 boards and
    # one launch of the value kernel over the whole leaf batch.
    per_step = 8
    if launched != {**{k: 0 for k in launched}, "ntuple_value": per_step * 2 * NT_D1_STEPS}:
        raise AssertionError(f"depth-1 evaluate_ntuple launched {launched}")
    if not all(np.isfinite(v) for v in stats.values()) or stats["episodes"] != NT_D1_ENVS:
        raise AssertionError(f"depth-1 n-tuple stats malformed: {stats}")
    log("ntuple/eval-depth1", envs=NT_D1_ENVS, steps=NT_D1_STEPS, chance_chunk=4, launches=json.dumps(launched),
        ms_per_step=[round(1e3 * w / NT_D1_STEPS, 3) for w in walls], stats=json.dumps({k: round(v, 3) for k, v in stats.items()}))

    policy = nt._get_ntuple_policy(cfg.network_config(dev), 1, 4)
    checked = LegalityCheck(lambda boards: policy(trained.params, boards))
    with torch.no_grad():
        evaluate._first_episode_rollout(vector.reset_batch(SEED + 5, NT_D1_ENVS, dev), policy_fn=checked, num_steps=32)
    log("ntuple/eval-depth1/legal", steps=32, illegal_choices=int(checked.illegal))
    if int(checked.illegal):
        raise AssertionError("depth-1 n-tuple planner chose an illegal action")
    return launched


def leaf_chunk(state):
    """A leaf chunk of depth-1 n-tuple evaluation: the second slice of 4,096
    boards (the JAX package's ``lax.map`` chunk) of one chance chunk's
    leaves, stored transposed as the engine's afterstates are, recorded
    from a depth-1 step over the first ``NT_D1_ENVS`` boards of
    ``state``."""
    from rein48_tpu_torch.control import search

    seen = []

    def leaf(boards):
        seen.append(boards)
        return torch.zeros(boards.shape[:-2], device=boards.device)

    with torch.no_grad():
        search.make_expectimax_policy(1, leaf_value=leaf, reward_fn=lambda r: r, gamma=1.0, death_value=0.0,
                                      chance_chunk=4)(state.env.boards[:NT_D1_ENVS])
    return seen[0].reshape((-1,) + seen[0].shape[-2:]).split(4096)[1]


def depth2_leaf_case(dev):
    """The value kernel's shape on ``eval --algo ntuple --depth 2
    --chance-chunk 8`` (the ``search_ntuple_d2`` cell): a YEH_4X6 network
    on the ``"torch"`` backend (``"auto"`` at these tables, no row map; 4 x
    16^6 float32 entries, 268 MB, drawn normal of standard deviation 1)
    and the first leaf call's 1,048,576 transposed afterstates, recorded
    from a depth-2 move of 256 games 30 random moves past the start."""
    from rein48_tpu_torch.control import search
    from rein48_tpu_torch.engine import vector
    from rein48_tpu_torch.train import ntuple as nt

    config = nt.NTupleTrainConfig().network_config(dev)
    net = nt.get_network(config)
    g = torch.Generator(device=dev).manual_seed(20)
    params = {f"t{i}": torch.randn(n, generator=g, device=dev) for i, n in enumerate(net.table_sizes)}
    env = vector.reset_batch(20, 256, dev)
    seen = []

    def leaf(boards):
        seen.append(boards)
        return torch.zeros(boards.shape[:-2], device=boards.device)

    with torch.no_grad():
        for _ in range(30):
            _, _, legal = search._afterstates(env.boards)
            env, _ = vector.step_autoreset(env, torch.multinomial(legal.float() + 1e-9, 1, generator=g)[:, 0])
        search._action_values(env.boards, 2, leaf, lambda r: r, 1.0, 0.0, 8)
    return (f"YEH_4X6 {config.backend} depth-2 leaf", net, params, seen[0])


def value_kernel_phase(cases) -> dict:
    """The fused value kernel at the main paths' shapes, bit-equal to its
    plain version, twice: the device time and launches of a call, of the
    same launch with one board (its latency alone), and of the plain
    version; the bound by bytes."""
    from rein48_tpu_torch.ops import hbm_tables
    from rein48_tpu_torch.ops import ntuple_value as value_ops

    out = {}
    for name, net, params, boards in cases:
        tabs, rowmaps = net.value_tables(params)
        with torch.no_grad():
            indices = net.indices(boards)
            n = boards.numel() // 16
            touched = 0  # table entries, and row-map entries, this call reads
            for i, idx in enumerate(indices):
                if rowmaps is not None:
                    touched += int(torch.unique(idx >> 7).numel())
                    idx = hbm_tables.physical_index(rowmaps[i], idx)
                touched += int(torch.unique(idx).numel())
            # Each board read once (16 B), each value written once (4 B), each touched entry read once.
            bound_ms = 1e3 * (20 * n + 4 * touched) / HBM_BYTES_PER_S
            got = net.value(params, boards)
            if not (torch.equal(got, value_ops.ntuple_value_reference(indices, tabs, rowmaps))
                    and torch.equal(net.value(params, boards), got)):
                raise AssertionError(f"the value kernel differs from its plain version or from one run to the next ({name})")
            del got
            t = timed(lambda: net.value(params, boards))
            t_plain = timed(lambda: value_ops.ntuple_value_reference(net.indices(boards), tabs, rowmaps))
            one = boards.reshape((-1,) + boards.shape[-2:])[:1]
            t_one = timed(lambda: net.value(params, one))
        log("ntuple/value-kernel", call=name, backend=net.config.backend, tables=len(tabs), boards=n,
            board_layout="transposed" if value_ops.board_layout(boards) else "row-major", touched=touched,
            us=round(1e3 * t["ms"], 4), us_one_board=round(1e3 * t_one["ms"], 4), launches_per_call=t["launches"],
            plain_us=round(1e3 * t_plain["ms"], 4), bound_us=round(1e3 * bound_ms, 5), kernels=json.dumps(t["kernels"]))
        if t["launches"] != 1:
            raise AssertionError(f"a fused value call made {t['launches']} launches ({name})")
        out[name] = dict(n=n, ms=t["ms"], plain_ms=t_plain["ms"], bound_ms=bound_ms)
    return out


@contextlib.contextmanager
def plain_value():
    """``NTupleNetwork.value`` of ``"mxu"`` and ``"cached"`` taken through
    the kernel's plain version on the network's own indices for the length
    of the block. The cached players are dropped on the way in and out: a
    player's CUDA graph replays the value it captured, whatever is patched
    since."""
    from rein48_tpu_torch.agents import ntuple
    from rein48_tpu_torch.ops import ntuple_value as value_ops
    from rein48_tpu_torch.train import ntuple as nt

    fused = ntuple.NTupleNetwork.value
    nt._get_ntuple_policy.cache_clear()

    def value(self, params, boards):
        if self.config.backend == "torch":
            return fused(self, params, boards)
        return value_ops.ntuple_value_reference(self.indices(boards), *self.value_tables(params))

    ntuple.NTupleNetwork.value = value
    try:
        yield
    finally:
        ntuple.NTupleNetwork.value = fused
        nt._get_ntuple_policy.cache_clear()


def kernel_profile(fn, reps: int = 1) -> dict:
    """Kernels launched, device ms and wall ms per call of ``fn()``, traced
    on the card alone: without the host's ops the profiler reads a call of
    80 k launches in seconds. Each launch runs one kernel, so the kernels
    counted are the launches (copies and fills by the runtime are not
    kernels, as they are no launch calls)."""
    from torch.profiler import ProfilerActivity, profile

    from rein48_tpu_torch.utils import profiling

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    kernels = [v for k, v in profiling.kernel_times(prof)[0].items() if not k.startswith(("Memcpy", "Memset"))]
    device_ms = sum(us for us, _ in kernels) / 1e3 / reps
    return {"launches": sum(calls for _, calls in kernels) // reps, "device_ms": round(device_ms, 6),
            "wall_ms": round(wall_ms, 4)}


def value_launches_phase(sj_trained, dev):
    """Launches, device and wall ms (``kernel_profile``) and the exact
    counts of one step-mode update of the SJ_2X4 trainer, continuing the
    state this run trained, and of one depth-1 evaluation step. Run last: a
    trace of an 80 k-launch update has shifted later readings."""
    from rein48_tpu_torch.agents import ntuple
    from rein48_tpu_torch.engine import vector
    from rein48_tpu_torch.train import ntuple as nt

    out = {}

    def measure(name, fn, reps):
        zero_table_counts()
        r = kernel_profile(fn, reps)
        counts = {k: v // reps for k, v in table_counts().items() if v}
        log("ntuple/value-launches", path=name, **r, counts_per_call=json.dumps(counts))
        out[name] = dict(**r, counts=counts)

    box = [sj_trained]
    step = nt.make_ntuple_step(nt.NTupleTrainConfig(tuples=ntuple.SJ_2X4, batch_size=NT_B, steps_per_update=NT_T), dev)

    def update():
        box[0] = step(box[0])[0]

    measure("SJ_2X4 step update", update, reps=1)
    # Op by op (``eager``), so that the launches counted are the step's own
    # kernels, not one graph replay.
    policy = nt._get_ntuple_policy(nt.NTupleTrainConfig(tuples=ntuple.SJ_2X4).network_config(dev), 1, 4).eager
    st = vector.reset_batch(SEED + 5, NT_D1_ENVS, dev)

    @torch.no_grad()
    def d1_step():
        vector.step_autoreset(st, policy(sj_trained.params, st.boards))

    d1_step()
    measure("SJ_2X4 depth-1 step, 256 envs", d1_step, reps=3)
    return out


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
    table 0 that ``value(afterstates)`` gathers (32,768), and ``window``
    the backups of four steps with the tables frozen, as ``(boards, errs)``.
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
    """The hot-prefix kernels at the trainer's shapes against their plain
    versions (the gather bit for bit, the scatter by
    ``testing.assert_scatter_matches``): their times, the plain versions',
    and the bound by bytes.

    The scatter runs on one window at two states: ``just-refreshed``, at the
    trainer's cold capacity, which the window fits, and ``overflowing``, the
    same window with the capacity lowered just below its largest block's
    cold count, as the trainer's overflowing windows exceed it with the
    same hot share.
    """
    from rein48_tpu_torch import testing
    from rein48_tpu_torch.ops import hbm_tables

    p = state.params
    table, rm, hot, k = p["t0"], p["t0_rm"], p["t0_hot"], net.prefix_rows[0]

    n = idx.numel()
    rows, touched = int(torch.unique(idx >> 7).numel()), int(torch.unique(idx).numel())
    hot_share = float(torch.isin(idx >> 7, hot).float().mean())
    if not torch.equal(hbm_tables.cached_gather(table, rm, hot, idx, prefix_rows=k),
                       hbm_tables.cached_gather_reference(table, rm, idx)):
        raise AssertionError("cached_gather differs from its plain version")
    kt = timed(lambda: hbm_tables.cached_gather(table, rm, hot, idx, prefix_rows=k))
    # The library call is table[physical_index(rm, idx)], which is also the plain version.
    pt = timed(lambda: hbm_tables.cached_gather_reference(table, rm, idx))
    # Each index read and each value written once, each touched row-map and table entry read once.
    bound_ms = 1e3 * (8 * n + 4 * rows + 4 * touched) / HBM_BYTES_PER_S
    log("hbm/gather", call="value(afterstates)", n=n, table=table.numel(), prefix_rows=k, hot_share=round(hot_share, 4),
        touched_rows=rows, touched=touched, ms=kt["ms"], call_ms=round(kt["call_ms"], 5), plain_ms=pt["ms"],
        plain_call_ms=round(pt["call_ms"], 5), bound_ms=round(bound_ms, 6), kernels=json.dumps(kt["kernels"]),
        plain_kernels=json.dumps(pt["kernels"]))
    gather = dict(n=n, ms=kt["ms"], plain_ms=pt["ms"], library_ms=pt["ms"], bound_ms=bound_ms)

    boards, errs = window
    lookups = net.num_lookups // len(net.table_sizes)
    sidx = net.indices(boards)[0].reshape(-1)
    d = errs[:, None].expand(-1, lookups).reshape(-1).contiguous()
    ns = sidx.numel()
    scatter = {}
    cap_rows = net.config.cold_capacity_rows
    for state_name in ("just-refreshed", "overflowing"):
        if state_name == "overflowing":
            cap_rows = max(1, (int(scatter["just-refreshed"]["cold_max"]) - 1) // hbm_tables.ROW)
        cap = cap_rows * hbm_tables.ROW
        got = hbm_tables.cached_scatter_blocks(hot, sidx, d, prefix_rows=k, cold_capacity_rows=cap_rows)
        testing.assert_scatter_matches(got, hbm_tables.cached_scatter_stats_reference(hot, sidx, d, cap_rows))
        counts = got[5]
        n_blocks = counts.numel()

        def call(cap_rows=cap_rows):
            return hbm_tables.cached_scatter_stats(hot, sidx, d, prefix_rows=k, cold_capacity_rows=cap_rows)

        overflow = bool(call()[5])
        kt = timed(call, kernel="cached_scatter")
        pt = timed(lambda cap_rows=cap_rows: hbm_tables.cached_scatter_stats_reference(hot, sidx, d, cap_rows), reps=10)
        # Each index and error read once; the three [K, 128] sums, the residue and the counts written once.
        bound_ms = 1e3 * (8 * ns + 3 * 4 * k * hbm_tables.ROW + 8 * n_blocks * cap + 4 * n_blocks) / HBM_BYTES_PER_S
        log("hbm/scatter", call="one delayed window", state=state_name, n=ns, prefix_rows=k, capacity=cap,
            hot_share=round(1.0 - float(counts.sum()) / ns, 4), cold_per_block=counts.tolist(), overflow=overflow,
            hottest_entry_hits=int(got[2].max()), ms=kt["ms"], kernel_ms=kt["kernel_ms"], call_ms=round(kt["call_ms"], 5),
            launches_per_call=kt["launches"], plain_ms=pt["ms"], plain_call_ms=round(pt["call_ms"], 5),
            bound_ms=round(bound_ms, 6), kernels=json.dumps(kt["kernels"]), plain_kernels=json.dumps(pt["kernels"]))
        # The state timed is the one named: the call's flag against its counts.
        if overflow != bool(counts.max() > cap) or overflow != (state_name == "overflowing"):
            raise AssertionError(f"cached_scatter overflow flag {overflow} at the {state_name} state, counts {counts.tolist()}")
        if k <= hbm_tables.HASH_MAX_ROWS and kt["launches"] > 3:
            raise AssertionError(f"cached_scatter call made {kt['launches']} launches at K={k}")
        scatter[state_name] = dict(n=ns, ms=kt["ms"], kernel_ms=kt["kernel_ms"], launches_per_call=kt["launches"],
                                   plain_ms=pt["ms"], bound_ms=bound_ms, cold_max=int(counts.max()))
    return gather, scatter


def cached_trainer_phase(dev):
    """``train_ntuple`` through its entry point with ``table_backend="cached"``
    at YEH_4X6 in both update modes, launches checked per update; again at
    8192 prefix rows if the defaults never took the fast branch."""
    from rein48_tpu_torch.agents import ntuple
    from rein48_tpu_torch.train import ntuple as nt

    launched = {k: 0 for k in table_counts()}
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
            counts, windows = table_counts(), cached_windows()
            # Per env step: one fused value call for the afterstates and one
            # for prev_after, no standalone gather; per window ("delayed"),
            # one scatter per table; "step" scatters nothing.
            scatters = 4 * (NT_T // cfg.delay_window) * updates if mode == "delayed" else 0
            want = {"table_gather": 0, "table_scatter": 0, "cached_gather": 0, "cached_scatter": scatters,
                    "ntuple_value": 2 * NT_T * updates}
            if counts != want or sum(windows.values()) != scatters:
                raise AssertionError(f"train_ntuple(cached, {mode}) launched {counts}, windows {windows}; expected {want}")
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
    return trained, launched


def cached_eval_phase(trained, dev):
    """Depth-0 ``evaluate_ntuple`` of the cached-trained tables, and the same
    evaluation with ``value`` taken through the kernel's plain version
    (``plain_value()``: the network's own indices, ``table[phys(idx)]``
    and the adds in the kernel's order, no kernel launched): equal stats.
    Not against ``"torch"``: the card's ``.sum(-1)`` adds a table's lookups
    in another order than the kernel's left fold, so a near-tied move may go
    the other way there."""
    from rein48_tpu_torch.train import ntuple as nt

    cfg = nt.NTupleTrainConfig(table_backend="cached")
    kw = dict(depth=0, num_envs=HP_EVAL_ENVS, num_steps=HP_EVAL_STEPS, seed=SEED, protocol="first", device=dev)
    zero_table_counts()
    t0 = time.perf_counter()
    stats = nt.evaluate_ntuple(trained.params, cfg, **kw)
    wall = time.perf_counter() - t0
    launched = table_counts()
    zero_table_counts()
    with plain_value():
        plain = nt.evaluate_ntuple(trained.params, cfg, **kw)
    plain_launched = table_counts()
    log("hbm/eval-depth0", envs=HP_EVAL_ENVS, steps=HP_EVAL_STEPS, wall_s=round(wall, 3), launches=json.dumps(launched),
        equal_to_plain=stats == plain, plain_launches=json.dumps(plain_launched),
        stats=json.dumps({k: round(v, 3) for k, v in stats.items()}))
    # One value call per step: 512 envs x 4 afterstates, one leaf chunk.
    if launched != {**{k: 0 for k in launched}, "ntuple_value": HP_EVAL_STEPS} or any(plain_launched.values()):
        raise AssertionError(f"depth-0 evaluation of cached tables launched {launched}, its plain run {plain_launched}")
    if stats != plain:
        raise AssertionError(f"depth-0 evaluation of cached tables: {stats}, through the plain value {plain}")
    return launched


def ntuple_cli_phase(dev):
    """``train --algo ntuple`` at the CLI's defaults: the YEH_4X6 flagship
    (4 tables of 16.7M entries with TC accumulators) on the plain path, its
    values through the value kernel: two launches an acting step, no table
    kernel."""
    from rein48_tpu_torch import cli

    argv = ["train", "--algo", "ntuple", "--updates", "3", "--batch-size", "1024", "--unroll", "64", "--log-every", "1"]
    out, err = io.StringIO(), io.StringIO()
    zero_table_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    final = ast.literal_eval(err.getvalue().split("final: ", 1)[1].strip())
    walls = [float(ln.split("wall_time=")[1].split()[0]) for ln in out.getvalue().splitlines() if "wall_time=" in ln]
    per_update = [b - a for a, b in zip(walls, walls[1:])]
    kernel_launches = table_counts()
    log("ntuple/cli", argv=" ".join(argv), rc=rc, table_launches=json.dumps(kernel_launches),
        env_steps_per_s_after_first=[round(1024 * 64 / dt, 1) for dt in per_update if dt > 0],
        final=json.dumps(final), peak_gib=round(torch.cuda.max_memory_allocated(dev) / 2**30, 3))
    launched = {k: v for k, v in kernel_launches.items() if v}
    if rc != 0 or final["update"] != 3 or not np.isfinite(final["td_abs_err"]) or launched != {"ntuple_value": 2 * 3 * 64}:
        raise AssertionError(f"train --algo ntuple failed: {final}, launched {launched}")


def run_cli_output(argv) -> tuple[str, str]:
    """``cli.main(argv)`` in this process: its standard output and error."""
    from rein48_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"cli {argv} returned {rc}: {err.getvalue()}")
    return out.getvalue(), err.getvalue()


def run_cli(argv) -> dict:
    return json.loads(run_cli_output(argv)[0].strip().splitlines()[-1])


def kernel_launches() -> dict:
    """Every launch count of the port's kernels, and the plain engine steps."""
    return {"rollout": counter(ROLLOUT_COUNTER), **table_counts(), **step_counts()}


def afterstate_config():
    from rein48_tpu_torch.train import afterstate

    return afterstate.AfterstateTDConfig(
        batch_size=8192, unroll_len=32, model="resnet", gamma=0.997, td_lambda=0.7, learning_rate=1e-4,
        lr_decay_updates=AS_UPDATES, lr_final_frac=0.1, num_epochs=2, num_minibatches=4,
    )


def batch_loss(step, batch, chunk: int = 65536) -> float:
    """MSE of the value net over a whole rollout batch."""
    boards = batch["after_boards"].reshape(-1, 4, 4)
    targets = batch["targets"].reshape(-1)
    with torch.no_grad():
        sq = sum(float(torch.square(step.value(boards[i : i + chunk]) - targets[i : i + chunk]).sum())
                 for i in range(0, boards.shape[0], chunk))
    return sq / boards.shape[0]


def afterstate_train_phase(dev, ckpt_dir):
    """``train_afterstate_td`` at the flagship configuration through its entry
    point (a checkpoint at its last update), then one more update driven by
    its two phases, with the loss on that update's own batch before and
    after its learn phase."""
    from rein48_tpu_torch.train import afterstate
    from rein48_tpu_torch.utils.checkpoint import Checkpointer

    cfg = afterstate_config()
    B, T = cfg.batch_size, cfg.unroll_len
    init = cfg.make_model(torch.Generator().manual_seed(SEED)).state_dict()  # the trainer's init (drawn on the CPU)
    zero_table_counts()
    before_launches = kernel_launches()
    clock = Clock()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state, history = afterstate.train_afterstate_td(
        cfg, AS_UPDATES, seed=SEED, log_every=1, logger=clock,
        checkpointer=Checkpointer(ckpt_dir, save_every=AS_UPDATES), device=dev,
    )
    wall = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    launched = {k: v - before_launches[k] for k, v in kernel_launches().items()}
    per_update = clock.per_update_s()  # updates 2..N: the first is the warm-up
    rates = [B * T / dt for dt in per_update]
    last = history[-1]
    log(
        "afterstate/train", B=B, T=T, model="resnet 64x4 bf16", updates=AS_UPDATES, wall_s=round(wall, 3),
        first_update_s=round(clock.records[0][0] - t0, 3), ms_per_update=[round(1e3 * dt, 3) for dt in per_update],
        env_steps_per_s=[round(r, 1) for r in rates], env_steps_per_s_median=round(float(np.median(rates)), 1),
        peak_gib=round(peak_gib, 3), kernel_launches=json.dumps(launched),
        **{k: round(last[k], 5) for k in ("loss", "v_mean", "target_mean", "grad_norm", "avg_episode_tile_sum", "best_tile")},
    )
    if not all(np.isfinite(v) for r in history for v in r.values()) or len(history) != AS_UPDATES:
        raise AssertionError(f"train_afterstate_td records not finite: {history}")
    check_other_paths("afterstate/train", launched, AS_UPDATES * T)
    moved = any(not torch.equal(v.cpu(), init[k]) for k, v in state.model.state_dict().items())
    if not moved:
        raise AssertionError("train_afterstate_td did not move the parameters")

    step = afterstate.make_afterstate_td_step(cfg, state.model, state.optimizer)
    env, batch, rollout_metrics = step.rollout(state)
    loss_before = batch_loss(step, batch)
    metrics = step.learn(state, batch)
    loss_after = batch_loss(step, batch)
    state = dataclasses.replace(state, env=env, update_step=state.update_step + 1)
    env_steps = batch["targets"].numel()
    finite = all(np.isfinite(float(v)) for v in {**metrics, **rollout_metrics}.values())
    log("afterstate/train/last-update", update=state.update_step, env_steps=env_steps,
        loss_on_own_batch_before=round(loss_before, 5), loss_on_own_batch_after=round(loss_after, 5),
        minibatch_loss=round(float(metrics["loss"]), 5), grad_norm=round(float(metrics["grad_norm"]), 5), finite=finite)
    if env_steps != B * T or not finite:
        raise AssertionError(f"the last update ran {env_steps} env steps, metrics {metrics}")
    if not loss_after < loss_before:
        raise AssertionError(f"the learn phase did not lower the loss on its own batch: {loss_before} -> {loss_after}")
    return state, cfg, step, batch


def afterstate_bf16_phase(state, cfg, step, batch):
    """One minibatch's loss and gradient norm: the bf16 net on the card
    against the same weights as a float32 net on the CPU."""
    from rein48_tpu_torch.models import nets
    from rein48_tpu_torch.train import afterstate, common

    perm = step.permutations(state, batch["targets"].device)[0]
    boards, targets = (x[0][:AS_BF16_BOARDS] for x in step.minibatches(batch, perm))
    f32 = nets.ResNetPolicy(64, 4, dtype=torch.float32)
    f32.load_state_dict({k: v.cpu() for k, v in state.model.state_dict().items()})
    out = {}
    for name, model, b, t in (("card_bf16", state.model, boards, targets), ("cpu_f32", f32, boards.cpu(), targets.cpu())):
        v = afterstate.make_value_fn(cfg, model)(b)
        loss = torch.mean(torch.square(v - t))
        grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
        out[name] = (float(loss.detach()), float(common.tree_norm(grads)))
    (lc, gc), (lf, gf) = out["card_bf16"], out["cpu_f32"]
    rel_loss, rel_grad = abs(lc - lf) / lf, abs(gc - gf) / gf
    log("afterstate/bf16-vs-f32", boards=AS_BF16_BOARDS, loss_card=round(lc, 6), loss_cpu_f32=round(lf, 6),
        grad_norm_card=round(gc, 6), grad_norm_cpu_f32=round(gf, 6), rel_err_loss=f"{rel_loss:.3g}",
        rel_err_grad_norm=f"{rel_grad:.3g}", rtol=LOSS_BF16_RTOL)
    if not (rel_loss <= LOSS_BF16_RTOL and rel_grad <= LOSS_BF16_RTOL):
        raise AssertionError("the bf16 loss or gradient norm on the card disagrees with the float32 net")


def afterstate_checkpoint_phase(state, cfg, ckpt_dir, dev):
    """Save the trained state, restore it into an init from another seed:
    every tensor, the optimizer, the env counters and the learner's seed
    equal bit for bit, and the next rollout gives the same boards and the
    next learn phase the same shuffles from both."""
    from rein48_tpu_torch.train import afterstate
    from rein48_tpu_torch.utils.checkpoint import Checkpointer

    ck = Checkpointer(ckpt_dir)
    t0 = time.perf_counter()
    ck.save(state.update_step, state)
    save_s = time.perf_counter() - t0
    step_dir = Path(ckpt_dir) / str(state.update_step)
    size = sum(f.stat().st_size for f in step_dir.iterdir())
    other = afterstate.init_afterstate_td(cfg, SEED + 1, dev)[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = ck.restore(other)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    equal = {
        "params": all(torch.equal(a, b) for a, b in zip(state.model.state_dict().values(), restored.model.state_dict().values())),
        "optimizer": restored.optimizer.count == state.optimizer.count and all(
            torch.equal(a, b) for m in state.optimizer.moments
            for a, b in zip(state.optimizer.moments[m], restored.optimizer.moments[m])
        ),
        "env": all(torch.equal(getattr(state.env, f.name), getattr(restored.env, f.name))
                   for f in dataclasses.fields(state.env)),
        "seed": restored.seed == state.seed,
        "update_step": restored.update_step == state.update_step,
    }
    steps = [afterstate.make_afterstate_td_step(cfg, s.model, s.optimizer) for s in (state, restored)]
    equal["next_rollout"] = bool(torch.equal(*(st.rollout(s)[1]["after_boards"] for st, s in zip(steps, (state, restored)))))
    equal["next_shuffles"] = bool(torch.equal(*(st.permutations(s, dev) for st, s in zip(steps, (state, restored)))))
    log("afterstate/checkpoint", step=state.update_step, save_s=round(save_s, 4), restore_s=round(restore_s, 4),
        bytes_on_disk=size, equal=json.dumps(equal))
    if not all(equal.values()):
        raise AssertionError(f"the restored afterstate state differs: {equal}")


def afterstate_eval_phase(cfg, ckpt_dir, dev):
    """``eval --algo search --checkpoint-dir`` through the CLI at depth 0 and
    1 (first-episode protocol): the stats equal ``evaluate_search`` called
    directly with the saved gamma and reward transform, and every chosen
    action is legal."""
    from rein48_tpu_torch.engine import vector
    from rein48_tpu_torch.models import nets
    from rein48_tpu_torch.train import evaluate
    from rein48_tpu_torch.utils.checkpoint import Checkpointer

    ck = Checkpointer(ckpt_dir)
    model = nets.make_model("resnet")
    model.load_state_dict(ck.restore_field("model"))
    model = model.to(dev).eval()
    for depth, envs, steps, chunk in AS_EVAL:
        argv = ["eval", "--algo", "search", "--checkpoint-dir", ckpt_dir, "--depth", str(depth), "--num-envs", str(envs),
                "--max-steps", str(steps), "--protocol", "first", "--seed", str(SEED)]
        argv += ["--chance-chunk", str(chunk)] if chunk else []
        zero_table_counts()
        t0 = time.perf_counter()
        out, err = run_cli_output(argv)
        wall = time.perf_counter() - t0
        stats = json.loads(out.strip().splitlines()[-1])
        leaf = json.loads(err.split("value leaf ", 1)[1].splitlines()[0])
        want = evaluate.evaluate_search(
            depth=depth, num_envs=envs, num_steps=steps, seed=SEED, model=model, gamma=cfg.gamma,
            reward_transform=cfg.reward_transform, chance_chunk=chunk, protocol="first", device=dev,
        )
        checked = LegalityCheck(evaluate._build_search_policy(depth, model, "onehot", cfg.gamma, cfg.reward_transform, chunk))
        with torch.inference_mode():
            evaluate._first_episode_rollout(vector.reset_batch(SEED, envs, dev), policy_fn=checked, num_steps=32)
        log(f"afterstate/eval-depth{depth}", envs=envs, steps=steps, chance_chunk=chunk, wall_s=round(wall, 3),
            ms_per_step=round(1e3 * wall / steps, 3), leaf=json.dumps(leaf), equal_to_evaluate_search=stats == want,
            illegal_choices=int(checked.illegal), stats=json.dumps({k: round(v, 3) for k, v in stats.items()}))
        if leaf["gamma"] != cfg.gamma or leaf["reward_transform"] != cfg.reward_transform:
            raise AssertionError(f"eval did not take the saved settings: {leaf}")
        if stats != want or int(checked.illegal) or stats["episodes"] != envs:
            raise AssertionError(f"eval --checkpoint-dir at depth {depth}: {stats} against {want}, {int(checked.illegal)} illegal")


def afterstate_cli_phase():
    """``train --algo afterstate --checkpoint-dir`` at the CLI's defaults
    (B=4096, T=32, ResNet 64x4, lr 3e-4) for 2 updates, then again for 2
    more, which resumes; then ``eval --depth 1`` of what it saved."""
    with tempfile.TemporaryDirectory() as d:
        base = ["train", "--algo", "afterstate", "--checkpoint-dir", d, "--checkpoint-every", "2", "--log-every", "1",
                "--seed", str(SEED), "--updates", "2"]
        t0 = time.perf_counter()
        _, err1 = run_cli_output(base)
        out2, err2 = run_cli_output(base)
        wall = time.perf_counter() - t0
        finals = [ast.literal_eval(e.split("final: ", 1)[1].strip()) for e in (err1, err2)]
        resumed = "resumed from checkpoint step 2" in out2
        out, err = run_cli_output(["eval", "--algo", "search", "--checkpoint-dir", d, "--depth", "1", "--num-envs", "64",
                                   "--max-steps", "16", "--chance-chunk", "4", "--protocol", "first"])
        stats = json.loads(out.strip().splitlines()[-1])
        leaf = json.loads(err.split("value leaf ", 1)[1].splitlines()[0])
        log("afterstate/cli", argv=" ".join(base).replace(d, "<tmpdir>"), wall_s=round(wall, 3), resumed=resumed,
            updates=[f["update"] for f in finals], steps_per_sec=[round(f["steps_per_sec"], 1) for f in finals],
            loss=[round(f["loss"], 5) for f in finals], eval_depth1_leaf=json.dumps(leaf),
            eval_depth1_avg_score=round(stats["avg_score"], 3))
        if not resumed or [f["update"] for f in finals] != [2, 4] or leaf["gamma"] != 0.997:
            raise AssertionError(f"train --algo afterstate did not resume or eval took other settings: {finals} {leaf}")
        if not all(np.isfinite(v) for f in finals for v in f.values()) or not all(np.isfinite(v) for v in stats.values()):
            raise AssertionError(f"train/eval --algo afterstate gave non-finite values: {finals} {stats}")


def ppo_config(critic: bool = False):
    from rein48_tpu_torch.train import ppo

    if critic:
        return ppo.PPOConfig(
            batch_size=8192, unroll_len=32, gamma=0.997, learning_rate=1.2e-4, lr_decay_updates=6000, lr_final_frac=0.1,
            entropy_beta=0.003, entropy_beta_final=0.001, entropy_decay_updates=4800, afterstate_critic=True,
        )
    return ppo.PPOConfig(
        batch_size=8192, unroll_len=32, gamma=0.997, learning_rate=3e-4, lr_decay_updates=8000, lr_final_frac=0.1,
        entropy_beta=0.01, entropy_beta_final=0.002, entropy_decay_updates=6400,
    )


def a3c_config():
    from rein48_tpu_torch.train import a3c

    return a3c.A3CConfig(
        batch_size=8192, unroll_len=32, gamma=0.997, learning_rate=3e-4, lr_decay_updates=12000, lr_final_frac=0.1,
        entropy_beta=0.01, entropy_beta_final=0.002, entropy_decay_updates=9600,
    )


def make_step(cfg, state):
    from rein48_tpu_torch.train import a3c, ppo

    if isinstance(cfg, ppo.PPOConfig):
        return ppo.make_ppo_step(cfg, state.model, state.optimizer, state.after_model)
    return a3c.make_a3c_step(cfg, state.model, state.optimizer)


def own_batch_loss(step, state, batch, chunk: int = 65536):
    """The update's loss on its own batch (no gradient): PPO's over the
    minibatches of the batch in rollout order, A3C's over the whole batch.
    Returns ``(loss, aux)``, ``aux`` of the first minibatch for PPO."""
    from rein48_tpu_torch.agents import a3c as a3c_agent
    from rein48_tpu_torch.train import a3c, ppo

    cfg = step.config
    T, B = cfg.unroll_len, cfg.batch_size
    beta = a3c.entropy_beta_at(cfg, state.update_step)
    with torch.no_grad():
        if isinstance(step, ppo.PPOStep):
            rows = torch.arange(T, device=batch["returns"].device)
            order = rows[:, None].expand(T, B) if cfg.shard_friendly_perm else torch.arange(T * B, device=rows.device)
            mbs = step.minibatches(batch, order)
            out = [step.minibatch_loss({k: v[m] for k, v in mbs.items()}, step.loss_cfg._replace(entropy_beta=beta))
                   for m in range(cfg.num_minibatches)]
            return float(torch.stack([loss for loss, _ in out]).mean()), {k: float(v) for k, v in out[0][1].items()}
        boards = batch["boards"].reshape(T * B, 4, 4)
        parts = [step.policy(boards[i : i + chunk]) for i in range(0, T * B, chunk)]
        logits = a3c_agent.masked_logits(torch.cat([p[0] for p in parts]).reshape(T, B, 4), batch["legal_mask"])
        loss, aux = a3c_agent.a3c_loss(
            logits, torch.cat([p[1] for p in parts]).reshape(T, B), batch["actions"], batch["targets"],
            step.loss_cfg._replace(entropy_beta=beta),
        )
        return float(loss), {k: float(v) for k, v in aux.items()}


def actor_critic_train_phase(name, dev, cfg, updates, ckpt_dir=None):
    """A trainer (``train_ppo`` or ``train_a3c``) at ``cfg`` through its entry
    point, a checkpoint at its last update when ``ckpt_dir`` is given; then
    one more update under the profiler (launches, device time) and one
    driven by its two phases, timed, with the loss on its own batch
    before and after the learn phase."""
    from rein48_tpu_torch.train import a3c, ppo
    from rein48_tpu_torch.utils import profiling
    from rein48_tpu_torch.utils.checkpoint import Checkpointer

    is_ppo = isinstance(cfg, ppo.PPOConfig)
    train = ppo.train_ppo if is_ppo else a3c.train_a3c
    B, T = cfg.batch_size, cfg.unroll_len
    zero_table_counts()
    before_launches = kernel_launches()
    clock = Clock()
    torch.cuda.reset_peak_memory_stats(dev)
    ckpt = Checkpointer(ckpt_dir, save_every=updates) if ckpt_dir else None
    t0 = time.perf_counter()
    state, history = train(cfg, updates, seed=SEED, log_every=1, logger=clock, checkpointer=ckpt, device=dev)
    wall = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    launched = {k: v - before_launches[k] for k, v in kernel_launches().items()}
    per_update = clock.per_update_s()  # updates 2..N: the first is the warm-up
    rates = [B * T / dt for dt in per_update]
    if not all(np.isfinite(v) for r in history for v in r.values()) or len(history) != updates:
        raise AssertionError(f"{name} records not finite: {history}")
    init = cfg.make_model(torch.Generator().manual_seed(SEED)).state_dict()
    if not any(not torch.equal(v.cpu(), init[k]) for k, v in state.model.state_dict().items()):
        raise AssertionError(f"{name} did not move the parameters")

    step = make_step(cfg, state)
    box = [state]

    def update():
        box[0] = step(box[0])[0]

    for c in (*LN_COUNTERS.values(), *STEP_COUNTERS.values()):
        set_counter(c, 0)
    # Every kernel of the update ranked, so that the layer norm's are all found.
    prof = profiling.device_breakdown(update, warmup=0, reps=1, top=1 << 20)
    norms = {k: counter(c) for k, c in LN_COUNTERS.items()}
    stepped = step_counts()
    STEP_PER_UPDATE[name] = stepped["engine_step"]
    norms["ms"] = sum(t["ms"] for t in prof["top"] if LN_KERNEL in t["kernel"])
    norms["bound_ms"] = 1e3 * norms.pop("bound_bytes") / HBM_BYTES_PER_S
    norms["roofline"] = 100.0 * norms["bound_ms"] / norms["ms"] if norms["ms"] else 0.0
    LN_PER_UPDATE[name] = norms
    state = box[0]
    last = history[-1]
    record = {k: round(last[k], 6) for k in ("loss", "entropy", "approx_kl", "clip_frac", "after_loss", "grad_norm",
                                               "avg_episode_tile_sum", "best_tile") if k in last}
    log(
        name, B=B, T=T, model=f"resnet 64x4 bf16{' x2' if is_ppo and cfg.afterstate_critic else ''}", updates=updates,
        wall_s=round(wall, 3), first_update_s=round(clock.records[0][0] - t0, 3),
        ms_per_update=[round(1e3 * dt, 3) for dt in per_update], env_steps_per_s=[round(r, 1) for r in rates],
        env_steps_per_s_median=round(float(np.median(rates)), 1), peak_gib=round(peak_gib, 3),
        profiled_update=json.dumps({k: prof[k] for k in ("device_ms", "launches")}),
        top_kernels=json.dumps(prof["top"][:5]), kernel_launches=json.dumps(launched), records=json.dumps(record),
        layer_norm_per_update=json.dumps({k: round(v, 5) for k, v in norms.items()}),
        engine_steps_per_update=json.dumps(stepped),
    )
    # One step kernel an acting step, T an update; no plain step.
    check_other_paths(name, launched, updates * T)
    check_steps(f"{name}'s profiled update", stepped, T)
    if not 0 < norms["backward"] == norms["backward_sum"] <= norms["forward"] or not norms["ms"]:
        raise AssertionError(f"{name}: the ResNet's layer norms did not all run the kernel: {norms}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    env, batch, rollout_metrics = step.rollout(state)
    torch.cuda.synchronize()
    rollout_ms = 1e3 * (time.perf_counter() - t0)
    loss_before, aux0 = own_batch_loss(step, state, batch)
    t0 = time.perf_counter()
    metrics = step.learn(state, batch)
    torch.cuda.synchronize()
    learn_ms = 1e3 * (time.perf_counter() - t0)
    loss_after, _ = own_batch_loss(step, state, batch)
    state = dataclasses.replace(state, env=env, update_step=state.update_step + 1)
    finite = all(np.isfinite(float(v)) for v in {**metrics, **rollout_metrics}.values())
    fields = dict(update=state.update_step, rollout_ms=round(rollout_ms, 3), learn_ms=round(learn_ms, 3),
                  loss_on_own_batch_before=round(loss_before, 5), loss_on_own_batch_after=round(loss_after, 5),
                  grad_norm=round(float(metrics["grad_norm"]), 5), finite=finite)
    if is_ppo:
        fields.update(approx_kl_at_behavior=f"{aux0['approx_kl']:.3g}", clip_frac_at_behavior=aux0["clip_frac"],
                      approx_kl_last=f"{float(metrics['approx_kl_last']):.3g}", clip_frac=round(float(metrics["clip_frac"]), 5))
    log(f"{name}/last-update", **fields)
    if not finite or batch["actions"].numel() != B * T:
        raise AssertionError(f"{name}: the last update's metrics {metrics}")
    if not loss_after < loss_before:
        raise AssertionError(f"{name}: the learn phase did not lower the loss on its own batch: {loss_before} -> {loss_after}")
    if is_ppo and not abs(aux0["approx_kl"]) <= KL_AT_BEHAVIOR_TOL:
        raise AssertionError(f"{name}: approx_kl at the behavior parameters is {aux0['approx_kl']}")
    return state, step, batch


def ppo_bf16_phase(state, step, batch):
    """One minibatch's PPO loss and gradient norm: the bf16 net on the card
    against the same weights as a float32 net on the CPU. Held to
    ``LOSS_BF16_RTOL`` on the first minibatch of a fresh rollout, the
    gradient the next update takes; printed, unheld, on ``batch``, which
    the last learn phase fitted: its gradient is a few times smaller, a sum
    of residuals of both signs, where bf16's rounding of values near 70
    (steps of 0.25-0.5) shows."""
    from rein48_tpu_torch.models import nets
    from rein48_tpu_torch.train import a3c, common, ppo

    cfg = step.config
    beta = a3c.entropy_beta_at(cfg, state.update_step)
    f32 = nets.ResNetPolicy(64, 4, dtype=torch.float32)
    f32.load_state_dict({k: v.cpu() for k, v in state.model.state_dict().items()})
    f32_step = ppo.make_ppo_step(cfg, f32, state.optimizer)
    perm = step.permutations(state, batch["returns"].device)[0]
    fresh = step.rollout(state)[1]
    out = {}
    for which, b in (("fresh", fresh), ("fitted", batch)):
        mb = {k: v[0][:AS_BF16_BOARDS] for k, v in step.minibatches(b, perm).items()}
        for name, st, model, m in (("card_bf16", step, state.model, mb), ("cpu_f32", f32_step, f32, {k: v.cpu() for k, v in mb.items()})):
            loss, _ = st.minibatch_loss(m, st.loss_cfg._replace(entropy_beta=beta))
            grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
            out[which, name] = (float(loss.detach()), float(common.tree_norm(grads)))
    rel = {}
    for which in ("fresh", "fitted"):
        (lc, gc), (lf, gf) = out[which, "card_bf16"], out[which, "cpu_f32"]
        rel[which] = (abs(lc - lf) / abs(lf), abs(gc - gf) / gf)
        log(f"ppo/bf16-vs-f32/{which}", boards=AS_BF16_BOARDS, loss_card=round(lc, 6), loss_cpu_f32=round(lf, 6),
            grad_norm_card=round(gc, 6), grad_norm_cpu_f32=round(gf, 6), rel_err_loss=f"{rel[which][0]:.3g}",
            rel_err_grad_norm=f"{rel[which][1]:.3g}", rtol=LOSS_BF16_RTOL if which == "fresh" else None)
    if not (rel["fresh"][0] <= LOSS_BF16_RTOL and rel["fresh"][1] <= LOSS_BF16_RTOL):
        raise AssertionError("the bf16 PPO loss or gradient norm on the card disagrees with the float32 net")


def a3c_parity_phase(dev):
    """``A3CConfig.reference_parity()`` (B=64, T=100, the MLP at 64 hidden
    units on raw tiles, RMSprop, no mask) through ``train_a3c``, then one
    update by phases: every reward is zero and the targets are the
    bootstrap's discounts alone, cut at episode ends."""
    from rein48_tpu_torch.agents import a3c as a3c_agent
    from rein48_tpu_torch.train import a3c

    cfg = a3c.A3CConfig.reference_parity()
    zero_table_counts()
    before_launches = kernel_launches()
    clock = Clock()
    t0 = time.perf_counter()
    state, history = a3c.train_a3c(cfg, A3C_PARITY_UPDATES, seed=SEED, log_every=1, logger=clock, device=dev)
    wall = time.perf_counter() - t0
    launched = {k: v - before_launches[k] for k, v in kernel_launches().items()}
    step = a3c.make_a3c_step(cfg, state.model, state.optimizer)
    env, batch, _ = step.rollout(state)
    targets = batch["targets"]
    want = a3c_agent.n_step_returns(torch.zeros_like(targets), targets[-1], cfg.gamma, dones=batch["dones"],
                                    parity_drop_last_reward=True)
    zero_reward = not bool(batch["rewards"].count_nonzero())
    bootstrap_only = bool(torch.equal(targets, want))
    metrics = step.learn(state, batch)
    log("a3c/parity", B=cfg.batch_size, T=cfg.unroll_len, model="mlp 64 float32, raw tiles, rmsprop",
        updates=A3C_PARITY_UPDATES, wall_s=round(wall, 3), ms_per_update=[round(1e3 * dt, 3) for dt in clock.per_update_s()],
        rewards_all_zero=zero_reward, targets_bootstrap_only=bootstrap_only,
        targets_nonzero=int(targets.count_nonzero()), loss=round(float(metrics["loss"]), 6),
        critic_loss=round(float(metrics["critic_loss"]), 6), kernel_launches=json.dumps(launched),
        records=json.dumps({k: round(v, 6) for k, v in history[-1].items()}))
    if not (zero_reward and bootstrap_only) or not all(np.isfinite(v) for r in history for v in r.values()):
        raise AssertionError(f"a3c reference parity: rewards zero {zero_reward}, targets bootstrap-only {bootstrap_only}")
    check_other_paths("a3c reference parity", launched, A3C_PARITY_UPDATES * cfg.unroll_len)


def ppo_checkpoint_phase(state, cfg, ckpt_dir, dev):
    """The critic-carrying PPO state saved and restored into an init from
    another seed on the card (every tensor, the optimizer, the env, the seed
    equal; the next rollout and shuffles equal) and into one on the CPU (the
    same shuffles and sampling noise: the draws are named by the seed and
    the update step)."""
    from rein48_tpu_torch.engine import philox
    from rein48_tpu_torch.train import ppo
    from rein48_tpu_torch.utils.checkpoint import Checkpointer

    ck = Checkpointer(ckpt_dir)
    t0 = time.perf_counter()
    ck.save(state.update_step, state)
    save_s = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in (Path(ckpt_dir) / str(state.update_step)).iterdir())
    restored = ck.restore(ppo.init_ppo(cfg, SEED + 1, dev)[0])
    nets_equal = all(
        torch.equal(a, b)
        for m in ("model", "after_model")
        for a, b in zip(getattr(state, m).state_dict().values(), getattr(restored, m).state_dict().values())
    )
    equal = {
        "params": nets_equal,
        "optimizer": restored.optimizer.count == state.optimizer.count and all(
            torch.equal(a, b) for m in state.optimizer.moments for a, b in zip(state.optimizer.moments[m], restored.optimizer.moments[m])
        ),
        "env": all(torch.equal(getattr(state.env, f.name), getattr(restored.env, f.name)) for f in dataclasses.fields(state.env)),
        "seed_and_step": (restored.seed, restored.update_step) == (state.seed, state.update_step),
    }
    steps = [make_step(cfg, s) for s in (state, restored)]
    rolled = [st.rollout(s)[1] for st, s in zip(steps, (state, restored))]
    equal["next_rollout"] = all(bool(torch.equal(rolled[0][k], rolled[1][k])) for k in ("boards", "actions", "after_boards"))
    perms = [st.permutations(s, dev) for st, s in zip(steps, (state, restored))]
    equal["next_shuffles"] = bool(torch.equal(*perms))
    on_cpu = ck.restore(ppo.init_ppo(cfg, SEED + 1, "cpu")[0])
    cpu_perms = make_step(cfg, on_cpu).permutations(on_cpu, torch.device("cpu"))
    shape = (cfg.unroll_len, cfg.batch_size, 4)
    words = [philox.learner_words(s.seed, s.update_step, philox.SAMPLE, shape, device=d).cpu() for s, d in ((state, dev), (on_cpu, "cpu"))]
    noise = [philox.learner_gumbel(s.seed, s.update_step, shape, device=d).cpu() for s, d in ((state, dev), (on_cpu, "cpu"))]
    noise_err = float((noise[0] - noise[1]).abs().max())
    equal["cpu_resume_shuffles"] = bool(torch.equal(perms[0].cpu(), cpu_perms))
    equal["cpu_resume_noise_words"] = bool(torch.equal(*words))
    log("ppo/checkpoint", step=state.update_step, save_s=round(save_s, 4), bytes_on_disk=size,
        fields=json.dumps([f.name for f in dataclasses.fields(state)]), equal=json.dumps(equal),
        cpu_resume_gumbel_max_abs_err=f"{noise_err:.3g}")
    if not all(equal.values()) or noise_err > 1e-5:
        raise AssertionError(f"the restored PPO state differs: {equal}, gumbel noise err {noise_err}")


def ppo_cli_phase(dev):
    """``train --algo ppo --afterstate --checkpoint-dir`` at the CLI's
    defaults (B=4096, T=32, two ResNets 64x4, lr 3e-4) for 2 updates, then 2
    more, which resume; ``eval --algo ppo`` greedy and with ``--sample``;
    ``eval --algo search --depth 0`` on the afterstate critic. Every action
    played is legal, and eval takes gamma and the transform from
    ``train_config.json``."""
    from rein48_tpu_torch.engine import vector
    from rein48_tpu_torch.models import nets
    from rein48_tpu_torch.train import evaluate
    from rein48_tpu_torch.utils.checkpoint import Checkpointer

    with tempfile.TemporaryDirectory() as d:
        base = ["train", "--algo", "ppo", "--afterstate", "--checkpoint-dir", d, "--checkpoint-every", "2", "--log-every", "1",
                "--seed", str(SEED), "--updates", "2"]
        t0 = time.perf_counter()
        _, err1 = run_cli_output(base)
        out2, err2 = run_cli_output(base)
        wall = time.perf_counter() - t0
        finals = [ast.literal_eval(e.split("final: ", 1)[1].strip()) for e in (err1, err2)]
        resumed = "resumed from checkpoint step 2" in out2
        ck = Checkpointer(d)
        saved = ck.load_config()
        stats, legal = {}, {}
        evals = [("ppo", ["--algo", "ppo"]), ("ppo_sample", ["--algo", "ppo", "--sample"]),
                 ("search_depth0", ["--algo", "search", "--depth", "0", "--protocol", "first"])]
        leaf = None
        for name, args in evals:
            out, err = run_cli_output(["eval", *args, "--checkpoint-dir", d, "--num-envs", "256", "--max-steps", "200",
                                       "--seed", str(SEED)])
            stats[name] = json.loads(out.strip().splitlines()[-1])
            if name.startswith("search"):
                leaf = json.loads(err.split("value leaf ", 1)[1].splitlines()[0])
                leaf["afterstate_critic_leaf"] = "using afterstate-critic leaf" in err
        policy, after = nets.make_model("resnet"), nets.make_model("resnet")
        policy.load_state_dict(ck.restore_field("model"))
        after.load_state_dict(ck.restore_field("after_model"))
        policy, after = policy.to(dev).eval(), after.to(dev).eval()
        for name, fn in (("ppo", evaluate.greedy_policy(policy)),
                         ("search_depth0", evaluate._build_search_policy(0, after, "onehot", saved["gamma"], saved["reward_transform"]))):
            checked = LegalityCheck(fn)
            with torch.inference_mode():
                evaluate._first_episode_rollout(vector.reset_batch(SEED, 256, dev), policy_fn=checked, num_steps=32)
            legal[name] = int(checked.illegal)
        log("ppo/cli", argv=" ".join(base).replace(d, "<tmpdir>"), wall_s=round(wall, 3), resumed=resumed,
            updates=[f["update"] for f in finals], steps_per_sec=[round(f["steps_per_sec"], 1) for f in finals],
            loss=[round(f["loss"], 5) for f in finals], after_loss=[round(f["after_loss"], 5) for f in finals],
            eval_search_leaf=json.dumps(leaf), illegal_choices=json.dumps(legal),
            eval_avg_score=json.dumps({k: round(v["avg_score"], 3) for k, v in stats.items()}))
        if not resumed or [f["update"] for f in finals] != [2, 4] or any(legal.values()):
            raise AssertionError(f"train --algo ppo --afterstate did not resume, or an action was illegal: {finals} {legal}")
        if leaf["gamma"] != saved["gamma"] or leaf["reward_transform"] != saved["reward_transform"] or not leaf["afterstate_critic_leaf"]:
            raise AssertionError(f"eval did not take the saved settings or the critic leaf: {leaf} {saved['gamma']}")
        if not all(np.isfinite(v) for f in finals for v in f.values()) or not all(np.isfinite(v) for st in stats.values() for v in st.values()):
            raise AssertionError(f"train/eval --algo ppo gave non-finite values: {finals} {stats}")



class Probe:
    """A checkpointer stand-in for a trainer's loop: at each logging point it
    records ``fn(state)`` by update and saves nothing."""

    def __init__(self, fn):
        self.fn, self.seen = fn, {}

    def save_config(self, config) -> None:
        pass

    def latest_step(self):
        return None

    def maybe_save(self, step, state) -> bool:
        self.seen[step] = self.fn(state)
        return False


def same_params(module, init: dict) -> bool:
    return all(torch.equal(v.cpu(), init[k]) for k, v in module.state_dict().items())


def game_phase(dev):
    """``Game(seed=7)`` on the card plays the first legal action to the end;
    then ``play --control rand`` through the CLI."""
    from rein48_tpu_torch import Game
    from rein48_tpu_torch.engine import core

    t0 = time.perf_counter()
    game = Game(seed=7, device=dev)
    first = game.reset()
    ok = {"one_tile_after_reset": int((first != 0).sum()) == 1, "on_device": game._state.boards.device.type == torch.device(dev).type}
    done, steps, zero_reward, boards_match = False, 0, True, True
    while not done and steps < 3000:
        legal = game.legal_actions
        board, reward, done = game.step(int(np.flatnonzero(legal)[0]) if legal.any() else 0)
        exps = game._state.boards
        boards_match &= exps.dtype == torch.uint8 and bool((core.boards_to_values(exps).cpu().numpy() == board).all())
        boards_match &= bool((board == game.state_matrix).all())
        zero_reward &= reward == 0.0
        steps += 1
    ok.update(boards_match=boards_match, parity_zero_reward=zero_reward, game_over=done)
    wall = time.perf_counter() - t0
    out, _ = run_cli_output(["play", "--control", "rand", "--seed", "0"])
    last = out.strip().splitlines()[-1]
    log("game", seed=7, steps=steps, wall_s=round(wall, 3), ms_per_step=round(1e3 * wall / steps, 3),
        tile_sum=int(game.state_matrix.sum()), checks=json.dumps(ok), play=last)
    if not all(ok.values()) or not last.startswith("game_over=True"):
        raise AssertionError(f"Game on the card failed its checks: {ok}, play: {last}")


def parity_phase():
    """``parity --seeds 5`` (JAX's default) on the card, the C oracle required."""
    t0 = time.perf_counter()
    out, err = run_cli_output(["parity", "--seeds", "5"])
    wall = time.perf_counter() - t0
    result = json.loads(out.strip().splitlines()[-1])
    log("parity", seconds=round(wall, 3), parity=result["parity"], native_oracle=result["native_oracle"],
        steps=[g["steps"] for g in result["games"]], done=[g["done"] for g in result["games"]])
    if not (result["parity"] and result["native_oracle"]) or len(result["games"]) != 5:
        raise AssertionError(f"parity failed or ran without the native oracle: {result}")


def dqn_flagship_config(**kw):
    """``examples/train_dqn_tpu.py:45-51``: 4,096 envs, ResNet 64x4 bf16, two
    acting steps per update, epsilon to 0.03 over 10M steps; the rest at
    DQNConfig's defaults (2**20 slots, learn batch 8,192, adam 3e-4, tau
    0.995, learning from 50,000 transitions)."""
    from rein48_tpu_torch.train import dqn

    return dqn.DQNConfig(num_envs=4096, model="resnet", acting_steps_per_update=2, epsilon_decay_steps=10_000_000,
                         epsilon_end=0.03, **kw)


def learning_update(cfg) -> int:
    """The first update whose buffer reaches the learn gate."""
    per_update = cfg.num_envs * cfg.acting_steps_per_update
    return -(-min(cfg.min_replay_before_learn, cfg.replay_capacity) // per_update)


def replay_trainer_run(name, dev, cfg, updates, train, state_fn):
    """A replay trainer (``train_dqn``, ``train_ddpg``) at ``cfg`` through its
    entry point with a :class:`Probe` recording ``state_fn`` per update.
    Returns ``(state, history, probe, per-update seconds, peak GiB)``."""
    zero_table_counts()
    before = kernel_launches()
    clock = Clock()
    probe = Probe(state_fn)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state, history = train(cfg, updates, seed=SEED, log_every=1, logger=clock, checkpointer=probe, device=dev)
    wall = time.perf_counter() - t0
    launched = {k: v - before[k] for k, v in kernel_launches().items()}
    check_other_paths(name, launched)
    if len(history) != updates or not all(np.isfinite(v) for r in history for v in r.values()):
        raise AssertionError(f"{name} records not finite: {history}")
    per_update = [clock.records[0][0] - t0] + clock.per_update_s()
    return state, history, probe, per_update, wall, torch.cuda.max_memory_allocated(dev) / 2**30


def dqn_update_timed(step, state):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = step(state)
    float(metrics["loss"])
    return state, time.perf_counter() - t0


def dqn_flagship_phase(dev, ckpt_dir):
    """The DQN flagship through ``train_dqn``: updates 1-6 fill the buffer
    under the learn gate, 7 and 8 learn. Checked per update by a probe:
    parameters and Adam's count unchanged through update 6. Then the
    checkpoint phase (save, restore, two more updates each, bit for bit),
    timed learning updates, one profiled, and bf16 against float32."""
    from rein48_tpu_torch.train import dqn
    from rein48_tpu_torch.utils import profiling

    cfg = dqn_flagship_config()
    first = learning_update(cfg)
    init = cfg.make_model(torch.Generator().manual_seed(SEED)).state_dict()
    state, history, probe, per_update, wall, peak = replay_trainer_run(
        "dqn/flagship", dev, cfg, 8, dqn.train_dqn, lambda s: (same_params(s.model, init), s.optimizer.count))
    frozen = all(probe.seen[u] == (True, 0) for u in range(1, first))
    learned = [probe.seen[u][1] for u in range(first, 9)] == list(range(1, 9 - first + 1)) and not probe.seen[8][0]
    restored, ck_fields = dqn_checkpoint_phase(state, cfg, ckpt_dir, dev)
    step = dqn.make_dqn_step(cfg, state.model, state.target_model, state.optimizer)
    # Two more updates of the live and the restored state, deterministic
    # algorithms both, so that bit-equality is the checkpoint's to keep.
    torch.backends.cudnn.deterministic = True
    rstep = dqn.make_dqn_step(cfg, restored.model, restored.target_model, restored.optimizer)
    for _ in range(2):
        state, _ = step(state)
        restored, _ = rstep(restored)
    torch.backends.cudnn.deterministic = False
    resume = dqn_states_equal(state, restored)
    del restored, rstep
    counts = {"adam_count_after_10": state.optimizer.count, "replay_size": state.replay.size, "cursor": state.replay.cursor}
    filled = 10 * cfg.num_envs * cfg.acting_steps_per_update
    want_counts = {"adam_count_after_10": 10 - first + 1, "replay_size": filled, "cursor": filled % cfg.replay_capacity}
    timed = []
    for _ in range(2):
        state, dt = dqn_update_timed(step, state)
        timed.append(dt)
    box = [state]

    def update():
        box[0] = step(box[0])[0]

    prof = profiling.device_breakdown(update, warmup=0, reps=1, top=5)
    state = box[0]
    learn_s = per_update[first - 1:] + timed
    rates = [cfg.num_envs * cfg.acting_steps_per_update / dt for dt in learn_s]
    bf16 = dqn_bf16_phase(state, cfg, step)
    last = history[-1]
    log(
        "dqn/flagship", envs=cfg.num_envs, model="resnet 64x4 bf16", acting_steps=cfg.acting_steps_per_update,
        capacity=cfg.replay_capacity, learn_batch=cfg.learn_batch_size, first_learning_update=first, wall_s=round(wall, 3),
        ms_per_warmup_update=[round(1e3 * dt, 3) for dt in per_update[:first - 1]],
        ms_per_learning_update=[round(1e3 * dt, 3) for dt in learn_s], env_steps_per_s=[round(r, 1) for r in rates],
        env_steps_per_s_median=round(float(np.median(rates)), 1), peak_gib=round(peak, 3),
        profiled_learning_update=json.dumps({k: prof[k] for k in ("device_ms", "launches")}),
        top_kernels=json.dumps(prof["top"]), frozen_through_gate=frozen, adam_counts=json.dumps(probe.seen),
        counts=json.dumps(counts), checkpoint=json.dumps(ck_fields), resume_bit_for_bit=json.dumps(resume),
        bf16_vs_f32=json.dumps(bf16), records=json.dumps({k: round(last[k], 6) for k in ("loss", "td_abs", "q_mean", "epsilon")}),
    )
    if not (frozen and learned) or counts != want_counts or not all(resume.values()):
        raise AssertionError(f"dqn/flagship: gate {frozen} {learned} {probe.seen}, counts {counts}, resume {resume}")
    if not (bf16["rel_err_loss"] <= LOSS_BF16_RTOL and bf16["rel_err_grad_norm"] <= LOSS_BF16_RTOL):
        raise AssertionError(f"dqn/flagship: the bf16 loss or gradient norm disagrees with float32: {bf16}")
    return state, cfg


def dqn_states_equal(a, b) -> dict:
    tensors = lambda s: [*s.model.state_dict().values(), *s.target_model.state_dict().values()]  # noqa: E731
    return {
        "nets": all(torch.equal(x, y) for x, y in zip(tensors(a), tensors(b))),
        "optimizer": a.optimizer.count == b.optimizer.count and all(
            torch.equal(x, y) for m in a.optimizer.moments for x, y in zip(a.optimizer.moments[m], b.optimizer.moments[m])),
        "replay": (a.replay.cursor, a.replay.size) == (b.replay.cursor, b.replay.size) and all(
            torch.equal(a.replay.data[k], b.replay.data[k]) for k in a.replay.data),
        "env": all(torch.equal(getattr(a.env, f.name), getattr(b.env, f.name)) for f in dataclasses.fields(a.env)),
        "counters": (a.seed, a.update_step, a.env_steps) == (b.seed, b.update_step, b.env_steps),
    }


def dqn_checkpoint_phase(state, cfg, ckpt_dir, dev):
    """Save the flagship state (its 2**20-slot buffer too) and restore it into
    an init from another seed: seconds, bytes, and every field equal."""
    from rein48_tpu_torch.train import dqn
    from rein48_tpu_torch.utils.checkpoint import Checkpointer

    ck = Checkpointer(ckpt_dir)
    ck.save_config(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.save(state.update_step, state)
    save_s = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in (Path(ckpt_dir) / str(state.update_step)).iterdir())
    fresh = dqn.init_dqn(cfg, SEED + 1, dev)[0]
    t0 = time.perf_counter()
    restored = ck.restore(fresh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    equal = dqn_states_equal(state, restored)
    fields = {"step": state.update_step, "save_s": round(save_s, 4), "restore_s": round(restore_s, 4), "bytes": size,
              "replay_bytes": sum(v.numel() * v.element_size() for v in state.replay.data.values()), "equal": equal}
    if not all(equal.values()):
        raise AssertionError(f"the restored DQN state differs: {equal}")
    return restored, fields


def dqn_bf16_phase(state, cfg, step) -> dict:
    """One learn batch's loss and gradient norm: the bf16 nets against float32
    copies of the same weights, on the card without TF32."""
    from rein48_tpu_torch.train import common, dqn

    kwargs = tuple((k, v) for k, v in cfg.model_kwargs if k != "dtype") + (("dtype", torch.float32),)
    f32_cfg = dataclasses.replace(cfg, model_kwargs=kwargs)
    device = next(state.model.parameters()).device
    model, target = f32_cfg.make_model().to(device), f32_cfg.make_model().to(device)
    model.load_state_dict(state.model.state_dict())
    target.load_state_dict(state.target_model.state_dict())
    f32_step = dqn.make_dqn_step(f32_cfg, model, target, common.make_optimizer("adam", 0.0, list(model.parameters())))
    batch = step.sample(state.replay, step.sample_indices(state, state.replay))
    out = {}
    for name, st in (("bf16", step), ("f32", f32_step)):
        loss, _ = st.loss(batch)
        grads = torch.autograd.grad(loss, list(st.model.parameters()), allow_unused=True)
        out[name] = (float(loss.detach()), float(common.tree_norm(grads)))
    (lb, gb), (lf, gf) = out["bf16"], out["f32"]
    return {"boards": cfg.learn_batch_size, "loss_bf16": round(lb, 6), "loss_f32": round(lf, 6), "grad_norm_bf16": round(gb, 6),
            "grad_norm_f32": round(gf, 6), "rel_err_loss": abs(lb - lf) / lf, "rel_err_grad_norm": abs(gb - gf) / gf,
            "rtol": LOSS_BF16_RTOL}


def dqn_nstep_phase(dev):
    """``examples/train_dqn_nstep_tpu.py:49-58``: the flagship with 5-step
    targets at gamma 0.997, 8 updates. Then the next update's draw on the
    final buffer: every chain lies inside the valid window (its last slot
    younger than the oldest valid one) and is one env's consecutive steps
    (each slot's next board is the board of the slot ``num_envs`` later)."""
    from rein48_tpu_torch.train import dqn

    cfg = dqn_flagship_config(n_step=5, gamma=0.997)
    state, history, probe, per_update, wall, peak = replay_trainer_run(
        "dqn/nstep", dev, cfg, 8, dqn.train_dqn, lambda s: s.optimizer.count)
    first = learning_update(cfg)
    step = dqn.make_dqn_step(cfg, state.model, state.target_model, state.optimizer)
    rep, stride, cap = state.replay, cfg.num_envs, cfg.replay_capacity
    j = step.sample_indices(state, rep)
    ages = j[:, None] + stride * torch.arange(cfg.n_step, device=dev)
    slots = (rep.cursor - rep.size + ages) % cap
    inside = bool((ages < rep.size).all()) and int(j.max()) < rep.size - (cfg.n_step - 1) * stride
    chained = bool(torch.equal(rep.data["next_board"][slots[:, :-1]], rep.data["board"][slots[:, 1:]]))
    batch = step.sample(rep, j)
    finite = bool(torch.isfinite(batch["reward"]).all())
    log("dqn/nstep", n_step=cfg.n_step, gamma=cfg.gamma, updates=8, wall_s=round(wall, 3),
        ms_per_update=[round(1e3 * dt, 3) for dt in per_update], first_learning_update=first,
        adam_counts=json.dumps(probe.seen), chains=cfg.learn_batch_size, chains_inside_window=inside,
        chains_consecutive=chained, done_share=round(float(batch["done"].float().mean()), 5), peak_gib=round(peak, 3),
        records=json.dumps({k: round(history[-1][k], 6) for k in ("loss", "td_abs", "q_mean")}))
    if not (inside and chained and finite) or probe.seen[8] != 8 - first + 1:
        raise AssertionError(f"dqn/nstep: inside {inside}, consecutive {chained}, finite {finite}, counts {probe.seen}")


def dqn_qnet_phase(dev):
    """The ``dqn-4k`` preset (``QNetwork``, 4,096 envs): 8 updates."""
    from rein48_tpu_torch import configs
    from rein48_tpu_torch.train import dqn

    cfg = configs.dqn_4k()
    state, history, probe, per_update, wall, peak = replay_trainer_run("dqn/qnet", dev, cfg, 8, dqn.train_dqn, lambda s: s.replay.size)
    log("dqn/qnet", model="qnet (32, 64) dueling bf16", envs=cfg.num_envs, updates=8, wall_s=round(wall, 3),
        ms_per_update=[round(1e3 * dt, 3) for dt in per_update], replay_size=state.replay.size, peak_gib=round(peak, 3),
        records=json.dumps({k: round(history[-1][k], 6) for k in ("loss", "td_abs", "q_mean", "epsilon")}))
    if state.replay.size != 8 * cfg.num_envs:
        raise AssertionError(f"dqn/qnet: replay size {state.replay.size}")


def dqn_eval_phase(ckpt_dir):
    """``eval --algo dqn --checkpoint-dir`` at 1,024 envs and 500 steps."""
    t0 = time.perf_counter()
    out, err = run_cli_output(["eval", "--algo", "dqn", "--checkpoint-dir", ckpt_dir, "--num-envs", str(DQN_EVAL_ENVS),
                               "--max-steps", str(DQN_EVAL_STEPS), "--seed", str(SEED)])
    wall = time.perf_counter() - t0
    stats = json.loads(out.strip().splitlines()[-1])
    log("dqn/eval", envs=DQN_EVAL_ENVS, steps=DQN_EVAL_STEPS, wall_s=round(wall, 3), ms_per_step=round(1e3 * wall / DQN_EVAL_STEPS, 3),
        restored="restored step 8" in err, stats=json.dumps({k: round(v, 3) for k, v in stats.items()}))
    if "restored step 8" not in err or not all(np.isfinite(v) for v in stats.values()):
        raise AssertionError(f"eval --algo dqn failed: {err} {stats}")


def ddpg_phase(dev):
    """``DDPGConfig()`` through ``train_ddpg`` (2,048 envs, 2**19 slots, batch
    4,096, learning from 20,000 transitions): 12 updates, a probe checking
    that the parameters stay through the cold updates while both Adam counts
    advance from the first."""
    from rein48_tpu_torch.train import ddpg

    cfg = ddpg.DDPGConfig()
    first = -(-cfg.min_replay_before_learn // cfg.num_envs)
    gen = torch.Generator().manual_seed(SEED)
    actor0, critic0 = cfg.make_actor(gen).state_dict(), cfg.make_critic(gen).state_dict()

    def probe_fn(s):
        return same_params(s.actor, actor0) and same_params(s.critic, critic0), s.actor_opt.count, s.critic_opt.count

    state, history, probe, per_update, wall, peak = replay_trainer_run("ddpg", dev, cfg, DDPG_UPDATES, ddpg.train_ddpg, probe_fn)
    cold_ok = all(probe.seen[u] == (True, u, u) for u in range(1, first))
    warm_ok = all(probe.seen[u] == (False, u, u) for u in range(first, DDPG_UPDATES + 1))
    log("ddpg", envs=cfg.num_envs, capacity=cfg.replay_capacity, learn_batch=cfg.learn_batch_size, updates=DDPG_UPDATES,
        first_learning_update=first, wall_s=round(wall, 3), ms_per_update=[round(1e3 * dt, 3) for dt in per_update],
        env_steps_per_s_learning=[round(cfg.num_envs / dt, 1) for dt in per_update[first - 1:]], peak_gib=round(peak, 3),
        probe=json.dumps(probe.seen), records=json.dumps({k: round(history[-1][k], 6) for k in ("critic_loss", "actor_loss", "td_abs")}))
    if not (cold_ok and warm_ok) or state.actor_opt.count != DDPG_UPDATES or state.critic_opt.count != DDPG_UPDATES:
        raise AssertionError(f"ddpg: cold/learning checks failed: {probe.seen}")


def replay_cli_phase():
    """``train --algo dqn`` and ``train --algo ddpg`` through the CLI, 3
    updates each at ``--batch-size 1024``."""
    for algo in ("dqn", "ddpg"):
        t0 = time.perf_counter()
        _, err = run_cli_output(["train", "--algo", algo, "--batch-size", "1024", "--updates", "3", "--log-every", "1",
                                 "--seed", str(SEED)])
        final = ast.literal_eval(err.split("final: ", 1)[1].strip())
        log(f"{algo}/cli", wall_s=round(time.perf_counter() - t0, 3), update=final["update"],
            steps_per_sec=round(final["steps_per_sec"], 1), replay_size=final["replay_size"])
        if final["update"] != 3 or final["replay_size"] != 3 * 1024 or not all(np.isfinite(v) for v in final.values()):
            raise AssertionError(f"train --algo {algo} failed: {final}")

# Multi-process training (``parallel/``). The card machine has one card, so
# the ranks of these phases share it over gloo (CUDA tensors; NCCL runs one
# rank): they check the sharded path, and two processes time-slice one card,
# so no time here is a scaling figure. The rollout at the bench shape; the
# flagship afterstate trainer at full width (B=8192 global, T=32, ResNet 64x4
# bf16, 2 epochs x 4 minibatches), 2 updates; the SJ_2X4 "mxu" trainer at
# B=1024 global, T=128, step and delayed/4, and "cached" delayed/4 at 128
# prefix rows of SJ_2X4's 512, one update each; PPO with the critic, A3C and
# the DQN flagship's learn gate at 1,024 envs in float32, 1-2 updates; the
# A3C MLP over dp=1 x tp=2, saving at each of its 2 updates, and the
# flagship afterstate learner (ResNet 64x4 bf16) over dp=1 x tp=2 on
# PAR_CKPT_ENVS envs (gloo's gathers of the sharded layers' features go
# through the host), 2 updates saving at each; both resumed from update 1 in
# a fresh pair of ranks; the CLI under torchrun.
PAR_RANKS = 2
PAR_CKPT_ENVS = 128
PAR_AS_UPDATES, PAR_NT_UPDATES = 2, 1
PAR_FAMILY_ENVS = 1024
PAR_TIMEOUT_S = 420
# Every decision of a board on which both runs agree up to then; a near-tie
# of bf16 values may fall the other way at a rank's batch size.
PAR_DECISIONS_MIN = 0.95


def _par_nt_configs():
    from rein48_tpu_torch.agents import ntuple as ntuple_lib
    from rein48_tpu_torch.train import ntuple as nt

    base = dict(batch_size=NT_B, steps_per_update=NT_T, tuples=ntuple_lib.SJ_2X4)
    return {
        "mxu/step": nt.NTupleTrainConfig(table_backend="mxu", update_mode="step", **base),
        "mxu/delayed": nt.NTupleTrainConfig(table_backend="mxu", update_mode="delayed", delay_window=4, **base),
        "cached/delayed": nt.NTupleTrainConfig(
            table_backend="cached", update_mode="delayed", delay_window=4, cache_prefix_rows=128, **base
        ),
    }


def _par_family_configs():
    from rein48_tpu_torch.train import a3c, ppo

    f32 = (("dtype", torch.float32),)
    return {
        "ppo+critic": dataclasses.replace(
            ppo_config(critic=True), batch_size=PAR_FAMILY_ENVS, model_kwargs=f32, after_model_kwargs=f32
        ),
        "a3c": dataclasses.replace(a3c_config(), batch_size=PAR_FAMILY_ENVS, model_kwargs=f32),
        "dqn": dataclasses.replace(
            dqn_flagship_config(), num_envs=PAR_FAMILY_ENVS, model_kwargs=f32, min_replay_before_learn=4 * PAR_FAMILY_ENVS
        ),
        "a3c-mlp/tp": a3c.A3CConfig(batch_size=PAR_FAMILY_ENVS, unroll_len=8, model="mlp"),
    }


def _host(t):
    return t.detach().cpu().clone()


def _full_params(model, mesh) -> dict:
    from rein48_tpu_torch.parallel import mesh as mesh_lib

    sd = model.state_dict() if mesh is None else mesh_lib.full_state_dict(model, mesh)
    return {k: _host(v) for k, v in sd.items()}


def par_rollout(mesh, dev) -> dict:
    """The rollout kernel on this rank's slice of B=65536, T=2048 (its env
    ids keyed into the global streams), its time, and the stats summed over
    the ranks."""
    from rein48_tpu_torch.engine import fused, vector
    from rein48_tpu_torch.parallel import mesh as mesh_lib
    from rein48_tpu_torch.parallel import spmd

    state = vector.reset_batch(SEED + 5, BENCH_B, dev)
    lo = 0
    if mesh is not None:
        lo = mesh_lib.batch_slice(mesh, BENCH_B).start
        state = mesh_lib.shard_env_state(state, mesh)
    before = counter(ROLLOUT_COUNTER)
    final, stats = fused.rollout_random_fused(state, SEED + 6, BENCH_T, env_base=lo)
    ms = cuda_ms(lambda: fused.rollout_random_fused(state, SEED + 6, BENCH_T, env_base=lo), reps=3)
    fields = [f.name for f in dataclasses.fields(stats)]
    sums = torch.stack([getattr(stats, f).to(torch.int64).sum() for f in fields if f != "max_exponent"]
                       + [getattr(stats, "max_exponent").to(torch.int64).max()])
    if mesh is not None:
        table = spmd.all_gather(sums, mesh.dp_group)
        sums = torch.cat([table[:, :-1].sum(0), table[:, -1:].amax(0)])
    return {"boards": _host(final.boards), "stats": _host(sums), "ms": ms, "launches": counter(ROLLOUT_COUNTER) - before}


def par_afterstate(mesh, dev) -> dict:
    """``train_afterstate_td`` at the flagship, 2 updates: the first
    rollout's decisions, the records, the parameters, the last update's ms,
    the gradient all-reduce's ms per update and the peak memory."""
    from rein48_tpu_torch.parallel import spmd
    from rein48_tpu_torch.train import afterstate

    cfg = afterstate_config()
    first = []
    rollout = afterstate.AfterstateTDStep.rollout
    reduce_s = [0.0]
    psum = spmd.psum_grads

    def recording_rollout(self, state, **kw):
        torch.cuda.synchronize()
        starts.append(time.perf_counter())
        env, batch, metrics = rollout(self, state, **kw)
        if not first:
            first.append(_host(batch["after_boards"]))
        return env, batch, metrics

    def timed_psum(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = psum(*args)
        torch.cuda.synchronize()
        reduce_s[0] += time.perf_counter() - t0
        return out

    starts = []
    torch.cuda.reset_peak_memory_stats(dev)
    afterstate.AfterstateTDStep.rollout, spmd.psum_grads = recording_rollout, timed_psum
    try:
        state, history = afterstate.train_afterstate_td(cfg, PAR_AS_UPDATES, seed=SEED, mesh=mesh, log_every=1, device=dev)
        torch.cuda.synchronize()
        end = time.perf_counter()
    finally:
        afterstate.AfterstateTDStep.rollout, spmd.psum_grads = rollout, psum
    return {
        "decisions": first[0], "history": [{k: v for k, v in r.items() if k != "steps_per_sec"} for r in history],
        "params": _full_params(state.model, mesh), "ms_per_update": 1e3 * (end - starts[-1]),
        "allreduce_ms_per_update": 1e3 * reduce_s[0] / PAR_AS_UPDATES,
        "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
    }


def par_ntuple(mesh, dev) -> dict:
    """``train_ntuple`` in each configuration of ``_par_nt_configs``: the
    tables (in logical order) after its first window alone, whose decisions
    all come from the initial tables, and after ``PAR_NT_UPDATES`` updates,
    with the kernels' launches per update."""
    from rein48_tpu_torch.train import ntuple as nt

    def tables(state, cfg):
        t = logical_tables(state.params) if cfg.table_backend == "cached" else state.params
        return {k: _host(v) for k, v in t.items() if v.dtype == torch.float32}

    out = {}
    for name, cfg in _par_nt_configs().items():
        first = dataclasses.replace(cfg, steps_per_update=cfg.delay_window if cfg.update_mode == "delayed" else 1)
        first_state, _ = nt.train_ntuple(first, 1, seed=SEED, mesh=mesh, device=dev)
        zero_table_counts()
        state, history = nt.train_ntuple(cfg, PAR_NT_UPDATES, seed=SEED, mesh=mesh, log_every=1, device=dev)
        out[name] = {
            "first_window": tables(first_state, cfg), "tables": tables(state, cfg),
            "history": [{k: v for k, v in r.items() if k != "steps_per_sec"} for r in history],
            "launches_per_update": {k: v / PAR_NT_UPDATES for k, v in table_counts().items() if v},
            "boards": _host(state.env.boards),
        }
    return out


def tp_mesh():
    from rein48_tpu_torch.parallel import mesh as mesh_lib

    return mesh_lib.make_mesh(mesh_lib.MeshConfig(tp=PAR_RANKS))


def timed_checkpointer(directory, save_every: int = 1):
    """A ``Checkpointer`` that keeps the seconds of each save (on every rank
    its gather, on rank 0 also the write; ``save_s``), of each save's gather
    alone (``gather_s``) and of each restore (``restore_s``)."""
    from rein48_tpu_torch.utils.checkpoint import Checkpointer

    class Timed(Checkpointer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.save_s, self.gather_s, self.restore_s = [], [], []

        def maybe_save(self, step, state, gather=None):
            def timed_gather(s):
                t0 = time.perf_counter()
                s = gather(s)
                torch.cuda.synchronize()
                self.gather_s.append(time.perf_counter() - t0)
                return s

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            saved = super().maybe_save(step, state, gather=None if gather is None else timed_gather)
            if saved:
                self.save_s.append(time.perf_counter() - t0)
            return saved

        def restore(self, state_like, step=None):
            t0 = time.perf_counter()
            state = super().restore(state_like, step)
            torch.cuda.synchronize()
            self.restore_s.append(time.perf_counter() - t0)
            return state

    return Timed(str(directory), save_every=save_every)


def par_families(mesh, dev, root=None) -> dict:
    """PPO with the critic and A3C (1 update each), the DQN flagship's learn
    gate (2 updates: cold, then learning), and the A3C MLP over tp (2
    updates; ``mesh`` a dp=1 x tp=2 mesh there, saving at each update under
    ``root``)."""
    from rein48_tpu_torch.train import a3c, dqn, ppo

    out = {}
    for name, cfg in _par_family_configs().items():
        m, ckpt = mesh, None
        if name.endswith("/tp") and mesh is not None:
            m, ckpt = tp_mesh(), timed_checkpointer(Path(root) / "a3c-tp")
        if name == "dqn":
            state, history = dqn.train_dqn(cfg, 2, seed=SEED, mesh=m, log_every=1, device=dev)
            extra = {"optimizer_count": state.optimizer.count}
        elif name.startswith("ppo"):
            state, history = ppo.train_ppo(cfg, 1, seed=SEED, mesh=m, log_every=1, device=dev)
            extra = {"after_params": _full_params(state.after_model, m)}
        else:
            state, history = a3c.train_a3c(
                cfg, 2 if name.endswith("/tp") else 1, seed=SEED, mesh=m, log_every=1, checkpointer=ckpt, device=dev
            )
            extra = {} if ckpt is None else {"save_s": ckpt.save_s}
        out[name] = {
            "history": [{k: v for k, v in r.items() if k != "steps_per_sec"} for r in history],
            "params": _full_params(state.model, m), "boards": _host(state.env.boards), **extra,
        }
    return out


def tp_afterstate_config():
    return dataclasses.replace(afterstate_config(), batch_size=PAR_CKPT_ENVS)


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms inside, so that bit-equality of two
    runs is the checkpoint's to keep."""
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = False


def _learner_bytes(state) -> int:
    """This rank's bytes of the learner: its slices of the params and the moments."""
    tensors = [*state.model.parameters(), *(t for ts in state.optimizer.moments.values() for t in ts)]
    return sum(t.numel() * t.element_size() for t in tensors)


def par_checkpoint_tp(mesh, dev, root) -> dict:
    """The flagship afterstate learner (ResNet 64x4 bf16) at dp=1 x tp=2 on
    ``PAR_CKPT_ENVS`` envs, 2 updates saving at each under ``root``, cuDNN
    deterministic: the records, the seconds of each save and its gather, and
    this rank's learner bytes."""
    from rein48_tpu_torch.train import afterstate

    ckpt = timed_checkpointer(Path(root) / "afterstate-tp")
    with deterministic_cudnn():
        state, history = afterstate.train_afterstate_td(tp_afterstate_config(), 2, seed=SEED, mesh=tp_mesh(),
                                                        log_every=1, checkpointer=ckpt, device=dev)
    return {"history": _no_rate(history), "save_s": ckpt.save_s, "gather_s": ckpt.gather_s,
            "learner_bytes": _learner_bytes(state)}


def par_resume(mesh, dev, root) -> dict:
    """In a fresh pair of ranks, at dp=1 x tp=2: the A3C MLP and the
    afterstate learner resumed from their update-1 checkpoints (copied under
    ``root`` as ``*-resume``) for their second update, which is saved."""
    from rein48_tpu_torch.train import a3c, afterstate

    out = {}
    ckpt = timed_checkpointer(Path(root) / "a3c-tp-resume")
    _, history = a3c.train_a3c(_par_family_configs()["a3c-mlp/tp"], 1, seed=SEED, mesh=tp_mesh(), log_every=1,
                               checkpointer=ckpt, device=dev)
    out["a3c-mlp/tp"] = {"history": _no_rate(history), "restore_s": ckpt.restore_s}
    ckpt = timed_checkpointer(Path(root) / "afterstate-tp-resume")
    with deterministic_cudnn():
        _, history = afterstate.train_afterstate_td(tp_afterstate_config(), 1, seed=SEED, mesh=tp_mesh(),
                                                    log_every=1, checkpointer=ckpt, device=dev)
    out["afterstate"] = {"history": _no_rate(history), "restore_s": ckpt.restore_s, "save_s": ckpt.save_s}
    return out


def _no_rate(history):
    return [{k: v for k, v in r.items() if k != "steps_per_sec"} for r in history]


PAR_PHASES = ("rollout", "afterstate", "ntuple", "families")
# Each spawn of a pair of ranks runs these phases; the second is a fresh pair.
PAR_SPAWNS = (PAR_PHASES + ("checkpoint-tp",), ("resume",))


def _par_rank(rank: int, store: str, out: str, names) -> None:
    """One rank of the gloo group on the card: the parallel phases ``names``,
    their results saved for the parent in ``out``, checkpoints beside it; a
    failure is written beside the results."""
    from rein48_tpu_torch.parallel import multihost

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    try:
        multihost.initialize(f"file://{store}", PAR_RANKS, rank, backend="gloo", device=dev)
        mesh = multihost.global_mesh()
        root = Path(out).parent
        phases = {
            "rollout": par_rollout, "afterstate": par_afterstate, "ntuple": par_ntuple,
            "families": lambda m, d: par_families(m, d, root),
            "checkpoint-tp": lambda m, d: par_checkpoint_tp(m, d, root),
            "resume": lambda m, d: par_resume(m, d, root),
        }
        results = {}
        for name in names:
            t0 = time.perf_counter()
            results[name] = phases[name](mesh, dev)
            results[f"{name}_s"] = time.perf_counter() - t0
        torch.save(results, Path(out) / f"rank{rank}.pt")
    except BaseException:
        import traceback

        (Path(out) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        multihost.shutdown()


def parallel_nccl_phase(dev) -> None:
    """``[parallel/nccl]``: one flagship afterstate update through
    ``train_afterstate_td(mesh=...)`` of a one-rank NCCL group against the
    same update without a mesh, deterministic cuDNN for the pair: equal bit
    for bit (one rank divides by one)."""
    import torch.distributed as dist

    from rein48_tpu_torch.parallel import multihost
    from rein48_tpu_torch.train import afterstate

    cfg = afterstate_config()
    runs = []
    torch.backends.cudnn.deterministic = True
    try:
        for joined in (False, True):
            mesh = None
            if joined:
                multihost.initialize(num_processes=1, process_id=0, backend="nccl", device=dev)
                mesh = multihost.global_mesh()
                backend = dist.get_backend()
            try:
                t0 = time.perf_counter()
                state, history = afterstate.train_afterstate_td(cfg, 1, seed=SEED, mesh=mesh, log_every=1, device=dev)
                runs.append((state, history, time.perf_counter() - t0))
            finally:
                if joined:
                    multihost.shutdown()
    finally:
        torch.backends.cudnn.deterministic = False
    (a, ha, _), (b, hb, wall) = runs
    equal = {
        "params": all(torch.equal(x, y) for x, y in zip(a.model.state_dict().values(), b.model.state_dict().values())),
        "adam": all(
            torch.equal(x, y) for m in a.optimizer.moments for x, y in zip(a.optimizer.moments[m], b.optimizer.moments[m])
        ),
        "boards": bool(torch.equal(a.env.boards, b.env.boards)),
        "records": [{k: v for k, v in r.items() if k != "steps_per_sec"} for r in ha]
        == [{k: v for k, v in r.items() if k != "steps_per_sec"} for r in hb],
    }
    log("parallel/nccl", backend=backend, world=1, B=cfg.batch_size, T=cfg.unroll_len, update_s=round(wall, 3),
        loss=hb[0]["loss"], equal=json.dumps(equal))
    if not all(equal.values()):
        raise AssertionError(f"a one-rank NCCL update differs from the update without a mesh: {equal}")


def _params_within(got: dict, want: dict, bound: float) -> float:
    err = max(float((got[k] - want[k]).abs().max()) for k in want)
    if not err <= bound:
        raise AssertionError(f"parameters differ by {err} > {bound}")
    return err


def close_tables(got, want, scales) -> tuple[bool, float, float]:
    """Each ``got`` against ``want`` at the scatters' tolerance,
    ``testing.SUM_ATOL + testing.SUM_RTOL * scale`` (the kernels' atomics
    reassociate the scatters' sums, whose rounding grows with their terms).

    Returns (all within, largest absolute difference, largest difference
    over what the tolerance allows: at most 1 when all are within).
    """
    from rein48_tpu_torch.testing import SUM_ATOL, SUM_RTOL

    err, ratio = 0.0, 0.0
    for g, w, sc in zip(got, want, scales):
        d = (g - w).abs()
        err = max(err, float(d.max()))
        ratio = max(ratio, float((d / (SUM_ATOL + SUM_RTOL * sc)).max()))
    return ratio <= 1.0, err, ratio


def _same_across_ranks(results, path) -> bool:
    def get(r):
        for k in path:
            r = r[k]
        return r

    a = get(results[0])
    for other in results[1:]:
        b = get(other)
        if isinstance(a, dict):
            if any(not torch.equal(a[k], b[k]) for k in a):
                return False
        elif a != b:
            return False
    return True


def _spawn_pair(out: Path, names) -> list[dict]:
    """A fresh pair of gloo ranks on the card (spawned; the kernels are
    built already) running the parallel phases ``names``: each rank's results."""
    import torch.multiprocessing as mp

    out.mkdir()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_par_rank, args=(r, str(out / "store"), str(out), names)) for r in range(PAR_RANKS)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(PAR_TIMEOUT_S)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [f.read_text() for f in sorted(out.glob("rank*.err"))]
    if errors or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"a rank failed (exit codes {[p.exitcode for p in procs]}):\n" + "\n".join(errors))
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(PAR_RANKS)]


def _copy_step(src: Path, step: int, dst: Path) -> None:
    """A checkpoint directory holding step ``step`` of ``src`` alone, and its config."""
    dst.mkdir()
    shutil.copytree(src / str(step), dst / str(step))
    shutil.copy(src / "train_config.json", dst)


def _saved_equal(a: Path, b: Path, step: int) -> bool:
    """Two checkpoints of ``step`` hold the same bits, field for field."""
    def same(x, y):
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(same(x[k], y[k]) for k in x)
        if isinstance(x, list):
            return len(x) == len(y) and all(same(u, v) for u, v in zip(x, y))
        if torch.is_tensor(x):
            return x.dtype == y.dtype and bool(torch.equal(x, y))
        return x == y

    load = lambda d: torch.load(d / str(step) / "state.pt", weights_only=True)  # noqa: E731
    return same(load(a), load(b))


def parallel_phases(dev, card: str) -> None:
    """``[parallel/rollout|afterstate|ntuple|families|tp|checkpoint-tp]``:
    two gloo ranks on the card, each phase held against the same run in this
    process without a mesh; the tp runs' update-1 checkpoints resumed in a
    fresh pair of ranks (and the A3C one here)."""
    from rein48_tpu_torch.train import a3c

    phases = {"rollout": par_rollout, "afterstate": par_afterstate, "ntuple": par_ntuple, "families": par_families}
    t0 = time.perf_counter()
    ref = {name: phases[name](None, dev) for name in PAR_PHASES}
    # A second one-process n-tuple run: the card's own spread from run to run.
    ref_again = par_ntuple(None, dev)
    ref_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    root_dir = tempfile.TemporaryDirectory()
    root = Path(root_dir.name)
    t0 = time.perf_counter()
    ranks = _spawn_pair(root / "spawn0", PAR_SPAWNS[0])
    ranks_s = time.perf_counter() - t0
    for name in ("a3c-tp", "afterstate-tp"):
        _copy_step(root / name, 1, root / f"{name}-resume")
    t0 = time.perf_counter()
    resumed = [r["resume"] for r in _spawn_pair(root / "spawn1", PAR_SPAWNS[1])]
    resume_s = time.perf_counter() - t0
    log("parallel/spawn", ranks=PAR_RANKS, backend="gloo", one_process_s=round(ref_s, 1), ranks_s=round(ranks_s, 1),
        resume_ranks_s=round(resume_s, 1),
        rank_phase_s=json.dumps({k: round(ranks[0][f"{k}_s"], 1) for k in PAR_SPAWNS[0]}))

    # The rollout: boards and summed stats bit for bit.
    got = [r["rollout"] for r in ranks]
    boards_equal = bool(torch.equal(torch.cat([g["boards"] for g in got]), ref["rollout"]["boards"]))
    stats_equal = all(torch.equal(g["stats"], ref["rollout"]["stats"]) for g in got)
    log("parallel/rollout", B=BENCH_B, T=BENCH_T, ms_per_rank=[round(g["ms"], 4) for g in got],
        one_process_ms=round(ref["rollout"]["ms"], 4), launches_per_rank=[g["launches"] for g in got],
        boards_equal=boards_equal, stats_equal=stats_equal, stats=ref["rollout"]["stats"].tolist())
    if not (boards_equal and stats_equal):
        raise AssertionError("the sharded rollout differs from the one-process kernel's")

    # The flagship afterstate trainer at full width.
    got, want = [r["afterstate"] for r in ranks], ref["afterstate"]
    decisions = torch.cat([g["decisions"] for g in got], dim=1)
    same = (decisions == want["decisions"]).flatten(2).all(-1)  # [T, B]
    share, share_first = float(same.float().mean()), float(same[0].float().mean())
    loss_err = abs(got[0]["history"][0]["loss"] - want["history"][0]["loss"]) / abs(want["history"][0]["loss"])
    steps = PAR_AS_UPDATES * afterstate_config().num_epochs * afterstate_config().num_minibatches
    bound = 2 * afterstate_config().learning_rate * steps
    param_err = _params_within(got[0]["params"], want["params"], bound)
    replicated = _same_across_ranks(ranks, ("afterstate", "params")) and _same_across_ranks(ranks, ("afterstate", "history"))
    log("parallel/afterstate", B=8192, T=32, model="resnet 64x4 bf16", updates=PAR_AS_UPDATES,
        equal_decisions=round(share, 6), equal_decisions_first_step=round(share_first, 6),
        loss=[h["loss"] for h in got[0]["history"]], one_process_loss=[h["loss"] for h in want["history"]],
        loss_rel_err_first=f"{loss_err:.3g}", max_param_err=f"{param_err:.3g}", param_bound=bound,
        ms_per_update_per_rank=[round(g["ms_per_update"], 1) for g in got],
        one_process_ms_per_update=round(want["ms_per_update"], 1),
        allreduce_ms_per_update_per_rank=[round(g["allreduce_ms_per_update"], 2) for g in got],
        peak_gib_per_rank=[round(g["peak_gib"], 3) for g in got], one_process_peak_gib=round(want["peak_gib"], 3),
        replicated_equal=replicated)
    if share_first < PAR_DECISIONS_MIN or loss_err > 1e-3 or not replicated:
        raise AssertionError("the sharded afterstate trainer differs from the one-process run")

    # The n-tuple trainers. After the first window, whose decisions all come
    # from the initial tables: within 1e-6 + 1e-5 x S of one process, S each
    # table's largest magnitude (the kernels' atomics reassociate the sums).
    # After the updates the ranks' replicas are the same bits; against one
    # process they are reported beside two one-process runs of the card,
    # which part as soon as a reassociated sum turns a tie of mirror-image
    # afterstates the other way.
    def within(got, want):
        return close_tables([got[k] for k in want], [want[k] for k in want], [float(want[k].abs().max()) for k in want])

    for name in _par_nt_configs():
        got, want = [r["ntuple"][name] for r in ranks], ref["ntuple"][name]
        ok, err, ratio = within(got[0]["first_window"], want["first_window"])
        _, err2, ratio2 = within(got[0]["tables"], want["tables"])
        _, spread, spread_ratio = within(ref_again[name]["tables"], want["tables"])
        boards = torch.cat([g["boards"] for g in got])
        boards_equal = float((boards == want["boards"]).flatten(1).all(1).float().mean())
        replicated = _same_across_ranks([r["ntuple"] for r in ranks], (name, "tables")) and \
            _same_across_ranks([r["ntuple"] for r in ranks], (name, "first_window"))
        log(f"parallel/ntuple/{name}", B=NT_B, T=NT_T, updates=PAR_NT_UPDATES, first_window_within_tol=ok,
            first_window_max_abs_err=f"{err:.3g}", first_window_err_over_tol=f"{ratio:.3g}",
            updates_err_over_tol=f"{ratio2:.3g}", one_process_twice_err_over_tol=f"{spread_ratio:.3g}",
            share_of_equal_boards=round(boards_equal, 4), replicated_equal=replicated,
            launches_per_update_per_rank=json.dumps([g["launches_per_update"] for g in got]),
            one_process_launches_per_update=json.dumps(want["launches_per_update"]))
        scatter = "cached_scatter" if name.startswith("cached") else "table_scatter"
        expect = {"ntuple_value": 2 * NT_T}
        for g in got:
            if any(g["launches_per_update"].get(k) != v for k, v in expect.items()) or not g["launches_per_update"].get(scatter):
                raise AssertionError(f"{name}: a rank's launches per update {g['launches_per_update']}")
        if not (ok and replicated):
            raise AssertionError(f"{name}: the first window differs from one process's, or the ranks' replicas part")

    # The other families and tp, float32: losses at rtol 1e-5; parameters
    # within Adam's per-entry bound, 2 x lr per optimizer step (a near-zero
    # gradient's sign may round apart, as tests/test_torch_afterstate.py
    # bounds it), and within rtol 1e-4 over the whole set.
    for name, cfg in _par_family_configs().items():
        got, want = [r["families"][name] for r in ranks], ref["families"][name]
        loss_err = max(abs(g["loss"] - w["loss"]) / abs(w["loss"]) for g, w in zip(got[0]["history"], want["history"]))
        keys = [k for k in ("params", "after_params") if k in want]
        err = max(float((got[0][k][p] - want[k][p]).abs().max()) for k in keys for p in want[k])
        steps = len(want["history"]) * (cfg.num_epochs * cfg.num_minibatches if name.startswith("ppo") else 1)
        bound = 2 * cfg.learning_rate * steps
        diff = torch.cat([(got[0][k][p] - want[k][p]).reshape(-1) for k in keys for p in want[k]])
        norm = torch.cat([want[k][p].reshape(-1) for k in keys for p in want[k]])
        set_rel = float(diff.norm() / norm.norm())
        replicated = all(_same_across_ranks([r["families"] for r in ranks], (name, k)) for k in keys)
        boards_equal = bool(torch.equal(torch.cat([g["boards"] for g in got]), want["boards"])) if not name.endswith("/tp") \
            else bool(torch.equal(got[0]["boards"], want["boards"]))
        fields = dict(envs=PAR_FAMILY_ENVS, updates=len(want["history"]), loss=[h["loss"] for h in got[0]["history"]],
                      loss_rel_err=f"{loss_err:.3g}", max_param_err=f"{err:.3g}", adam_bound=bound,
                      params_rel_err=f"{set_rel:.3g}", boards_equal=boards_equal, replicated_equal=replicated)
        if name == "dqn":
            fields["optimizer_count_per_rank"] = [g["optimizer_count"] for g in got]
        resume_ok = True
        if name.endswith("/tp"):
            # Saved at updates 1 and 2; update 1 resumed by a fresh pair of
            # ranks (bit for bit) and in this process (within the bounds above).
            again = [r[name] for r in resumed]
            equal = _saved_equal(root / "a3c-tp", root / "a3c-tp-resume", 2)
            records = all(a["history"] == got[0]["history"][1:] for a in again)
            _copy_step(root / "a3c-tp", 1, root / "a3c-tp-here")
            here_ckpt = timed_checkpointer(root / "a3c-tp-here")
            here, here_history = a3c.train_a3c(cfg, 1, seed=SEED, log_every=1, checkpointer=here_ckpt, device=dev)
            here_loss_err = abs(here_history[0]["loss"] - got[0]["history"][1]["loss"]) / abs(got[0]["history"][1]["loss"])
            here_err = max(float((_host(v) - got[0]["params"][k]).abs().max()) for k, v in here.model.state_dict().items())
            fields.update(save_s_per_rank=[[round(x, 4) for x in g["save_s"]] for g in got],
                          resume_restore_s_per_rank=[[round(x, 4) for x in a["restore_s"]] for a in again],
                          resumed_equal=equal, resumed_records_equal=records,
                          here_restore_s=round(here_ckpt.restore_s[0], 4), here_loss_rel_err=f"{here_loss_err:.3g}",
                          here_max_param_err=f"{here_err:.3g}")
            resume_ok = equal and records and here_loss_err <= 1e-5 and here_err <= 2 * cfg.learning_rate
        log("parallel/tp" if name.endswith("/tp") else f"parallel/families/{name}", **fields)
        if loss_err > 1e-5 or err > bound or set_rel > 1e-4 or not replicated or not boards_equal:
            raise AssertionError(f"{name}: the sharded run differs from the one-process run")
        if not resume_ok:
            raise AssertionError(f"{name}: a resumed tp checkpoint differs from the uninterrupted run")
        if name == "dqn" and [g["optimizer_count"] for g in got] + [want["optimizer_count"]] != [1] * (PAR_RANKS + 1):
            raise AssertionError("dqn: the learn gate did not open at update 2 alone")

    # The full-width afterstate learner over tp: what a save and a restore
    # cost, and the resume from update 1 against the uninterrupted update 2.
    got, again = [r["checkpoint-tp"] for r in ranks], [r["afterstate"] for r in resumed]
    equal = _saved_equal(root / "afterstate-tp", root / "afterstate-tp-resume", 2)
    records = all(a["history"] == got[0]["history"][1:] for a in again)
    size = (root / "afterstate-tp" / "1" / "state.pt").stat().st_size
    log("parallel/checkpoint-tp", card=card, model="resnet 64x4 bf16", mesh="dp=1 x tp=2", backend="gloo",
        envs=PAR_CKPT_ENVS, T=afterstate_config().unroll_len, updates=2,
        save_s_per_rank=[[round(x, 4) for x in g["save_s"]] for g in got],
        gather_s_per_rank=[[round(x, 4) for x in g["gather_s"]] for g in got],
        restore_s_per_rank=[round(a["restore_s"][0], 4) for a in again], checkpoint_bytes=size,
        learner_bytes_per_rank=[g["learner_bytes"] for g in got],
        loss=[h["loss"] for h in got[0]["history"]], resumed_equal=equal, resumed_records_equal=records)
    root_dir.cleanup()
    if not (equal and records):
        raise AssertionError("the afterstate learner resumed over tp differs from the uninterrupted run")


PAR_CLI_ARGV = ["train", "--algo", "ntuple", "--mesh", "--updates", "2", "--batch-size", "1024", "--unroll", "64",
                "--log-every", "1", "--checkpoint-every", "2"]


def parallel_cli_start() -> tuple:
    """Starts ``train --algo ntuple --mesh`` under torchrun with two ranks
    (gloo: they share the card) in a temporary directory, its output
    there; ``parallel_cli_phase`` waits for it and checks it. It runs beside
    ``parallel_phases``, whose timings no cell reads."""
    import os

    tmp = tempfile.TemporaryDirectory()
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    with open(f"{tmp.name}/stdout", "w") as out, open(f"{tmp.name}/stderr", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(PAR_RANKS),
             "-m", "rein48_tpu_torch", *PAR_CLI_ARGV, "--checkpoint-dir", f"{tmp.name}/ck", "--log-dir", f"{tmp.name}/log"],
            stdout=out, stderr=err, env=env, cwd=tmp.name,
        )
    return tmp, proc, time.perf_counter()


def parallel_cli_phase(started) -> None:
    """``[parallel/cli]``: the run ``parallel_cli_start`` started: equal
    records, and only rank 0 writes the log and the checkpoint."""
    import csv
    import os

    tmp_dir, proc, t0 = started
    tmp = tmp_dir.name
    try:
        proc.wait(timeout=max(1.0, PAR_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    wall = time.perf_counter() - t0
    stderr = Path(f"{tmp}/stderr").read_text()
    finals = [ast.literal_eval(ln[len("final: "):]) for ln in stderr.splitlines() if ln.startswith("final: ")]
    for f in finals:
        f.pop("steps_per_sec", None)
    rows = list(csv.DictReader(open(f"{tmp}/log/metrics.csv"))) if os.path.exists(f"{tmp}/log/metrics.csv") else []
    saved = sorted(os.listdir(f"{tmp}/ck")) if os.path.exists(f"{tmp}/ck") else []
    meshes = [ln for ln in stderr.splitlines() if ln.startswith("mesh: ")]
    tmp_dir.cleanup()
    log("parallel/cli", argv=" ".join(PAR_CLI_ARGV), rc=proc.returncode, wall_s=round(wall, 1), meshes=json.dumps(meshes),
        records_equal=len(finals) == PAR_RANKS and all(f == finals[0] for f in finals), log_rows=len(rows), checkpoint=saved)
    if proc.returncode or len(finals) != PAR_RANKS or any(f != finals[0] for f in finals) or len(rows) != 2 \
            or saved != ["2", "train_config.json"]:
        raise AssertionError(f"train --mesh under torchrun failed: {stderr[-3000:]}")


def recipes_phase(dev) -> None:
    """``[recipes/<module>]``: every recipe's ``main`` at its full widths in
    one temporary working directory (``RECIPES``), its records checked
    against the keys of the JAX recipe's (``_recipe.jax_keys``)."""
    from rein48_tpu_torch.examples import _recipe
    from rein48_tpu_torch.testing import capped_evaluations

    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        for name, argv in RECIPES:
            module = importlib.import_module(f"rein48_tpu_torch.examples.{name}")
            saved = getattr(module, "evaluations", None)  # a3c_parity_curve scores its own way
            if saved is not None:
                module.evaluations = capped_evaluations(saved, num_steps=RECIPE_EVAL_STEPS)
            torch.cuda.reset_peak_memory_stats(dev)
            zero_table_counts()
            set_counter(ROLLOUT_COUNTER, 0)
            t0 = time.perf_counter()
            try:
                out = module.main(argv, device=dev)
            finally:
                if saved is not None:
                    module.evaluations = saved
            wall = time.perf_counter() - t0
            want = _recipe.jax_keys(module, root)
            row = dict(argv=" ".join(argv), wall_s=round(wall, 2), peak_gib=round(torch.cuda.max_memory_allocated(dev) / 2**30, 3),
                       launches=json.dumps({k: v for k, v in kernel_launches().items() if v}))
            if name == "eval_ntuple_depth2":
                # Two probes of launch_chunk steps, one policy call a step: one
                # value launch a leaf call, 16 a depth-2 move at chance_chunk 8.
                moves = 2 * int(argv[-1])
                row.update(leaf_launches=counter(TABLE_COUNTERS["ntuple_value"]),
                           leaf_launches_per_move=counter(TABLE_COUNTERS["ntuple_value"]) / moves)
            for path in (p for p in want if p.endswith(".csv")):
                with open(path) as f:
                    last = list(csv.DictReader(f))[-1]
                # Since the logger opened: init and the first update's warm-up included.
                row.update(updates=int(last["update"]), ms_per_update=round(1e3 * float(last["wall_time"]) / int(last["update"]), 1),
                           steps_per_sec=round(float(last["steps_per_sec"]), 1))
            if isinstance(out, dict):
                result = out.get("eval", out.get("results", {k: v for k, v in out.items() if k != "seeds"}))
                row["eval"] = json.dumps(result, default=str)[:600]
            log(f"recipes/{name}", **row)
            got = _recipe.written_keys(module)
            if got != want:
                raise AssertionError(f"recipe {name} wrote records with keys {got}, the JAX recipe {want}")
            if name.startswith("eval_") and name.endswith("depth2") and set(out) != {"compile+run", "steady"}:
                raise AssertionError(f"recipe {name} probed {sorted(out)}")
            torch.cuda.empty_cache()


def frontier_phase(dev) -> None:
    """``[recipes/<frontier>]``: each frontier sweep's ``main`` (``FRONTIERS``)
    in a temporary directory, one leg through its budget, its
    record's keys held to the JAX record's (``frontier_r3.json`` lacks the
    ``backend`` key the script writes) and, under ``"cached"``, each kernel
    launched at least once per update."""
    from rein48_tpu_torch.examples import _recipe
    from rein48_tpu_torch.testing import capped_evaluations

    root = Path(__file__).resolve().parent
    for name, legs, check_every, backend in FRONTIERS:
        module = importlib.import_module(f"rein48_tpu_torch.examples.{name}")
        argv = [str(FRONTIER_BUDGET_S), module.OUT, *legs]
        saved = module.evaluations
        module.evaluations = capped_evaluations(saved, num_steps=RECIPE_EVAL_STEPS)
        torch.cuda.reset_peak_memory_stats(dev)
        try:
            with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
                zero_table_counts()
                t0 = time.perf_counter()
                out = module.main(argv, device=dev)
                wall = time.perf_counter() - t0
                launches, stepped = table_counts(), step_counts()
                got = _recipe.written_keys(module)
        finally:
            module.evaluations = saved
        (leg,) = out["legs"]
        log(
            f"recipes/{name}", argv=" ".join(argv), backend=backend, wall_s=round(wall, 2),
            peak_gib=round(torch.cuda.max_memory_allocated(dev) / 2**30, 3),
            **{k: v for k, v in leg.items() if k not in ("backend", "eval")}, eval=json.dumps(leg["eval"]),
            launches=json.dumps({k: v for k, v in launches.items() if v}), engine_steps=json.dumps(stepped),
        )
        check_steps(f"{name} on {backend!r}", stepped)
        want = _recipe.jax_keys(module, root)
        if got != want:
            raise AssertionError(f"{name} wrote records with keys {got}, the JAX record {want}")
        # Stopped at the first clock check past the budget.
        checks, rest = divmod(leg["updates"], check_every)
        if rest or not checks or leg["train_sec"] < FRONTIER_BUDGET_S or leg["eval"]["episodes"] != 512 \
                or not all(np.isfinite(v) for v in leg["eval"].values()):
            raise AssertionError(f"{name} trained {leg['updates']} updates in {leg['train_sec']} s (a check every "
                                 f"{check_every}) or scored {leg['eval']}")
        # The warm-up update is trained too. Every backend's values take the
        # value kernel on the card.
        kernels = {"ntuple_value", "cached_scatter"} if backend == "cached" else {"ntuple_value"}
        if {k for k, v in launches.items() if v} != kernels or any(launches[k] < leg["updates"] + 1 for k in kernels):
            raise AssertionError(f"{name} on {backend!r} launched {launches} in {leg['updates'] + 1} updates")
        torch.cuda.empty_cache()


def random_play_phase(dev) -> float:
    """``[capability/random]``: uniform-random legal play's mean tile sum of
    finished episodes, the floor each learning check must clear."""
    from rein48_tpu_torch.testing import random_play

    t0 = time.perf_counter()
    stats = random_play(dev, RANDOM_ENVS, SEED)
    log("capability/random", envs=RANDOM_ENVS, avg_tile_sum=round(stats["avg_tile_sum"], 2),
        avg_length=round(stats["avg_length"], 2), avg_score=round(stats["avg_score"], 1), best_tile=stats["best_tile"],
        wall_s=round(time.perf_counter() - t0, 2))
    return stats["avg_tile_sum"]


def capability_phase(dev, name: str, random_tile_sum: float | None = None, backends=(None,)) -> None:
    """``[capability/<name>]``: the recipe of ``LEARNING_CHECKS[name]`` through
    its ``main`` in a fresh directory (``testing.learning_curve``: the config
    at the JAX run's horizon, the closing evaluations capped as in
    ``recipes_phase``), the mean of each held column at the check updates
    within ``CAPABILITY_BAND`` of the JAX run's; a check ``above_random``
    also above ``random_tile_sum`` (random play, measured here when not
    given). A DQN check must have filled its buffer before the first check
    update, and the checkpoint its recipe saved at its end must restore the
    buffer full, its cursor where ``replay_add`` leaves it. Under each of
    ``backends`` (a table backend swapped into the config, the n-tuple
    recipe's "auto" and "cached"), each run's kernel launches checked."""
    from rein48_tpu_torch.testing import LEARNING_CHECKS, learning_curve

    check = LEARNING_CHECKS[name]
    if check.above_random and random_tile_sum is None:
        random_tile_sum = random_play_phase(dev)
    root = Path(__file__).resolve().parent
    for backend in backends:
        configure = None if backend is None else (lambda c, backend=backend: dataclasses.replace(c, table_backend=backend))
        zero_table_counts()
        result = learning_curve(check, root, dev, configure=configure, num_steps=RECIPE_EVAL_STEPS)
        launches, stepped = table_counts(), step_counts()
        config, curve, jax_curve, checks = result["config"], result["curve"], result["jax_curve"], check.checks
        updates = int(check.argv[0])
        B = config.num_envs if hasattr(config, "num_envs") else config.batch_size
        T = next(getattr(config, k) for k in ("unroll_len", "steps_per_update", "acting_steps_per_update") if hasattr(config, k))
        row = dict(argv=" ".join(check.argv), horizon=result["horizon"], B=B, T=T, updates=updates)
        if backend is not None:
            config = configure(config)
            row.update(backend=backend, resolved=config.network_config(dev).backend)
        row.update({
            "main_wall_s": round(result["wall_s"], 2), "train_s": round(result["train_s"], 2),
            "ms_per_update": round(1e3 * result["train_s"] / max(checks), 1),
            "env_steps_per_s": round(updates * B * T / result["train_s"], 1),
            check.column: [_rounded(v) for v in result["values"]], "episodes": result["episodes"],
            "mean": _rounded(result["mean"]), "jax_mean": _rounded(result["jax_mean"]), "ratio": round(result["ratio"], 4),
        })
        ratios = {check.column: result["ratio"]}
        for col, held in result.get("also", {}).items():
            ratios[col] = held["ratio"]
            row.update({col: [_rounded(v) for v in held["values"]], f"{col}_mean": _rounded(held["mean"]),
                        f"{col}_jax_mean": _rounded(held["jax_mean"]), f"{col}_ratio": round(held["ratio"], 4)})
        row["band"] = CAPABILITY_BAND
        for col in CAPABILITY_BESIDE:
            if col not in ratios and col in curve[checks[0]] and col in jax_curve[checks[0]]:
                row.update({col: [_rounded(curve[u][col]) for u in checks], f"jax_{col}": [_rounded(jax_curve[u][col]) for u in checks]})
        if random_tile_sum is not None:
            row["random_tile_sum"] = round(random_tile_sum, 2)
        saved = result.get("replay")
        if saved is not None:
            first = curve[checks[0]]
            row.update(replay_size_at_first_check=first["replay_size"], epsilon_at_first_check=round(first["epsilon"], 5),
                       restored=json.dumps(saved))
        if check.same_start:
            row["warm_start"] = json.dumps(result["record"]["config"]["warm_start"])
        log(f"capability/{name}", **row, launches=json.dumps({k: v for k, v in launches.items() if v}),
            engine_steps=json.dumps(stepped))
        run = f"{check.recipe}{'' if backend is None else f' under {backend!r}'}"
        check_steps(run, stepped)
        for col, ratio in ratios.items():
            if not CAPABILITY_BAND[0] <= ratio <= CAPABILITY_BAND[1]:
                raise AssertionError(f"{run} has {col} at {ratio:.4f} of the JAX run's at updates {list(checks)}")
        if check.above_random and result["mean"] <= random_tile_sum:
            raise AssertionError(f"{check.recipe} plays no better than random: {result['mean']:.1f} <= {random_tile_sum:.1f}")
        if saved is not None and not (
            first["replay_size"] == saved["capacity"] == saved["size"] and saved["cursor"] == saved["expected_cursor"]
            and saved["update_step"] == updates
        ):
            raise AssertionError(f"{run}: buffer of {first['replay_size']:.0f} slots at update {checks[0]}, restored {saved}")
        # Under "cached" the learning run launches both kernels on every update
        # (the closing evaluations may add launches of their own); under
        # "auto" ("torch" at YEH_4X6) the value kernel alone, whose launches
        # take every backend's values on the card; a run of another family
        # launches none.
        kernels = {"cached": {"ntuple_value", "cached_scatter"}, "auto": {"ntuple_value"}}.get(backend, set())
        launched = {k for k, v in launches.items() if v}
        if backend is not None and row["resolved"] != ("cached" if backend == "cached" else "torch"):
            raise AssertionError(f"the {backend!r} run resolved to {row['resolved']}")
        if launched != kernels or any(launches[k] < updates for k in kernels):
            raise AssertionError(f"{run} launched {launches} in {updates} updates")


def _rounded(v: float) -> float:
    """Tile sums and scores to 0.1, Q-values and TD errors to 1e-4."""
    return round(v, 1) if abs(v) >= 100 else round(v, 4)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from rein48_tpu_torch import build, testing
    from rein48_tpu_torch.control import search
    from rein48_tpu_torch.engine import fused, vector
    from rein48_tpu_torch.models import nets
    from rein48_tpu_torch.train import common, evaluate
    from rein48_tpu_torch.train import ntuple as nt

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)

    laps, lap_at = {}, [t_start]

    def lap(name: str) -> None:
        """Seconds since the previous lap, kept for the ``[timing]`` line."""
        now = time.perf_counter()
        laps[name] = round(now - lap_at[0], 1)
        lap_at[0] = now

    # 1. Build every kernel, one nvcc each, all at once.
    t0 = time.perf_counter()
    report = build.build()
    for name, r in report.items():
        regs = [ln.split("info    : ")[-1] for ln in r["log"].splitlines() if "registers" in ln or "spill" in ln]
        log("build", kernel=name, seconds=f"{r['seconds']:.1f}", ptxas="; ".join(regs))
    log("build", total_seconds=f"{time.perf_counter() - t0:.1f}", torch=torch.__version__, cuda=torch.version.cuda)

    lap("build")
    # 2-3. The main paths, through their entry points, with the counts at 0.
    set_counter(ROLLOUT_COUNTER, 0)
    bench = run_cli(["bench", "--batch", str(BENCH_B), "--unroll", str(BENCH_T), "--rounds", str(BENCH_ROUNDS)])
    if bench["engine"] != "fused" or bench["value"] <= 0:
        raise AssertionError(f"bench did not run the kernel: {bench}")
    log(
        "bench", engine=bench["engine"], B=BENCH_B, T=BENCH_T, rounds=BENCH_ROUNDS,
        steps_per_s=bench["value"], median_steps_per_s=bench["median"],
        ms_per_launch=bench["ms_per_launch"], launches=counter(ROLLOUT_COUNTER),
    )
    if counter(ROLLOUT_COUNTER) != BENCH_ROUNDS + 1:  # a warm-up and one launch per round
        raise AssertionError(f"bench launched {counter(ROLLOUT_COUNTER)} rollout kernels, not {BENCH_ROUNDS + 1}")
    plain_bench = run_cli(["bench", "--engine", "plain", "--batch", str(BENCH_B), "--unroll", "64", "--rounds", "2"])
    log("bench/plain-engine", B=BENCH_B, T=64, steps_per_s=plain_bench["value"], ms_per_round=plain_bench["ms_per_launch"])

    model = nets.ResNetPolicy(64, 4, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(SEED)).to(dev).eval()
    serving = {}
    for depth, envs, steps, chunk, launch in ((0, 1024, 512, None, 256), (1, 256, 128, 4, 128)):
        zero_table_counts()
        stats = evaluate.evaluate_search(
            depth=depth, num_envs=envs, num_steps=steps, seed=123, model=model,
            chance_chunk=chunk, protocol="first", launch_chunk=launch, device=dev,
        )
        if not all(np.isfinite(v) for v in stats.values()) or stats["episodes"] != envs:
            raise AssertionError(f"depth-{depth} stats malformed: {stats}")
        serving[depth] = dict(envs=envs, steps=steps, chunk=chunk)
        log(f"serve/depth{depth}", envs=envs, steps=steps, chance_chunk=chunk, engine_steps=json.dumps(step_counts()),
            stats=json.dumps({k: round(v, 3) for k, v in stats.items()}))
        check_steps(f"serve/depth{depth}", step_counts(), steps)  # one step kernel a move
    launches = counter(ROLLOUT_COUNTER)
    if launches <= 0:
        raise AssertionError("the bench path launched no rollout kernel")

    # Every chosen action is legal wherever one exists (64 steps replayed
    # through the same policy and sweep that evaluate_search runs).
    for depth, cfg in serving.items():
        checked = LegalityCheck(evaluate._build_search_policy(depth, model, "onehot", 0.99, "log2", cfg["chunk"]))
        with torch.inference_mode():
            evaluate._first_episode_rollout(vector.reset_batch(123, cfg["envs"], dev), policy_fn=checked, num_steps=64)
        log(f"serve/depth{depth}/legal", steps=64, illegal_choices=int(checked.illegal))
        if int(checked.illegal):
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

    lap("bench, ResNet serving")
    # 4. The kernel at the bench shape against its plain version, bit for
    # bit: its time, the plain version's, its bound from the work of an
    # env-step, and this design's own instruction counts.
    state = vector.reset_batch(SEED + 4, BENCH_B, dev)
    saved = counter(ROLLOUT_COUNTER)
    got = fused.rollout_random_fused(state, 2, BENCH_T)  # also the warm-up
    ms = cuda_ms(lambda: fused.rollout_random_fused(state, 2, BENCH_T), reps=10)
    set_counter(ROLLOUT_COUNTER, saved)
    plain = []
    plain_ms = cuda_ms(lambda: plain.append(fused.rollout_random_reference(state, 2, BENCH_T)))
    log("rollout-kernel", B=BENCH_B, T=BENCH_T, ms=round(ms, 4), plain_ms=round(plain_ms, 1),
        episodes=int(plain[0][1].episodes.sum()))
    testing.assert_same_rollout(got, plain[0])
    del got, plain
    # This design's own figures, for the [kernel-bound] line only: SASS per
    # env-step of its main loop and the times they would take at the issue
    # rate and on the INT32 pipe (computed, not measured).
    per_step, per_step_int32 = sass_per_step(build.library_path("rollout"), "rollout_kernelILb0E", 4)
    env_steps = BENCH_B * BENCH_T
    design_issue_ms = 1e3 * per_step * env_steps / ISSUE_PER_S
    design_int32_ms = 1e3 * per_step_int32 * env_steps / INT32_PIPE_PER_S
    log(
        "kernel-bound", design_sass_per_env_step=per_step, design_int32_pipe_per_env_step=per_step_int32,
        design_issue_ms=round(design_issue_ms, 4), design_int32_pipe_ms=round(design_int32_ms, 4),
        philox_instr_per_env_step=PHILOX_INSTR_PER_STEP,
    )
    # The bound is the work, not this design: the Philox words at the issue
    # rate, or the bytes (each board (16 B), score and steps read once, the
    # row table (196,864 B) read once; board, score, steps and 4 stats
    # written once), whichever is larger.
    bound_ops_ms = 1e3 * env_steps * PHILOX_INSTR_PER_STEP / ISSUE_PER_S
    bound_bytes_ms = 1e3 * (BENCH_B * (16 + 8 + 16 + 8 + 16) + fused.row_table_bytes().size) / HBM_BYTES_PER_S
    kernels = [
        {
            "name": "rollout",
            "route": "cuda",
            "source": "rein48_tpu_torch/csrc/rollout.cu",
            "replaces": "rein48_tpu/engine/fused.py:269",
            "launches": launches,
            "ms": round(ms, 4),
            "plain_ms": round(plain_ms, 1),
            "bound_ms": round(max(bound_ops_ms, bound_bytes_ms), 4),
            "bound_by": "operations" if bound_ops_ms >= bound_bytes_ms else "bytes",
            "bound_of": f"the Philox words: {PHILOX_INSTR_PER_STEP:g} instructions per env-step at the issue rate",
            "sass_per_env_step": per_step,
            "int32_pipe_per_env_step": per_step_int32,
            "library_ms": None,
        }
    ]
    # 5-9. The card's launch floor; the layer norm kernel; the n-tuple family:
    # the table and value kernels timed at the trainer's shapes, then the main
    # paths with the counts at 0: the trainer in both update modes with its
    # depth-0 and depth-1 evaluation, and the CLI. The floor is timed here,
    # after the host-bound serving runs, so that no profiler session
    # precedes those.
    lap("rollout kernel at the bench shape")
    floor_ms = floor_phase(dev)
    norm = layer_norm_phase(dev)
    lap("layer norm kernel")
    engine_step = engine_step_phase(dev)
    lap("engine step kernel")
    state, net, gathers, window = ntuple_trainer_inputs(dev)
    gather, scatter = table_kernel_phase(state, net, gathers, window)
    after = nt._all_afterstates(state.env.boards)[0]
    values = value_kernel_phase([("SJ_2X4 value(afterstates)", net, state.params, after),
                                 ("SJ_2X4 depth-1 leaf chunk", net, state.params, leaf_chunk(state))])
    del state, after
    trained, table_launches = ntuple_trainer_phase(dev)
    for k, v in ntuple_depth1_phase(trained, dev).items():
        table_launches[k] += v
    sj_trained = trained
    del trained
    lap("SJ_2X4 kernels, value kernel, trainer, depth-0/1")
    # 10-12. The "cached" backend at YEH_4X6: its kernels timed, then its main
    # paths with the counts at 0: the trainer in both update modes and depth-0
    # evaluation of what it trained.
    state, net, idx, window = cached_trainer_inputs(dev)
    hp_gather, hp_scatter = hbm_kernel_phase(state, net, idx, window)
    after = nt._all_afterstates(state.env.boards)[0]
    values.update(value_kernel_phase([("YEH_4X6 cached value(afterstates)", net, state.params, after)]))
    del state, window, after
    trained, hp_launches = cached_trainer_phase(dev)
    for k, v in cached_eval_phase(trained, dev).items():
        hp_launches[k] += v
    del trained
    lap("YEH_4X6 cached kernels, value kernel, trainer, depth-0")
    values.update(value_kernel_phase([depth2_leaf_case(dev)]))
    lap("YEH_4X6 value kernel at the depth-2 leaf")
    ntuple_cli_phase(dev)
    lap("CLI ntuple")
    nt_launches = {k: table_launches[k] + hp_launches[k] for k in table_launches}
    # The value calls go through the fused kernel, never a standalone gather.
    for k, v in nt_launches.items():
        if (v > 0) != (k not in ("table_gather", "cached_gather")):
            raise AssertionError(f"the n-tuple main paths launched {v} {k} kernels")
    # 13-17. The deep afterstate-TD trainer at its flagship configuration
    # through its entry point, the bf16 net against float32, its checkpoint,
    # search with the trained value net at the leaves, and the CLI. This path runs
    # no kernel of the port but the layer norm (cuDNN and cuBLAS do the rest of
    # its dense work).
    with tempfile.TemporaryDirectory() as ckpt_dir:
        state, cfg, step, batch = afterstate_train_phase(dev, ckpt_dir)
        afterstate_bf16_phase(state, cfg, step, batch)
        del step, batch
        afterstate_checkpoint_phase(state, cfg, ckpt_dir, dev)
        del state
        afterstate_eval_phase(cfg, ckpt_dir, dev)
    afterstate_cli_phase()
    lap("afterstate trainer, checkpoint, eval, CLI")
    # 18-24. The actor-critic family at the flagship configurations through
    # their entry points: PPO, PPO with the afterstate critic and its
    # checkpoint (restored on the card and on the CPU), A3C in one pass over
    # 262,144 boards, the reference-parity regime, the CLI, and PPO's bf16
    # loss against float32. Of the port's kernels only the layer norm is on
    # this path.
    ppo_trained = actor_critic_train_phase("ppo/train", dev, ppo_config(), PPO_UPDATES)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        cfg = ppo_config(critic=True)
        state, step, batch = actor_critic_train_phase("ppo/afterstate", dev, cfg, PPOC_UPDATES, ckpt_dir)
        del step, batch
        ppo_checkpoint_phase(state, cfg, ckpt_dir, dev)
        del state
    torch.cuda.empty_cache()
    actor_critic_train_phase("a3c/train", dev, a3c_config(), A3C_UPDATES)
    torch.cuda.empty_cache()
    a3c_parity_phase(dev)
    ppo_cli_phase(dev)
    ppo_bf16_phase(*ppo_trained)
    del ppo_trained
    lap("PPO, A3C, their checkpoint and CLI")
    torch.cuda.empty_cache()
    # 25-32. The single-game surface on the card (Game, play, parity with the
    # C oracle), then the replay family through its entry points: the DQN
    # flagship with its checkpoint and eval, n-step DQN, the dqn-4k preset,
    # DDPG, and the CLI. Of the port's kernels only the layer norm (the DQN
    # flagship's ResNet) is on these paths.
    game_phase(dev)
    parity_phase()
    lap("Game, play, parity")
    with tempfile.TemporaryDirectory() as ckpt_dir:
        dqn_flagship_phase(dev, ckpt_dir)
        dqn_eval_phase(ckpt_dir)
    torch.cuda.empty_cache()
    dqn_nstep_phase(dev)
    dqn_qnet_phase(dev)
    ddpg_phase(dev)
    replay_cli_phase()
    lap("DQN, DDPG, their checkpoint, eval and CLI")
    torch.cuda.empty_cache()
    # 33-39. Multi-process training: a one-rank NCCL group, then two gloo
    # ranks sharing the card (the rollout kernel, the flagship afterstate
    # trainer, the n-tuple trainers with their kernels, PPO, A3C, DQN, tp),
    # each against one process, and, beside them, train --mesh under torchrun.
    parallel_nccl_phase(dev)
    cli = parallel_cli_start()
    try:
        parallel_phases(dev, card)
    except BaseException:
        cli[1].kill()
        raise
    parallel_cli_phase(cli)
    lap("parallel: NCCL, gloo ranks, torchrun")
    # 40-41. The recipes of examples/ through their main at full widths (each
    # logs the kernel launches it made) and the frontier sweeps one leg each,
    # then the n-tuple recipe's learning against the JAX run's curve: YEH_4X6
    # "auto" is the plain path with the value kernel, the "cached" run
    # launches the value and hot-prefix kernels.
    recipes_phase(dev)
    frontier_phase(dev)
    lap("recipes of examples/, the frontier sweeps")
    capability_phase(dev, "ntuple", backends=("auto", "cached"))
    lap("capability: the n-tuple recipe's curve, auto and cached")
    # 42-44. The deep trainers' learning against the JAX runs' curves, and
    # random play's floor. Of the port's kernels only the layer norm is on
    # these paths.
    random_tile_sum = random_play_phase(dev)
    for name in ("ppo", "afterstate", "a3c"):
        capability_phase(dev, name, random_tile_sum)
        torch.cuda.empty_cache()
    lap("capability: PPO, afterstate TD and A3C against JAX's curves")
    # 45-46. DQN's learning past the first wrap of its 2**20-slot buffer, 1-step
    # and n-step: Q-values and TD errors against the JAX runs', the buffer
    # full before the first check, the saved cursor. Of the port's kernels
    # only the layer norm is on these paths.
    for name in ("dqn", "dqn_nstep"):
        capability_phase(dev, name, random_tile_sum)
        torch.cuda.empty_cache()
    lap("capability: DQN and n-step DQN against JAX's curves")
    # Last, after every other reading: a profiled update leaves the profiler
    # with 80 k launches, which has shifted later readings.
    value_launches = value_launches_phase(sj_trained, dev)
    del sj_trained
    lap("value launches per update")
    log("timing", seconds=json.dumps(laps))
    g, sc = gather["value(afterstates)"], scatter[("stats", NT_B * 2 * 8)]
    sc_big, hp_over = scatter[("stats", NT_B * 2 * 8 * 4)], hp_scatter["overflowing"]
    hp_scatter = hp_scatter["just-refreshed"]
    kernels += [
        {
            "name": "table_gather",
            "route": "cuda",
            "source": "rein48_tpu_torch/csrc/tables.cu",
            "replaces": "rein48_tpu/ops/tables.py:102",
            "launches": table_launches["table_gather"],
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
            "n": sc["n"],
            "ms": sc["ms"],
            "launches_per_call": sc["launches_per_call"],
            "n_window": sc_big["n"],
            "ms_window": sc_big["ms"],
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
            "n": hp_scatter["n"],
            "ms": hp_scatter["ms"],
            "kernel_ms": hp_scatter["kernel_ms"],
            "launches_per_call": hp_scatter["launches_per_call"],
            "overflowing_ms": hp_over["ms"],
            "overflowing_kernel_ms": hp_over["kernel_ms"],
            "plain_ms": hp_scatter["plain_ms"],
            "bound_ms": round(hp_scatter["bound_ms"], 6),
            "bound_by": "bytes",
            "library_ms": None,
        },
    ]
    sj, leaf, yeh, deep = (values[k] for k in ("SJ_2X4 value(afterstates)", "SJ_2X4 depth-1 leaf chunk",
                                               "YEH_4X6 cached value(afterstates)", "YEH_4X6 torch depth-2 leaf"))
    kernels.append({
        "name": "ntuple_value",
        "route": "cuda",
        "source": "rein48_tpu_torch/csrc/ntuple_value.cu",
        # The value path of both gathers, fused with the lookups and sums around them.
        "replaces": "rein48_tpu/ops/tables.py:102",
        "also_replaces": "rein48_tpu/ops/hbm_tables.py:222",
        "launches": nt_launches["ntuple_value"],
        "n": sj["n"],
        "ms": sj["ms"],
        "ms_leaf_chunk": leaf["ms"],
        "ms_cached": yeh["ms"],
        # One leaf call of the depth-2 player at YEH_4X6: 1,048,576 boards
        # over 268 MB of tables, 16 such calls a move.
        "n_depth2_leaf": deep["n"],
        "ms_depth2_leaf": deep["ms"],
        "plain_ms": sj["plain_ms"],
        "plain_ms_cached": yeh["plain_ms"],
        "plain_ms_depth2_leaf": deep["plain_ms"],
        "bound_ms": round(sj["bound_ms"], 6),
        "bound_ms_leaf_chunk": round(leaf["bound_ms"], 6),
        "bound_ms_cached": round(yeh["bound_ms"], 6),
        "bound_ms_depth2_leaf": round(deep["bound_ms"], 6),
        "bound_by": "bytes",
        "library_ms": None,
        "library_note": "no PyTorch call computes boards -> summed lookups",
        "launches_per_update": {name: r["launches"] for name, r in value_launches.items()},
    })
    small, large = (engine_step[b] for b in STEP_BATCHES)
    kernels.append({
        "name": "engine_step",
        "route": "cuda",
        "source": "rein48_tpu_torch/csrc/rollout.cu",
        # No Pallas kernel: in the JAX package XLA fuses engine/vector.py's step.
        "replaces": None,
        "replaces_note": "the XLA fusion of rein48_tpu/engine/vector.py's step_autoreset",
        # One launch an acting step, counted in [ppo/train]'s profiled update
        # (1 a search move, counted in [serve/depth*]).
        "launches": STEP_PER_UPDATE["ppo/train"],
        "n": STEP_BATCHES[1],
        "ms": large["ms"],
        "ms_b256": small["ms"],
        "plain_ms": large["plain_ms"],
        "plain_ms_b256": small["plain_ms"],
        "plain_launches": large["plain_launches"],
        "bound_ms": round(large["bound_ms"], 6),
        "bound_ms_b256": round(small["bound_ms"], 6),
        "bound_by": "bytes",
        "library_ms": None,
        "library_note": "no PyTorch call steps a 2048 board",
    })
    nt_, ln_ppo = norm["t"], LN_PER_UPDATE["ppo/train"]
    launches = ln_ppo["forward"] + ln_ppo["backward"] + ln_ppo["backward_sum"]
    kernels.append({
        "name": "layer_norm",
        "route": "cuda",
        "source": "rein48_tpu_torch/csrc/layer_norm.cu",
        # No Pallas kernel: in the JAX package XLA fuses Flax's nn.LayerNorm.
        "replaces": None,
        "replaces_note": "the XLA fusion of Flax's nn.LayerNorm and nn.relu (rein48_tpu/models/nets.py)",
        # Launches of one PPO flagship update, counted in [ppo/train]: the
        # acting and learning forwards, the backwards and their partial sums.
        # "ms" and "bound_ms" are the mean launch of that update, so that
        # "gap_ms" is the update's; "pair_ms", "pair_bound_ms", "plain_ms" and
        # "library_ms" are a forward and a backward at the PPO minibatch.
        "launches": launches,
        "launches_per_update": {k: ln_ppo[k] for k in ("forward", "backward", "backward_sum")},
        "update_ms": round(ln_ppo["ms"], 5),
        "update_bound_ms": round(ln_ppo["bound_ms"], 5),
        "update_roofline": round(ln_ppo["roofline"], 3),
        "n": norm["rows"],
        "ms": round(ln_ppo["ms"] / launches, 6),
        "pair_ms": round(nt_["forward"]["ms"] + nt_["backward"]["ms"], 5),
        "forward_ms": nt_["forward"]["ms"],
        "forward_no_stats_ms": nt_["forward_no_stats"]["ms"],
        "backward_ms": nt_["backward"]["ms"],
        "plain_ms": round(nt_["plain_forward"]["ms"] + nt_["plain_backward"]["ms"], 5),
        "plain_forward_ms": nt_["plain_forward"]["ms"],
        "plain_backward_ms": nt_["plain_backward"]["ms"],
        "bound_ms": round(ln_ppo["bound_ms"] / launches, 6),
        "pair_bound_ms": round(norm["bound_f"] + norm["bound_b"], 5),
        "forward_bound_ms": round(norm["bound_f"], 5),
        "backward_bound_ms": round(norm["bound_b"], 5),
        "bound_by": "bytes",
        "library_ms": round(nt_["library_forward"]["ms"] + nt_["library_backward"]["ms"], 5),
        "library_forward_ms": nt_["library_forward"]["ms"],
        "library_backward_ms": nt_["library_backward"]["ms"],
        "library_note": "F.layer_norm then relu, exact variance, bf16 weights: a yardstick the port never calls",
    })
    for entry in kernels:
        # The main path's time over the least any launch of this work can take.
        entry["floor_ms"] = floor_ms
        entry["gap_ms"] = round(entry["launches"] * (entry["ms"] - max(entry["bound_ms"], floor_ms)), 4)
    log("kernels", total_seconds=f"{time.perf_counter() - t_start:.1f}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

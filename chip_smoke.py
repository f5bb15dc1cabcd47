#!/usr/bin/env python3
# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Smoke test of the PyTorch/CUDA port (``rein48_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``rein48_tpu_torch/csrc`` with ``nvcc``, holds
each kernel against its plain PyTorch version, drives the port's main
paths through their entry points (the ``bench`` rollout and full-width
ResNet depth-0/depth-1 ``evaluate_search``), checks what comes out, and
prints one line per phase. A failing phase raises, so the script exits
non-zero. The second-to-last line is a JSON object describing every
ported kernel; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Without a CUDA device it exits 1 and prints no result. It imports no JAX.
"""

from __future__ import annotations

import contextlib
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
    log("kernels", total_seconds=f"{time.perf_counter() - t_start:.1f}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

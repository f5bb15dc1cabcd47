# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Command-line interface of the port (counterpart of ``rein48_tpu/cli.py``).

    python -m rein48_tpu_torch bench --batch 65536 --unroll 2048
    python -m rein48_tpu_torch eval --algo search --depth 1 --num-envs 256

Ported so far: ``bench`` and ``eval --algo search``. The other
subcommands and algorithms exist with the JAX CLI's names and say that
they are not yet ported. Everything runs on ``cuda`` unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Optional, Sequence

# The north-star of env-steps/s a host should reach (bench.py's TARGET);
# ``vs_baseline`` is the measured value over it.
TARGET = 10_000_000.0


def _not_ported(what: str):
    def fn(args: argparse.Namespace) -> int:
        raise SystemExit(f"{what} is not yet ported to rein48_tpu_torch")

    return fn


def _cmd_eval(args: argparse.Namespace) -> int:
    if args.algo != "search":
        raise SystemExit(f"eval --algo {args.algo} is not yet ported to rein48_tpu_torch")
    # These flags set up a checkpoint's critic leaf; without a checkpoint
    # the planner's leaf is the snake heuristic, as in the JAX CLI.
    for flag in ("checkpoint_dir", "model", "obs_encoding", "gamma", "reward_transform", "sample"):
        if getattr(args, flag) not in (None, False):
            raise SystemExit(f"eval --{flag.replace('_', '-')} is not yet ported to rein48_tpu_torch")
    from rein48_tpu_torch.train.evaluate import evaluate_search

    stats = evaluate_search(
        depth=args.depth,
        num_envs=args.num_envs,
        num_steps=args.max_steps,
        seed=args.seed,
        device=args.device,
    )
    print(json.dumps(stats))
    return 0


def _cmd_bench(args: argparse.Namespace) -> int:
    import torch

    from rein48_tpu_torch.device import resolve_device
    from rein48_tpu_torch.engine import fused, vector

    device = resolve_device(args.device)
    engine = args.engine
    if engine == "auto":
        engine = "fused" if device.type == "cuda" else "plain"

    def rollout(st, rnd):
        if engine == "fused":
            return fused.rollout_random_fused(st, args.seed * 1000 + rnd, args.unroll)[0]
        return vector.rollout_random(st, args.unroll)[0]

    state = vector.reset_batch(args.seed, args.batch, device)
    state = rollout(state, 0)  # build the kernel, warm up
    times = []
    for i in range(args.rounds):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state = rollout(state, i + 1)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            state = rollout(state, i + 1)
            times.append(time.perf_counter() - t0)
    steps = args.batch * args.unroll
    best, median = steps / min(times), steps / statistics.median(times)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(
        json.dumps(
            {
                "metric": "env_steps_per_sec",
                "value": round(best, 1),
                "unit": "steps/s",
                "vs_baseline": round(best / TARGET, 3),
                "median": round(median, 1),
                "engine": engine,
                "batch": args.batch,
                "unroll": args.unroll,
                "rounds": args.rounds,
                "ms_per_launch": round(1e3 * statistics.median(times), 3),
                "device": name,
            }
        )
    )
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rein48_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    for name in ("play", "train", "parity"):
        sub.add_parser(name, help=f"{name} (not yet ported)").set_defaults(fn=_not_ported(name))

    pe = sub.add_parser("eval", help="evaluate the expectimax planner")
    pe.add_argument("--algo", choices=("a3c", "ppo", "dqn", "search", "ntuple"), default="a3c")
    pe.add_argument("--model", default=None)
    pe.add_argument("--obs-encoding", default=None, choices=("onehot", "raw", "log2"))
    pe.add_argument("--gamma", type=float, default=None)
    pe.add_argument("--reward-transform", default=None)
    pe.add_argument("--depth", type=int, default=1, help="expectimax depth")
    pe.add_argument("--checkpoint-dir", default=None)
    pe.add_argument("--num-envs", type=int, default=512)
    pe.add_argument("--max-steps", type=int, default=4096)
    pe.add_argument("--seed", type=int, default=0)
    pe.add_argument("--sample", action="store_true", help="sample instead of greedy")
    pe.add_argument("--device", default=None, help="cuda (default) or cpu")
    pe.set_defaults(fn=_cmd_eval)

    pb = sub.add_parser("bench", help="env throughput benchmark")
    pb.add_argument("--batch", type=int, default=16384)
    pb.add_argument("--unroll", type=int, default=1024)
    pb.add_argument("--rounds", type=int, default=4)
    pb.add_argument("--seed", type=int, default=0)
    pb.add_argument(
        "--engine",
        choices=("auto", "fused", "plain"),
        default="auto",
        help="fused rollout (the CUDA kernel on a card) or the plain torch engine; "
        "auto takes the kernel on cuda and the plain engine on the cpu",
    )
    pb.add_argument("--device", default=None, help="cuda (default) or cpu")
    pb.set_defaults(fn=_cmd_bench)
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

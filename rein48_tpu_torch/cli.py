# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Command-line interface of the port (counterpart of ``rein48_tpu/cli.py``).

    python -m rein48_tpu_torch play --control rand --visual
    python -m rein48_tpu_torch parity --seeds 5
    python -m rein48_tpu_torch bench --batch 65536 --unroll 2048
    python -m rein48_tpu_torch train --algo afterstate --updates 200 --checkpoint-dir ckpt/as
    python -m rein48_tpu_torch eval --algo search --depth 1 --checkpoint-dir ckpt/as
    python -m rein48_tpu_torch train --algo ntuple --updates 200 --checkpoint-dir ckpt/nt
    python -m rein48_tpu_torch eval --algo ntuple --depth 0 --checkpoint-dir ckpt/nt
    python -m rein48_tpu_torch train --algo ppo --afterstate --checkpoint-dir ckpt/ppo
    python -m rein48_tpu_torch eval --algo ppo --sample --checkpoint-dir ckpt/ppo
    python -m rein48_tpu_torch train --algo a3c --parity
    python -m rein48_tpu_torch train --algo dqn --updates 500 --checkpoint-dir ckpt/dqn
    python -m rein48_tpu_torch eval --algo dqn --checkpoint-dir ckpt/dqn
    python -m rein48_tpu_torch train --algo ddpg --updates 500
    torchrun --nproc_per_node 2 -m rein48_tpu_torch train --algo ntuple --mesh --updates 200

Every subcommand of the JAX CLI is ported: ``play`` (rand or hand
control; the reference's ``-c`` aliases), ``parity`` (fixed-seed games of
the Python oracle, the C oracle and the engine, one JSON line equal to the
JAX CLI's for the same seeds), ``bench``, ``train --algo
a3c|ppo|dqn|ddpg|afterstate|ntuple`` (with checkpoints and resume, DDPG
saving without resuming as in JAX; ``--parity`` for a3c, ``--afterstate``
for ppo, ``--model mlp`` meaning ``qnet`` for dqn) and ``eval --algo
a3c|ppo|dqn|search|ntuple`` (``--sample`` for a3c, ppo and dqn), where
``search`` plays the snake heuristic or, with ``--checkpoint-dir``, a
trained value net at its leaves: a PPO checkpoint's afterstate critic where
it has one. ``train --mesh`` runs data-parallel over every rank of the job
(``parallel/``): under ``torchrun`` every rank runs the CLI, joins the group
from torchrun's environment and trains its slice of the batch on its own
card (NCCL), or on a shared card or the CPU over gloo; without torchrun it
is a one-rank group. DDPG takes no mesh, as in JAX. The table backend
``torch`` is the JAX CLI's ``xla``. Everything runs on ``cuda`` unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from typing import Optional, Sequence

# The north-star of env-steps/s a host should reach (bench.py's TARGET);
# ``vs_baseline`` is the measured value over it.
TARGET = 10_000_000.0


def _cmd_play(args: argparse.Namespace) -> int:
    import numpy as np

    from rein48_tpu_torch import control
    from rein48_tpu_torch.engine.core import RewardMode
    from rein48_tpu_torch.env import Game

    game = Game(
        seed=args.seed, reward_mode=RewardMode.MERGE_SCORE if args.score else RewardMode.PARITY_ZERO, device=args.device
    )
    is_hand = args.control == "hand"
    if is_hand:
        # The reference's banner (main.py:20-33).
        print("=" * 40)
        print("Welcome to 2048 (rein48-tpu edition)")
        print("Actions: U/D/L/R (or up/down/left/right); Ctrl-C quits.")
        print("=" * 40)
    steps, done = 0, False
    rng = np.random.default_rng(args.seed)
    total_reward = 0.0
    while not done and steps < args.max_steps:
        if is_hand or args.visual:
            print(game.render())
        if is_hand:
            action = control.hand_control()
        else:
            legal = game.legal_actions
            if args.legal_only and legal.any():
                action = int(rng.choice(np.flatnonzero(legal)))
            else:
                action = int(rng.integers(0, 4))
        _, reward, done = game.step(action)
        total_reward += reward
        steps += 1
    print(game.render())
    # The reference's score: the sum of the tiles (main.py:48).
    print(f"game_over={done} steps={steps} tile_sum={int(game.state_matrix.sum())} merge_score={total_reward:.0f}")
    return 0


def _cmd_parity(args: argparse.Namespace) -> int:
    """Fixed-seed trajectory parity (the first graded configuration).

    Plays whole random-policy games three ways: the Python oracle, the C
    oracle (where a compiler builds it) consuming the action draw on its
    own stream, and the engine's ``move_boards`` and ``place_tile`` on the
    device, replaying the oracle's spawn decisions; the boards must agree
    at every step. Prints the JAX CLI's JSON line and exits 1 on any
    divergence.
    """
    import random as pyrandom

    import numpy as np
    import torch

    from rein48_tpu_torch import native
    from rein48_tpu_torch.device import resolve_device
    from rein48_tpu_torch.engine import core, oracle

    device = resolve_device(args.device)

    def place(board, decision):
        rank, value = torch.tensor([decision.rank, decision.value_exp], device=device)
        return core.place_tile(board, rank, value, torch.tensor(True, device=device))

    use_native = native.available()
    results = []
    for seed in range(args.seeds):
        rng = pyrandom.Random(seed)
        game = oracle.OracleGame(rng=rng)
        native_game = native.NativeOracleGame(seed) if use_native else None
        board = place(torch.zeros((4, 4), dtype=torch.uint8, device=device), game.spawn_log[0])
        if native_game is not None and native_game.state_matrix != game.state_matrix:
            raise SystemExit(f"native oracle reset diverged (seed {seed})")
        steps, done, diverged = 0, False, False
        while not done and steps < args.max_steps:
            action = oracle.random_action(rng)
            prev_spawns = len(game.spawn_log)
            state, _, done = game.step(action)
            if native_game is not None:
                # Consume the action draw on the native stream too, then step.
                native_game.random_action()
                n_state, _, n_done = native_game.step(action)
                if n_state != state or n_done != done:
                    diverged = True
                    break
            board = core.move_boards(board, torch.tensor(core.ACTION_ALIASES[action], device=device))[0]
            if len(game.spawn_log) > prev_spawns:
                board = place(board, game.spawn_log[-1])
            if not np.array_equal(core.boards_to_values(board).cpu().numpy(), np.asarray(state)):
                diverged = True
                break
            steps += 1
        results.append({"seed": seed, "steps": steps, "done": done, "parity": not diverged})
        print(f"seed {seed}: {'OK ' if not diverged else 'FAIL'} {steps} steps", file=sys.stderr)
    ok = all(r["parity"] for r in results)
    print(json.dumps({"parity": ok, "native_oracle": use_native, "games": results}))
    return 0 if ok else 1


def _join_mesh(device):
    """``train --mesh``: join the job's process group (torchrun's, or one
    rank of its own), build the mesh over all its ranks, and print it."""
    import torch.distributed as dist

    from rein48_tpu_torch.parallel import multihost

    multihost.initialize(device=device)
    if not dist.is_initialized():
        multihost.initialize(num_processes=1, process_id=0, device=device)
    mesh = multihost.global_mesh()
    device = multihost.rank_device(device)
    print(f"mesh: {mesh}, backend {dist.get_backend()}, device {device}", file=sys.stderr)
    return mesh, device


def _cmd_train(args: argparse.Namespace) -> int:
    if args.mesh and args.algo == "ddpg":
        raise SystemExit("train --algo ddpg takes no --mesh: train_ddpg has none, as in JAX")
    try:
        mesh, device = _join_mesh(args.device) if args.mesh else (None, args.device)
        return _train(args, mesh, device)
    finally:
        if args.mesh:
            from rein48_tpu_torch.parallel import multihost

            multihost.shutdown()


def _train(args: argparse.Namespace, mesh, device) -> int:
    from rein48_tpu_torch.utils.checkpoint import Checkpointer
    from rein48_tpu_torch.utils.metrics import MetricLogger

    ckpt = Checkpointer(args.checkpoint_dir, save_every=args.checkpoint_every) if args.checkpoint_dir else None
    logger = MetricLogger(log_dir=args.log_dir)
    run = dict(num_updates=args.updates, seed=args.seed, log_every=args.log_every, logger=logger, checkpointer=ckpt, device=device)
    mesh_run = dict(run, mesh=mesh)
    try:
        if args.algo == "dqn":
            from rein48_tpu_torch.train.dqn import DQNConfig, train_dqn

            model = args.model if args.model != "mlp" else "qnet"
            config = DQNConfig(num_envs=args.batch_size, model=model, learning_rate=args.lr)
            _, history = train_dqn(config, **mesh_run)
        elif args.algo == "ddpg":
            from rein48_tpu_torch.train.ddpg import DDPGConfig, train_ddpg

            _, history = train_ddpg(DDPGConfig(num_envs=args.batch_size, learning_rate=args.lr), **run)
        elif args.algo == "a3c":
            from rein48_tpu_torch.train.a3c import A3CConfig, train_a3c

            if args.parity:
                config = A3CConfig.reference_parity(batch_size=args.batch_size)
            else:
                config = A3CConfig(batch_size=args.batch_size, unroll_len=args.unroll, model=args.model, learning_rate=args.lr)
            _, history = train_a3c(config, **mesh_run)
        elif args.algo == "ppo":
            from rein48_tpu_torch.train.ppo import PPOConfig, train_ppo

            config = PPOConfig(
                batch_size=args.batch_size, unroll_len=args.unroll, model=args.model, learning_rate=args.lr,
                afterstate_critic=args.afterstate, after_model=args.model,
            )
            _, history = train_ppo(config, **mesh_run)
        elif args.algo == "afterstate":
            from rein48_tpu_torch.train.afterstate import AfterstateTDConfig, train_afterstate_td

            config = AfterstateTDConfig(
                batch_size=args.batch_size, unroll_len=args.unroll, model=args.model, learning_rate=args.lr
            )
            _, history = train_afterstate_td(config, **mesh_run)
        else:
            from rein48_tpu_torch.train.ntuple import NTupleTrainConfig, train_ntuple

            kwargs = {} if args.alpha is None else {"alpha": args.alpha}
            if args.delay_window is not None:
                # 0 is a whole-update window (None); unset keeps the trainer's default.
                kwargs["delay_window"] = args.delay_window or None
            config = NTupleTrainConfig(
                batch_size=args.batch_size,
                steps_per_update=args.unroll,
                update_mode=args.update_mode,
                table_backend=args.table_backend,
                **kwargs,
            )
            _, history = train_ntuple(config, **mesh_run)
    finally:
        logger.close()
    if history:
        print(f"final: {history[-1]}", file=sys.stderr)
    return 0


def _model_kwargs(saved: dict, field: str = "model_kwargs") -> dict:
    """A net's keyword arguments from a saved trainer config (pairs as JSON
    lists; a dtype saved as its ``str``, e.g. ``"torch.float32"``)."""
    import torch

    out = {}
    for key, value in saved.get(field, ()):
        if key == "dtype" and isinstance(value, str):
            value = getattr(torch, value.rsplit(".", 1)[-1])
        out[key] = value
    return out


def _cmd_eval(args: argparse.Namespace) -> int:
    from rein48_tpu_torch.device import resolve_device
    from rein48_tpu_torch.models import nets
    from rein48_tpu_torch.train import common
    from rein48_tpu_torch.utils.checkpoint import Checkpointer

    device = resolve_device(args.device)
    # Settings resolve as in the JAX CLI: a flag, else the config saved with
    # the checkpoint, else the trainer's default. A value leaf must be
    # searched in the units (gamma, reward transform) it was trained in.
    if args.checkpoint_dir and not os.path.isdir(args.checkpoint_dir):
        raise SystemExit(f"no checkpoint directory {args.checkpoint_dir}")
    ckpt = Checkpointer(args.checkpoint_dir) if args.checkpoint_dir else None
    saved = (ckpt.load_config() or {}) if ckpt is not None else {}

    def setting(flag_value, key, default):
        return flag_value if flag_value is not None else saved.get(key, default)

    obs_encoding = setting(args.obs_encoding, "obs_encoding", "onehot")
    if args.algo in ("a3c", "ppo", "dqn"):
        import torch

        from rein48_tpu_torch.train.dqn import DQNConfig
        from rein48_tpu_torch.train.evaluate import evaluate_policy

        # The policy net (a PPO checkpoint's afterstate critic is for
        # search), or the Q net, whose values the policy takes as logits.
        name, kwargs, generator = setting(args.model, "model", "resnet"), _model_kwargs(saved), torch.Generator().manual_seed(0)
        if args.algo == "dqn":
            model = DQNConfig(model=name, model_kwargs=tuple(kwargs.items()), obs_encoding=obs_encoding).make_model(generator)
        else:
            model = nets.make_model(name, in_channels=common.obs_channels(obs_encoding), generator=generator, **kwargs)
        if ckpt is not None:
            model.load_state_dict(ckpt.restore_field("model"))
            print(f"restored step {ckpt.latest_step()}", file=sys.stderr)
        stats = evaluate_policy(
            model.to(device).eval(), obs_encoding=obs_encoding, num_envs=args.num_envs, num_steps=args.max_steps,
            seed=args.seed, greedy=not args.sample, protocol=args.protocol, device=device,
        )
        print(json.dumps(stats))
        return 0

    eval_kw = dict(
        depth=args.depth, num_envs=args.num_envs, num_steps=args.max_steps, seed=args.seed,
        protocol=args.protocol, chance_chunk=args.chance_chunk, device=device,
    )
    if args.algo == "ntuple":
        from rein48_tpu_torch.agents.ntuple import YEH_4X6
        from rein48_tpu_torch.train.ntuple import NTupleTrainConfig, evaluate_ntuple

        if ckpt is None:
            raise SystemExit("eval --algo ntuple needs --checkpoint-dir")
        config = NTupleTrainConfig(
            tuples=tuple(tuple(int(c) for c in t) for t in saved.get("tuples", YEH_4X6)),
            symmetric=saved.get("symmetric", True),
            table_backend=saved.get("table_backend", "auto"),
            cache_prefix_rows=saved.get("cache_prefix_rows", NTupleTrainConfig.cache_prefix_rows),
        )
        params = {k: v.to(device) for k, v in ckpt.restore_field("params").items()}
        print(f"restored step {ckpt.latest_step()}", file=sys.stderr)
        stats = evaluate_ntuple(params, config, **eval_kw)
        print(json.dumps(stats))
        return 0

    from rein48_tpu_torch.train.evaluate import evaluate_search

    if ckpt is None:
        # Without a checkpoint the leaf is the snake heuristic, which has no
        # critic units to set.
        for flag in ("model", "obs_encoding", "gamma", "reward_transform"):
            if getattr(args, flag) is not None:
                raise SystemExit(f"eval --{flag.replace('_', '-')} needs --checkpoint-dir")
    else:
        if saved.get("afterstate_critic"):
            # A PPO checkpoint's co-trained afterstate critic is the leaf the
            # planner's backups are consistent with.
            name, kwargs, field = saved.get("after_model", "resnet"), _model_kwargs(saved, "after_model_kwargs"), "after_model"
            print("using afterstate-critic leaf", file=sys.stderr)
        else:
            name, kwargs, field = setting(args.model, "model", "resnet"), _model_kwargs(saved), "model"
        model = nets.make_model(name, in_channels=common.obs_channels(obs_encoding), **kwargs)
        model.load_state_dict(ckpt.restore_field(field))
        leaf = dict(
            obs_encoding=obs_encoding,
            gamma=setting(args.gamma, "gamma", 0.99),
            reward_transform=setting(args.reward_transform, "reward_transform", "log2"),
        )
        eval_kw.update(model=model.to(device).eval(), **leaf)
        print(f"restored step {ckpt.latest_step()}; value leaf {json.dumps(leaf)}", file=sys.stderr)
    stats = evaluate_search(**eval_kw)
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


def _normalize_control(value: str) -> str:
    # The reference's alias sets (main.py:64-69).
    if value in ("r", "rand", "random", "Random"):
        return "rand"
    if value in ("h", "hand", "human", "Hand"):
        return "hand"
    raise argparse.ArgumentTypeError(f"unknown control '{value}' (choose rand/hand)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rein48_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pp = sub.add_parser("play", help="play one game (rand or hand control)")
    pp.add_argument("-c", "--control", type=_normalize_control, default="rand")
    pp.add_argument("-v", "--visual", action="store_true")
    pp.add_argument("--seed", type=int, default=0)
    pp.add_argument("--max-steps", type=int, default=10000)
    # Always on, as in the JAX CLI (store_true with a True default).
    pp.add_argument("--legal-only", action="store_true", default=True)
    pp.add_argument("--score", action="store_true", help="pay merge score")
    pp.add_argument("--device", default=None, help="cuda (default) or cpu")
    pp.set_defaults(fn=_cmd_play)

    pr = sub.add_parser("parity", help="fixed-seed parity check vs reference")
    pr.add_argument("--seeds", type=int, default=5)
    pr.add_argument("--max-steps", type=int, default=3000)
    pr.add_argument("--device", default=None, help="cuda (default) or cpu")
    pr.set_defaults(fn=_cmd_parity)

    pt = sub.add_parser("train", help="train an agent")
    pt.add_argument("--algo", choices=("a3c", "ppo", "dqn", "ddpg", "ntuple", "afterstate"), default="a3c")
    pt.add_argument(
        "--model", default="resnet", help="mlp | cnn | resnet (afterstate: the value net; dqn: mlp means qnet; ddpg: unused)"
    )
    pt.add_argument("--updates", type=int, default=200)
    pt.add_argument("--batch-size", type=int, default=4096)
    pt.add_argument("--unroll", type=int, default=32)
    pt.add_argument("--lr", type=float, default=3e-4, help="learning rate (not ntuple)")
    pt.add_argument("--alpha", type=float, default=None, help="TD learning rate (default: the trainer's)")
    pt.add_argument("--update-mode", choices=("step", "delayed"), default="step")
    pt.add_argument(
        "--delay-window", type=int, default=None,
        help="--update-mode delayed: env steps per frozen-table window (must divide --unroll; 0 = whole update)",
    )
    pt.add_argument(
        "--table-backend", choices=("auto", "torch", "mxu"), default="auto",
        help="torch = plain index ops (the JAX CLI's xla); mxu = the table kernels, tables <= 65536 entries; "
        "auto takes mxu on cuda when every table qualifies",
    )
    pt.add_argument("--seed", type=int, default=0)
    pt.add_argument("--afterstate", action="store_true", help="ppo only: co-train an afterstate value net (planner leaf)")
    pt.add_argument(
        "--mesh", action="store_true",
        help="data-parallel over every rank of the job (run under torchrun; alone, one rank); not ddpg",
    )
    pt.add_argument("--parity", action="store_true", help="a3c only: the reference-parity regime")
    pt.add_argument("--log-dir", default=None)
    pt.add_argument("--log-every", type=int, default=10)
    pt.add_argument("--checkpoint-dir", default=None, help="save here, and resume from the latest checkpoint here")
    pt.add_argument("--checkpoint-every", type=int, default=100, help="save at the logged updates this divides")
    pt.add_argument("--device", default=None, help="cuda (default) or cpu")
    pt.set_defaults(fn=_cmd_train)

    pe = sub.add_parser("eval", help="evaluate a trained policy, the expectimax planner or n-tuple tables")
    pe.add_argument("--algo", choices=("a3c", "ppo", "dqn", "search", "ntuple"), default="a3c")
    # None: the config saved with the checkpoint decides, then the default.
    pe.add_argument("--model", default=None)
    pe.add_argument("--obs-encoding", default=None, choices=("onehot", "raw", "log2"))
    pe.add_argument("--gamma", type=float, default=None)
    pe.add_argument("--reward-transform", default=None)
    pe.add_argument("--depth", type=int, default=1, help="expectimax depth (ntuple depth 0: the greedy afterstate policy)")
    pe.add_argument(
        "--checkpoint-dir", default=None,
        help="a3c/ppo/dqn: the trained policy or Q net (a fresh init without); search: the trained value net as the leaf",
    )
    pe.add_argument("--num-envs", type=int, default=512)
    pe.add_argument("--max-steps", type=int, default=4096)
    pe.add_argument("--seed", type=int, default=0)
    pe.add_argument(
        "--protocol", choices=("window", "first"), default="window",
        help="window: episodes finished within the sweep; first: each env's first episode",
    )
    pe.add_argument("--chance-chunk", type=int, default=None, help="chance children per leaf batch (divides 32)")
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

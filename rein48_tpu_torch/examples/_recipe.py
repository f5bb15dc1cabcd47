# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""What the recipes share: their argument layout, the training run and the
evaluation loop around the port's APIs, the n-tuple checkpoint's restore,
the frontier sweeps' legs, their JSON records, and the keys those records
must share with the JAX recipes' committed ones."""

from __future__ import annotations

import csv
import dataclasses
import json
import os
import sys
import time
from pathlib import Path
from typing import Any, Callable, Sequence, Tuple

import torch

from rein48_tpu_torch.train.ntuple import NTupleTrainConfig, evaluate_ntuple, init_ntuple, make_ntuple_step
from rein48_tpu_torch.utils.checkpoint import Checkpointer
from rein48_tpu_torch.utils.metrics import MetricLogger
from rein48_tpu_torch.utils.profiling import force


def positional(argv: Sequence[str] | None, *spec: Tuple[Callable, Any]) -> list:
    """The JAX scripts' ``type(sys.argv[i]) if len(sys.argv) > i else
    default`` lines: one ``(type, default)`` per position, ``argv`` without
    the program name (``None`` reads ``sys.argv[1:]``). A callable default
    is called with the values before it."""
    argv = sys.argv[1:] if argv is None else list(argv)
    values: list = []
    for i, (cast, default) in enumerate(spec):
        if i < len(argv):
            values.append(cast(argv[i]))
        else:
            values.append(default(*values) if callable(default) else default)
    return values


def train(trainer: Callable, config, num_updates: int, *, tag: str, ckpt: Checkpointer, log_every: int, device,
          **kwargs) -> tuple:
    """One training run as the JAX recipes make it: seed 0, a record every
    ``log_every`` updates in ``runs/<tag>/metrics.csv``, checkpoints through
    ``ckpt`` (resumed from its latest step, saved again at the end).
    Returns ``(state, history, train_sec)``."""
    logger = MetricLogger(log_dir=f"runs/{tag}")
    t0 = time.perf_counter()
    try:
        state, history = trainer(
            config, num_updates=num_updates, seed=0, log_every=log_every, logger=logger, checkpointer=ckpt,
            device=device, **kwargs,
        )
    finally:
        logger.close()
    train_sec = time.perf_counter() - t0
    ckpt.save(state.update_step, state)
    return state, history, train_sec


def training_record(state, history, train_sec: float, frames_per_update: int | None = None, **fields) -> dict:
    """The head of a training recipe's ``eval.json``: updates, seconds,
    frames where the JAX recipe counts them, the last logged rate, then
    ``fields`` in order."""
    out: dict = {"updates": state.update_step, "train_sec": round(train_sec, 1)}
    if frames_per_update is not None:
        out["frames"] = state.update_step * frames_per_update
    out["steps_per_sec"] = history[-1]["steps_per_sec"] if history else None
    return {**out, **fields}


def schedule(config) -> dict:
    """The ``config`` block of the flagship records: batch, discount and the
    learning-rate and entropy schedules."""
    return {
        "batch_size": config.batch_size,
        "gamma": config.gamma,
        "lr": config.learning_rate,
        "lr_decay_updates": config.lr_decay_updates,
        "entropy": [config.entropy_beta, config.entropy_beta_final],
    }


def evaluate(plan: list, run: Callable, out: dict, path: str, sized: Callable[[str], bool] = lambda tag: True) -> dict:
    """Each ``(tag, keywords)`` of ``plan`` through ``run(keywords)``, timed:
    its stats go to ``out["results"][tag]`` with ``wall_sec`` (and the
    envs and steps where ``sized(tag)``), and ``out`` is written to ``path``
    after each, so a long sweep keeps the rows before."""
    results = out.setdefault("results", {})
    for tag, kwargs in plan:
        t0 = time.perf_counter()
        stats = run(kwargs)
        stats["wall_sec"] = round(time.perf_counter() - t0, 1)
        if sized(tag):
            stats["num_envs"], stats["num_steps"] = kwargs["num_envs"], kwargs["num_steps"]
        results[tag] = stats
        print(f"EVAL {tag}:", stats, flush=True)
        write_json(path, out)
    return out


def probe(plan: list, run: Callable, num_envs: int, num_steps: int) -> dict:
    """The depth-2 recipes' probe: each launch of ``plan`` timed, with what
    a ``num_envs`` x ``num_steps`` run would take at that rate."""
    probes = {}
    for tag, kwargs in plan:
        t0 = time.perf_counter()
        probes[tag] = run(kwargs)
        per = (time.perf_counter() - t0) / (kwargs["num_steps"] * num_envs)
        print(
            f"PROBE {tag}: {num_envs} envs x {kwargs['num_steps']} steps, {1e6 * per:.1f} us/env-step; "
            f"a {num_envs}x{num_steps} run would take ~{per * num_envs * num_steps / 60:.0f} min",
            flush=True,
        )
    return probes


def ntuple_config(saved: dict) -> NTupleTrainConfig:
    """The n-tuple config a checkpoint was trained with, from its saved
    ``train_config.json`` as the JAX eval scripts read it: the tuples, the
    symmetry and TC flags and the batch size; the rest at their defaults."""
    kwargs: dict = {}
    if "tuples" in saved:  # JSON round-trips the tuple-of-tuples as lists
        kwargs["tuples"] = tuple(tuple(int(c) for c in t) for t in saved["tuples"])
    for flag in ("symmetric", "tc"):
        if flag in saved:
            kwargs[flag] = saved[flag] in (True, "True")
    if "batch_size" in saved:
        kwargs["batch_size"] = int(saved["batch_size"])
    return NTupleTrainConfig(**kwargs)


def restore_ntuple(make_config: Callable[[dict], NTupleTrainConfig], device, tag: str = "ntuple_cuda") -> tuple:
    """The n-tuple recipe's latest checkpoint restored whole onto ``device``:
    ``(config, state, step, init_sec, restore_sec)``, the config from
    ``make_config(saved config)``, each timed to a fence (one scalar read
    back)."""
    ckpt = Checkpointer(f"ckpt/{tag}")
    config = make_config(ckpt.load_config() or {})
    t0 = time.perf_counter()
    template, _ = init_ntuple(config, 0, device)
    force(template.env.score)
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = ckpt.restore(template)
    force(state.params["t0"])
    return config, state, ckpt.latest_step(), t_init, time.perf_counter() - t0


def frontier(legs: Sequence[tuple], evaluation: dict, budget_sec: float, path: str, device) -> dict:
    """The frontier sweeps (``ntuple_frontier``, ``ntuple_frontier_b``): each
    leg ``(label, fields, config, check_every)`` trains ``config`` from
    ``init_ntuple`` at seed 0 for ``budget_sec`` of stepping, then plays
    ``evaluate_ntuple(**evaluation)``. The warm-up update (and, under
    ``"cached"``, the first refresh of the hot prefix) runs before the clock
    starts; the clock is read after every ``check_every`` updates (one scalar
    fetch), and under ``"cached"`` the refresh every 40 updates counts as
    training. The record, ``{"budget_sec", "legs"}`` with each leg's
    ``fields`` first, is written to ``path`` after every leg."""
    record: dict = {"budget_sec": budget_sec, "legs": []}
    for label, fields, config, check_every in legs:
        state, net = init_ntuple(config, 0, device)
        step = make_ntuple_step(config, device)
        cached = config.network_config(device).backend == "cached"
        t0 = time.perf_counter()
        state, metrics = step(state)
        force(metrics["td_abs_err"])
        if cached:
            state = dataclasses.replace(state, params=net.refresh_cache(state.params))
            force(state.params["t0_rm"])
        compile_sec = time.perf_counter() - t0

        updates = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < budget_sec:
            for _ in range(check_every):
                state, metrics = step(state)
            force(metrics["td_abs_err"])
            updates += check_every
            if cached and updates % 40 == 0:
                state = dataclasses.replace(state, params=net.refresh_cache(state.params))
        train_sec = time.perf_counter() - t0
        env_steps = updates * config.batch_size * config.steps_per_update

        t0 = time.perf_counter()
        stats = evaluate_ntuple(state.params, config, device=device, **evaluation)
        eval_sec = time.perf_counter() - t0
        del state, metrics, step
        if device.type == "cuda":  # a YEH_4X6 leg holds ~1 GB of tables
            torch.cuda.empty_cache()

        record["legs"].append({
            **fields,
            "compile_sec": round(compile_sec, 1),
            "train_sec": round(train_sec, 1),
            "updates": updates,
            "env_steps": env_steps,
            "steps_per_sec": round(env_steps / train_sec, 1),
            "eval_sec": round(eval_sec, 1),
            "eval": stats,
        })
        print(
            f"LEG {label}: {env_steps / 1e6:.1f}M steps in {train_sec:.0f}s ({env_steps / train_sec / 1e3:.0f}k/s) -> "
            f"avg_score {stats['avg_score']:.0f}, frac_1024 {stats['frac_1024']:.3f}, frac_2048 {stats['frac_2048']:.3f}",
            flush=True,
        )
        write_json(path, record)
    return record


def write_json(path: str, obj: dict) -> None:
    """Write one record (its directory made if missing)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)
    print(f"wrote {path}", flush=True)


def record_keys(path: str | Path, lists: bool = False):
    """A record's keys: a CSV's header, or a JSON object's nested key set
    (a scalar as ``None``, and a list too unless ``lists``: then a list of
    objects is the list of its items' distinct key sets, in order)."""

    def nested(value):
        if isinstance(value, dict):
            return {k: nested(v) for k, v in value.items()}
        if lists and isinstance(value, list) and value and all(isinstance(v, dict) for v in value):
            distinct: list = []
            for keys in map(nested, value):
                if keys not in distinct:
                    distinct.append(keys)
            return distinct
        return None

    with open(path) as f:
        return next(csv.reader(f)) if str(path).endswith(".csv") else nested(json.load(f))


def jax_keys(module, root: str | Path) -> dict:
    """``{path the recipe writes: the keys it must have}``: those of the
    committed JAX records that ``module.JAX_RECORDS`` names (paths under
    ``root``), as ``module.adjust_jax_keys`` adjusts them where the
    record predates the JAX script. A module whose records hold lists of
    objects (the frontier sweeps' legs) sets ``KEYS_IN_LISTS``."""
    lists = getattr(module, "KEYS_IN_LISTS", False)
    keys = {ours: record_keys(Path(root) / theirs, lists) for ours, theirs in getattr(module, "JAX_RECORDS", {}).items()}
    adjust = getattr(module, "adjust_jax_keys", None)
    if adjust is not None:
        adjust(keys)
    return keys


def written_keys(module) -> dict:
    """The keys of the records ``module`` wrote under the working directory,
    read as :func:`jax_keys` reads their twins."""
    lists = getattr(module, "KEYS_IN_LISTS", False)
    return {path: record_keys(path, lists) for path in getattr(module, "JAX_RECORDS", {})}

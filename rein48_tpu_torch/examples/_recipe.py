# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""What the recipes share: their argument layout, the training run and the
evaluation loop around the port's APIs, the n-tuple checkpoint's restore,
their JSON records, and the keys those records must share with the JAX
recipes' committed ones."""

from __future__ import annotations

import csv
import json
import os
import sys
import time
from pathlib import Path
from typing import Any, Callable, Sequence, Tuple

from rein48_tpu_torch.train.ntuple import NTupleTrainConfig, init_ntuple
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


def write_json(path: str, obj: dict) -> None:
    """Write one record (its directory made if missing)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)
    print(f"wrote {path}", flush=True)


def record_keys(path: str | Path):
    """A record's keys: a CSV's header, or a JSON object's nested key set
    (a list or scalar as ``None``)."""

    def nested(value):
        return {k: nested(v) for k, v in value.items()} if isinstance(value, dict) else None

    with open(path) as f:
        return next(csv.reader(f)) if str(path).endswith(".csv") else nested(json.load(f))


def jax_keys(module, root: str | Path) -> dict:
    """``{path the recipe writes: the keys it must have}``: those of the
    committed JAX records that ``module.JAX_RECORDS`` names (paths under
    ``root``), as ``module.adjust_jax_keys`` adjusts them where the
    record predates the JAX script."""
    keys = {ours: record_keys(Path(root) / theirs) for ours, theirs in getattr(module, "JAX_RECORDS", {}).items()}
    adjust = getattr(module, "adjust_jax_keys", None)
    if adjust is not None:
        adjust(keys)
    return keys

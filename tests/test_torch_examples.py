# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""The recipes of ``examples/`` as the port's entry points
(``rein48_tpu_torch.examples``).

Config parity: the JAX scripts run at import, so each is read with ``ast``
and walked statement by statement with every ``sys.argv[i]`` absent (their
defaults); the config it builds and the keyword arguments of each of its
evaluation calls must equal the port module's ``make_config`` and
``evaluations`` at the same defaults, field by field.

The frontier sweeps are read the same way, leg by leg: every config their
legs build, their budget, legs or batches and the scoring call.

Then every recipe runs on the CPU at a tiny size in a temporary working
directory, in the order the recipes feed each other (n-tuple training, its
evaluations; the PPO flagship, its depth-1 evaluation, the afterstate PPO
warm-started from it, the afterstate TD warm-started from its critic, its
depth-2 probe; A3C, DQN, the parity curve; the two frontier sweeps, at a
budget of about 0 s). Widths are shrunk only by the
tests' own replacement of config fields (and of evaluation sizes); each
``eval.json`` must have the key set of the committed JAX record, each
``metrics.csv`` its header; the warm-started weights at update 0 equal the
donor's; a second ``main`` resumes the first run's checkpoint.
"""

from __future__ import annotations

import ast
import builtins
import csv
import dataclasses
import enum
import importlib
import json
import os
import types
from pathlib import Path

import pytest
import torch

from rein48_tpu_torch.examples import (
    _recipe,
    a3c_parity_curve,
    eval_afterstate_depth2,
    eval_ntuple,
    eval_ntuple_depth1,
    eval_ntuple_depth2,
    eval_ppo_depth1,
    ntuple_frontier,
    ntuple_frontier_b,
    train_a3c,
    train_a3c_flagship,
    train_afterstate_td,
    train_dqn,
    train_dqn_nstep,
    train_ntuple,
    train_ppo,
    train_ppo_afterstate,
    train_ppo_flagship,
)
from rein48_tpu_torch.testing import capped_evaluations
from rein48_tpu_torch.utils.checkpoint import Checkpointer

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
EVAL_FUNCTIONS = ("evaluate_ntuple", "evaluate_policy", "evaluate_search")
SAFE_BUILTINS = {n: getattr(builtins, n) for n in ("max", "min", "int", "float", "str", "bool", "range", "dict", "tuple", "list", "len", "round", "abs")}


# --- reading a JAX script ---------------------------------------------------


class Opaque:
    """A value the walk cannot know (a trained state, a model, a clock):
    any use gives another; ``.get`` and ``in`` read as an empty dict (an
    absent saved config)."""

    def __init__(self, name: str):
        self.name = name

    def __getattr__(self, attr):
        return Opaque(f"{self.name}.{attr}")

    def __call__(self, *args, **kwargs):
        return Opaque(f"{self.name}()")

    def __getitem__(self, key):
        return Opaque(f"{self.name}[]")

    def __contains__(self, key):
        return False

    def get(self, key, default=None):
        return default


class _Names(dict):
    """The walk's namespace: a name never bound is an :class:`Opaque`."""

    def __missing__(self, name):
        if name in SAFE_BUILTINS:
            raise KeyError(name)
        return Opaque(name)


class _Exit(Exception):
    pass


def _evaluate(node, names):
    try:
        return eval(compile(ast.Expression(node), "<recipe>", "eval"), {"__builtins__": SAFE_BUILTINS}, names)
    except Exception:  # an expression over values the walk cannot know
        return Opaque(ast.unparse(node))


def _bind(target, value, names):
    if isinstance(target, ast.Name):
        names[target.id] = value
    elif isinstance(target, ast.Tuple):
        items = list(value) if isinstance(value, (tuple, list)) and len(value) == len(target.elts) else None
        for i, t in enumerate(target.elts):
            _bind(t, Opaque("item") if items is None else items[i], names)


def _call_name(node):
    f = node.func
    return f.id if isinstance(f, ast.Name) else f.attr if isinstance(f, ast.Attribute) else None


def _walk(stmts, names, found):
    for s in stmts:
        if isinstance(s, ast.ImportFrom):
            module = importlib.import_module(s.module) if s.module.startswith("rein48_tpu") else None
            for alias in s.names:
                name = alias.asname or alias.name
                # Only the config classes are real: nothing else may run.
                names[name] = getattr(module, alias.name) if module and alias.name.endswith("Config") else Opaque(name)
        elif isinstance(s, (ast.FunctionDef, ast.Import)):
            continue
        elif isinstance(s, ast.For):
            items = _evaluate(s.iter, names)
            for item in [] if isinstance(items, Opaque) else items:
                _bind(s.target, item, names)
                _walk(s.body, names, found)
        elif isinstance(s, ast.If):
            _walk(s.body if _evaluate(s.test, names) is True else s.orelse, names, found)
        elif isinstance(s, (ast.With, ast.Try)):
            _walk(s.body, names, found)
        else:
            for node in ast.walk(s):
                if isinstance(node, ast.Call) and _call_name(node) in EVAL_FUNCTIONS:
                    kwargs = {}
                    for kw in node.keywords:
                        value = _evaluate(kw.value, names)
                        kwargs.update(value if kw.arg is None else {kw.arg: value})
                    found["calls"].append((_call_name(node), kwargs))
            if isinstance(s, ast.Assign):
                value = _evaluate(s.value, names)
                for target in s.targets:
                    _bind(target, value, names)
                if dataclasses.is_dataclass(value) and type(value).__name__.endswith("Config"):
                    found["configs"].append(value)
            elif isinstance(s, ast.Expr) and isinstance(s.value, ast.Call) and ast.unparse(s.value.func) == "sys.exit":
                raise _Exit


def read_jax_recipe(script: str, argv=()) -> dict:
    """The configs a JAX script builds, its evaluation calls' keywords and
    the names it bound (``names``), with ``sys.argv`` = ``[script, *argv]``."""
    names = _Names(sys=types.SimpleNamespace(argv=[script, *argv]))
    found = {"configs": [], "calls": [], "names": names}
    try:
        _walk(ast.parse((REPO / "examples" / script).read_text()).body, names, found)
    except _Exit:
        pass
    return found


# JAX config values the port names otherwise, as tests/test_torch_api.py
# records its differences: (field, JAX value) -> (the port's value, why).
RENAMED = {
    ("table_backend", "xla"): ("torch", "the JAX package's plain table backend is the port's 'torch' (agents/ntuple.py)"),
}


def plain(value):
    """A config value comparable across the packages: enums by name."""
    if isinstance(value, enum.Enum):
        return value.name
    if isinstance(value, (tuple, list)):
        return tuple(plain(v) for v in value)
    return value


# module, JAX script, argv, (module, parsed args) -> (config, evaluation plan)
CASES = {
    "train_ntuple": ("train_ntuple_tpu.py", (), lambda m, a: (m.make_config(*a), m.evaluations())),
    "eval_ntuple": ("eval_ntuple_tpu.py", (), lambda m, a: (m.make_config({}), m.evaluations(*a))),
    "eval_ntuple_depth1": ("eval_ntuple_depth1_tpu.py", (), lambda m, a: (m.make_config({}), m.evaluations(*a))),
    "eval_ntuple_depth2": ("eval_ntuple_depth2_tpu.py", (), lambda m, a: (m.make_config({}), m.evaluations(*a))),
    "eval_ntuple_depth2-run": ("eval_ntuple_depth2_tpu.py", ("run",), lambda m, a: (m.make_config({}), m.evaluations(*a))),
    "train_ppo": ("train_ppo_tpu.py", (), lambda m, a: (c := m.make_config(*a), m.evaluations(c))),
    "train_ppo_flagship": ("train_ppo_flagship_tpu.py", (), lambda m, a: (c := m.make_config(*a), m.evaluations(c))),
    "train_ppo_afterstate": ("train_ppo_afterstate_tpu.py", (), lambda m, a: (c := m.make_config(*a), m.evaluations(c))),
    "eval_ppo_depth1": ("eval_ppo_depth1_tpu.py", (), lambda m, a: (c := m.make_config({}), m.evaluations(c, *a))),
    "train_afterstate_td": ("train_afterstate_td_tpu.py", (), lambda m, a: (c := m.make_config(*a[:2]), m.evaluations(c))),
    "eval_afterstate_depth2": ("eval_afterstate_depth2_tpu.py", (), lambda m, a: (c := m.make_config(), m.evaluations(c, *a[:5]))),
    "eval_afterstate_depth2-run": ("eval_afterstate_depth2_tpu.py", ("run",), lambda m, a: (c := m.make_config(), m.evaluations(c, *a[:5]))),
    "train_a3c": ("train_a3c_tpu.py", (), lambda m, a: (c := m.make_config(*a), m.evaluations(c))),
    "train_a3c_flagship": ("train_a3c_flagship_tpu.py", (), lambda m, a: (c := m.make_config(*a), m.evaluations(c))),
    "train_dqn": ("train_dqn_tpu.py", (), lambda m, a: (c := m.make_config(*a), m.evaluations(c))),
    "train_dqn_nstep": ("train_dqn_nstep_tpu.py", (), lambda m, a: (c := m.make_config(*a[:5]), m.evaluations(c))),
    "a3c_parity_curve": ("a3c_parity_curve.py", (), lambda m, a: (m.make_config(), [])),
    # The sweeps: every leg's config, and one scoring call per leg.
    "ntuple_frontier": ("ntuple_frontier_tpu.py", (), lambda m, a: _legs(m, *a[2:])),
    "ntuple_frontier-cached": ("ntuple_frontier_tpu.py", ("420", "x.json", "cached", "delayed:4", "step:none"), lambda m, a: _legs(m, *a[2:])),
    "ntuple_frontier_b": ("ntuple_frontier_b_tpu.py", (), lambda m, a: _legs(m, *a[2:])),
}


def _legs(module, *spec):
    legs = module.legs(*spec)
    return [config for _, _, config, _ in legs], [e for _ in legs for e in module.evaluations()]


@pytest.mark.parametrize("case", sorted(CASES))
def test_recipe_matches_jax_defaults(case):
    script, argv, port = CASES[case]
    module = importlib.import_module(f"rein48_tpu_torch.examples.{case.split('-')[0]}")
    jax = read_jax_recipe(script, argv)
    config, plan = port(module, module.parse(list(argv)))

    configs, wants = (config, jax["configs"]) if isinstance(config, list) else ([config], jax["configs"][:1])
    assert len(configs) == len(wants)
    for config, want in zip(configs, wants):
        for f in dataclasses.fields(want):
            theirs = plain(getattr(want, f.name))
            assert plain(getattr(config, f.name)) == RENAMED.get((f.name, theirs), (theirs,))[0], f.name
    assert len(plan) == len(jax["calls"])
    for (tag, kwargs), (fn, jax_kwargs) in zip(plan, jax["calls"]):
        # What the walk knows (a model, params or callback is the port's own object).
        known = {k: v for k, v in jax_kwargs.items() if v is None or isinstance(v, (bool, int, float, str))}
        assert kwargs == known, (tag, fn)


def test_reading_resolves_loops_and_defaults():
    """The walk binds loop variables and argv defaults: train_ntuple_tpu.py's
    two depths, and eval_ntuple_tpu.py's sweep at max_depth 2."""
    calls = read_jax_recipe("train_ntuple_tpu.py")["calls"]
    assert [(fn, kw["depth"], kw["num_envs"], kw["chance_chunk"]) for fn, kw in calls] == [
        ("evaluate_ntuple", 0, 1024, None), ("evaluate_ntuple", 1, 256, 4)
    ]
    calls = read_jax_recipe("eval_ntuple_tpu.py", ("2", "512", "4096"))["calls"]
    assert [(kw["num_envs"], kw["num_steps"]) for _, kw in calls] == [(512, 4096), (128, 2048), (32, 1024)]
    assert eval_ntuple.evaluations(2, 512, 4096) == [(f"depth{d}", kw) for d, (_, kw) in enumerate(calls)]


def test_positional_layout():
    """JAX's argv layout: given positions win, later ones take defaults,
    a callable default sees the values before it."""
    assert eval_ntuple_depth2.parse([]) == ["probe", 8, 20480, 8, 128]
    assert eval_ntuple_depth2.parse(["run"]) == ["run", 32, 20480, 8, 128]
    assert eval_ntuple_depth2.parse(["run", "4", "64"]) == ["run", 4, 64, 8, 128]
    assert train_dqn_nstep.parse(["3", "16", "3", "0.99"]) == [3, 16, 3, 0.99, 1.0, "dqn_r5_cuda"]


def test_frontier_defaults_read_from_jax():
    """The sweeps' budget, legs and batches are the JAX scripts' (read with
    ``ast``); a leg given as ``mode:window`` replaces them; the clock is read
    every 20 updates, and every ``max(1, 20480 // B)`` over B."""
    jax = read_jax_recipe("ntuple_frontier_tpu.py")["names"]
    budget, out, backend, modes = ntuple_frontier.parse([])
    assert (budget, modes) == (jax["BUDGET_SEC"], jax["LEGS"]) and out == ntuple_frontier.OUT
    assert backend == RENAMED[("table_backend", jax["BACKEND"])][0]
    assert {check for *_, check in ntuple_frontier.legs(backend, modes)} == {20}
    argv = ("60", "x.json", "cached", "delayed:4", "step:none")
    jax = read_jax_recipe("ntuple_frontier_tpu.py", argv)["names"]
    assert ntuple_frontier.parse(list(argv)) == [60.0, "x.json", jax["BACKEND"], jax["LEGS"]]

    jax = read_jax_recipe("ntuple_frontier_b_tpu.py")["names"]
    budget, out, batches = ntuple_frontier_b.parse([])
    assert (budget, batches) == (jax["BUDGET_SEC"], jax["BATCHES"]) and out == ntuple_frontier_b.OUT
    assert [check for *_, check in ntuple_frontier_b.legs(batches)] == [20, 5, 1]
    assert read_jax_recipe("ntuple_frontier_b_tpu.py", ("60", "x.json", "512"))["names"]["BATCHES"] == (512,)
    assert ntuple_frontier_b.parse(["60", "x.json", "512"])[2] == (512,)


def test_frontier_backend_names():
    """The JAX name ``xla`` is read as the port's ``"torch"``; the port's own
    names pass as they are."""
    for name, port in (("xla", "torch"), ("torch", "torch"), ("cached", "cached"), ("mxu", "mxu"), ("auto", "auto")):
        assert ntuple_frontier.parse(["1", "x.json", name])[2] == port
    assert ntuple_frontier.JAX_BACKENDS == {jax: port for (field, jax), (port, _) in RENAMED.items() if field == "table_backend"}


def test_recipes_refuse_without_a_card(monkeypatch, tmp_path):
    """No fallback hides the card: with no CUDA and no device named, a
    recipe raises before it writes anything."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for module in (train_ntuple, ntuple_frontier, ntuple_frontier_b):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            module.main(["1"])
    assert not any(tmp_path.iterdir())


# --- the recipes at a tiny size, in the order they feed each other -----------

SMALL = (("channels", 8), ("num_blocks", 1), ("dtype", torch.float32))
TINY_TUPLES = ((0, 1, 2, 3), (4, 5, 6, 7))
TINY_EVAL = dict(num_envs=4, num_steps=8)
FRONTIER_BUDGET = "0.01"


def _shrunk(module, **fields):
    make = module.make_config

    def make_config(*args):
        return dataclasses.replace(make(*args), **fields)

    return make_config


def _shrink(mp):
    """Tiny widths, through replaced config fields and evaluation sizes."""
    ntuple = dict(tuples=TINY_TUPLES, batch_size=8, steps_per_update=4)
    ppo = dict(unroll_len=4, model_kwargs=SMALL)
    dqn = dict(model_kwargs=SMALL, replay_capacity=256, learn_batch_size=16, min_replay_before_learn=16)
    shrink = {
        train_ntuple: ntuple,
        train_ppo: ppo,
        train_ppo_flagship: ppo,
        eval_ppo_depth1: dict(model_kwargs=SMALL),
        train_ppo_afterstate: dict(ppo, after_model_kwargs=SMALL),
        train_afterstate_td: ppo,
        eval_afterstate_depth2: dict(model_kwargs=SMALL),
        train_a3c: dict(ppo, batch_size=8),
        train_a3c_flagship: ppo,
        train_dqn: dqn,
        train_dqn_nstep: dqn,
        a3c_parity_curve: dict(unroll_len=8),
        ntuple_frontier: ntuple,
        ntuple_frontier_b: ntuple,
    }
    for module, fields in shrink.items():
        mp.setattr(module, "make_config", _shrunk(module, **fields))
    for module in (train_ntuple, eval_ntuple, eval_ntuple_depth1, train_ppo, train_ppo_flagship,
                   eval_ppo_depth1, train_ppo_afterstate, train_afterstate_td, train_a3c, train_a3c_flagship, train_dqn,
                   train_dqn_nstep, ntuple_frontier, ntuple_frontier_b):
        mp.setattr(module, "evaluations", capped_evaluations(module.evaluations, **TINY_EVAL))


def _read(path: Path):
    return json.loads(path.read_text())


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """Every recipe, run once in one working directory: what each returned,
    and the keys of the records it wrote that have a JAX twin."""
    root = tmp_path_factory.mktemp("recipes")
    out, written, cwd = {}, {}, os.getcwd()
    with pytest.MonkeyPatch.context() as mp:
        _shrink(mp)
        os.chdir(root)
        try:
            run = [
                ("train_ntuple", train_ntuple, ["2", "8"]),
                ("train_ntuple-resumed", train_ntuple, ["1", "8"]),
                ("eval_ntuple", eval_ntuple, ["1", "4", "8"]),
                ("eval_ntuple_depth1", eval_ntuple_depth1, ["4", "8"]),
                ("eval_ntuple_depth2", eval_ntuple_depth2, ["probe", "2", "20480", "8", "1"]),
                ("train_ppo", train_ppo, ["1", "8"]),
                ("train_ppo_flagship", train_ppo_flagship, ["1", "8"]),
                ("eval_ppo_depth1", eval_ppo_depth1, ["4", "8"]),
                ("train_ppo_afterstate-warm", train_ppo_afterstate, ["0", "8"]),
                ("train_ppo_afterstate", train_ppo_afterstate, ["1", "8"]),
                ("train_afterstate_td-warm", train_afterstate_td, ["0", "8"]),
                ("train_afterstate_td", train_afterstate_td, ["1", "8"]),
                ("eval_afterstate_depth2", eval_afterstate_depth2, ["probe", "1", "16384", "8", "1"]),
                ("train_a3c", train_a3c, ["1"]),
                ("train_a3c_flagship", train_a3c_flagship, ["1", "8"]),
                ("train_dqn", train_dqn, ["3", "8"]),
                ("train_dqn_nstep", train_dqn_nstep, ["3", "8"]),
                ("a3c_parity_curve", a3c_parity_curve, ["1", "3"]),
                # About 0 s a leg: a clock check of 20 tiny updates, and at B=16384 of one.
                ("ntuple_frontier", ntuple_frontier, [FRONTIER_BUDGET, ntuple_frontier.OUT, "xla", "delayed:4", "step:none"]),
                ("ntuple_frontier_b", ntuple_frontier_b, [FRONTIER_BUDGET, ntuple_frontier_b.OUT, "16384"]),
            ]
            for name, module, argv in run:
                out[name] = module.main(argv, device="cpu")
                if "-" not in name:  # read at once: a later recipe may write the same file
                    written[name] = _recipe.written_keys(module)
        finally:
            os.chdir(cwd)
    return root, out, written


RECIPES = (
    train_ntuple, eval_ntuple, eval_ntuple_depth1, eval_ntuple_depth2, train_ppo, train_ppo_flagship, eval_ppo_depth1,
    train_ppo_afterstate, train_afterstate_td, eval_afterstate_depth2, train_a3c, train_a3c_flagship, train_dqn,
    train_dqn_nstep, a3c_parity_curve, ntuple_frontier, ntuple_frontier_b,
)
WITH_TWIN = [m.__name__.rsplit(".", 1)[1] for m in RECIPES if hasattr(m, "JAX_RECORDS")]


@pytest.mark.parametrize("name", WITH_TWIN)
def test_recipe_writes_jax_keys(chain, name):
    """Each record a recipe writes has the keys of the committed JAX record
    its module names (a CSV, its header), as the module adjusts them."""
    _, _, written = chain
    module = importlib.import_module(f"rein48_tpu_torch.examples.{name}")
    assert written[name] == _recipe.jax_keys(module, REPO)


def test_records_name_their_twins():
    """Every recipe that writes a record names its twin, and each twin is
    committed: the depth-2 recipes, whose repo holds no depth-2 record,
    are the only ones without."""
    assert sorted(set(m.__name__.rsplit(".", 1)[1] for m in RECIPES) - set(WITH_TWIN)) == [
        "eval_afterstate_depth2", "eval_ntuple_depth2"
    ]
    for name in WITH_TWIN:
        for theirs in importlib.import_module(f"rein48_tpu_torch.examples.{name}").JAX_RECORDS.values():
            assert (REPO / theirs).is_file(), (name, theirs)


def test_parity_record_curves(chain):
    """The parity record's per-seed curves have the JAX record's fields; the
    reference replicas are summarised only where they were run."""
    root, _, _ = chain
    got, want = _read(root / "runs/a3c_parity_cuda/parity.json"), _read(REPO / "runs/a3c_parity/parity.json")
    assert got["reference_replicas"] == [] and want["reference_replicas"]
    for seed in want["seeds"]:
        assert got["seeds"][seed]["curve"][0].keys() == want["seeds"][seed]["curve"][0].keys()


def test_records_beyond_the_keys(chain):
    """What the key sets do not show: the sweep's table bytes, train_a3c
    writing metrics only, and the depth-2 probes writing no record."""
    root, out, _ = chain
    assert _read(root / "runs/ntuple_cuda/eval.json")["timings"]["params_bytes"] == 2 * 3 * 16**4 * 4  # two tables and their TC arrays
    assert out["train_a3c"] is None and not (root / "runs/a3c_cuda/eval.json").exists()
    probes = out["eval_ntuple_depth2"], out["eval_afterstate_depth2"]
    assert all(set(p) == {"compile+run", "steady"} for p in probes)
    assert not any((root / "runs" / d / "eval_depth2.json").exists() for d in ("ntuple_cuda", "afterstate_td_cuda"))


def test_no_jax_record_is_touched(chain):
    root, _, _ = chain
    assert not [p for p in (root / "runs").iterdir() if p.name.endswith("_tpu") or p.name == "a3c_parity"]
    # The sweeps write under runs/, never over the JAX records in benchmarks/.
    assert not (root / "benchmarks").exists()
    assert {"ntuple_frontier_cuda", "ntuple_frontier_b_cuda"} <= {p.name for p in (root / "runs").iterdir()}
    assert sorted(p.name for p in (root / "ckpt").iterdir()) == [
        "a3c_cuda", "a3c_flagship_cuda", "afterstate_td_cuda", "dqn_cuda_r4", "dqn_r5_cuda", "ntuple_cuda",
        "ppo_afterstate_cuda", "ppo_cuda", "ppo_flagship_cuda",
    ]


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_warm_start_chain(chain):
    """train_ppo_flagship -> train_ppo_afterstate -> train_afterstate_td:
    at update 0 each starts from the previous one's latest checkpoint."""
    root, out, _ = chain
    ckpt = root / "ckpt"
    flagship = Checkpointer(str(ckpt / "ppo_flagship_cuda"))
    ppo_after = Checkpointer(str(ckpt / "ppo_afterstate_cuda"))
    td = Checkpointer(str(ckpt / "afterstate_td_cuda"))
    assert flagship.latest_step() == 1
    assert _same(ppo_after.restore_field("model", step=0), flagship.restore_field("model"))
    assert out["train_ppo_afterstate-warm"]["config"]["warm_start"] == "ckpt/ppo_flagship_cuda step 1"
    assert _same(td.restore_field("model", step=0), ppo_after.restore_field("after_model", step=1))
    assert out["train_afterstate_td-warm"]["config"]["warm_start"] == "ckpt/ppo_afterstate_cuda after_model"
    # Trained on from there: the update moved the weights.
    assert not _same(td.restore_field("model", step=1), td.restore_field("model", step=0))


def test_second_main_resumes(chain):
    root, out, _ = chain
    assert out["train_ntuple"]["checkpoint_step"] == 2 and out["train_ntuple-resumed"]["checkpoint_step"] == 3
    with open(root / "runs/ntuple_cuda/metrics.csv") as f:
        assert [int(r["update"]) for r in csv.DictReader(f)] == [2, 3]
    assert out["train_ppo_afterstate"]["updates"] == 1
    assert out["train_ppo_afterstate"]["config"]["warm_start"] == "resumed ckpt/ppo_afterstate_cuda"
    assert out["train_afterstate_td"]["config"]["warm_start"] == "resumed ckpt/afterstate_td_cuda"
    assert Checkpointer(str(root / "ckpt/afterstate_td_cuda")).all_steps() == [0, 1]


def test_afterstate_ppo_needs_its_donor(monkeypatch, tmp_path):
    """As in JAX, the afterstate PPO run has no fallback: without the
    flagship checkpoint it raises, while the afterstate TD run trains from
    its fresh init and says so."""
    monkeypatch.chdir(tmp_path)
    _shrink(monkeypatch)
    with pytest.raises(FileNotFoundError):
        train_ppo_afterstate.main(["0", "8"], device="cpu")
    out = train_afterstate_td.main(["0", "8"], device="cpu")
    assert out["config"]["warm_start"] == "none (fresh init)" and out["updates"] == 0


def test_frontier_records(chain):
    """Each leg in the order given, its fields first, its updates a whole
    number of clock checks, its env-steps counted from the trained config,
    and the record written after the last leg as returned."""
    root, out, _ = chain
    for module, heads in ((ntuple_frontier, [("delayed", 4, "torch"), ("step", None, "torch")]),
                          (ntuple_frontier_b, [(16384, "delayed", 4)])):
        name = module.__name__.rsplit(".", 1)[1]
        record = out[name]
        assert record == _read(root / module.OUT) and record["budget_sec"] == float(FRONTIER_BUDGET)
        assert [tuple(leg.values())[:3] for leg in record["legs"]] == heads
        check = 20 if module is ntuple_frontier else 1
        for leg in record["legs"]:
            assert leg["updates"] % check == 0 and leg["env_steps"] == leg["updates"] * 8 * 4
            assert leg["eval"]["episodes"] == TINY_EVAL["num_envs"]


def test_dqn_recipe_reaches_learning(chain):
    """Both DQN recipes at 8 envs x 2 acting steps, gate at 16 transitions:
    three updates fill 48 slots and the last one learns."""
    root, _, _ = chain
    for tag in ("dqn_cuda", "dqn_r5_cuda"):
        with open(root / "runs" / tag / "metrics.csv") as f:
            last = list(csv.DictReader(f))[-1]
        assert int(last["update"]) == 3 and float(last["replay_size"]) == 48 and float(last["loss"]) > 0, tag

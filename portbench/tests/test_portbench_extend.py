"""A configuration, a cell, a driver and a per-layer metric can be added as
new files and new BENCHMARK.json entries, without editing any file already
there."""

import hashlib
import json
import shutil
import time
from pathlib import Path

import torch

from conftest import ROOT, SEED, device_only, tiny_cell
from portbench import harness

# A driver of its own: expectimax with the port's heuristic leaf, one
# lockstep move of every game per unit, its boards replayed by the
# reference engine along the program's actions.
DRIVER = '''"""Expectimax with the port's heuristic leaf, one lockstep move per unit."""

import contextlib

from portbench.reference import engine as ref_engine


class Run:
    def __init__(self, ctx):
        from rein48_tpu_torch.control import search
        from rein48_tpu_torch.engine import vector

        t = ctx.cell.traffic
        self.ctx, self.vector = ctx, vector
        self.policy = search.make_expectimax_policy(t["depth"], chance_chunk=t["chance_chunk"])
        self.env = vector.reset_batch(ctx.seed, t["games"], ctx.device)
        self.boards, self.actions = [], []
        self.unit(None)
        self.trace_units = 1

    def unit(self, spans):
        with spans.span("policy") if spans is not None else contextlib.nullcontext():
            actions = self.policy(self.env.boards)
        self.boards.append(self.env.boards)
        self.actions.append(actions)
        self.env, _ = self.vector.step_autoreset(self.env, actions)

    def counters(self):
        return {}

    def release(self):
        self.final = self.env.boards
        del self.policy, self.env

    def check(self):
        games = ref_engine.new_games(self.ctx.seed, self.ctx.cell.traffic["games"], self.ctx.device)
        differ = 0
        for boards, actions in zip(self.boards, self.actions):
            differ += int((boards != games.boards).flatten(1).any(-1).sum())
            games = ref_engine.step(games, actions.long())[0]
        differ += int((self.final != games.boards).flatten(1).any(-1).sum())
        return {"boards_differ": differ}


def setup(ctx):
    return Run(ctx)


def tiny(cell):
    cell.traffic.update(games=3)
    return cell
'''


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_and_metric_as_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(tmp_path)
    pkg = tmp_path / "portbench"

    config = json.loads((pkg / "configs" / "ntuple_yeh4x6.json").read_text())
    config.update(name="ntuple_2x3", tuples=[[0, 1, 2], [0, 4, 8]], table_entries=4096)
    (pkg / "configs" / "ntuple_2x3.json").write_text(json.dumps(config))
    (pkg / "traffic" / "ntuple_b16_t8_delayed4.json").write_text(json.dumps(
        {"why": "a small mix", "batch_size": 16, "steps_per_update": 8, "update_mode": "delayed", "delay_window": 4,
         "collision": "mean"}))
    (pkg / "workloads" / "ntuple_small.json").write_text(
        (pkg / "workloads" / "ntuple_b1024.json").read_text())
    (pkg / "metrics" / "td_updates_seen.ntuple.py").write_text(
        "def read(ctx):\n    return ctx.window['units'] * ctx.cell.traffic['batch_size']\n")

    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "ntuple_2x3", "source": "a test", "file": "portbench/configs/ntuple_2x3.json",
                             "reduced": [], "why": "small tables"})
    bench["workloads"].append({"name": "ntuple_small", "config": "ntuple_2x3", "traffic": "ntuple_b16_t8_delayed4",
                               "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "td_updates_seen.ntuple", "unit": "boards", "better": "higher",
                               "source": "program_counter", "layer": "device", "moves": "ntuple_env_steps_per_s",
                               "workloads": ["ntuple_small"]})
    bench["end_to_end"].append({"name": "ntuple_env_steps_per_s", "unit": "env-steps/s", "better": "higher",
                                "bound": 0.25, "source": "host_clock", "workloads": ["ntuple_small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.find_cell("ntuple_small", tmp_path, pkg)
    assert cell.config["tuples"] == [[0, 1, 2], [0, 4, 8]]
    for trace in (False, True):
        out = harness.run_cell(cell, SEED, 0.2, trace, torch.device("cpu"), time.perf_counter())
        assert out["checks"]["boards_differ"]["value"] == 0
    assert "td_updates_seen.ntuple" in out["metrics"]
    for name in ("ppo_flagship", "search_depth1"):
        old, here = harness.find_cell(name, tmp_path, pkg), harness.find_cell(name)
        assert [m["name"] for m in old.per_layer + old.end_to_end] == [m["name"] for m in here.per_layer + here.end_to_end]
    after = digests(tmp_path)
    changed = {p for p in before if before[p] != after.get(p)}
    assert changed == {Path("BENCHMARK.json")}


def test_new_driver_cell_and_device_metric_as_files(tmp_path):
    """A cell with a driver of its own (and its own CPU size) and a
    ``device_trace`` metric runs tiny on the CPU, traced and untraced, with
    BENCHMARK.json the only file already there that changed."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(tmp_path)
    pkg = tmp_path / "portbench"

    (pkg / "drivers" / "heuristic_move.py").write_text(DRIVER)
    (pkg / "configs" / "expectimax_heuristic.json").write_text(json.dumps({"name": "expectimax_heuristic",
                                                                          "leaf": "heuristic"}))
    (pkg / "traffic" / "heuristic_g256_d1.json").write_text(json.dumps(
        {"why": "256 lockstep games", "games": 256, "depth": 1, "chance_chunk": 4}))
    (pkg / "workloads" / "heuristic_depth1.json").write_text(json.dumps(
        {"driver": "heuristic_move", "limits": {"boards_differ": 0}}))
    (pkg / "metrics" / "device_busy_ms.heuristic.py").write_text(
        "def read(ctx):\n    p = ctx.profile\n    return 1e3 * p['busy_s'] / p['units'] if p and p['busy_s'] > 0 else None\n")

    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "expectimax_heuristic", "source": "a test",
                             "file": "portbench/configs/expectimax_heuristic.json", "reduced": [], "why": "no model"})
    bench["workloads"].append({"name": "heuristic_depth1", "config": "expectimax_heuristic",
                               "traffic": "heuristic_g256_d1", "chips": 1, "why": "a test cell"})
    entries = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    for name in ("moves_per_s", "tree_ms.search"):
        entries[name]["workloads"].append("heuristic_depth1")
    bench["per_layer"].append({"name": "device_busy_ms.heuristic", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "device", "moves": "moves_per_s",
                               "workloads": ["heuristic_depth1"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    for trace, want in ((False, {"setup_s", "moves_per_s"}), (True, {"tree_ms.search"})):
        cell = tiny_cell("heuristic_depth1", tmp_path, pkg)
        assert cell.traffic["games"] == 3 and cell.config["leaf"] == "heuristic"
        out = harness.run_cell(cell, SEED, 0.2, trace, torch.device("cpu"), time.perf_counter())
        metrics = cell.per_layer if trace else cell.end_to_end
        assert {m["name"] for m in metrics if not device_only(m)} == want
        assert "device_busy_ms.heuristic" not in out["metrics"]
        assert set(out["metrics"]) == want
        assert all(v["value"] > 0 for v in out["metrics"].values())
        assert out["correct"], out["checks"]
    after = digests(tmp_path)
    changed = {p for p in before if before[p] != after.get(p)}
    assert changed == {Path("BENCHMARK.json")}

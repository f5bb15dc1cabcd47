"""A configuration, a cell and a per-layer metric can be added as new files
and new BENCHMARK.json entries, without editing any file already there."""

import hashlib
import json
import shutil
import time

import torch

from conftest import ROOT, SEED
from portbench import harness


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
    assert changed == {__import__("pathlib").Path("BENCHMARK.json")}

"""Every cell of BENCHMARK.json runs at a tiny size on the CPU through the
port's plain path, with every metric it names found as a file."""

import json
import time

import pytest
import torch

from conftest import PENDING, ROOT, SEED, tiny_cell
from portbench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
ALL = CELLS + sorted(PENDING)
CPU = torch.device("cpu")


def test_every_named_file_exists():
    pkg = ROOT / "portbench"
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert (pkg / "workloads" / f"{w['name']}.json").is_file()
        assert (pkg / "traffic" / f"{w['traffic']}.json").is_file()
        driver = json.loads((pkg / "workloads" / f"{w['name']}.json").read_text())["driver"]
        assert (pkg / "drivers" / f"{driver}.py").is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert harness.load_module("metrics", m["name"]).read, m["name"]


def test_pending_files_exist():
    pkg = ROOT / "portbench"
    for name, (config, traffic, e2e, layers) in PENDING.items():
        assert name not in CELLS
        assert (pkg / "configs" / f"{config}.json").is_file() and (pkg / "traffic" / f"{traffic}.json").is_file()
        for m in e2e + layers:
            assert harness.load_module("metrics", m).read, m


@pytest.mark.parametrize("name", ALL)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_tiny(name, trace):
    cell = tiny_cell(name)
    out = harness.run_cell(cell, SEED, 0.3, trace, CPU, time.perf_counter())
    assert out["attempted"] >= 1
    names = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    device_only = {n for n in names if n.startswith("device_idle") or n.startswith("launches_per_step")}
    # The CPU has no device events: the device-trace metrics stay silent.
    assert set(out["metrics"]) == names - device_only
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert out["checks"]["boards_differ"]["value"] == 0
    assert list(out["checks"]) == list(cell.workload["limits"])


@pytest.mark.parametrize("name", ALL)
def test_same_seed_same_inputs(name):
    def first_boards(cell):
        ctx = harness.Ctx(cell=cell, seed=SEED, device=CPU, sync=lambda: None)
        run = harness.load_module("drivers", cell.workload["driver"]).setup(ctx)
        side = run.side
        return side["boards"][0] if "boards" in side else side["updates"][-1]["boards"][-1]

    a, b = first_boards(tiny_cell(name)), first_boards(tiny_cell(name))
    assert torch.equal(a, b)


def test_cli_refuses_without_card(monkeypatch, capsys):
    from portbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", str(SEED), "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_unknown_workload():
    with pytest.raises(KeyError):
        harness.find_cell("no_such_cell")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_card(cuda_device, name):
    """A short run of each cell at its full size on the card."""
    cell = harness.find_cell(name)
    out = harness.run_cell(cell, SEED, 2.0, False, cuda_device, time.perf_counter())
    assert out["correct"], out["checks"]

"""Every cell of BENCHMARK.json runs at a tiny size on the CPU through the
port's plain path, with every metric it names found as a file."""

import json
import time

import pytest
import torch

from conftest import PENDING, ROOT, SEED, device_only, tiny_cell
from portbench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
ALL = CELLS + sorted(PENDING)
DRIVERS = sorted(p.stem for p in (ROOT / "portbench" / "drivers").glob("*.py") if p.stem != "__init__")
CPU = torch.device("cpu")
# Each cell's CPU test size: (traffic, configuration, workload) fields as
# its driver's ``tiny`` sets them.
TINY = {
    "ppo_flagship": ({"ppo": {"batch_size": 8, "unroll_len": 4, "num_minibatches": 2}},
                     {"channels": 8, "num_blocks": 1, "head_hidden": 8}, {}),
    "search_depth1": ({"games": 4}, {"channels": 8, "num_blocks": 1, "head_hidden": 8},
                      {"warmup_moves": 2, "traced_moves": 2, "checked_moves": 3}),
    "ntuple_b16384": ({"batch_size": 8, "steps_per_update": 8}, {"tuples": [[0, 1, 2], [0, 4, 8]]}, {}),
    "ntuple_b1024": ({"batch_size": 8, "steps_per_update": 8}, {"tuples": [[0, 1, 2], [0, 4, 8]]}, {}),
}


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
    """Every workload file that BENCHMARK.json leaves out is a pending cell
    whose files and metric readers are all here."""
    pkg = ROOT / "portbench"
    for name, block in PENDING.items():
        assert block is not None, f"workloads/{name}.json is neither in BENCHMARK.json nor pending"
        assert name not in CELLS
        assert (pkg / "configs" / f"{block['config']}.json").is_file()
        assert (pkg / "traffic" / f"{block['traffic']}.json").is_file()
        for m in block["end_to_end"] + block["per_layer"]:
            assert harness.load_module("metrics", m).read, m


@pytest.mark.parametrize("driver", DRIVERS)
def test_every_driver_has_tiny(driver):
    assert callable(getattr(harness.load_module("drivers", driver), "tiny", None)), \
        f"portbench/drivers/{driver}.py has no tiny(cell)"


@pytest.mark.parametrize("name", sorted(TINY))
def test_tiny_sizes(name):
    """The CPU sizes, each field as the cell's driver cuts it."""
    cell = tiny_cell(name)
    traffic, config, workload = TINY[name]
    for key, want in traffic.items():
        got = cell.traffic[key]
        assert ({k: got[k] for k in want} if isinstance(want, dict) else got) == want, key
    assert {k: cell.config[k] for k in config} == config
    assert {k: cell.workload[k] for k in workload} == workload


@pytest.mark.parametrize("name", ALL)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_tiny(name, trace):
    cell = tiny_cell(name)
    out = harness.run_cell(cell, SEED, 0.3, trace, CPU, time.perf_counter())
    assert out["attempted"] >= 1
    metrics = cell.per_layer if trace else cell.end_to_end
    # The CPU has no device events: the device-trace metrics stay silent.
    assert set(out["metrics"]) == {m["name"] for m in metrics if not device_only(m)}
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

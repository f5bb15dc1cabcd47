"""Shared helpers of the benchmark's CPU tests: the repository root on the
path, the card fixture, the pending cells, and cells cut by their drivers to
a size a CPU test can hold."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

torch.set_num_threads(2)

# Seeds past 32 signed bits, as the benchmark is given them.
SEED = 2**31 + 12_345


def shrink(cell: harness.Cell) -> harness.Cell:
    """The cell at a CPU test's size, as its driver's ``tiny`` cuts it."""
    return harness.load_module("drivers", cell.workload["driver"], cell.pkg).tiny(cell)


def pending(root: Path = ROOT, pkg: Path = None) -> dict:
    """Cells whose workload file is here but which BENCHMARK.json leaves
    out: each file's ``pending`` block (configuration, traffic, end-to-end
    and per-layer metric names), by cell name."""
    pkg = pkg or root / "portbench"
    listed = {w["name"] for w in harness.load_json(root / "BENCHMARK.json")["workloads"]}
    files = sorted((pkg / "workloads").glob("*.json"))
    return {f.stem: harness.load_json(f).get("pending") for f in files if f.stem not in listed}


PENDING = pending()


def cell(name: str, root: Path = ROOT, pkg: Path = None) -> harness.Cell:
    """A cell of BENCHMARK.json, or a pending one built from its files."""
    pkg = pkg or root / "portbench"
    block = pending(root, pkg).get(name)
    if block is None:
        return harness.find_cell(name, root, pkg)

    def load(*parts):
        return harness.load_json(pkg.joinpath(*parts))

    return harness.Cell(
        name=name,
        entry={"name": name, "config": block["config"], "traffic": block["traffic"], "chips": 1},
        workload=load("workloads", f"{name}.json"),
        config=load("configs", f"{block['config']}.json"),
        traffic=load("traffic", f"{block['traffic']}.json"),
        end_to_end=[{"name": m, "unit": "-"} for m in block["end_to_end"]],
        per_layer=[{"name": m, "unit": "-"} for m in block["per_layer"]],
        pkg=pkg,
    )


def device_only(metric: dict) -> bool:
    """A metric read from the device's events alone, which stays silent on
    the CPU: by its ``source``, or by the name of the device's idle share or
    of the launches."""
    return metric.get("source") == "device_trace" or metric["name"].startswith(("device_idle", "launches_per_step"))


def tiny_cell(name: str, root: Path = ROOT, pkg: Path = None) -> harness.Cell:
    return shrink(cell(name, root, pkg))


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)

"""Shared helpers of the benchmark's CPU tests: the repository root on the
path, the card fixture, and cells cut to a size a CPU test can hold."""

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
    """The cell at a CPU test's size: the same paths, few games and steps,
    a narrow tower and small tuples."""
    driver = cell.workload["driver"]
    if driver == "ppo_update":
        cell.traffic["ppo"].update(batch_size=8, unroll_len=4, num_minibatches=2)
        cell.config.update(channels=8, num_blocks=1, head_hidden=8)
    elif driver == "ntuple_update":
        cell.traffic.update(batch_size=8, steps_per_update=8)
        cell.config.update(tuples=[[0, 1, 2], [0, 4, 8]])
    elif driver == "search_move":
        cell.traffic.update(games=4)
        cell.workload.update(warmup_moves=2, traced_moves=2, checked_moves=3)
        cell.config.update(channels=8, num_blocks=1, head_hidden=8)
    return cell


# Cells whose files are here but which BENCHMARK.json leaves out, their
# host-bound rate being too noisy for a bound (PERF.md, section 7):
# (configuration, traffic, end-to-end and per-layer metrics).
PENDING = {
    name: ("ntuple_yeh4x6", traffic, ["setup_s", "ntuple_env_steps_per_s"], ["launches_per_step.ntuple", "device_idle.ntuple"])
    for name, traffic in (("ntuple_b16384", "ntuple_b16384_t128_delayed4"), ("ntuple_b1024", "ntuple_b1024_t128_delayed4"))
}


def cell(name: str, root: Path = ROOT, pkg: Path = None) -> harness.Cell:
    """A cell of BENCHMARK.json, or a pending one built from its files."""
    pkg = pkg or root / "portbench"
    if name not in PENDING:
        return harness.find_cell(name, root, pkg)
    config, traffic, e2e, layers = PENDING[name]

    def load(*parts):
        return harness.load_json(pkg.joinpath(*parts))

    return harness.Cell(
        name=name,
        entry={"name": name, "config": config, "traffic": traffic, "chips": 1},
        workload=load("workloads", f"{name}.json"),
        config=load("configs", f"{config}.json"),
        traffic=load("traffic", f"{traffic}.json"),
        end_to_end=[{"name": m, "unit": "-"} for m in e2e],
        per_layer=[{"name": m, "unit": "-"} for m in layers],
        pkg=pkg,
    )


def tiny_cell(name: str, root: Path = ROOT, pkg: Path = None) -> harness.Cell:
    return shrink(cell(name, root, pkg))


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)

"""The n-tuple search cell: its planted faults fail the check at a CPU size,
and its two byte shares count what their docstrings say."""

import time

import pytest
import torch

from conftest import SEED, tiny_cell
from portbench import calibrate_search_ntuple as cal
from portbench import flops, harness, ntuple_bytes
from portbench.drivers import search_ntuple

CELL = "search_ntuple_d2"
KERNEL = "void (anonymous namespace)::ntuple_value_kernel((anonymous namespace)::Params)"


def small_cell():
    """Eight games played ten moves, past the symmetric openings whose
    actions tie, and two checked moves: enough that every fault moves some
    action."""
    cell = tiny_cell(CELL)
    cell.traffic["games"] = 8
    cell.workload.update(warmup_moves=10, checked_moves=2)
    return cell


def failed(cell, readings) -> list:
    return [k for k, limit in cell.workload["limits"].items() if readings[k] > limit]


def test_the_program_passes_its_limits():
    cell = small_cell()
    r = cal.reading(cell, SEED, torch.device("cpu"), 0.0)
    assert r["moves"] == cell.workload["warmup_moves"]
    assert failed(cell, r) == [], r


@pytest.mark.parametrize("name", cal.FAULTS)
def test_each_planted_fault_fails_a_limit(name):
    cell = small_cell()
    with cal.fault(name):
        r = cal.reading(cell, SEED, torch.device("cpu"), 0.0)
    assert failed(cell, r), r


def test_the_run_counts_leaves_needed_from_a_sample():
    cell = tiny_cell(CELL)
    out = harness.run_cell(cell, SEED, 0.2, True, torch.device("cpu"), time.perf_counter())
    assert out["correct"], out["checks"]
    assert {"leaf_useful.search", "mfu.search_ntuple", "leaf_ms.search"} <= set(out["metrics"])
    assert 0 < out["metrics"]["leaf_useful.search"]["value"] <= 100


def ctx_with(kernels: dict, counters: dict, units: int = 6):
    ctx = harness.Ctx(cell=harness.find_cell(CELL), seed=SEED, device=torch.device("cpu"), sync=lambda: None)
    ctx.profile = {"units": units, "kernels": kernels, "counters": counters}
    return ctx


def read(name, ctx):
    return harness.load_module("metrics", name).read(ctx)


def test_the_kernel_share_counts_20_bytes_a_board_fed():
    boards = 6 * 16 * 1_048_576
    ctx = ctx_with({KERNEL: 0.05, "other": 1.0}, {"search.leaf_boards": boards})
    assert read("ntuple_value_roofline.search", ctx) == pytest.approx(100 * boards * 20 / flops.PEAK_HBM / 0.05)


@pytest.mark.parametrize("kernels, counters", [({"other": 1.0}, {"search.leaf_boards": 1000}),
                                               ({KERNEL: 0.05}, {}), ({}, {})])
def test_the_kernel_share_is_silent_without_kernel_or_boards(kernels, counters):
    assert read("ntuple_value_roofline.search", ctx_with(kernels, counters)) is None


def test_the_move_share_counts_148_bytes_a_leaf_needed():
    ctx = ctx_with({}, {})
    ctx.window = {"seconds": 51.0, "units": 1000}
    assert ntuple_bytes.lookups(ctx.cell.config) == 32
    ctx.counters = {"leaves_needed": 3e9}
    assert read("mfu.search_ntuple", ctx) == pytest.approx(100 * 3e9 * 148 / 51.0 / flops.PEAK_HBM)
    ctx.counters = {}
    assert read("mfu.search_ntuple", ctx) is None


@pytest.mark.parametrize("chunk, depth, calls", [(8, 2, 16), (8, 1, 4), (None, 2, 1), (32, 2, 1)])
def test_the_gate_wants_one_kernel_launch_a_leaf_call(chunk, depth, calls):
    traffic = {"chance_chunk": chunk, "depth": depth}
    assert search_ntuple.leaf_calls(traffic) == calls
    search_ntuple.fused_leaf(calls, traffic)
    for launched in (0, calls + 1):
        with pytest.raises(SystemExit, match="cannot run the cell"):
            search_ntuple.fused_leaf(launched, traffic)

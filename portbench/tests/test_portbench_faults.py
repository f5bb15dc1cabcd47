"""The check fails what it must: each fault planted in the port under a
run, and the control put in the program's place, come out not correct at a
size a test can hold."""

import time

import pytest
import torch

from conftest import SEED, tiny_cell
from portbench import calibrate, faults, harness

CPU = torch.device("cpu")
CELLS = ["ppo_flagship", "ntuple_b16384", "search_depth1"]


def judged(readings: dict, limits: dict) -> bool:
    return all(readings[k] <= limits[k] for k in limits)


PLANTED = [(name, fault) for name in CELLS for fault in faults.FAULTS[tiny_cell(name).workload["driver"]]]


@pytest.mark.parametrize("name,fault", PLANTED)
def test_fault_fails_the_run(name, fault):
    cell = tiny_cell(name)
    with getattr(faults, cell.workload["driver"])(fault):
        out = harness.run_cell(cell, SEED, 0.2, False, CPU, time.perf_counter())
    assert out["correct"] is False, out["checks"]
    assert out["failed"] >= 1


# The widest gap of the search cell grows with the boards judged: the
# control's shows over 64 games.
CONTROL_SIZE = {"search_depth1": lambda c: (c.traffic.update(games=64), c.workload.update(checked_moves=8))}


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_check(name):
    cell = tiny_cell(name)
    CONTROL_SIZE.get(name, lambda c: None)(cell)
    limits = cell.workload["limits"]
    sound, control = calibrate.program(cell, SEED, CPU, 0.2), calibrate.control(cell, SEED, CPU, 0.2)
    # The limits are set at the cells' sizes, where rounding moves less than
    # here: the control has to break one of them and read above the program.
    assert any(control[k] > limits[k] and control[k] > sound[k] for k in limits), (sound, control)


@pytest.mark.parametrize("name", CELLS)
def test_faults_leave_the_port_as_it_was(name):
    cell = tiny_cell(name)
    with getattr(faults, cell.workload["driver"])("altered"):
        pass
    out = harness.run_cell(cell, SEED, 0.2, False, CPU, time.perf_counter())
    assert out["checks"]["boards_differ"]["value"] == 0

# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's profiling hooks and FLOP count against the JAX package's
(``rein48_tpu/utils/profiling.py``, ``utils/flops.py``)."""

from __future__ import annotations

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rein48_tpu.utils import flops as jflops
from rein48_tpu.utils import profiling as jprofiling
from rein48_tpu_torch.utils import flops, profiling

torch.set_num_threads(1)


@pytest.mark.parametrize("m, k, n", [(64, 128, 32), (3, 5, 7)])
def test_program_flops_of_a_matmul(m, k, n):
    a, b = torch.zeros(m, k), torch.zeros(k, n)
    assert flops.program_flops(torch.matmul, a, b) == 2 * m * n * k
    assert jflops.program_flops(jnp.matmul, jnp.zeros((m, k)), jnp.zeros((k, n))) == pytest.approx(2 * m * n * k, rel=0.01)


def test_program_flops_passes_keywords_and_counts_backward():
    w = torch.zeros(16, 8, requires_grad=True)

    def loss(x, *, scale):
        return (scale * (x @ w)).sum()

    assert flops.program_flops(loss, torch.zeros(4, 16), scale=2.0) == 2 * 4 * 16 * 8
    assert flops.program_flops(lambda x: loss(x, scale=1.0).backward(), torch.zeros(4, 16)) == 2 * (2 * 4 * 16 * 8)


@dataclasses.dataclass
class State:
    note: str
    score: torch.Tensor


def test_force_fetches_the_first_tensor_leaf():
    tree = {"a": [3, State("x", torch.tensor([[2.5, 1.0]]))], "b": torch.tensor(7.0)}
    assert profiling.force(tree) == 2.5
    assert profiling.force(torch.arange(3.0) + 4) == 4.0
    assert profiling.force(torch.tensor([1.5])) == jprofiling.force(jnp.asarray([1.5]))
    with pytest.raises(ValueError, match="no tensor"):
        profiling.force({"a": 1})


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_enable_nan_debugging_raises_on_a_nan_gradient():
    before = torch.is_anomaly_enabled()
    try:
        profiling.enable_nan_debugging()
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    finally:
        torch.autograd.set_detect_anomaly(before)
    assert np.isnan(torch.sqrt(torch.tensor(-1.0)).item())


class _Event:
    """A raw profiler event as ``kernel_times`` reads it."""

    def __init__(self, name, device, ns, annotation=False):
        self._name, self._device, self._ns, self._annotation = name, device, ns, annotation

    def name(self):
        return self._name

    def device_type(self):
        return getattr(torch.autograd.DeviceType, self._device)

    def duration_ns(self):
        return self._ns

    def is_user_annotation(self):
        return self._annotation


def test_kernel_times_sums_device_events_and_counts_launch_calls():
    """Device events with a duration summed by name (µs, calls); the host's
    kernel-launch calls counted; every other host event, a device event
    without a duration, and a span's annotation on either timeline, left
    out. A session on the CPU alone has neither."""
    events = [
        _Event("cudaLaunchKernel", "CPU", 3000), _Event("cuLaunchKernelEx", "CPU", 2000),
        _Event("aten::add", "CPU", 9000), _Event("cudaDeviceSynchronize", "CPU", 5000),
        _Event("add_kernel", "CUDA", 1500), _Event("add_kernel", "CUDA", 2500),
        _Event("Memset (Device)", "CUDA", 700), _Event("marker", "CUDA", 0),
        _Event("ppo.learn", "CPU", 8000, annotation=True), _Event("ppo.learn", "CUDA", 7000, annotation=True),
    ]
    session = type("Session", (), {})()
    session.profiler = type("Profiler", (), {})()
    session.profiler.kineto_results = type("Results", (), {"events": lambda self: events})()
    assert profiling.kernel_times(session) == ({"add_kernel": [4.0, 2], "Memset (Device)": [0.7, 1]}, 2)

    x = torch.ones(4)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(10):
            x = x + 1
    assert profiling.kernel_times(prof) == ({}, 0)
    assert sum(e.count for e in prof.key_averages() if e.key == "aten::add") == 10

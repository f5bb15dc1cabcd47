"""The readers of the program's own spans and counters
(``portbench/program_trace.py`` and the metrics that name a span): on
hand-built records, on fake raw profiler events, and in a tiny traced run of
each cell on the CPU."""

import json
import time

import pytest
import torch

from conftest import ROOT, SEED, tiny_cell
from portbench import harness, program_trace

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = [m for m in BENCH["per_layer"] if m["source"] in ("program_span", "program_counter")
                and m["name"] not in ("rollout_ms.ppo", "learn_ms.ppo", "policy_ms.search")]
# Each new metric's spans and the parent each must have (None: a root).
SPANS = {
    "ppo_flagship": {"ppo.rollout": None, "a3c.act": "ppo.rollout", "engine.step": "ppo.rollout", "ppo.learn": None,
                     "ppo.forward": "ppo.learn", "ppo.backward": "ppo.learn", "optim.step": "ppo.learn"},
    "search_depth1": {"search.policy": None, "search.leaf": "search.policy", "engine.step": None},
}


class Ev:
    """A raw profiler event as ``program_trace.annotated`` reads it."""

    def __init__(self, name, device, start, dur, corr=0, link=0, annotation=False):
        self._v = (name, device, start, dur, corr, link, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return getattr(torch.autograd.DeviceType, self._v[1])

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def span(name, i, parent, start, end, device_ms):
    return {"name": name, "id": i, "parent": parent, "root": i if parent is None else 0, "start_ns": start,
            "end_ns": end, "host_ms": (end - start) / 1e6, "device_ms": device_ms}


def test_annotated_reads_busy_launches_and_clocks():
    events = [
        Ev("ppo.rollout", "CPU", 1000, 9000, annotation=True),          # 1000..10000
        Ev("ppo.rollout", "CUDA", 1500, 9000, annotation=True),         # the device's copy: not work
        Ev("aten::add", "CPU", 2000, 500, corr=7),
        Ev("cudaLaunchKernel", "CPU", 2100, 100, corr=101),
        Ev("cudaLaunchKernel", "CPU", 3000, 100, corr=102),
        Ev("cudaLaunchKernel", "CPU", 12000, 100, corr=103),           # after the annotation
        Ev("kernel_a", "CUDA", 11000, 2000, corr=101),                  # launched inside, runs after it
        Ev("kernel_b", "CUDA", 12000, 2000, corr=102),                  # overlaps a: union 11000..14000
        Ev("kernel_c", "CUDA", 15000, 1000, corr=103),                  # launched outside
        Ev("memcpy", "CUDA", 9000, 500, corr=0, link=7),                # placed by its op
        Ev("orphan", "CUDA", 5000, 100),                                # placed by its own start
    ]
    spans = [span("ppo.rollout", 0, None, 990, 10030, 0.01)]
    got = program_trace.annotated(events, spans)["ppo.rollout"]
    assert got["calls"] == 1 and got["launches"] == 2
    assert got["busy_s"] == pytest.approx((3000 + 500 + 100) / 1e9)
    assert got["linked"] == pytest.approx(4 / 5)
    assert got["clock_us"] == [pytest.approx(0.03)]


def test_span_sums_and_self_time():
    rec = {"units": 2, "counters": {}, "annotated": {}, "spans": [
        span("ppo.rollout", 0, None, 0, 10, 30.0),
        span("engine.step", 1, 0, 1, 2, 4.0),
        span("engine.step", 2, None, 3, 4, 100.0),   # outside the rollout
        span("search.policy", 3, None, 5, 9, 50.0),
        span("search.leaf", 4, 3, 6, 7, 20.0),
        span("search.leaf", 5, 3, 7, 8, 10.0),
    ]}
    assert program_trace.per_unit_ms(rec, "engine.step") == 52.0
    assert program_trace.per_unit_ms(rec, "engine.step", under="ppo.rollout") == 2.0
    assert program_trace.per_unit_ms(rec, "ppo.forward") is None
    assert program_trace.self_ms(rec, "search.policy", "search.leaf") == 10.0
    assert program_trace.idle_share(rec, "ppo.rollout") is None  # no device events
    rec["annotated"] = {"ppo.rollout": {"busy_s": 0.012, "launches": 7, "calls": 2, "linked": 1.0, "clock_us": [1.0]}}
    assert program_trace.idle_share(rec, "ppo.rollout") == pytest.approx(100 * (1 - 6 / 15))


def hand_built(cell_name):
    """A context whose program record is given, as the first reader leaves it."""
    ctx = harness.Ctx(cell=tiny_cell(cell_name), seed=SEED, device=torch.device("cpu"), sync=lambda: None)
    ctx.window = {"seconds": 10.0, "units": 4, "latencies": [], "setup_s": 1.0}
    ctx.counters = {"leaves_needed": 3000} if cell_name == "search_depth1" else {}
    spans = [span(name, i, None if parent is None else list(SPANS[cell_name]).index(parent), 0, 1, 2.0 * (i + 1))
             for i, (name, parent) in enumerate(SPANS[cell_name].items())]
    seen = {"busy_s": 0.001, "launches": 40, "calls": 2, "linked": 1.0, "clock_us": [1.0, 2.0]}
    ctx.program_trace = {"units": 2, "wall_s": 1.0, "spans": spans, "counters": {"search.leaf_boards": 2048},
                         "annotated": {"ppo.rollout": seen, "search.policy": seen}}
    return ctx


READS = {  # metric -> value on hand_built's record (device ms of span i: 2(i+1), 2 units)
    "act_ms.ppo": 2.0, "env_ms.ppo": 3.0, "forward_ms.ppo": 5.0, "backward_ms.ppo": 6.0, "optimizer_ms.ppo": 7.0,
    "launches_per_step.ppo_rollout": 40 / (2 * 4), "device_idle_rollout.ppo": 100 * (1 - 0.5 / 1.0),
    "leaf_ms.search": 2.0, "tree_ms.search": 1.0 - 2.0, "engine_ms.search": 3.0,
    "leaf_useful.search": 100 * 3000 / (1024 * 4), "device_idle_policy.search": 100 * (1 - 0.5 / 1.0),
}


@pytest.mark.parametrize("metric", sorted(READS))
def test_each_reader_on_a_hand_built_record(metric):
    cell = "ppo_flagship" if metric.endswith(("ppo", "ppo_rollout")) else "search_depth1"
    assert harness.load_module("metrics", metric).read(hand_built(cell)) == pytest.approx(READS[metric])


@pytest.mark.parametrize("metric", sorted(READS))
def test_each_reader_is_silent_without_the_programs_spans(metric, monkeypatch):
    from rein48_tpu_torch.utils import profiling

    class Run:  # handed to the readers on the context, as harness.run_cell does
        trace_units = 1

        def unit(self, spans):
            raise AssertionError("a program without spans is not run again")

    monkeypatch.delattr(profiling, "tracing")
    ctx = hand_built("ppo_flagship" if metric.endswith(("ppo", "ppo_rollout")) else "search_depth1")
    del ctx.program_trace
    ctx.run = Run()
    assert harness.load_module("metrics", metric).read(ctx) is None
    assert ctx.program_trace is None


def test_every_new_metric_has_a_reader_here():
    assert sorted(m["name"] for m in SPAN_METRICS) == sorted(READS)


@pytest.mark.parametrize("name", sorted(SPANS))
def test_readers_get_the_run_and_counters_on_the_context(name, monkeypatch):
    """The readers measure with the driver's own ``Run``, handed to them on
    the context; the program's counters over the harness's profiled segment
    are those of segment A (as many units)."""
    runs, measured = [], []
    driver = harness.load_module("drivers", tiny_cell(name).workload["driver"])
    setup, measure = driver.setup, program_trace.measure

    def keep_setup(ctx):
        runs.append(setup(ctx))
        return runs[-1]

    def keep(ctx, run):
        measured.append((ctx, run, measure(ctx, run)))
        return measured[-1][2]

    load = harness.load_module
    monkeypatch.setattr(harness, "load_module", lambda kind, n, pkg=harness.PKG: driver if kind == "drivers" else
                        load(kind, n, pkg))
    monkeypatch.setattr(driver, "setup", keep_setup)
    monkeypatch.setattr(program_trace, "measure", keep)
    harness.run_cell(tiny_cell(name), SEED, 0.3, True, torch.device("cpu"), time.perf_counter())
    ((ctx, run, rec),) = measured
    assert run is runs[0] and ctx.run is run
    assert ctx.profile["counters"] == rec["counters"]


@pytest.mark.parametrize("name", sorted(SPANS))
def test_a_tiny_traced_run_has_every_span_under_its_parent(name, monkeypatch):
    kept = []
    measure = program_trace.measure

    def keep(ctx, run):
        kept.append(measure(ctx, run))
        return kept[-1]

    monkeypatch.setattr(program_trace, "measure", keep)
    cell = tiny_cell(name)
    out = harness.run_cell(cell, SEED, 0.3, True, torch.device("cpu"), time.perf_counter())
    (rec,) = kept
    spans = rec["spans"]
    for s in spans:
        if s["name"] in SPANS[name]:
            parent = None if s["parent"] is None else spans[s["parent"]]["name"]
            assert parent == SPANS[name][s["name"]], s
    assert {s["name"] for s in spans} == set(SPANS[name])
    assert set(rec["annotated"]) == set(SPANS[name])
    for m in SPAN_METRICS:
        if name in m["workloads"] and not m["name"].startswith(("device_idle", "launches_per_step")):
            assert out["metrics"][m["name"]]["value"] > 0, m["name"]
    assert out["checks"]["boards_differ"]["value"] == 0

"""The benchmark's engine: finds a cell's files by name, sets it up, times
it, traces it, reads its metrics and judges its outputs.

Everything that belongs to one cell lives in files named after it, which
this module finds through ``BENCHMARK.json``:

* ``portbench/configs/<config>.json``: the model or table configuration
  (the ``file`` of the ``configs`` entry);
* ``portbench/traffic/<traffic>.json``: the batch geometry and trainer or
  game settings the cell feeds the program;
* ``portbench/workloads/<cell>.json``: the driver, the unit of work and the
  limits of the numbers that decide ``correct``;
* ``portbench/drivers/<driver>.py``: ``setup(ctx) -> Run``, where ``Run``
  has ``unit(spans)``, ``trace_units``, ``counters()``, ``release()`` and
  ``check() -> {name: value}``, and ``tiny(cell) -> cell``, the cell cut to
  the size of a CPU test;
* ``portbench/metrics/<metric>.py``: ``read(ctx) -> float | None``; a
  metric split by the end-to-end metric it moves (``device_idle.ppo``,
  ``device_idle.search``) may share the reader named by the part before its
  first dot (``device_idle.py``).

A run: set-up (the driver builds the program from the seed and drives its
first units, which compiles and warms every shape), a window of whole
units for ``--seconds`` with a device sync after each, then the peak
memory, with ``--trace 1`` two profiled segments of ``trace_units`` more units,
the metrics, and last the reference's check with the program's state freed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(__file__).resolve().parent
# Top-level modules that no run may hold: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "rein48_tpu")


def cache_dirs(root: Path) -> dict:
    """Fixed build and kernel cache directories inside the checkout."""
    base = root / ".portbench_cache"
    return {
        "TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
        "TRITON_CACHE_DIR": str(base / "triton"),
        "CUDA_CACHE_PATH": str(base / "nv"),
    }


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, pkg: Path = PKG):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots), or
    else the file named by the part of ``name`` before its first dot."""
    path = pkg / kind / f"{name}.py"
    if not path.is_file():
        path = pkg / kind / f"{name.split('.')[0]}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """A cell's entries and files, as found by name."""

    name: str
    entry: dict
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    pkg: Path = PKG


def find_cell(name: str, root: Path = ROOT, pkg: Path = PKG) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"unknown workload {name!r}; BENCHMARK.json has {sorted(entries)}")
    entry = entries[name]
    config_entry = {c["name"]: c for c in bench["configs"]}[entry["config"]]

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return Cell(
        name=name,
        entry=entry,
        workload=load_json(pkg / "workloads" / f"{name}.json"),
        config=load_json(root / config_entry["file"]),
        traffic=load_json(pkg / "traffic" / f"{entry['traffic']}.json"),
        end_to_end=mine(bench["end_to_end"]),
        per_layer=mine(bench["per_layer"]),
        pkg=pkg,
    )


class Spans:
    """Host-clock spans around calls into the program, each closed by a
    device sync; kept in memory by name."""

    def __init__(self, sync):
        self.sync = sync
        self.times: dict = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        yield
        self.sync()
        self.times.setdefault(name, []).append(time.perf_counter() - t0)


@dataclasses.dataclass
class Ctx:
    """What a driver and the metric readers see: the driver's ``run`` and the
    timed ``window``; in a traced run also the benchmark's ``spans``, the
    driver's ``counters`` and the first profiled segment's summary
    (``profile``, with the program's counters' change over that segment)."""

    cell: Cell
    seed: int
    device: object
    sync: object
    run: object = None
    window: dict = dataclasses.field(default_factory=dict)
    spans: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)
    profile: dict = dataclasses.field(default_factory=dict)


def _segment(run, ctx, activities) -> dict:
    """Profile ``run.trace_units`` units; the summary of their events over
    the segment's host-clock window (the profiler's time base), with the
    program's counters' change over the segment (``utils/profiling.counters``)."""
    from rein48_tpu_torch.utils import profiling
    from torch.profiler import profile, record_function

    from portbench import events

    marker = "portbench.segment"
    before = dict(profiling.counters)
    with profile(activities=activities) as prof:
        t0 = time.time_ns()
        with record_function(marker):
            for _ in range(run.trace_units):
                run.unit(None)
            ctx.sync()
        t1 = time.time_ns()
    out = events.summarize(prof, (t0, t1), marker)
    out["counters"] = {k: v - before.get(k, 0) for k, v in profiling.counters.items() if v != before.get(k, 0)}
    return out


def _profile(run, ctx) -> dict:
    """Two segments: the device's events alone, which cost the host least,
    for busy time, launches and the top operations; then the host's
    operations beside them, to name what the host did across each gap."""
    from torch.profiler import ProfilerActivity

    cpu, cuda = ProfilerActivity.CPU, ProfilerActivity.CUDA
    out = _segment(run, ctx, [cuda] if ctx.device.type == "cuda" else [cpu])
    named = _segment(run, ctx, [cpu, cuda] if ctx.device.type == "cuda" else [cpu])
    out["idle_gaps"] = named["idle_gaps"]
    out["launches"] = out["launches"] or named["launches"]
    out["units"] = run.trace_units
    return out


def make_sync(device):
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    import torch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    return sync


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, start: float) -> dict:
    """Set up, time, trace and judge one cell; the result's fields."""
    import torch

    sync = make_sync(device)
    ctx = Ctx(cell=cell, seed=seed, device=device, sync=sync)
    driver = load_module("drivers", cell.workload["driver"], cell.pkg)
    ctx.run = run = driver.setup(ctx)
    sync()
    spans = Spans(sync) if trace else None
    lat, units = [], 0
    t_start = time.perf_counter()
    setup_s = t_start - start
    while True:
        t0 = time.perf_counter()
        run.unit(spans)
        sync()
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        units += 1
        if t1 - t_start >= seconds:
            break
    ctx.window = {"seconds": t1 - t_start, "units": units, "latencies": lat, "setup_s": setup_s}
    if len(lat) > 1:
        q = statistics.quantiles(lat, n=4)
        print(f"portbench: window {units} units in {t1 - t_start:.3f} s; unit ms quartiles "
              f"{1e3 * q[0]:.3f} {1e3 * q[1]:.3f} {1e3 * q[2]:.3f}, max {1e3 * max(lat):.3f}", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if trace:
        ctx.spans = spans.times
        ctx.profile = _profile(run, ctx)
        ctx.counters = run.counters()
    kinds = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in kinds:
        value = load_module("metrics", m["name"], cell.pkg).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    run.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = run.check()
    limits = cell.workload["limits"]
    checks = {k: {"value": float(readings[k]), "limit": float(limits[k])} for k in limits}
    failed = sum(c["value"] > c["limit"] for c in checks.values())
    out = {"correct": failed == 0, "attempted": units, "failed": failed, "metrics": metrics, "peak": peak,
           "profile": ctx.profile, "checks": checks}
    return out


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(args, start: float) -> int:
    os.environ.update(cache_dirs(ROOT))
    cell = find_cell(args.workload)
    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, start)
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips, "memory_peak_bytes": res["peak"]}
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"], "metrics": res["metrics"],
            "device": dev}
    if args.trace:
        prof = res["profile"]
        dev["busy_s"], dev["window_s"] = prof["busy_s"], prof["window_s"]
        line["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
        line["card"] = card_line()
    line["checks"] = res["checks"]
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0

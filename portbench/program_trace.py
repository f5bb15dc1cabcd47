"""The program's own spans and counters (``rein48_tpu_torch.utils.profiling``),
read in a traced run after the harness's profiled segments.

Segment A: ``trace_units`` more units under ``profiling.tracing()``, each
ended by a device sync as in the timed window, with no profiler: every span's
host and device-clock durations, and the counters' change. It first clears
what the harness's profiled segments leave behind (:func:`settle`), which
would slow the host-bound spans. Segment B: as many
units again under ``tracing()`` inside a ``torch.profiler`` session; its raw
events are read as ``events.summarize`` reads them and give, for each span
name, the device's busy time in the operations launched inside its
annotations (the union of their intervals), the host's kernel-launch calls
inside them, and how far each span's in-memory start and end lie from its
annotation's.

The metrics that name a span call :func:`record`; the first call measures
both segments with the cell's ``Run``, which the harness hands the readers
on the context (``ctx.run``), and keeps the result there, so the later ones
read the same segments. A program without the facility (no
``profiling.tracing``) gives None, and those metrics stay silent.
"""

from __future__ import annotations

import bisect
import gc
import os
import statistics
import sys
import time

from portbench.events import LAUNCH_CALLS, _union

KEY = "program_trace"


def record(ctx):
    """Segments A and B of this run, measured at the first call; None where
    the program has no spans."""
    if not hasattr(ctx, KEY):
        setattr(ctx, KEY, None if ctx.run is None else measure(ctx, ctx.run))
    return getattr(ctx, KEY)


def measure(ctx, run):
    try:
        from rein48_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "tracing"):
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile

    units = run.trace_units
    settle(ctx.device)
    with profiling.tracing() as a:
        t0 = time.perf_counter()
        for _ in range(units):
            run.unit(None)
            ctx.sync()
        wall = time.perf_counter() - t0
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if ctx.device.type == "cuda" else [])
    with profiling.tracing() as b, profile(activities=activities) as prof:
        for _ in range(units):
            run.unit(None)
            ctx.sync()
    out = {
        "units": units,
        "wall_s": wall,
        "spans": [span_dict(s) for s in a.resolve()],
        "counters": dict(a.counters),
        "annotated": annotated(prof.profiler.kineto_results.events(), [span_dict(s) for s in b.resolve()]),
    }
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    print_table(out, ctx.window)
    return out


def settle(device) -> None:
    """Collect the profiled segments' garbage, and on a card detach CUPTI:
    a CUDA profiler session leaves it attached, which slows every later
    launch, and an empty session ended with ``TEARDOWN_CUPTI=1`` tears it
    down (the next session attaches it again)."""
    gc.collect()
    if device.type != "cuda":
        return
    from torch.profiler import ProfilerActivity, profile

    saved = os.environ.get("TEARDOWN_CUPTI")
    os.environ["TEARDOWN_CUPTI"] = "1"
    try:
        with profile(activities=[ProfilerActivity.CUDA]):
            pass
    finally:
        if saved is None:
            del os.environ["TEARDOWN_CUPTI"]
        else:
            os.environ["TEARDOWN_CUPTI"] = saved


def span_dict(s) -> dict:
    return {"name": s.name, "id": s.id, "parent": s.parent, "root": s.root, "start_ns": s.start_ns,
            "end_ns": s.end_ns, "host_ms": s.host_ms, "device_ms": s.device_ms}


def annotated(events, spans) -> dict:
    """Per span name, from a session's raw events and the spans recorded in
    it: ``busy_s`` (the union of the intervals of the device operations whose
    launch lies inside the name's annotations), ``launches`` (the host's
    launch calls inside them), ``linked`` (the share of device operations
    placed by their launch call rather than by their own start) and
    ``clock_us`` (per span, the larger distance between its start and end and
    its annotation's; ``start_us`` and ``end_us`` each alone)."""
    names = {s["name"] for s in spans}
    marks: dict = {}
    launch_ns, runtime, ops, device = [], {}, {}, []
    for e in events:
        kind, start, dur = e.device_type().name, e.start_ns(), e.duration_ns()
        if e.is_user_annotation():
            if kind == "CPU" and e.name() in names:
                marks.setdefault(e.name(), []).append((start, start + dur))
            continue
        if kind == "CPU":
            if e.name().startswith(LAUNCH_CALLS):
                launch_ns.append(start)
            if e.name().startswith("cu"):
                runtime[e.correlation_id()] = start
            else:
                ops[e.correlation_id()] = start
        elif kind == "CUDA" and dur > 0:
            device.append((e.correlation_id(), e.linked_correlation_id(), start, start + dur))
    placed, linked = [], 0
    for corr, link, s, t in device:
        at = runtime.get(corr, ops.get(link))
        linked += at is not None
        placed.append((s if at is None else at, s, t))
    placed.sort()
    at_ns = [p[0] for p in placed]
    launch_ns.sort()
    out = {}
    for name, intervals in marks.items():
        intervals.sort()
        busy, launches = 0, 0
        for s, t in intervals:
            lo, hi = bisect.bisect_left(at_ns, s), bisect.bisect_right(at_ns, t)
            busy += sum(b - a for a, b in _union([p[1:] for p in placed[lo:hi]]))
            launches += bisect.bisect_right(launch_ns, t) - bisect.bisect_left(launch_ns, s)
        mine = sorted((x["start_ns"], x["end_ns"]) for x in spans if x["name"] == name)
        starts = [abs(a - s) / 1e3 for (a, _), (s, _) in zip(mine, intervals)]
        ends = [abs(b - t) / 1e3 for (_, b), (_, t) in zip(mine, intervals)]
        out[name] = {"calls": len(intervals), "busy_s": busy / 1e9, "launches": launches,
                     "linked": linked / len(device) if device else None,
                     "clock_us": [max(a, b) for a, b in zip(starts, ends)], "start_us": starts, "end_us": ends}
    return out


def ancestors(spans: list, s: dict):
    while s["parent"] is not None:
        s = spans[s["parent"]]
        yield s["name"]


def per_unit_ms(rec, name: str, under: str | None = None) -> float | None:
    """Device-clock ms per unit of the spans ``name`` of segment A, those
    inside a span ``under`` alone when given; None where there are none."""
    spans = rec["spans"]
    mine = [s for s in spans if s["name"] == name and (under is None or under in ancestors(spans, s))]
    return sum(s["device_ms"] for s in mine) / rec["units"] if mine else None


def self_ms(rec, name: str, child: str) -> float | None:
    """Device-clock ms per unit of the spans ``name`` less their children ``child``."""
    spans = rec["spans"]
    total = per_unit_ms(rec, name)
    if total is None:
        return None
    ids = {s["id"] for s in spans if s["name"] == name}
    return total - sum(s["device_ms"] for s in spans if s["name"] == child and s["parent"] in ids) / rec["units"]


def idle_share(rec, name: str) -> float | None:
    """% of the spans' device-clock time in which no operation they launched
    ran: 1 - busy per unit in segment B over the device-clock duration per
    unit in segment A (as ``metrics/device_idle.py`` divides a profiled
    run's busy time by an unprofiled run's time). Silent without device
    events."""
    seen = (rec.get("annotated") or {}).get(name)
    total = per_unit_ms(rec, name)
    if not seen or not seen["busy_s"] or not total:
        return None
    return 100.0 * (1.0 - 1e3 * seen["busy_s"] / rec["units"] / total)


def print_table(rec, window: dict) -> None:
    """Per span name on standard error: spans, host, device and self ms per
    unit (segment A); busy ms and launches per unit and the clock distance
    (segment B)."""
    units, spans = rec["units"], rec["spans"]
    child = [0.0] * len(spans)
    for s in spans:
        if s["parent"] is not None:
            child[s["parent"]] += s["device_ms"]
    rows: dict = {}
    for s in spans:
        r = rows.setdefault(s["name"], [0, 0.0, 0.0, 0.0])
        r[0] += 1
        r[1] += s["host_ms"]
        r[2] += s["device_ms"]
        r[3] += s["device_ms"] - child[s["id"]]
    err = sys.stderr
    print("span name calls/unit host_ms device_ms self_ms busy_ms launches clock_us_median clock_us_max", file=err)
    for name, (n, host, dev, own) in rows.items():
        b = rec["annotated"].get(name, {})
        clock = b.get("clock_us") or [float("nan")]
        print(f"span {name} {n / units:g} {host / units:.3f} {dev / units:.3f} {own / units:.3f} "
              f"{1e3 * b.get('busy_s', 0.0) / units:.3f} {b.get('launches', 0) / units:g} "
              f"{statistics.median(clock):.1f} {max(clock):.1f}", file=err)
    seen = rec["annotated"].values()
    clocks = [c for b in seen for c in b["clock_us"]]
    if clocks:
        linked = next(iter(seen))["linked"]
        print(f"span clocks_us median {statistics.median(clocks):.1f} max {max(clocks):.1f} over {len(clocks)} spans; "
              f"start median {statistics.median(c for b in seen for c in b['start_us']):.1f}, end median "
              f"{statistics.median(c for b in seen for c in b['end_us']):.1f}; device operations placed by their "
              f"launch {linked}", file=err)
    window_unit = window["seconds"] / window["units"]
    print(f"span segment_a_wall_per_unit_s {rec['wall_s'] / units:.6f} window_wall_per_unit_s {window_unit:.6f} "
          f"ratio {rec['wall_s'] / units / window_unit:.4f} counters {rec['counters']}", file=err)

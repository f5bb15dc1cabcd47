"""Reading a ``torch.profiler`` session from its raw events, in memory.

:func:`summarize` sums device time by name and counts the host's launch
calls from the session's raw events, as the port's
``utils/profiling.kernel_times`` does (an 80 k-launch session reads in
seconds, where ``key_averages()`` takes tens of seconds), and adds the
device's busy time (the union of the intervals of every device event),
the traced window, every device operation's total time by name, the
operations that took the most time and the longest idle gaps named by the
innermost host operation that was running across each gap.
"""

from __future__ import annotations

import bisect

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")
# The profiler's own host events, which say nothing of the program.
IGNORED_HOST = ("Activity Buffer Request",)
# Entries of each list of the result's breakdown.
TOP = 10


def _union(intervals):
    """Merged ``[(start, end)]`` of device intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(prof, window_ns: tuple[int, int], marker: str) -> dict:
    """Busy and window seconds, launches, device seconds by operation name
    (``kernels``, every name), top device operations and idle gaps of the
    session, over ``window_ns`` (the profiler's time base, ns).
    ``marker`` names the annotation that spans the segment: it is no
    device work, and a gap inside it alone finds the host in Python."""
    w0, w1 = window_ns
    kernels, device, host = {}, [], []
    launches = 0
    for e in prof.profiler.kineto_results.events():
        kind = e.device_type().name
        start, dur = e.start_ns(), e.duration_ns()
        if e.name() == marker or e.is_user_annotation():
            continue
        if kind == "CPU":
            launches += e.name().startswith(LAUNCH_CALLS)
            if dur > 0 and not e.name().startswith(IGNORED_HOST):
                host.append((start, start + dur, e.name()))
        elif kind == "CUDA" and dur > 0:
            device.append((max(start, w0), min(start + dur, w1)))
            entry = kernels.setdefault(e.name(), [0.0, 0])
            entry[0] += dur / 1e9
            entry[1] += 1
    merged = [iv for iv in _union([d for d in device if d[1] > d[0]])]
    busy = sum(e - s for s, e in merged) / 1e9
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(reverse=True)
    host.sort()
    starts = [h[0] for h in host]
    named: dict = {}
    for length, g0, g1 in gaps[:200]:
        mid = (g0 + g1) // 2
        name = "host in Python, outside any operation"
        i = bisect.bisect_right(starts, mid) - 1
        while i >= 0:
            s, e, n = host[i]
            if e >= mid:
                name = n
                break
            i -= 1
            if mid - s > 5e9:
                break
        named[name] = named.get(name, 0.0) + length / 1e9
    ops = sorted(kernels.items(), key=lambda kv: kv[1][0], reverse=True)[:TOP]
    return {
        "busy_s": busy,
        "window_s": (w1 - w0) / 1e9,
        "launches": launches,
        "kernels": {n: s for n, (s, _) in kernels.items()},
        "device_ops": [[n[:120], s] for n, (s, _) in ops],
        "idle_gaps": [[n[:120], s] for n, s in sorted(named.items(), key=lambda kv: kv[1], reverse=True)[:TOP]],
    }

"""Share of a unit's wall time in which no operation ran on the device, in
%: 1 minus the device's busy time per unit (the union of the device events'
intervals in the profiled segment) over the wall time per unit of the
traced run's timed window, where the profiler is off and cannot slow the
host. It reads ``device_idle.<kind>`` for every kind of cell, each name
moving that cell's own rate."""


def read(ctx):
    p, w = ctx.profile, ctx.window
    if not p or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - (p["busy_s"] / p["units"]) / (w["seconds"] / w["units"]))

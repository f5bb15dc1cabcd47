"""95th percentile of the window's move times (policy and engine step,
each timed to a device sync), in ms."""

import statistics


def read(ctx):
    lat = ctx.window["latencies"]
    if len(lat) < 2:
        return None
    return 1e3 * statistics.quantiles(lat, n=100)[94]

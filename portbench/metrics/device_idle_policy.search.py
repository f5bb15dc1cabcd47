"""Share of the ``search.policy`` spans' device-clock time in which none of
the operations they launched ran on the device, in %: 1 minus the busy time
per move inside the annotations of the profiled segment over the span's
device-clock duration per move in the unprofiled one."""

from portbench import program_trace


def read(ctx):
    rec = program_trace.record(ctx)
    return None if rec is None else program_trace.idle_share(rec, "search.policy")

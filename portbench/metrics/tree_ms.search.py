"""Device-clock ms per move of the expectimax tree around its leaves: the
``search.policy`` spans less their ``search.leaf`` children, in the
program's traced segment."""

from portbench import program_trace


def read(ctx):
    rec = program_trace.record(ctx)
    return None if rec is None else program_trace.self_ms(rec, "search.policy", "search.leaf")

"""Device-clock ms per move of the engine's auto-reset step: the
``engine.step`` spans, in the program's traced segment."""

from portbench import program_trace


def read(ctx):
    rec = program_trace.record(ctx)
    return None if rec is None else program_trace.per_unit_ms(rec, "engine.step")

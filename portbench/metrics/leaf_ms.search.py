"""Device-clock ms per move of the leaf evaluations: the ``search.leaf``
spans (``control/search.make_value_leaf``: encoding and the tower), in the
program's traced segment."""

from portbench import program_trace


def read(ctx):
    rec = program_trace.record(ctx)
    return None if rec is None else program_trace.per_unit_ms(rec, "search.leaf")

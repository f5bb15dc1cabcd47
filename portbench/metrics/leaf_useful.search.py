"""Share of the boards fed to the tower that the timed moves' trees needed,
in %: the driver's ``leaves_needed`` over the window's moves times the
boards per move that the program's ``search.leaf_boards`` counter counted in
its traced segment (base: the boards fed to the tower)."""

from portbench import program_trace


def read(ctx):
    rec = program_trace.record(ctx)
    needed = ctx.counters.get("leaves_needed")
    fed = None if rec is None else rec["counters"].get("search.leaf_boards")
    if not needed or not fed:
        return None
    return 100.0 * needed / (fed / rec["units"] * ctx.window["units"])

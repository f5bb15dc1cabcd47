"""Kernel launch calls of the host inside the ``ppo.rollout`` annotations of
the program's profiled segment, per acting step (updates x ``unroll_len``).
A count; silent without launches (no card)."""

from portbench import program_trace


def read(ctx):
    rec = program_trace.record(ctx)
    seen = None if rec is None else rec["annotated"].get("ppo.rollout")
    if not seen or not seen["launches"]:
        return None
    return seen["launches"] / (rec["units"] * ctx.cell.traffic["ppo"]["unroll_len"])

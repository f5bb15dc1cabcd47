"""Kernel launch calls of the host per lockstep step in the profiled
updates: launches over (updates x steps per update). A count."""


def read(ctx):
    p = ctx.profile
    if not p or not p["launches"]:
        return None
    return p["launches"] / (p["units"] * ctx.cell.traffic["steps_per_update"])

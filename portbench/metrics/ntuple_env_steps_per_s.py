"""n-tuple trainer env-steps per second: batch x steps per update x the
updates completed in the window, over the window."""


def read(ctx):
    t = ctx.cell.traffic
    return ctx.window["units"] * t["batch_size"] * t["steps_per_update"] / ctx.window["seconds"]

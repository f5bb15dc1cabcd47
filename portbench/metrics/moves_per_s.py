"""Boards moved per second: games x the lockstep moves completed in the
window, over the window."""


def read(ctx):
    return ctx.window["units"] * ctx.cell.traffic["games"] / ctx.window["seconds"]

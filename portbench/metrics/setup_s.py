"""Seconds from process start to the first timed unit: imports, weights,
tables, the first units that build and warm every shape."""


def read(ctx):
    return ctx.window["setup_s"]

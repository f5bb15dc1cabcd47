"""Leaf forwards the timed moves needed (legal afterstates of the blank-cell
children of legal afterstates) x the forward's operations counted from
shapes, per second of the window, over the card's dense bf16 peak, in %."""

from portbench import flops


def read(ctx):
    n = ctx.counters.get("leaves_needed")
    if not n:
        return None
    c = ctx.cell.config
    return 100.0 * n * flops.resnet_forward(c["channels"], c["num_blocks"]) / ctx.window["seconds"] / flops.PEAK_BF16

"""Share of the card's HBM bandwidth that the whole move reaches in an
n-tuple search cell, in %: the leaf values the window's trees needed (the
driver's ``leaves_needed``) x 148 B each (``ntuple_bytes.leaf_bytes``: the
board, the value and 4 B a lookup), per second of the window, over 3.35
TB/s.

An ``mfu`` is a share of the card's peak for the work the step must do. The
n-tuple value does no floating-point work to speak of (integer indices and
adds), so its peak is the card's memory bandwidth, and the work is counted
in bytes. The count takes the leaves a move needs, not those the program
feeds its leaf, so that a program that wastes fewer leaves reads higher for
the same time, and the lookups at full price, which the whole move's time
can bear: it reads far below 100%.
"""

from portbench import flops, ntuple_bytes


def read(ctx):
    n = ctx.counters.get("leaves_needed")
    if not n:
        return None
    return 100.0 * ntuple_bytes.leaf_bytes(ctx.cell.config, n) / ctx.window["seconds"] / flops.PEAK_HBM

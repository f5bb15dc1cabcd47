"""Share of its byte roofline that the n-tuple value kernel of
``csrc/ntuple_value.cu`` reaches in a search cell, in %: the bytes the leaf
work must move (``ntuple_bytes.fed_bytes``: 20 B a board the program fed its
leaf in the segment, by its ``search.leaf_boards`` counter) over the
``ntuple_value_kernel`` device time in the first profiled segment, over the
card's HBM bandwidth. The lookups are left out of the count (see
``ntuple_bytes.py``); the share with 4 B a lookup is printed on standard
error beside it. Silent without the kernel's device events (no card, or a
program whose leaf runs another way) or without the boards counted.
"""

import sys

from portbench import flops, ntuple_bytes

KERNEL = "ntuple_value_kernel"


def read(ctx):
    p = ctx.profile
    if not p:
        return None
    seconds = sum(s for name, s in p["kernels"].items() if KERNEL in name)
    boards = p["counters"].get("search.leaf_boards", 0)
    if not seconds or not boards:
        return None
    work = ntuple_bytes.fed_bytes(boards)
    every = ntuple_bytes.leaf_bytes(ctx.cell.config, boards)
    print(f"ntuple_value_roofline bytes {work} kernel_s {seconds!r} boards {boards} units {p['units']} "
          f"with_lookups_bytes {every} with_lookups_share {100.0 * every / flops.PEAK_HBM / seconds!r}",
          file=sys.stderr)
    return 100.0 * work / flops.PEAK_HBM / seconds

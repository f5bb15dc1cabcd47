"""Share of its byte roofline that the layer norm kernels of
``csrc/layer_norm.cu`` reach, in %: the bytes the work must move (counted in
``flops.py``) over the kernels' device time in the first profiled segment
(forward, the backward's rows and its partial sums), over the card's HBM
bandwidth.

The work: in a PPO cell, fixed by the traffic, ``trace_units`` updates of
``flops.ppo_layer_norm_bytes``; in a search cell, inference forwards of the
boards the program fed the tower in the segment (its ``search.leaf_boards``
counter), so a program that feeds fewer boards is held to fewer bytes.
Silent without the kernels' device events (no card) or without the work.
A cell that runs the norm another way brings ``layer_norm_roofline.<kind>.py``
of its own.
"""

import sys

from portbench import flops

KERNELS = ("layer_norm_relu_forward", "layer_norm_relu_backward", "layer_norm_relu_sum")


def read(ctx):
    p, c = ctx.profile, ctx.cell.config
    if not p:
        return None
    seconds = sum(s for name, s in p["kernels"].items() if any(k in name for k in KERNELS))
    if "ppo" in ctx.cell.traffic:
        work = p["units"] * flops.ppo_layer_norm_bytes(c, ctx.cell.traffic["ppo"])
    else:
        work = flops.layer_norm_bytes(c, p["counters"].get("search.leaf_boards", 0))
    if not seconds or not work:
        return None
    print(f"layer_norm_roofline bytes {work} kernel_s {seconds!r} program_bound_bytes "
          f"{p['counters'].get('layer_norm.bound_bytes')} units {p['units']}", file=sys.stderr)
    return 100.0 * work / flops.PEAK_HBM / seconds

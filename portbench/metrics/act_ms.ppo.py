"""Device-clock ms per PPO update of the acting steps: the ``a3c.act`` spans
(each step's policy forward, mask and Gumbel-max sampling, and the bootstrap
forward) of ``train/a3c.rollout_policy``, in the program's traced segment."""

from portbench import program_trace


def read(ctx):
    rec = program_trace.record(ctx)
    return None if rec is None else program_trace.per_unit_ms(rec, "a3c.act")
